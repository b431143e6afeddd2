"""The face-reenactment (AffectNet) family on the port against the JAX
package, on the CPU in fp32.

* ``ClassEmbedder`` in each null layout (``separate`` = ClassEmbedder3, with
  ``freeze_null`` = ClassEmbedder2, ``none``, ``extra_row``): tokens, null
  tokens and the label drop exact; the config builders' choices and the
  frozen null row kept out of the optimizer.
* ``build_model`` of both AffectNet YAMLs on the meta device (the second
  through ``build_finetune``), every self-attention's route in eval and in
  training at the shapes the kernels take, and the 1-cond branches.
* A tiny 1-cond model ([4, 2, 1] UNet of 32 channels, 32-wide heads, a 16 px
  VQ first stage with attention, ClassEmbedder3), weights from a numpy seed
  carried by ``from_jax_params``: the UNet call, the encode / decode and
  the conditioning (1e-4 of the output's maximum), the training loss (1e-5)
  and every gradient leaf (1e-4 of its own maximum) with the JAX side's
  draws; guided sampling by each sampler, the latent cache of
  ``compute_latent_cache`` and ``manipulate`` (latents 1e-3, as the
  pipeline's).
* ``AffectnetDataset`` / ``LatentDataset`` on files the test writes, item for
  item against the JAX datasets; the refusals (no Pillow where a resize is
  needed, ``DSML_NATIVE_IMAGE=1`` without a decoder that builds).
* The three new scripts and ``scripts/train_torch.py`` with ``--cpu`` on the
  tiny config, and ``chip_smoke.py``'s launch arithmetic of the AffectNet
  runs against spies on the wrappers.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.data import datasets as jds
from dsml_thesis_tpu.diffusion import (ddim_invert as j_ddim_invert,
                                       ddim_reverse_from as j_reverse,
                                       dpm_solver_sample_suite as j_dpm,
                                       make_ddim_schedule as j_ddim_schedule,
                                       plms_sample as j_plms)
from dsml_thesis_tpu.models import encoders as jenc
from dsml_thesis_tpu_torch import reenactment as R
from dsml_thesis_tpu_torch.config import (build_finetune, build_model,
                                          instantiate_from_config, load_config)
from dsml_thesis_tpu_torch.convert import from_jax_params, from_jax_tree
from dsml_thesis_tpu_torch.data import datasets as tds
from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
from dsml_thesis_tpu_torch.models import encoders as tenc
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.training import train_state as tts
from test_torch_port_pipeline import random_params
from test_torch_port_training import B, _jax_draws, _jb, _leaves, _tb
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
YAML = os.path.join(ROOT, "configs", "latent-diffusion",
                    "affectnet-128-ldm-vq-f4.yaml")
YAML_CLIP = os.path.join(ROOT, "configs", "latent-diffusion",
                         "affectnet-128-clip-ldm-vq-f4.yaml")

TINY_AFFECTNET = """
model:
  base_learning_rate: 1.0e-05
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.0015
    linear_end: 0.0205
    timesteps: 100
    image_size: 8
    channels: 3
    first_stage_key: image
    cond_stage_key: class_label
    cond_stage_trainable: true
    conditioning_key: crossattn
    monitor: val_loss_ema
    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params: {image_size: 8, in_channels: 3, out_channels: 3,
               model_channels: 32, attention_resolutions: [4, 2, 1],
               num_res_blocks: 1, channel_mult: [1, 2, 4],
               num_head_channels: 32, use_spatial_transformer: true,
               transformer_depth: 1, context_dim: 16}
    first_stage_config:
      target: ldm.models.autoencoder.VQModelInterface
      params:
        embed_dim: 3
        n_embed: 64
        ddconfig: {double_z: false, z_channels: 3, resolution: 16,
                   in_channels: 3, out_ch: 3, ch: 32, ch_mult: [1, 2],
                   num_res_blocks: 1, attn_resolutions: [8], dropout: 0.0}
        lossconfig: {target: torch.nn.Identity}
    cond_stage_config:
      target: ldm.modules.encoders.modules.ClassEmbedder3
      params: {embed_dim: 16, n_classes: 8, key: class_label, p_uncond: 0.0}
data:
  params:
    batch_size: 4
    num_workers: 1
"""


def tiny_cfg(p_uncond=0.0, embedder="ClassEmbedder3"):
    cfg = yaml.safe_load(TINY_AFFECTNET)
    node = cfg["model"]["params"]["cond_stage_config"]
    node["target"] = f"ldm.modules.encoders.modules.{embedder}"
    node["params"]["p_uncond"] = p_uncond
    return cfg


def batch_of(seed, n=B):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
            "class_label": rng.integers(0, 8, (n,)).astype(np.int32)}


def tiny_models(p_uncond=0.0, params=None, seed=1):
    """The tiny model on both sides with one set of weights: ``params``, or
    the JAX init refilled from a numpy seed (it zeroes every block-final
    conv)."""
    cfg = tiny_cfg(p_uncond)
    jldm = jax_build_model(cfg["model"])
    if params is None:
        params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0),
                                           _jb(batch_of(0)))
        params = random_params(params, np.random.default_rng(seed))
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    return cfg, jldm, params, tldm


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


# --------------------------------------------------------------------------
# ClassEmbedder's null layouts
# --------------------------------------------------------------------------

MODES = {"separate": ("separate", False), "frozen-null": ("separate", True),
         "none": ("none", False), "extra-row": ("extra_row", False)}


@pytest.mark.parametrize("mode", list(MODES))
def test_class_embedder_modes_match_jax(mode):
    null_mode, freeze = MODES[mode]
    p = 0.0 if null_mode == "none" else 1.0
    labels = jnp.asarray([0, 3, 7, 3])
    kw = dict(embed_dim=16, n_classes=8, null_mode=null_mode,
              freeze_null=freeze)
    jm = jenc.ClassEmbedder(p_uncond=p, **kw)
    params = random_params(jm.init(jax.random.PRNGKey(0), labels)["params"],
                           np.random.default_rng(0))
    tm = tenc.ClassEmbedder(p_uncond=p, **kw)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    want = np.asarray(jm.apply({"params": params}, labels))
    tl = torch.tensor(np.asarray(labels))
    with torch.no_grad():
        np.testing.assert_array_equal(tm(tl).numpy(), want)
    assert tm.frozen_paths() == jm.frozen_paths()
    if null_mode == "none":
        with pytest.raises(ValueError):
            tm.null_token(2)
        with pytest.raises(ValueError):
            tenc.ClassEmbedder(p_uncond=0.2, **kw)
        return
    want_null = np.asarray(jm.apply({"params": params}, method="null_token",
                                    batch_size=3))
    # p_uncond = 1: the training draw always drops the whole batch
    want_drop = np.asarray(jm.apply({"params": params}, labels, training=True,
                                    rngs={"cfg": jax.random.PRNGKey(1)}))
    with torch.no_grad():
        np.testing.assert_array_equal(tm.null_token(3).numpy(), want_null)
        got_drop = tm(tl, training=True, generator=torch.Generator())
        np.testing.assert_array_equal(got_drop.numpy(), want_drop)
        np.testing.assert_array_equal(
            tm(tl, training=True, drop=torch.tensor(False)).numpy(), want)
    if null_mode == "separate":
        np.testing.assert_array_equal(
            want_null[0, 0], np.asarray(params["uncond_embedding"]["embedding"])[0])
        assert tm.embedding.weight.shape[0] == 8
    # the frozen null row passes no gradient
    null = tm.null_token(2)
    assert null.requires_grad == (not freeze)


@pytest.mark.parametrize("target,params", [
    ("ClassEmbedder3", {"embed_dim": 8, "n_classes": 8}),
    ("ClassEmbedder3", {"embed_dim": 8, "n_classes": 8, "p_uncond": 0.3}),
    ("ClassEmbedder2", {"embed_dim": 8, "n_classes": 8}),
    ("ClassEmbedder", {"embed_dim": 8, "n_classes": 8}),
    ("ClassEmbedder", {"embed_dim": 8, "n_classes": 8, "p_uncond": 0.1}),
], ids=["3-default", "3-p", "2", "plain", "talking-face"])
def test_class_embedder_builders_match_jax(target, params):
    from dsml_thesis_tpu.config import instantiate_from_config as jinst

    node = {"target": f"ldm.modules.encoders.modules.{target}",
            "params": params}
    jm, tm = jinst(node), instantiate_from_config(node)
    assert (tm.null_mode, tm.freeze_null, tm.p_uncond, tm.n_classes) == (
        jm.null_mode, jm.freeze_null, jm.p_uncond, jm.n_classes)
    assert instantiate_from_config({"target": "torch.nn.Identity"}) is None


def test_frozen_null_row_stays_out_of_the_optimizer():
    """ClassEmbedder2: the null row is no trainable parameter, AdamW's
    decoupled decay never reaches it, and a step that drops every label
    leaves it as it was."""
    cfg = tiny_cfg(p_uncond=1.0, embedder="ClassEmbedder2")
    tldm, jldm = build_model(cfg["model"]), jax_build_model(cfg["model"])
    assert tldm.frozen_subpaths() == jldm.frozen_subpaths() == {
        "cond/class_label": ("uncond_embedding",)}
    opt = tts.make_optimizer(tldm, base_lr=1e-2)
    null = tldm.cond["class_label"].uncond_embedding.weight
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(null) not in in_opt and not null.requires_grad
    assert id(tldm.cond["class_label"].embedding.weight) in in_opt
    before = null.detach().clone()
    state = tts.create_train_state(tldm, opt, base_lr=1e-2)
    assert not any("uncond" in n for n in state.names)
    tts.make_train_step(tldm)(state, _tb(batch_of(3)), seed=0)
    assert torch.equal(null, before)


# --------------------------------------------------------------------------
# the shipped YAMLs and the 1-cond branches of build_model
# --------------------------------------------------------------------------

def _meta(path):
    cfg = load_config([path])
    with torch.device("meta"):
        if path == YAML_CLIP:
            return build_finetune(cfg["model"]).ldm
        return build_model(cfg["model"])


@pytest.mark.parametrize("path", [YAML, YAML_CLIP], ids=["ldm", "clip"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_shipped_yamls_build_and_route(path, mode, monkeypatch):
    """Both YAMLs build (the finetune's through ``build_finetune``); every
    one of the 16 self-attentions of a UNet call goes, in eval, to the
    fused-projection op and, in training, to the packed op, at fp32 D = 32
    shapes their kernels take; the first stage's attention blocks to the
    split-head op at D = 512, N = 1024."""
    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    ldm = _meta(path)
    emb = ldm.cond["class_label"]
    assert (emb.null_mode, emb.n_classes) == ("separate", 8)
    assert ldm.first_stage.quantize.n_e == 16384
    seen = []

    def spy(name):
        def call(*args, **kw):
            x = args[0]
            seen.append((name, x.shape, x.dtype, args))
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        return call

    monkeypatch.setattr(tunet, "flash_attention_fproj", spy("fproj"))
    monkeypatch.setattr(tunet, "packed_multi_head_attention", spy("packed"))
    monkeypatch.setattr(tunet, "multi_head_attention", spy("split"))
    unet = ldm.unet.train(mode == "train")
    for m in unet.modules():
        if isinstance(m, tunet.SpatialTransformer):
            n = {160: 1024, 320: 256, 640: 64}[m.proj_in.in_channels]
            c = m.proj_in.out_channels
            x = torch.empty(4, n, c, device="meta")
            m.block_0.attn1(x)
    assert len(seen) == 16
    for name, shape, dtype, args in seen:
        assert dtype == torch.float32
        if mode == "eval":
            heads = args[6]
            assert name == "fproj" and args[1].shape[0] // heads == 32
            assert tatt.fproj_one_q_block(shape[1])
            assert tatt.fproj_kernel_takes(shape[-1], 32, dtype)
        else:
            heads = args[3]
            assert name == "packed" and shape[-1] // heads == 32
            assert tatt.packed_kernel_takes(32, dtype)
            assert tatt.packed_bwd_kernel_takes(32, dtype)
    seen.clear()
    from dsml_thesis_tpu_torch.models import autoencoder as tae

    monkeypatch.setattr(tae, "multi_head_attention", spy("split"))
    blocks = [m for m in ldm.first_stage.decoder.modules()
              if isinstance(m, tae.AttnBlock)]
    assert len(blocks) == 4
    for m in blocks:
        m(torch.empty(4, 512, 32, 32, device="meta"))
    for name, shape, dtype, _ in seen:
        assert name == "split" and tuple(shape) == (4, 1, 1024, 512)
        assert tatt.flash_kernel_takes(512, dtype)


@pytest.mark.parametrize("case", ["null-key", "first-stage", "concat",
                                  "unconditional", "latent-key"])
def test_one_cond_branches_match_jax(case):
    cfg = tiny_cfg()
    p = cfg["model"]["params"]
    if case == "null-key":
        cfg["model"]["target"] = \
            "ldm.models.diffusion.latent_diffclip.LatentDiffusionCLIP"
        p["cond_stage_key"] = None
        p["cond_stage_trainable"] = False
    elif case == "first-stage":
        p["cond_stage_config"] = "__is_first_stage__"
        p["cond_stage_key"] = "masked"
    elif case == "concat":
        p["conditioning_key"] = "concat"
    elif case == "unconditional":
        p["cond_stage_config"] = "__is_unconditional__"
    else:
        p["first_stage_key"] = "latent"
    j, t = jax_build_model(cfg["model"]), build_model(cfg["model"])
    spec = lambda s: (s.key, s.route, s.trainable, s.module is None)
    assert [spec(s) for s in t.cond_specs] == [spec(s) for s in j.cond_specs]
    assert (t.first_stage_key, t.image_size, t.channels) == (
        j.first_stage_key, j.image_size, j.channels)


# --------------------------------------------------------------------------
# the tiny 1-cond model against the JAX package
# --------------------------------------------------------------------------

def test_model_call_and_codecs_match_jax(tiny):
    _, jldm, params, tldm = tiny
    tldm.eval()
    b = batch_of(5)
    rng = np.random.default_rng(6)
    x_t = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 50, 99, 17])

    @jax.jit
    def jax_side(params, b, x_t, t):
        cond = jldm.encode_conditioning(params, b)
        unc = jldm.null_conditioning(params, b, batch_size=B)
        return (cond, unc, jldm.apply_model(params, x_t, t, cond),
                jldm.apply_model(params, x_t, t, unc),
                jldm.encode_first_stage(params, b["image"]),
                jldm.decode_first_stage(params, x_t, force_not_quantize=True),
                jldm.make_eps_fn(params, cond, unc, 3.0)(x_t, t))

    jcond, junc, want, want_u, want_enc, want_dec, jeps = jax_side(
        params, _jb(b), jnp.asarray(x_t), jnp.asarray(t))
    with torch.no_grad():
        cond = tldm.encode_conditioning(_tb(b))
        unc = tldm.null_conditioning({"class_label": None}, batch_size=B)
        np.testing.assert_array_equal(cond["crossattn"].numpy(),
                                      np.asarray(jcond["crossattn"]))
        np.testing.assert_array_equal(unc["crossattn"].numpy(),
                                      np.asarray(junc["crossattn"]))
        _close(tldm.apply_model(torch.from_numpy(x_t), torch.from_numpy(t),
                                cond), want)
        _close(tldm.apply_model(torch.from_numpy(x_t), torch.from_numpy(t),
                                unc), want_u)
        _close(tldm.encode_first_stage(torch.from_numpy(b["image"])),
               want_enc)
        _close(tldm.decode_first_stage(torch.from_numpy(x_t),
                                       force_not_quantize=True), want_dec)
        # guidance: one batch-doubled call at scale 3
        eps = tldm.make_eps_fn(cond, unc, 3.0)(torch.from_numpy(x_t),
                                                torch.from_numpy(t))
    _close(eps, jeps)


@pytest.mark.parametrize("p_uncond", [0.0, 1.0],
                         ids=["labels-kept", "labels-dropped"])
def test_training_loss_and_gradients_match_jax(tiny, p_uncond):
    """Loss (1e-5) and every gradient leaf (1e-4 of its own maximum) of one
    batch, t and noise from the JAX loss's own draws; the label drop fixed
    by p_uncond 0 (never) and 1 (always)."""
    _, jldm, params, tldm = tiny_models(p_uncond=p_uncond, params=tiny[2])
    batch, rng = batch_of(2), jax.random.PRNGKey(5)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jldm.training_loss(p, _jb(batch), rng), has_aux=True))(
            params)
    t, noise = _jax_draws(rng)
    tldm.configure_trainable()
    tldm.zero_grad(set_to_none=True)
    loss, _ = tldm.training_loss(_tb(batch), generator=torch.Generator(),
                                 t=t, noise=noise)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-5, rtol=0)
    from dsml_thesis_tpu_torch.convert import to_jax_params

    got_l = _leaves(to_jax_params(tldm, {
        n: p.grad for n, p in tldm.named_parameters() if p.grad is not None}))
    want_l = _leaves({g: v for g, v in want_grads.items()
                      if g != "first_stage"})
    top = max(np.abs(w).max() for w in want_l.values())
    for k in set(want_l) - set(got_l):
        assert not want_l[k].any(), k
    assert sum("attn1" in k for k in got_l) >= 7 * 4
    assert any("uncond_embedding" in k for k in got_l) == (p_uncond > 0)
    for k, g in got_l.items():
        np.testing.assert_allclose(
            g, want_l[k], rtol=0, err_msg=k,
            atol=max(1e-4 * np.abs(want_l[k]).max(), 1e-6 * top))


def _jax_guided(jldm, params, label, n, scale):
    batch = {"class_label": jnp.full((n,), label, dtype=jnp.int32)}
    return jldm.make_eps_fn(params, jldm.encode_conditioning(params, batch),
                            jldm.null_conditioning(params, batch,
                                                   batch_size=n), scale)


class _NoDecode:
    """``sample_class`` with the decode taken out (the latents are held
    to the JAX chain's; the decode has its own comparison)."""

    def __init__(self, ldm, monkeypatch):
        monkeypatch.setattr(ldm, "decode_first_stage", lambda z: z)


@pytest.mark.parametrize("sampler", list(R.SAMPLERS))
def test_sample_class_matches_jax(tiny, sampler, monkeypatch):
    """Guided at scale 3 from one injected x_T: 5 DDIM / PLMS steps or 5
    DPM-Solver evaluations of order 2 (latents 1e-3)."""
    _, jldm, params, tldm = tiny
    tldm.eval()
    n, steps, scale = 3, 5, 3.0
    x_T = np.random.default_rng(9).standard_normal((n, 8, 8, 3)
                                                   ).astype(np.float32)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def jax_chain(params, x_T):
        eps = _jax_guided(jldm, params, 4, n, scale)
        if sampler == "ddim":
            from dsml_thesis_tpu.diffusion import ddim_sample as j_ddim

            return j_ddim(j_ddim_schedule(jldm.schedule, steps, eta=0.0),
                          jldm.schedule, eps, x_T.shape, key, x_T=x_T,
                          eta_noise=False)
        if sampler == "plms":
            return j_plms(j_ddim_schedule(jldm.schedule, steps, eta=0.0), eps,
                          x_T.shape, key, x_T=x_T)
        return j_dpm(jldm.schedule, eps, x_T.shape, key, steps=steps, order=2,
                     method="multistep", predict_x0=sampler == "dpm++",
                     x_T=x_T)

    want = jax_chain(params, jnp.asarray(x_T))
    _NoDecode(tldm, monkeypatch)
    got = R.sample_class(tldm, 4, n, steps=steps, scale=scale,
                         sampler=sampler, order=2, x_T=torch.from_numpy(x_T))
    # sample_class clamps what the decode returns: here the latents
    want = np.clip(np.asarray(want), -1.0, 1.0)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def _jax_cache(jldm, params, images, labels, steps, strength, bs):
    """The JAX script's ``invert`` over padded batches (reconstruct on)."""
    ddim = j_ddim_schedule(jldm.schedule, steps, eta=0.0,
                           strength=None if strength >= 1.0 else strength)

    @jax.jit
    def invert(params, x, y):
        z0 = jldm.encode_first_stage(params, x)
        cond = jldm.encode_conditioning(params, {"class_label": y})
        eps = jldm.make_eps_fn(params, cond, None, 1.0)
        x_lat = j_ddim_invert(ddim, eps, z0)
        return x_lat, j_reverse(ddim, eps, x_lat)

    lat, rec = [], []
    for s in range(0, len(images), bs):
        x, y = images[s:s + bs], labels[s:s + bs]
        n, pad = len(x), bs - len(x)
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,), y.dtype)])
        x_lat, z_rec = invert(params, jnp.asarray(x), jnp.asarray(y))
        lat.append(np.asarray(x_lat)[:n])
        rec.append(np.asarray(z_rec)[:n])
    return np.concatenate(lat), np.concatenate(rec)


def test_compute_latent_cache_matches_jax(tiny, monkeypatch):
    """5 images in batches of 2 (the last padded), 6 steps at strength 0.5:
    origin exact, latents and the reconstruction's latents 1e-3; the
    decoded reconstruction is the decode of those."""
    _, jldm, params, tldm = tiny
    tldm.eval()
    rng = np.random.default_rng(12)
    images = rng.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 3, 7, 1, 5], np.int32)
    want_lat, want_rec = _jax_cache(jldm, params, images, labels, 6, 0.5, 2)
    cache = R.compute_latent_cache(tldm, images, labels, steps=6,
                                   strength=0.5, reconstruct=True,
                                   batch_size=2)
    np.testing.assert_array_equal(cache["origin"], (images + 1) / 2)
    assert np.abs(want_lat).max() > 0.1
    np.testing.assert_allclose(cache["latents"], want_lat, atol=1e-3, rtol=0)
    assert cache["recon"].shape == images.shape
    _NoDecode(tldm, monkeypatch)
    cache = R.compute_latent_cache(tldm, images, labels, steps=6,
                                   strength=0.5, reconstruct=True,
                                   batch_size=2)
    np.testing.assert_allclose(cache["recon"], np.clip(want_rec, -1, 1),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("start,scale", [("z0", 2.0), ("x_lat", 1.0)])
def test_manipulate_matches_jax(tiny, scale, start, monkeypatch):
    """Source-conditioned inversion, target-conditioned reverse chain (8
    steps, strength 0.5), guided where the scale is not 1: latents 1e-3."""
    _, jldm, params, tldm = tiny
    tldm.eval()
    rng = np.random.default_rng(14)
    z0 = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    ddim = j_ddim_schedule(jldm.schedule, 8, eta=0.0, strength=0.5)

    def eps_for(params, label):
        if scale != 1.0:
            return _jax_guided(jldm, params, label, 3, scale)
        return jldm.make_eps_fn(params, jldm.encode_conditioning(
            params, {"class_label": jnp.full((3,), label, jnp.int32)}))

    @jax.jit
    def jax_edit(params, z0):
        x_lat = j_ddim_invert(ddim, eps_for(params, 0), z0)
        return x_lat, j_reverse(ddim, eps_for(params, 6), x_lat)

    want_lat, want = jax_edit(params, jnp.asarray(z0))
    want = np.asarray(want)
    _NoDecode(tldm, monkeypatch)
    tddim = R.inversion_schedule(tldm, 8, 0.5)
    if start == "z0":
        got, x_lat = R.manipulate(tldm, tddim, 6, src_label=0,
                                  z0=torch.from_numpy(z0), scale=scale)
        np.testing.assert_allclose(x_lat.numpy(), np.asarray(want_lat),
                                   atol=1e-3, rtol=0)
    else:
        got, _ = R.manipulate(tldm, tddim, 6, scale=scale, x_lat=torch.from_numpy(
            np.asarray(want_lat)))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.clip(want, -1, 1), atol=1e-3,
                               rtol=0)
    with pytest.raises(ValueError):
        R.manipulate(tldm, tddim, 6)


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

def _write_faces(d, specs, seed=0):
    """Image files named ``<label>_<i>.<ext>`` of the given sizes."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    paths = []
    for i, (label, w, h, ext) in enumerate(specs):
        p = os.path.join(d, f"{label}_img{i}.{ext}")
        arr = (rs.rand(h, w, 3) * 255).astype("uint8")
        img = Image.fromarray(arr)
        if ext == "png" and i % 2:
            img = img.convert("L")   # a grey file: converted to RGB
        img.save(p)
        paths.append(p)
    return paths


def _same_items(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("random_crop", [False, True])
def test_affectnet_dataset_matches_jax(tmp_path, random_crop, monkeypatch):
    monkeypatch.delenv("DSML_NATIVE_IMAGE", raising=False)
    paths = _write_faces(str(tmp_path / "img"), [
        (1, 20, 24, "jpg"), (6, 16, 16, "png"), (0, 30, 18, "png"),
        (7, 17, 40, "jpg")])
    shape_root = tmp_path / "shapes"
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        _write_faces(str(shape_root / name), [(0, 24, 20, "png")], seed=3)
        os.rename(str(shape_root / name / "0_img0.png"),
                  str(shape_root / name / "geometry_detail.png"))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    kw = dict(size=16, random_crop=random_crop, seed=4)
    for shapes in (None, str(shape_root)):
        jd = jds.AffectnetTrain(training_images_list_file=str(lst),
                                shape_root=shapes, **kw)
        td = instantiate_from_config({
            "target": "taming.data.custom.AffectnetTrain",
            "params": dict(training_images_list_file=str(lst),
                           shape_root=shapes, **kw)})
        assert isinstance(td, tds.AffectnetDataset) and len(td) == len(jd) == 4
        for epoch in (0, 1):
            jd._epoch = td._epoch = epoch
            for i in range(len(jd)):
                _same_items(td[i], jd[i])
    test = instantiate_from_config({
        "target": "taming.data.custom.AffectnetTest",
        "params": {"test_images_list_file": str(lst), "size": 16}})
    assert [int(test[i]["class_label"]) for i in range(4)] == [1, 6, 0, 7]
    np.testing.assert_array_equal(tds.load_images(paths[:2], 16),
                                  jds.load_images(paths[:2], 16))


def _write_cache(d, n=5, hw=(16, 16), seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "latents.npy"),
            rng.standard_normal((n, 8, 8, 3)).astype(np.float32))
    np.save(os.path.join(d, "origin.npy"),
            rng.uniform(0, 1, (n,) + hw + (3,)).astype(np.float32))
    np.save(os.path.join(d, "files.npy"),
            np.array([f"/data/{i % 8}_face{i}.jpg" for i in range(n)]))
    return {k: os.path.join(d, f"{k}.npy")
            for k in ("latents", "origin", "files")}


@pytest.mark.parametrize("size,hw,n_samples", [
    (None, (16, 16), None), (16, (16, 16), 3), (12, (20, 16), None)],
    ids=["no-size", "same-size", "resized"])
def test_latent_dataset_matches_jax(tmp_path, size, hw, n_samples):
    f = _write_cache(str(tmp_path), hw=hw)
    kw = dict(n_samples=n_samples, size=size, seed=2)
    jd = jds.LatentTrain(f["latents"], f["origin"], f["files"], **kw)
    td = instantiate_from_config({
        "target": "ldm.data.latents.LatentTrain",
        "params": dict(training_precomputed_latents_path=f["latents"],
                       training_origin_path=f["origin"],
                       training_files_path=f["files"], **kw)})
    assert len(td) == len(jd) == (n_samples or 5)
    for i in range(len(jd)):
        _same_items(td[i], jd[i])
    tt = instantiate_from_config({
        "target": "ldm.data.latents.LatentTest",
        "params": {"test_precomputed_latents_path": f["latents"],
                   "test_origin_path": f["origin"], "size": size}})
    assert len(tt) == 5 and "class_label" not in tt[0]


def test_latent_dataset_raises_where_it_must_resize_without_pillow(
        tmp_path, monkeypatch):
    """The JAX package skips the resize when Pillow is missing; the port
    raises, and needs no Pillow where no resize is needed."""
    f = _write_cache(str(tmp_path), hw=(16, 16))

    def no_pillow():
        raise ImportError("No module named 'PIL'")

    monkeypatch.setattr(tds, "_pil_image", no_pillow)
    same = tds.LatentDataset(f["latents"], f["origin"], size=16)
    assert same[0]["original"].shape == (16, 16, 3)
    with pytest.raises(ImportError):
        tds.LatentDataset(f["latents"], f["origin"], size=12)[0]


def test_native_image_flag_raises(tmp_path, monkeypatch):
    """``DSML_NATIVE_IMAGE=1`` where the native decoder cannot be built (no
    compiler, a fresh build directory) raises rather than decode with
    Pillow (the decoder itself: ``test_torch_port_native_image.py``)."""
    from dsml_thesis_tpu_torch import native_lib

    paths = _write_faces(str(tmp_path), [(2, 16, 16, "png")])
    monkeypatch.setenv("DSML_NATIVE_IMAGE", "1")
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="imagepipe"):
        tds.load_image(paths[0], 16)


def test_data_modules_import_no_pillow():
    """Nothing on the card's path imports Pillow when it is imported."""
    import subprocess

    code = ("import sys; import dsml_thesis_tpu_torch.data, "
            "dsml_thesis_tpu_torch.reenactment, dsml_thesis_tpu_torch.config, "
            "dsml_thesis_tpu_torch.models.diffclip, "
            "dsml_thesis_tpu_torch.training.finetune_trainer; "
            "print([m for m in sys.modules if m.split('.')[0] == 'PIL'])")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# --------------------------------------------------------------------------
# the scripts on the CPU
# --------------------------------------------------------------------------

def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def tiny_yaml(tmp_path):
    p = tmp_path / "tiny.yaml"
    cfg = tiny_cfg(p_uncond=0.2)
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


@pytest.mark.parametrize("sampler", ["ddim", "plms", "dpm++"])
def test_sample_affectnet_script(tiny_yaml, tmp_path, sampler, capsys):
    out = tmp_path / "out"
    args = ["--config", tiny_yaml, "--outdir", str(out), "--n-samples", "2",
            "--steps", "3", "--classes", "0", "5", "--sampler", sampler,
            "--cpu"]
    script("sample_affectnet_torch").main(args)
    for c in (0, 5):
        imgs = np.load(out / f"class_{c}.npy")
        assert imgs.shape == (2, 16, 16, 3) and np.isfinite(imgs).all()
        assert np.abs(imgs).max() <= 1.0
    again = tmp_path / "again"
    script("sample_affectnet_torch").main(
        [a if a != str(out) else str(again) for a in args])
    np.testing.assert_array_equal(np.load(out / "class_5.npy"),
                                  np.load(again / "class_5.npy"))
    assert "class 5: saved (2, 16, 16, 3)" in capsys.readouterr().out


def test_scripts_want_the_card_unless_told_otherwise(tiny_yaml, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(SystemExit, match="no CUDA device"):
        script("sample_affectnet_torch").main(
            ["--config", tiny_yaml, "--outdir", str(tmp_path)])


def test_compute_latents_and_manipulation_scripts(tiny_yaml, tmp_path):
    """compute_latents_torch writes a cache LatentDataset reads, equal to
    the library call on the same images; latent_manipulation_torch edits
    from images and from that cache."""
    paths = _write_faces(str(tmp_path / "img"), [
        (1, 16, 16, "png"), (4, 20, 18, "jpg"), (0, 16, 16, "png")])
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths))
    cache_dir = tmp_path / "cache"
    script("compute_latents_torch").main(
        ["--config", tiny_yaml, "--list", str(lst), "--outdir",
         str(cache_dir), "--steps", "4", "--strength", "0.5", "--batch", "2",
         "--size", "16", "--reconstruct", "--cpu"])
    for k in ("origin", "latents", "recon", "files"):
        assert (cache_dir / f"{k}.npy").exists(), k
    cfg = load_config([tiny_yaml])
    torch.manual_seed(0)
    ldm = build_model(cfg["model"]).eval()
    images = tds.load_images(paths, 16)
    want = R.compute_latent_cache(ldm, images, np.array([1, 4, 0]), steps=4,
                                  strength=0.5, reconstruct=True,
                                  batch_size=2)
    for k in ("origin", "latents", "recon"):
        np.testing.assert_allclose(np.load(cache_dir / f"{k}.npy"), want[k],
                                   atol=1e-6, rtol=0)
    ds = tds.LatentDataset(str(cache_dir / "latents.npy"),
                           str(cache_dir / "origin.npy"),
                           str(cache_dir / "files.npy"), size=16)
    assert [int(ds[i]["class_label"]) for i in range(3)] == [1, 4, 0]

    out = tmp_path / "edit"
    manip = script("latent_manipulation_torch")
    manip.main(["--config", tiny_yaml, "--images", *paths, "--src-class", "0",
                "--targets", "1", "6", "--steps", "4", "--strength", "0.5",
                "--scale", "2.0", "--outdir", str(out), "--size", "16",
                "--cpu"])
    for t in (1, 6):
        e = np.load(out / f"edited_to_{t}.npy")
        assert e.shape == (3, 16, 16, 3) and np.isfinite(e).all()
    manip.main(["--config", tiny_yaml, "--from-latents",
                str(cache_dir / "latents.npy"), "--src-class", "0",
                "--targets", "2", "--steps", "4", "--strength", "0.5",
                "--outdir", str(out), "--cpu"])
    assert np.load(out / "edited_to_2.npy").shape == (3, 16, 16, 3)


def test_train_script_trains_the_one_cond_model(tiny_yaml, tmp_path):
    spec = {"image": [[16, 16, 3], "float32"], "class_label": [[], "int32"]}
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"spec": spec, "length": 8}}
    import json

    trainer = script("train_torch").main(
        ["--base", tiny_yaml, "-t", "--max-steps", "2", "--cpu", "--logdir",
         str(tmp_path), "--seed", "0", "--no-test", "--log-every", "1",
         f"data.params.train={json.dumps(node)}",
         f"data.params.validation={json.dumps(node)}"])
    assert type(trainer).__name__ == "Trainer" and trainer._state.step == 2
    lines = open(os.path.join(trainer.logdir, "metrics.jsonl")).read()
    assert "val_loss_ema" in lines


# --------------------------------------------------------------------------
# chip_smoke.py's arithmetic of the AffectNet runs
# --------------------------------------------------------------------------

def test_expected_launches_of_the_affectnet_runs(tiny, monkeypatch):
    """The counts ``expected_launches`` / ``expected_train_launches`` /
    ``expected_edit_launches`` take from a model's own blocks against spies
    on the wrappers: one guided UNet call and a decode, one training step,
    and the finetune's chain and decode under autograd; and the real YAML's
    16 fused-projection launches a UNet call, 4 split-head ones a decode."""
    import chip_smoke
    from test_torch_port_mead128 import _wrapper_spy

    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    _, _, _, tldm = tiny
    calls = _wrapper_spy(monkeypatch)
    tldm.eval()
    with torch.no_grad():
        R.sample_class(tldm, 2, 2, steps=3, scale=3.0,
                       x_T=torch.zeros(2, 8, 8, 3))
    # 3 uniform steps over T = 100 are 4 (range(0, 100, 33)); 50 over 1000
    # are 50
    steps = R.make_ddim_schedule(tldm.schedule, 3).num_steps
    assert steps == 4
    expect = chip_smoke.expected_launches(tldm, {}, unet_calls=steps,
                                          encodes=0, decodes=1)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    for k in calls:
        calls[k] = 0
    tldm.configure_trainable()
    loss, _ = tldm.training_loss(_tb(batch_of(1)), generator=torch.Generator())
    loss.backward()
    _, per_step = chip_smoke.expected_train_launches(tldm, {}, 1, 0)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in per_step.items() if v}
    real = _meta(YAML)
    assert chip_smoke.count_attentions(real.unet, real.image_size) == (16, 0)
    one = chip_smoke.expected_launches(real, {}, unet_calls=50, encodes=0,
                                       decodes=1)
    assert one["flash_attention_fproj"] == 800
    assert one["flash_attention"] == 4
