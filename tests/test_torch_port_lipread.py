"""The lip-reading finetune of the talking-face model (``ddpm2condtune``)
against the JAX package, on the CPU in fp32.

* ``LipreaderFrontend`` (the Conv3dResNet frontend, ResNet-18 at full
  width) with random weights and statistics from one JAX variables tree
  (``convert.from_jax_variables``): the video form and the frame form, 1e-5
  of the output's maximum; ``convert_lipreader`` against the JAX converter
  and ``reference_state_dict`` round trips under each prefix
  ``detect_frontend_prefix`` finds; the vendored torch oracle
  (``tests/lipreader_torch.py``) through the converter.
* ``cut_mouth`` (centroid, round half to even, clamped corners, gray
  weights), ``resize_bilinear`` (64 -> 88 and odd sizes, edges) and
  ``prep_mouths`` against the JAX functions, values and gradients.
* ``LipreadFinetune.training_loss`` on the tiny tune YAML of
  ``tests/test_finetune_cli.py`` (4-cond talking-face model, VQ first stage)
  with the JAX side's own draws injected (t, the ``q_sample`` noise, the
  chain's per-step noise; the label drop fixed by ``p_uncond`` 0 or 1): the
  loss terms to 1e-5 and every UNet and cond-stage gradient leaf to 1e-4 of
  its maximum against ``jax.grad`` of the JAX ``training_loss``, at
  ``decode_steps`` 2 and 8 with the lipreader, and L2 only without it.
* the warm-up gate (``start_lr_loss``), the ``KeyError`` without
  landmarks, the eta = 1.0 DDIM schedule, ``build_finetune`` of the real
  ``mead-128-ldm-f4-tune.yaml`` (meta device), and
  ``chip_smoke.expected_tune_launches`` against spies on the kernel
  wrappers in one CPU step.
"""
from __future__ import annotations

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.models import lipread_tune as jlt
from dsml_thesis_tpu.models import lipreader as jlr
from dsml_thesis_tpu_torch.config import build_finetune, build_model
from dsml_thesis_tpu_torch.convert import (from_jax_params,
                                           from_jax_variables, to_jax_params)
from dsml_thesis_tpu_torch.models import lipread_tune as tlt
from dsml_thesis_tpu_torch.models import lipreader as tlr
from test_finetune_cli import TUNE_CFG
from test_torch_port_pipeline import random_params
from test_torch_port_training import _leaves
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE_YAML = os.path.join(ROOT, "configs", "latent-diffusion",
                         "mead-128-ldm-f4-tune.yaml")
B = 2
MOUTH = dict(mouth_crop=12, mouth_center_crop=10, mouth_size=24)


def _rel_close(got, want, rel=1e-5, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


# --------------------------------------------------------------------------
# the lipreader's frontend
# --------------------------------------------------------------------------

def _random_stats(tree, rng):
    """Running statistics of a JAX batch_stats tree: means about 0, variances
    about 1, all positive."""
    return {k: (_random_stats(v, rng) if isinstance(v, dict) else jnp.asarray(
        (0.1 * rng.standard_normal(v.shape) if k == "mean"
         else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)))
        for k, v in tree.items()}


@pytest.fixture(scope="module", params=["swish", "relu"])
def frontends(request):
    relu = request.param
    jm = jlr.LipreaderFrontend(relu_type=relu)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 24, 24, 1)))
    rng = np.random.default_rng(3)
    variables = {"params": random_params(v["params"], rng),
                 "batch_stats": _random_stats(v["batch_stats"], rng)}
    tm = tlr.LipreaderFrontend(relu)
    tm.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return relu, jm, variables, tm.eval()


def test_frontend_video_matches_jax(frontends):
    """The temporal form: [B, T = 5, 28, 28, 1] -> [B, 5, 512]."""
    relu, jm, variables, tm = frontends
    x = np.random.default_rng(4).standard_normal(
        (2, 5, 28, 28, 1)).astype(np.float32)
    want = jax.jit(jlr.make_lipreader_video_apply(relu))(variables,
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = tlr.make_lipreader_video_apply(tm)(torch.from_numpy(x))
    assert got.shape == (2, 5, 512)
    _rel_close(got.numpy(), want)


def test_frame_features_match_jax(frontends):
    """The finetune's frame form: mouths [B, 24, 24, 1] -> [B, 512], each a
    sequence of one frame."""
    relu, _, variables, tm = frontends
    x = np.random.default_rng(5).standard_normal(
        (3, 24, 24, 1)).astype(np.float32)
    want = jax.jit(jlr.make_lipreader_apply(relu))(variables, jnp.asarray(x))
    feats = tlr.make_lipreader_apply(tm)
    assert not feats.training
    assert not any(p.requires_grad for p in feats.parameters())
    with torch.no_grad():
        got = feats(torch.from_numpy(x))
    assert got.shape == (3, 512)
    _rel_close(got.numpy(), want)


def _oracle_sd(relu="swish", seed=0):
    """The vendored torch Conv3dResNet's state dict with random statistics."""
    from lipreader_torch import Conv3dResNet

    torch.manual_seed(seed)
    tm = Conv3dResNet(relu).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1, 0.1)
                m.bias.normal_(0, 0.1)
    return tm, tm.state_dict()


@pytest.mark.parametrize("prefix", ["", "encoder.frontend.",
                                    "module.encoder.frontend."])
def test_converter_and_reference_state_dict_round_trip(prefix):
    """Each prefix: detected, converted as the JAX converter converts it
    (through ``from_jax_variables``), and written back by
    ``reference_state_dict`` key for key and bit for bit."""
    _, sd = _oracle_sd(seed=1)
    sd = {f"{prefix}{k}": v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    assert tlr.detect_frontend_prefix(sd) == prefix \
        == jlr.detect_frontend_prefix(sd)
    got = tlr.convert_lipreader(sd)
    jp, js = jlr.convert_lipreader(sd)
    want = from_jax_variables({"params": jp, "batch_stats": js})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tm = tlr.LipreaderFrontend()
    tm.load_state_dict(got, strict=True)
    back = tlr.reference_state_dict(tm, prefix=prefix)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    with pytest.raises(ValueError):
        tlr.detect_frontend_prefix({"x.weight": torch.zeros(1)})


def test_checkpoint_loads_as_the_oracle_computes(tmp_path):
    """``load_lipreader_checkpoint`` of an LRS3-layout file (a dict holding
    ``model_state_dict``) against the vendored torch Conv3dResNet."""
    oracle, sd = _oracle_sd("relu", seed=2)
    path = str(tmp_path / "model.pth")
    torch.save({"model_state_dict": {f"encoder.frontend.{k}": v
                                     for k, v in sd.items()}}, path)
    tm = tlr.load_lipreader_checkpoint(path, "relu")
    assert not tm.training and not any(p.requires_grad
                                       for p in tm.parameters())
    x = torch.randn(2, 3, 28, 28, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = oracle(x)
        got = tm(x[..., None])
    _rel_close(got.numpy(), want.numpy())


def test_prelu_is_refused_on_both_sides():
    with pytest.raises(ValueError):
        tlr.LipreaderFrontend("prelu")
    with pytest.raises(ValueError):
        jlr._act("prelu")


# --------------------------------------------------------------------------
# the mouth crop and the resize
# --------------------------------------------------------------------------

def _landmarks(centers, rng):
    """[B, 68, 2] landmarks whose mouth (48-68) has the given centroids."""
    lm = rng.uniform(0, 16, (len(centers), 68, 2)).astype(np.float32)
    mouth = rng.uniform(-2, 2, (len(centers), 20, 2)).astype(np.float32)
    mouth -= mouth.mean(axis=1, keepdims=True)
    lm[:, 48:68] = mouth + np.asarray(centers, np.float32)[:, None, :]
    return lm


CUT_CASES = {
    # (image size, crop, centroids (x, y))
    "inside": (24, 8, [(11.2, 12.7), (13.0, 9.4)]),
    "clamped-low": (24, 8, [(-3.0, 1.2), (2.0, 30.0)]),
    "clamped-high": (24, 8, [(40.0, 23.9), (22.6, -1.0)]),
    "tie-half-to-even": (24, 8, [(10.5, 11.5), (12.5, 13.5)]),
    "odd-crop-at-edge": (20, 7, [(19.0, 0.0), (3.5, 17.5)]),
}


@pytest.mark.parametrize("case", sorted(CUT_CASES))
def test_cut_mouth_matches_jax(case):
    """Values exactly and the gradient of a weighted sum (1e-6) against JAX:
    clamped corners, half-way centroids (half to even on both sides), an odd
    crop whose corner the slice keeps inside the image."""
    size, crop, centers = CUT_CASES[case]
    rng = np.random.default_rng(7)
    lm = _landmarks(centers, rng)
    if case == "tie-half-to-even":   # the centroid sits exactly on .5
        lm[:, 48:68] = np.asarray(centers, np.float32)[:, None, :]
    img = rng.uniform(-1, 1, (len(centers), size, size, 3)).astype(np.float32)
    w = rng.standard_normal((len(centers), crop, crop, 1)).astype(np.float32)
    fn = lambda x: jnp.sum(jlt.cut_mouth(x, jnp.asarray(lm), crop=crop) * w)
    want = jlt.cut_mouth(jnp.asarray(img), jnp.asarray(lm), crop=crop)
    want_g = jax.grad(fn)(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    got = tlt.cut_mouth(x, torch.from_numpy(lm), crop=crop)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (len(centers), crop, crop, 1)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-6,
                               rtol=0)
    color = tlt.cut_mouth(torch.from_numpy(img), torch.from_numpy(lm),
                          crop=crop, grayscale=False)
    np.testing.assert_array_equal(color.numpy(), np.asarray(jlt.cut_mouth(
        jnp.asarray(img), jnp.asarray(lm), crop=crop, grayscale=False)))


@pytest.mark.parametrize("src,dst", [(64, 88), (10, 24), (7, 13), (5, 5)])
def test_resize_bilinear_matches_jax(src, dst):
    """Upsampling (and the identity) against ``jax.image.resize`` bilinear,
    the edge rows and columns included; values and gradient 1e-5 of their
    maximum (both sides place the sample points in fp32)."""
    rng = np.random.default_rng(src)
    x = rng.standard_normal((2, src, src, 1)).astype(np.float32)
    w = rng.standard_normal((2, dst, dst, 1)).astype(np.float32)
    want = jlt.resize_bilinear(jnp.asarray(x), dst)
    want_g = jax.grad(lambda v: jnp.sum(jlt.resize_bilinear(v, dst) * w))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = tlt.resize_bilinear(t, dst)
    (got * torch.from_numpy(w)).sum().backward()
    _rel_close(got.detach().numpy(), want)
    _rel_close(t.grad.numpy(), want_g)


def test_prep_mouths_matches_jax(tiny):
    """Crop 12, center crop 10, normalization, resize to 24; and the
    reference geometry (72 -> 64 -> 88) on 128 px frames."""
    cfg, jldm, _, tldm = tiny
    rng = np.random.default_rng(8)
    for size, geometry in ((16, MOUTH), (128, {})):
        img = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        lm = _landmarks([(size * 0.5, size * 0.6), (size * 0.4, size * 0.7)],
                        rng)
        jft = jlt.LipreadFinetune(jldm, **geometry)
        tft = tlt.LipreadFinetune(tldm, **geometry)
        want = jft._prep_mouths(jnp.asarray(img), jnp.asarray(lm))
        got = tft.prep_mouths(torch.from_numpy(img), torch.from_numpy(lm))
        assert got.shape == want.shape == (
            2, geometry.get("mouth_size", 88), geometry.get("mouth_size", 88),
            1)
        _rel_close(got.numpy(), want)


# --------------------------------------------------------------------------
# the finetune loss on the tiny tune YAML
# --------------------------------------------------------------------------

def tune_cfg(p_uncond=0.2, **over):
    """The tiny tune YAML of tests/test_finetune_cli.py (a 4-cond
    talking-face model at 16 px, VQ-f2 first stage), data left out."""
    cfg = yaml.safe_load(TUNE_CFG.format(tuples="t", root="r", audio="a"))
    p = cfg["model"]["params"]
    p["cond_stage_config_1"]["params"]["p_uncond"] = p_uncond
    p.update(MOUTH, **over)
    return cfg


def tune_batch(seed, landmarks=True):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    out = {"image": img(), "masked_image": img(), "identity": img(),
           "class_label": rng.integers(0, 8, (B,)).astype(np.int32),
           "audio": rng.standard_normal((B, 5, 32)).astype(np.float32)}
    if landmarks:
        out["landmarks"] = _landmarks([(8.3, 9.6), (6.5, 10.5)], rng)
    return out


def _models(p_uncond):
    cfg = tune_cfg(p_uncond)
    jldm = jax_build_model(cfg["model"])
    init = {k: jnp.asarray(v) for k, v in tune_batch(0).items()}
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), init)
    params = random_params(params, np.random.default_rng(1))
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    return cfg, jldm, params, tldm


@pytest.fixture(scope="module")
def tiny():
    return _models(0.0)


@pytest.fixture(scope="module")
def reader():
    """The lipreader on both sides from one random variables tree."""
    jm = jlr.LipreaderFrontend()
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 1, 24, 24, 1)))
    rng = np.random.default_rng(9)
    variables = {"params": random_params(v["params"], rng),
                 "batch_stats": _random_stats(v["batch_stats"], rng)}
    tm = tlr.LipreaderFrontend()
    tm.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return variables, tm


def _jax_draws(rng, b, z_shape, steps, timesteps):
    """t, the q_sample noise and the chain's per-step noise exactly as the
    JAX ``training_loss`` draws them from ``rng``."""
    k_t, k_noise, _, k_dec = jax.random.split(rng, 4)
    t = jax.random.randint(k_t, (b,), 0, timesteps)
    noise = jax.random.normal(k_noise, z_shape, dtype=jnp.float32)
    seq = jnp.stack([jax.random.normal(jax.random.fold_in(k_dec, i), z_shape,
                                       dtype=jnp.float32)
                     for i in range(steps)])
    return {"t": torch.from_numpy(np.array(t)).long(),
            "noise": torch.from_numpy(np.array(noise)),
            "noise_seq": torch.from_numpy(np.array(seq))}


LOSS_CASES = {
    # (decode_steps, p_uncond, with the lipreader)
    "ddim2-labels-kept": (2, 0.0, True),
    "ddim8-labels-dropped": (8, 1.0, True),
    "ddim2-l2-only": (2, 0.0, False),
}


@pytest.fixture(scope="module", params=sorted(LOSS_CASES))
def loss_case(request, tiny, reader):
    steps, p_uncond, with_reader = LOSS_CASES[request.param]
    cfg, jldm, params, tldm = tiny if p_uncond == 0.0 else _models(p_uncond)
    variables, tm = reader
    jft = jlt.LipreadFinetune(
        jldm, lipreader_fn=jlr.make_lipreader_apply() if with_reader else None,
        decode_steps=steps, **MOUTH)
    batch = tune_batch(11)
    rng = jax.random.PRNGKey(4)
    full = dict(params, **({"frozen/guidance": {"lipreader": variables}}
                           if with_reader else {}))
    (want, want_aux), want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jft.training_loss(p, b, rng, global_step=0),
        has_aux=True))(full, {k: jnp.asarray(v) for k, v in batch.items()})
    tldm = copy.deepcopy(tldm)
    tcfg = copy.deepcopy(cfg["model"])
    tcfg["params"]["decode_steps"] = steps
    tft = build_finetune(tcfg, ldm=tldm, lipreader_fn=(
        tlr.make_lipreader_apply(copy.deepcopy(tm)) if with_reader else None))
    tldm.configure_trainable()
    # the uniform sub-schedule of T = 50 in 8 steps has 9 (50 // 8 = 6 apart)
    assert tft.ddim.num_steps == jft.ddim.num_steps
    draws = _jax_draws(rng, B, (B, 8, 8, 3), tft.ddim.num_steps,
                       tldm.schedule.num_timesteps)
    loss, aux = tft.training_loss({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, **draws)
    loss.backward()
    return dict(want=want, want_aux=want_aux, want_grads=want_grads,
                loss=loss, aux=aux, tldm=tldm, tft=tft,
                with_reader=with_reader)


def test_tune_loss_terms_match_jax(loss_case):
    c = loss_case
    want_keys = {"loss", "l2_loss"} | ({"lr_loss"} if c["with_reader"]
                                       else set())
    assert set(c["aux"]) == set(c["want_aux"]) == want_keys
    for k in want_keys:
        np.testing.assert_allclose(
            float(c["aux"][k].detach()), float(c["want_aux"][k]), rtol=0,
            atol=1e-5 * max(1.0, abs(float(c["want_aux"][k]))), err_msg=k)
    if c["with_reader"]:
        assert 0 < float(c["aux"]["lr_loss"].detach()) < 2


def test_tune_gradients_match_jax(loss_case):
    """Every gradient leaf of the UNet and the trainable cond stages; none
    reaches the first stage or the lipreader."""
    c = loss_case
    tldm = c["tldm"]
    grads = {n: p.grad for n, p in tldm.named_parameters()
             if p.grad is not None}
    assert grads and not any(n.startswith("first_stage") for n in grads)
    assert any(n.startswith("cond.") for n in grads)
    if c["with_reader"]:
        assert all(p.grad is None for p in c["tft"].lipreader.parameters())
    got_l = _leaves(to_jax_params(tldm, grads))
    want_l = _leaves({g: v for g, v in c["want_grads"].items()
                      if g == "unet" or g.startswith("cond/")})
    assert set(got_l) <= set(want_l) and len(got_l) > 50
    for k in set(want_l) - set(got_l):
        assert not want_l[k].any(), k
    top = max(np.abs(w).max() for w in want_l.values())
    for k, g in got_l.items():
        w = want_l[k]
        np.testing.assert_allclose(g, w, rtol=0, err_msg=k,
                                   atol=max(1e-4 * np.abs(w).max(),
                                            1e-6 * top))


def test_warm_up_gate_and_validation_form(tiny, reader):
    """Before ``start_lr_loss`` the loss is the L2 term (lr_loss still
    reported), from it on L2 + weight * lr_loss; the validation form draws
    no label drop."""
    cfg, _, _, tldm = tiny
    tcfg = copy.deepcopy(cfg["model"])
    tcfg["params"].update(start_lr_loss=3, lr_loss_w=0.5, decode_steps=2)
    tft = build_finetune(tcfg, ldm=copy.deepcopy(tldm),
                         lipreader_fn=tlr.make_lipreader_apply(
                             copy.deepcopy(reader[1])))
    assert (tft.start_lr_loss, tft.lr_loss_weight) == (3, 0.5)
    batch = {k: torch.from_numpy(v) for k, v in tune_batch(12).items()}
    out = {}
    for step in (2, 3):
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            _, out[step] = tft.training_loss(batch, g, global_step=step)
    assert float(out[2]["loss"]) == float(out[2]["l2_loss"])
    np.testing.assert_allclose(
        float(out[3]["loss"]),
        float(out[3]["l2_loss"]) + 0.5 * float(out[3]["lr_loss"]), rtol=1e-6)
    assert float(out[2]["lr_loss"]) == float(out[3]["lr_loss"]) > 0


def test_missing_landmarks_raise_keyerror(tiny, reader):
    cfg, _, _, tldm = tiny
    tft = build_finetune(cfg["model"], ldm=copy.deepcopy(tldm),
                         lipreader_fn=tlr.make_lipreader_apply(
                             copy.deepcopy(reader[1])))
    batch = {k: torch.from_numpy(v)
             for k, v in tune_batch(13, landmarks=False).items()}
    with pytest.raises(KeyError):
        tft.training_loss(batch, torch.Generator().manual_seed(0))
    # without a lipreader the landmarks are not needed (the JAX semantics)
    l2 = build_finetune(cfg["model"], ldm=copy.deepcopy(tldm))
    assert l2.lipreader is None
    _, aux = l2.training_loss(batch, torch.Generator().manual_seed(0))
    assert set(aux) == {"loss", "l2_loss"}


def test_ddim_schedule_is_eta_one(tiny):
    """The chain's schedule against the JAX finetune's (timesteps, alphas,
    sigmas) at 8 steps: eta = 1.0, every step adds noise. The tiny model's
    T = 50 cut every 50 // 8 = 6 steps gives 9 positions."""
    cfg, jldm, _, tldm = tiny
    jft = jlt.LipreadFinetune(jldm)
    tft = build_finetune(cfg["model"], ldm=tldm)
    assert tft.ddim.num_steps == jft.ddim.num_steps == 9
    for name in ("timesteps", "alphas", "alphas_prev", "sigmas"):
        np.testing.assert_allclose(getattr(tft.ddim, name).numpy(),
                                   np.asarray(getattr(jft.ddim, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert (tft.ddim.sigmas > 0).all()


def test_real_tune_yaml_builds_on_the_meta_device(tmp_path):
    """``build_finetune`` of ``mead-128-ldm-f4-tune.yaml`` (meta device): the
    LDM target, the reference's geometry and chain, the monitor, the
    lipreader from ``lipread_ckpt`` outside the LDM's trainable
    parameters."""
    cfg = yaml.safe_load(open(TUNE_YAML))
    path = str(tmp_path / "model.pth")
    torch.save(tlr.reference_state_dict(tlr.LipreaderFrontend()), path)
    cfg["model"]["params"]["lipread_ckpt"] = path
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    ft = build_finetune(cfg["model"], ldm=ldm)
    assert isinstance(ft, tlt.LipreadFinetune)
    assert ldm.monitor == "val_loss_ema"
    assert ft.ddim.num_steps == 8
    assert (ft.decode_steps, ft.mouth_crop, ft.mouth_center_crop,
            ft.mouth_size, ft.lr_loss_weight, ft.start_lr_loss) == (
        8, 72, 64, 88, 1.0, 0)
    assert isinstance(ft.lipreader, tlr.LipreaderFeatures)
    trainable = {id(p) for _, _, p in ldm.named_trainable_parameters()}
    assert not any(id(p) in trainable for p in ft.lipreader.parameters())
    assert {g for g, _, _ in ldm.named_trainable_parameters()} == {
        "unet", "cond/class_label", "cond/audio"}


def test_expected_tune_launches_against_the_wrappers(tiny, reader,
                                                     monkeypatch):
    """One tune step on the tiny model (a chain of 9): the fused-projection
    op at every self-attention of every chain call (all through its autograd
    ``Function``), the split-head forward at each attention block of the
    three encodes and the two decodes, its backward at the prediction
    decode's, as chip_smoke counts them from the model's blocks."""
    import chip_smoke
    from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
    from test_torch_port_mead128 import _wrapper_spy

    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    cfg, _, _, tldm = tiny
    tldm = copy.deepcopy(tldm)
    ft = build_finetune(cfg["model"], ldm=tldm, lipreader_fn=(
        tlr.make_lipreader_apply(copy.deepcopy(reader[1]))))
    tldm.configure_trainable()
    calls = _wrapper_spy(monkeypatch)
    loss, _ = ft.training_loss(
        {k: torch.from_numpy(v) for k, v in tune_batch(14).items()},
        torch.Generator().manual_seed(0))
    loss.backward()
    expect, through_function = chip_smoke.expected_tune_launches(
        tldm, ft.ddim.num_steps, 1, 0)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    assert expect["flash_attention_bwd"] == chip_smoke.count_attn_blocks(
        tldm.first_stage.decoder) > 0
    assert through_function == calls["flash_attention_fproj"] > 0
