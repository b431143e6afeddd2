"""The DiffusionCLIP emotion-editing finetune of the port against the JAX
package, on the CPU in fp32.

* The loss of ``DiffusionCLIPFinetune`` (l2, identity and CLIP-direction
  terms; the reverse chain of the training schedule under the edit's target
  in the model's evaluation form, the decode unclamped) and every gradient
  leaf of the LDM against ``jax.grad`` of the JAX ``training_loss``, with
  injected towers: a tiny CLIP (2 layers of width 64, 32 px) and IR-SE50 at
  full depth (pooled to 112 px); loss and each gradient leaf 1e-4 (of the
  leaf's maximum); both the source-indexed direction table (``edit_attr``)
  and the per-target one.
* ``build_finetune`` from checkpoint paths in the config (a tiny CLIP in the
  OpenAI layout, IR-SE50 in the reference layout, a synthetic BPE table):
  the text-direction table and the loss against the JAX package's
  ``build_finetune`` of the same files (1e-4); the refusals of the
  classifier loss, and the lip-reading target now building its wrapper.
* ``scripts/train_torch.py --cpu`` on a tiny finetune config over a latent
  cache: ``FinetuneTrainer``, two steps, the towers and the first stage as
  loaded, the optimizer and the EMA over the UNet only, the edited grids of
  ``log_images``; and ``chip_smoke.expected_edit_launches`` against spies on
  the wrappers in one CPU step.
"""
from __future__ import annotations

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_finetune as jax_build_finetune
from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.models import clip as jclip
from dsml_thesis_tpu.models import insight_face as jif
from dsml_thesis_tpu_torch import reenactment as R
from dsml_thesis_tpu_torch.config import build_finetune, build_model
from dsml_thesis_tpu_torch.convert import (from_jax_params, from_jax_tree,
                                           to_jax_params)
from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
from dsml_thesis_tpu_torch.models import clip as tclip
from dsml_thesis_tpu_torch.models import insight_face as tif
from test_torch_port_affectnet import TINY_AFFECTNET, script
from test_torch_port_clip import MERGES, TINY, _reference_sd
from test_torch_port_pipeline import random_params
from test_torch_port_training import _leaves
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

B = 2


def finetune_cfg(**over):
    cfg = yaml.safe_load(TINY_AFFECTNET)
    cfg["model"]["target"] = \
        "ldm.models.diffusion.latent_diffclip.LatentDiffusionCLIP"
    p = cfg["model"]["params"]
    p.update(first_stage_key="latent", cond_stage_trainable=False,
             monitor="val_loss", edit_attr="happy", strength=0.5,
             num_train_steps=3, cls_loss_w=0.0, clip_loss_w=1.0,
             id_loss_w=1.0, l2_loss_w=1.0)
    p.update(over)
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"latent": rng.standard_normal((B, 8, 8, 3)).astype(np.float32),
            "original": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
            "class_label": np.array([2, 6], np.int32)}


@pytest.fixture(scope="module")
def towers():
    """A tiny CLIP and IR-SE50 on both sides from one set of weights."""
    rng = np.random.default_rng(0)
    jcfg = jclip.CLIPConfig(**TINY)
    images = jnp.zeros((1, 32, 32, 3))
    tokens = jnp.ones((1, 16), jnp.int32)
    cparams = random_params(jclip.CLIP(jcfg).init(
        jax.random.PRNGKey(0), images, tokens)["params"], rng)
    clip = tclip.CLIP(tclip.CLIPConfig(**TINY))
    clip.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, cparams)),
                         strict=True)
    sd = _reference_sd(True, seed=2)
    iparams, istats = jif.convert_irse(sd)
    irse = tif.IRSE()
    irse.load_state_dict(tif.convert_irse(sd), strict=True)
    table = rng.standard_normal((8, TINY["embed_dim"])).astype(np.float32)
    return {"jcfg": jcfg, "cparams": cparams, "clip": clip, "iparams": iparams,
            "istats": istats, "irse": irse, "table": table, "sd": sd}


@pytest.fixture(scope="module")
def tiny_ft():
    cfg = finetune_cfg()
    jldm = jax_build_model(cfg["model"])
    init = {"latent": jnp.zeros((B, 8, 8, 3)),
            "class_label": jnp.zeros((B,), jnp.int32)}
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), init)
    params = random_params(params, np.random.default_rng(1))
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    return cfg, jldm, params, tldm


def _jax_towers(t):
    return dict(
        clip_image_embed=jclip.make_clip_image_embed(t["jcfg"],
                                                     t["cparams"]["visual"]),
        arcface_embed=jif.make_id_embed_fn(t["iparams"], t["istats"]))


def _torch_towers(t):
    return dict(
        clip_image_embed=tclip.make_clip_image_embed(
            t["clip"].cfg, t["clip"].visual.state_dict()),
        arcface_embed=tif.make_id_embed(copy.deepcopy(t["irse"])))


def test_loss_and_gradients_match_jax(tiny_ft, towers):
    """jax.grad of the JAX finetune's loss against the port's backward: the
    chain of 3 steps at strength 0.5 through the eval-mode UNet, the
    unclamped decode and the three guidance terms, the direction table
    indexed by the source class (``edit_attr``; the per-target table is
    held by ``test_build_finetune_from_files_matches_jax``)."""
    cfg, jldm, params, tldm = tiny_ft
    model_cfg = copy.deepcopy(cfg["model"])
    table = towers["table"]
    by_source = True
    jft = jax_build_finetune(model_cfg, ldm=jldm, **_jax_towers(towers),
                             text_direction=jnp.asarray(table),
                             direction_by_source=by_source)
    tldm = copy.deepcopy(tldm)
    tft = build_finetune(model_cfg, ldm=tldm, **_torch_towers(towers),
                         text_direction=torch.from_numpy(table),
                         direction_by_source=by_source)
    assert (tft.edit_attr_label, tft.train_steps) == (jft.edit_attr_label, 3)
    np.testing.assert_array_equal(tft.train_ddim.timesteps.numpy(),
                                  np.asarray(jft.train_ddim.timesteps))
    batch = _batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the batch as an argument: closed over, XLA would fold the source
    # images' tower passes into the compile
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jft.training_loss(p, b, jax.random.PRNGKey(0)),
        has_aux=True))(params, jb)

    tldm.configure_trainable()
    tldm.train()    # the chain must still run the model's evaluation form
    loss, aux = tft.training_loss({k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    assert not tldm.unet.training
    loss.backward()
    assert set(aux) == set(want_aux) == {"loss", "loss_l2", "loss_id",
                                         "loss_clip"}
    for k in want_aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(want_aux[k]),
                                   atol=1e-4 * max(1.0, abs(float(want_aux[k]))),
                                   rtol=0, err_msg=k)
    grads = {n: p.grad for n, p in tldm.named_parameters()
             if p.grad is not None}
    assert grads and all(n.startswith("unet.") for n in grads)
    got_l = _leaves(to_jax_params(tldm, grads))
    want_l = _leaves({"unet": want_grads["unet"]})
    assert set(got_l) <= set(want_l) and len(got_l) > 100
    for k in set(want_l) - set(got_l):
        assert not want_l[k].any(), k
    # the training tests' standard: 1e-4 of each leaf's maximum, and a leaf
    # of rounding noise (a bias ahead of a GroupNorm of one channel a group,
    # which the norm removes) held to 1e-6 of the tree's largest
    top = max(np.abs(w).max() for w in want_l.values())
    for k, g in got_l.items():
        w = want_l[k]
        np.testing.assert_allclose(g, w, rtol=0, err_msg=k,
                                   atol=max(1e-4 * np.abs(w).max(),
                                            1e-6 * top))
    for tower in (tft.clip_image_embed, tft.arcface_embed):
        assert all(p.grad is None for p in tower.parameters())


def _guidance_files(towers, d):
    os.makedirs(d, exist_ok=True)
    paths = {"clip_ckpt": os.path.join(d, "clip.pt"),
             "id_ckpt": os.path.join(d, "irse.pth"),
             "clip_bpe": os.path.join(d, "bpe.txt")}
    torch.save(tclip.openai_state_dict(towers["clip"]), paths["clip_ckpt"])
    torch.save(towers["sd"], paths["id_ckpt"])
    with open(paths["clip_bpe"], "w") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return paths


@pytest.mark.parametrize("edit_attr", ["happy", "fear", None])
def test_build_finetune_from_files_matches_jax(tiny_ft, towers, tmp_path,
                                               edit_attr):
    """The towers and text directions the config's paths build: the
    direction table (1e-4) and the direction mode; the loss (1e-4) with the
    source-indexed table (``happy``) and the per-target one (no
    ``edit_attr``)."""
    cfg, jldm, params, tldm = tiny_ft
    model_cfg = copy.deepcopy(cfg["model"])
    p = model_cfg["params"]
    p.update(_guidance_files(towers, str(tmp_path)))
    if edit_attr is None:
        p.pop("edit_attr")
    else:
        p["edit_attr"] = edit_attr
    # the OpenAI layout records no head count: 64-wide heads, 1 of 64 here
    jft = jax_build_finetune(model_cfg, ldm=jldm)
    tft = build_finetune(model_cfg, ldm=copy.deepcopy(tldm))
    assert tft.direction_by_source == jft.direction_by_source == (
        edit_attr is not None)
    np.testing.assert_allclose(tft.text_direction.numpy(),
                               np.asarray(jft.text_direction), atol=1e-4,
                               rtol=0)
    assert tft.text_direction.shape == (8, TINY["embed_dim"])
    if edit_attr == "fear":
        assert tft.edit_attr_label == 4
        return
    batch = _batch(4)
    want, _ = jax.jit(lambda prm, b: jft.training_loss(
        prm, b, jax.random.PRNGKey(0)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, aux = tft.training_loss({k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert float(aux["loss_clip"]) > 0 and float(aux["loss_id"]) > 0
    np.testing.assert_allclose(float(got), float(want),
                               atol=1e-4 * max(1.0, abs(float(want))), rtol=0)


def test_unported_finetune_options_raise(tiny_ft, tmp_path):
    cfg = tiny_ft[0]
    model_cfg = copy.deepcopy(cfg["model"])
    model_cfg["params"]["cls_loss_w"] = 1.0
    with pytest.raises(NotImplementedError):
        build_finetune(model_cfg)
    model_cfg["params"].update(cls_loss_w=0.0, cls_ckpt=str(tmp_path / "x"))
    with pytest.raises(NotImplementedError):
        build_finetune(model_cfg)
    # the lip-reading finetune is ported: its target builds its wrapper
    from dsml_thesis_tpu_torch.config import is_finetune_target
    from dsml_thesis_tpu_torch.models.lipread_tune import LipreadFinetune
    from test_torch_port_lipread import tune_cfg

    tune = tune_cfg()["model"]
    assert isinstance(build_finetune(tune), LipreadFinetune)
    assert is_finetune_target(tune["target"])
    assert is_finetune_target(cfg["model"]["target"])
    assert not is_finetune_target("ldm.models.diffusion.ddpm.LatentDiffusion")


def _cache(tmp_path, tldm):
    """A latent cache of 4 images by compute_latent_cache, as the script
    writes it."""
    rng = np.random.default_rng(7)
    images = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 3, 6, 2])
    cache = R.compute_latent_cache(tldm.eval(), images, labels, steps=3,
                                   strength=0.5)
    d = tmp_path / "cache"
    os.makedirs(d)
    np.save(d / "latents.npy", cache["latents"])
    np.save(d / "origin.npy", cache["origin"])
    np.save(d / "files.npy", np.array([f"{l}_x{i}.png"
                                       for i, l in enumerate(labels)]))
    return {k: str(d / f"{k}.npy") for k in ("latents", "origin", "files")}


def test_finetune_trainer_through_the_train_script(tiny_ft, towers, tmp_path):
    cfg, _, _, tldm = tiny_ft
    files = _cache(tmp_path, copy.deepcopy(tldm))
    cfg = copy.deepcopy(cfg)
    cfg["model"]["params"].update(_guidance_files(towers,
                                                  str(tmp_path / "g")))
    node = lambda split, prefix: {
        "target": f"ldm.data.latents.Latent{split}", "params": {
            f"{prefix}_precomputed_latents_path": files["latents"],
            f"{prefix}_origin_path": files["origin"],
            f"{prefix}_files_path": files["files"], "size": 16}}
    cfg["data"] = {"params": {"batch_size": 2, "num_workers": 1,
                              "train": node("Train", "training"),
                              "validation": node("Test", "test")}}
    cfg["lightning"] = {"callbacks": {"image_logger": {"params": {
        "batch_frequency": 2, "max_images": 2}}}}
    path = tmp_path / "ft.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = script("train_torch").main(
        ["--base", str(path), "-t", "--max-steps", "2", "--cpu", "--logdir",
         str(tmp_path / "logs"), "--seed", "0", "--log-every", "1"])
    assert type(trainer).__name__ == "FinetuneTrainer"
    state, ft = trainer._state, trainer.finetune
    assert state.step == 2
    assert state.names and all(n.startswith("unet.") for n in state.names)
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for tower in (ft.clip_image_embed, ft.arcface_embed):
        assert not tower.training
        assert not any(id(p) in in_opt or p.requires_grad
                       for p in tower.parameters())
    saved = torch.load(str(tmp_path / "g" / "clip.pt"))
    assert torch.equal(ft.clip_image_embed.visual.proj, saved["visual.proj"])
    assert torch.equal(ft.arcface_embed.tower.output_fc.weight,
                       towers["irse"].output_fc.weight)
    torch.manual_seed(0)   # the trainer's own init, from its seed
    built = build_model(cfg["model"])
    fs = dict(trainer.ldm.first_stage.named_parameters())
    for n, p in built.first_stage.named_parameters():
        assert torch.equal(fs[n], p), n
    assert not torch.equal(trainer.ldm.unet.conv_in.weight,
                           built.unet.conv_in.weight)
    recs = [json.loads(ln) for ln in open(os.path.join(trainer.logdir,
                                                       "metrics.jsonl"))]
    train = [r for r in recs if r["split"] == "train"]
    assert len(train) == 2
    assert all(r["train/loss_clip"] > 0 and r["train/loss_id"] > 0
               for r in train)
    assert any(r["split"] == "val" and "val_loss" in r for r in recs)
    edited = np.load(os.path.join(trainer.logdir, "images",
                                  "edited_step00000002.npy"))
    assert edited.shape == (2, 16, 16, 3) and np.abs(edited).max() <= 1.0


def test_expected_edit_launches_against_the_wrappers(tiny_ft, towers,
                                                     monkeypatch):
    """One finetune step on the tiny model (chain of 3): the fused-projection
    op at every self-attention of every chain call, the split-head forward
    and backward at each decoder attention block, as chip_smoke counts them
    from the model's blocks."""
    import chip_smoke
    from test_torch_port_mead128 import _wrapper_spy

    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    cfg, _, _, tldm = tiny_ft
    tldm = copy.deepcopy(tldm)
    ft = build_finetune(cfg["model"], ldm=tldm, **_torch_towers(towers),
                        text_direction=torch.from_numpy(towers["table"]),
                        direction_by_source=True)
    tldm.configure_trainable()
    calls = _wrapper_spy(monkeypatch)
    loss, _ = ft.training_loss({k: torch.from_numpy(v)
                                for k, v in _batch(5).items()})
    loss.backward()
    expect, through_function = chip_smoke.expected_edit_launches(
        tldm, ft.train_ddim.num_steps, 1, 0, 0)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    assert through_function == calls["flash_attention_fproj"] == 3 * 10
