"""First-stage training of the port against the JAX package's, on the CPU:
one fused VQGAN step and one KL-autoencoder step against
``make_vqgan_train_step`` / ``make_kl_ae_train_step`` from the same weights
and batch (the KL step with the JAX step's own posterior noise), then the
port's ``VQGANTrainer`` / ``KLAETrainer`` (fit, validation, top-k, resume,
reconstructions, the LPIPS files) and ``scripts/train_torch.py --cpu`` on an
autoencoder target.

A tiny config: ch 64 (two channels a GroupNorm group, so that no parameter's
gradient is zero by construction and Adam's first step, which divides a
gradient by its own size, is defined by the arithmetic and not by rounding),
``ch_mult [1, 2]``, attention at 8 x 8, 16 px, ``disc_start: 0`` so that the
GAN term and the adaptive weight run. The JAX step runs under ``jax.jit``
with its attention through XLA's composed ops (the same arithmetic as the
port's plain versions). Tolerances per assert: losses 1e-5 relative (fp32
sums in another order). Parameters after one Adam step of lr 1e-3: Adam's
first step is lr * g / (|g| + 1e-8), about lr * sign(g) for every element,
so an element whose gradient is a sum that cancels to near zero takes the
sign of its rounding noise, which differs between the frameworks. Each
element is held to 1e-2 of lr absolute, or, where Adam's eps dominates its
step, to its gradient: ``_same_tree`` states the rule.
"""
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.training import kl_ae as jkl
from dsml_thesis_tpu.training import vqgan as jvqgan
from dsml_thesis_tpu.training import vqgan_trainer as jtrainer
from dsml_thesis_tpu_torch.convert import from_jax_tree, to_jax_tree
from dsml_thesis_tpu_torch.losses.lpips import LPIPS, lpips_weight_files
from dsml_thesis_tpu_torch.training import vqgan_trainer as ttrainer
from dsml_thesis_tpu_torch.training.kl_ae import make_kl_ae_train_step
from dsml_thesis_tpu_torch.training.vqgan import (create_first_stage_state,
                                                  make_vqgan_train_step)
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _syn(length, seed=0):
    return {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"length": length, "seed": seed,
                       "spec": {"image": [[16, 16, 3], "float32"]}}}


def _config(kind, perceptual=0.0, batch=2, train_logvar=False, top_k=5):
    dd = dict(double_z=kind == "kl", z_channels=3, resolution=16,
              in_channels=3, out_ch=3, ch=64, ch_mult=[1, 2],
              num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
    lp = {"disc_start": 0, "disc_num_layers": 2, "disc_ndf": 16,
          "disc_weight": 0.8, "perceptual_weight": perceptual}
    params = {"embed_dim": 3, "ddconfig": dd, "lossconfig": {"params": lp}}
    if kind == "vq":
        target = "ldm.models.autoencoder.VQModel"
        params["n_embed"] = 32
        lp["codebook_weight"] = 1.0
    else:
        target = "ldm.models.autoencoder.AutoencoderKL"
        lp.update(kl_weight=1e-3, logvar_init=0.2, train_logvar=train_logvar)
    return {"model": {"base_learning_rate": LR / batch, "target": target,
                      "params": params},
            "data": {"params": {"batch_size": batch, "num_workers": 1,
                                "train": _syn(4), "validation": _syn(2, 7)}},
            "lightning": {"modelcheckpoint": {"params": {"save_top_k": top_k}}}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


# Adam's eps (both frameworks' first-stage optimizers)
ADAM_EPS = 1e-8
# the gradient below which eps shapes Adam's step: at |g| = 1,000 eps the
# step is lr * (1 - 1e-3), and a step 1e-2 lr off needs a gradient that is
# off by about 1e-2 |g|^2 / eps; the tiny model's gradients are 1e-3 .. 1e-2
EPS_DOMINATED = 1e3 * ADAM_EPS


def _implied_grad(after, before):
    """The gradient Adam's first step took: the step is -lr * g / (|g| +
    eps) (its bias corrections cancel at step 1), so r = (before - after) /
    lr gives g = eps * r / (1 - |r|); inf where |r| rounds to 1."""
    r = ((before.astype(np.float64) - after) / LR).clip(-1, 1)
    with np.errstate(divide="ignore"):
        return ADAM_EPS * r / (1 - np.abs(r))


def _same_tree(got, want, atol, before):
    """Leaf by leaf, element by element: within ``atol`` of the JAX step's
    parameter, or, for an element whose gradient is a sum that cancels to
    near zero, held to that gradient instead of to Adam's step. Adam divides
    a gradient by its own size plus eps, so at |g| of a few eps it amplifies
    the fp32 rounding of the sum (at |g| = 13 eps a gradient 1.8e-8 off moves
    the step by 1e-2 lr). Such an element passes where both steps imply a
    gradient of at most ``EPS_DOMINATED`` (so the two gradients agree within
    2 ``EPS_DOMINATED``, 1e-3 .. 1e-2 of the leaves' gradients); every
    element within 2 lr (a flipped step). An attention
    block's key bias has no gradient by construction (a constant added to
    every key shifts a row's scores alike, which the softmax cancels): Adam's
    first step moves it by +-lr on the rounding noise of that zero, so it is
    held to moving at most lr."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys() == before.keys()
    for k in want:
        if "attn" in k and k.endswith("/k/bias"):
            np.testing.assert_array_less(np.abs(got[k] - before[k]),
                                         LR * (1 + 1e-3), err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * LR * (1 + 1e-3), k
        off = diff > atol
        if not off.any():
            continue
        g_got = _implied_grad(got[k][off], before[k][off])
        g_want = _implied_grad(want[k][off], before[k][off])
        assert (np.abs(g_got) <= EPS_DOMINATED).all() and (
            np.abs(g_want) <= EPS_DOMINATED).all(), (k, diff[off], g_got,
                                                     g_want)


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _images(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 16, 16, 3)) \
        .astype(np.float32)


def test_vqgan_step_matches_jax():
    """Losses, d_weight, the updated autoencoder and the updated
    discriminator after one fused step."""
    cfg = _config("vq")
    jm, jl = jtrainer.build_vqgan(cfg["model"])
    state, ae_tx, disc_tx = jvqgan.create_vqgan_state(
        jm, jl, jax.random.PRNGKey(0), (2, 16, 16, 3), LR)
    x = _images(1)
    new, jmetrics = jax.jit(jvqgan.make_vqgan_train_step(jm, jl, ae_tx,
                                                         disc_tx))(
        state, {"image": jnp.asarray(x)})

    tm, tl = ttrainer.build_vqgan(cfg["model"])
    tm.load_state_dict(from_jax_tree(state.ae_params))
    tl.load_state_dict(from_jax_tree(state.loss_params))
    tstate = create_first_stage_state(tm, tl, LR)
    tmetrics = make_vqgan_train_step(tm, tl)(tstate, torch.from_numpy(x))
    assert tstate.step == 1 and float(tmetrics["train/d_weight"]) > 0
    _metrics_close(tmetrics, jmetrics)
    _same_tree(to_jax_tree(tm), new.ae_params, 1e-2 * LR, _flat(state.ae_params))
    _same_tree(to_jax_tree(tl.discriminator),
               new.loss_params["discriminator"], 1e-2 * LR,
               _flat(state.loss_params["discriminator"]))
    moved = _flat(to_jax_tree(tm))["decoder/conv_out/kernel"] \
        - _flat(state.ae_params)["decoder/conv_out/kernel"]
    assert np.abs(moved).max() > 0.5 * LR


def test_kl_step_matches_jax_with_its_noise_and_trained_logvar():
    """The KL step under ``train_logvar``: losses, the updated autoencoder,
    log-variance and discriminator, the posterior drawn from the JAX step's
    own key and handed to the port as noise."""
    cfg = _config("kl", train_logvar=True)
    jm, jl = jtrainer.build_kl_ae(cfg["model"])
    state, ae_tx, disc_tx = jkl.create_kl_ae_state(
        jm, jl, jax.random.PRNGKey(2), (2, 16, 16, 3), LR, train_logvar=True)
    x = _images(3)
    new, jmetrics = jax.jit(jkl.make_kl_ae_train_step(jm, jl, ae_tx, disc_tx))(
        state, {"image": jnp.asarray(x)})
    _, sub = jax.random.split(state.rng)
    noise = np.array(jax.random.normal(sub, (2, 8, 8, 3)))

    tm, tl = ttrainer.build_kl_ae(cfg["model"])
    ae = {k: v for k, v in state.ae_params.items() if k != "_loss_logvar"}
    tm.load_state_dict(from_jax_tree(ae))
    tl.load_state_dict(from_jax_tree(
        {**state.loss_params, "logvar": state.ae_params["_loss_logvar"]}))
    tl.logvar.requires_grad_(True)
    tstate = create_first_stage_state(tm, tl, LR, extra_ae_params=(tl.logvar,))
    tmetrics = make_kl_ae_train_step(tm, tl)(tstate, torch.from_numpy(x),
                                             noise=torch.from_numpy(noise))
    _metrics_close(tmetrics, jmetrics)
    new_ae = {k: v for k, v in new.ae_params.items() if k != "_loss_logvar"}
    _same_tree(to_jax_tree(tm), new_ae, 1e-2 * LR, _flat(ae))
    np.testing.assert_allclose(float(tl.logvar.detach()), float(
        new.ae_params["_loss_logvar"]), atol=1e-2 * LR, rtol=0)
    assert abs(float(tl.logvar.detach()) - 0.2) > 0.5 * LR
    _same_tree(to_jax_tree(tl.discriminator),
               new.loss_params["discriminator"], 1e-2 * LR,
               _flat(state.loss_params["discriminator"]))


def test_kl_step_draws_from_seed_and_step():
    """Without injected noise the step draws from (seed, step): equal seeds
    give equal bits, another step another draw."""
    cfg = _config("kl")
    x = torch.from_numpy(_images(4))
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        tm, tl = ttrainer.build_kl_ae(cfg["model"])
        state = create_first_stage_state(tm, tl, LR, seed=5)
        step = make_kl_ae_train_step(tm, tl)
        runs.append([float(step(state, x)["train/total_loss"])
                     for _ in range(2)])
    assert runs[0] == runs[1]


def _write_lpips_files(tmp_path):
    """Random LPIPS weights in the torchvision / taming key layout."""
    torch.manual_seed(1)
    sd = LPIPS().state_dict()
    paths = str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth")
    for path, part in zip(paths, lpips_weight_files(sd)):
        torch.save(part, path)
    return paths, sd


@pytest.mark.parametrize("kind", ["vq", "kl"])
def test_trainer_fit_validate_topk_resume(kind, tmp_path):
    """fit over max_steps across epochs, a validation and a top-k checkpoint
    after each epoch, ``last``, metrics.jsonl, reconstructions, the LPIPS
    files loaded (the VQ run); a resumed trainer continues at the saved step
    with the saved weights and optimizer state, and a second fresh run from
    the same seed repeats the first's losses bit for bit."""
    cfg = _config(kind, perceptual=1.0 if kind == "vq" else 0.0, top_k=2)
    if kind == "vq":
        (vgg, lin), lpips_sd = _write_lpips_files(tmp_path)
        cfg["model"]["params"]["lossconfig"]["params"].update(
            vgg_ckpt=vgg, lpips_lin_ckpt=lin)
    cls = ttrainer.VQGANTrainer if kind == "vq" else ttrainer.KLAETrainer
    run = str(tmp_path / "run")
    t = cls(cfg, run, seed=0, max_steps=5, device="cpu")
    if kind == "vq":
        for k, v in lpips_sd.items():
            assert torch.equal(t.loss.lpips.state_dict()[k], v)
    assert t.lr == pytest.approx(LR)
    state = t.fit(log_every=1, image_every=5)
    t.close()
    assert state.step == 5
    recs = [json.loads(line) for line in open(os.path.join(run,
                                                          "metrics.jsonl"))]
    train = [r for r in recs if r["split"] == "train"]
    val = [r for r in recs if r["split"] == "val"]
    assert [r["step"] for r in train] == list(range(1, 6))
    assert [r["step"] for r in val] == [2, 4, 5]   # 2 batches an epoch
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if isinstance(v, float))
    assert all(r["train/d_weight"] > 0 for r in train)
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    assert "last" in ckpts and len(ckpts) == 3   # top-2 and last
    best = sorted(r["val/rec_loss"] for r in val)[:2]
    assert sorted(float(c.rsplit("=", 1)[1]) for c in ckpts
                  if c != "last") == pytest.approx(best, abs=1e-5)
    assert glob.glob(os.path.join(run, "images", "recon_step00000005.npy"))

    again = cls(cfg, run, seed=0, max_steps=6, device="cpu")
    again.restore_checkpoint("last")
    assert again._state.step == 5
    for a, b in zip(again.model.parameters(), t.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(again.loss.discriminator.parameters(),
                    t.loss.discriminator.parameters()):
        assert torch.equal(a, b)
    assert again.fit(log_every=1).step == 6
    again.close()

    twin = cls(cfg, str(tmp_path / "twin"), seed=0, max_steps=2,
               device="cpu")
    twin.fit(log_every=1)
    twin.close()
    twin_recs = [json.loads(line) for line in open(
        os.path.join(tmp_path, "twin", "metrics.jsonl"))]
    assert [r["train/total_loss"] for r in twin_recs if r["split"] == "train"] \
        == [r["train/total_loss"] for r in train[:2]]


def test_perceptual_weight_needs_the_lpips_files(tmp_path):
    with pytest.raises(ValueError, match="LPIPS"):
        ttrainer.VQGANTrainer(_config("vq", perceptual=1.0), str(tmp_path),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="one card"):
        ttrainer.VQGANTrainer(_config("vq"), str(tmp_path), fsdp=True,
                              device="cpu")


def _train_torch():
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "scripts", "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["vq", "kl"])
def test_train_torch_cli_trains_an_autoencoder_target(kind, tmp_path):
    """``scripts/train_torch.py --cpu`` on a first-stage YAML with the data
    given as overrides, then ``--resume`` for one more step; without
    ``--cpu`` and without a card it refuses."""
    cfg = _config(kind)
    data = cfg.pop("data")
    base = tmp_path / "ae.yaml"
    base.write_text(yaml.safe_dump(cfg))
    argv = ["--base", str(base), "-t", "--cpu", "--max-steps", "2",
            "--logdir", str(tmp_path / "logs"), "--seed", "0", "--log-every",
            "1", "data.params.batch_size=2", "data.params.num_workers=1",
            f"data.params.train={json.dumps(data['params']['train'])}",
            f"data.params.validation={json.dumps(data['params']['validation'])}"]
    cli = _train_torch()
    trainer = cli.main(argv)
    want = ttrainer.VQGANTrainer if kind == "vq" else ttrainer.KLAETrainer
    assert type(trainer) is want and trainer._state.step == 2
    again = cli.main(["--resume", trainer.logdir, "-t", "--cpu",
                      "--max-steps", "3", "--log-every", "1"])
    assert again._state.step == 3
    recs = [json.loads(line) for line in open(
        os.path.join(trainer.logdir, "metrics.jsonl"))]
    assert [r["step"] for r in recs if r["split"] == "train"] == [1, 2, 3]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main([a for a in argv if a != "--cpu"])
