"""The LDM trainer's warm start, image logger and step profiler, on the CPU.

Warm start: the port's ``Trainer`` against the JAX package's
``Trainer.init_state`` on one reference-layout Lightning file (parameters
and EMA shadows equal after ``from_jax_params``); from a port trainer's own
``last/state.pt``; with a first-stage ``ckpt_path``; through
``FinetuneTrainer``, whose lipreader stays as built. ``log_images``: the
``inputs`` and ``reconstruction`` rows against the JAX package's encode and
decode, and the rows that draw noise against the JAX package's own calls
(``sample_ddim``, ``ddim_sample_with_intermediates``, ``q_sample``, the
quantizing ``ddim_sample``) on the noise the port drew (seeds do not cross
frameworks); the files, the launch counts ``chip_smoke.py`` expects, and
training losses bit-equal with and without logging. ``StepProfiler``'s
window, and a real trace of exactly five steps. The shipped YAMLs with
their image logger build a ``Trainer``. The tiny 2-cond MEAD model
throughout.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from dsml_thesis_tpu.config import build_model as jbuild_model
from dsml_thesis_tpu.diffusion import (
    ddim_sample as jddim_sample,
    ddim_sample_with_intermediates as jddim_intermediates,
    make_ddim_schedule as jmake_ddim_schedule,
    q_sample as jq_sample,
)
from dsml_thesis_tpu.training.trainer import Trainer as JaxTrainer
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.convert import (from_jax_params, from_jax_tree,
                                           to_jax_params)
from dsml_thesis_tpu_torch.models import lipreader as tlr
from dsml_thesis_tpu_torch.training import profiling
from dsml_thesis_tpu_torch.training.finetune_trainer import FinetuneTrainer
from dsml_thesis_tpu_torch.training.trainer import Trainer, diffusion_row_t
from test_finetune_cli import TUNE_CFG
from test_torch_port_ckpt import reference_state_dict
from test_torch_port_hygiene import one_torch_thread  # noqa: F401
from test_torch_port_mead128 import _wrapper_spy
from test_torch_port_pipeline import random_params
from test_torch_port_trainer import SPEC, _config, _records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, DDIM_STEPS, LOG_STEP = 2, 4, 3


def _random_model(cfg, seed=5):
    """A port model of ``cfg`` with random weights (every tensor, the
    zero-initialized ones too), and its tree in the JAX layout."""
    torch.manual_seed(seed)
    ldm = build_model(cfg["model"])
    tree = random_params(to_jax_params(ldm), np.random.default_rng(seed))
    ldm.load_state_dict(from_jax_params(tree))
    return ldm, tree


def _trainer(tmp_path, cfg=None, tag="run", seed=0, **kw):
    return Trainer(copy.deepcopy(cfg or _config(batch=4, length=8)),
                   str(tmp_path / tag), seed=seed, device="cpu", **kw)


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# warm start
# --------------------------------------------------------------------------

def test_warm_start_matches_the_jax_trainer(tmp_path, monkeypatch):
    """``model.params.ckpt_path`` naming a reference Lightning file with
    LitEma shadows: the port's parameters are the file's raw weights, its
    EMA the shadows (the raw weights where the file shadows nothing), at
    step 0, as the JAX ``Trainer.init_state`` gives them. The JAX model's
    random init, which the file overwrites whole, is handed in built."""
    cfg = _config(batch=8, length=8)
    _, tree = _random_model(cfg)
    ema = random_params(tree["unet"], np.random.default_rng(9))
    path = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": reference_state_dict(tree, cfg["model"],
                                                   ema_unet=ema)}, path)
    cfg["model"]["params"]["ckpt_path"] = path

    jt = JaxTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"), seed=0)
    skeleton = jax.tree.map(np.zeros_like, tree)
    monkeypatch.setattr(jt.ldm, "init_params", lambda *_: skeleton)
    js = jt.init_state(next(iter(jt.train_data)))
    jparams = from_jax_params(jax.tree.map(np.asarray, js.params))
    jema = from_jax_params(jax.tree.map(np.asarray, js.ema_params))

    t = _trainer(tmp_path, cfg, tag="port", seed=1)
    state = t.init_state()
    _assert_sd_equal(t.ldm.state_dict(), jparams)
    assert state.step == 0 == int(js.step)
    assert sorted(state.names) == sorted(jema)
    for name, e in zip(state.names, state.ema_params):
        assert torch.equal(e, jema[name]), name
    assert not torch.equal(dict(zip(state.names, state.ema_params))[
        "unet.conv_in.weight"], t.ldm.unet.conv_in.weight)


def test_warm_start_from_a_port_trainers_checkpoint(tmp_path):
    """A run's ``checkpoints/last`` (directory or ``state.pt``) starts a new
    run from its raw weights and shadows, at step 0, the optimizer fresh."""
    first = _trainer(tmp_path, tag="a", max_steps=2)
    first.fit(log_every=1)
    ckpt = os.path.join(first.logdir, "checkpoints", "last")
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    cfg = _config(batch=4, length=8)
    cfg["model"]["params"]["ckpt_path"] = ckpt
    t = _trainer(tmp_path, cfg, tag="b", seed=7)
    state = t.init_state()
    _assert_sd_equal(t.ldm.state_dict(), saved["model"])
    assert state.step == 0 and not state.optimizer.state
    assert any(not torch.equal(e, saved["model"][n])
               for n, e in zip(state.names, state.ema_params))
    for name, e in zip(state.names, state.ema_params):
        assert torch.equal(e, saved["ema"][name]), name


@pytest.mark.parametrize("layout", ["taming", "port-trainer"])
def test_first_stage_ckpt_path(tmp_path, layout):
    """``first_stage_config.params.ckpt_path``: a taming VQModel file or
    the port's first-stage trainer checkpoint loads into the frozen first
    stage; the rest of the model stays as built from the seed."""
    cfg = _config(batch=4, length=8)
    _, tree = _random_model(cfg)
    want = from_jax_tree(tree["first_stage"])
    if layout == "taming":
        sd = reference_state_dict(tree, cfg["model"])
        obj = {"state_dict": {k[len("first_stage_model."):]: v
                              for k, v in sd.items()
                              if k.startswith("first_stage_model.")}}
    else:
        obj = {"model": want, "loss": {}, "step": 4}
    path = str(tmp_path / "vq.ckpt")
    torch.save(obj, path)
    cfg["model"]["params"]["first_stage_config"]["params"]["ckpt_path"] = path
    t = _trainer(tmp_path, cfg)
    _assert_sd_equal(t.ldm.first_stage.state_dict(), want)
    cold = _trainer(tmp_path, tag="cold")
    _assert_sd_equal(t.ldm.unet.state_dict(), cold.ldm.unet.state_dict())


def _tune_config(tmp_path):
    cfg = yaml.safe_load(TUNE_CFG.format(tuples="x", root="x", audio="x"))
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"length": 2,
                       "spec": dict(SPEC, landmarks=[[68, 2], "float32"])}}
    cfg["data"]["params"].update(train=node, validation=node)
    torch.manual_seed(3)
    path = str(tmp_path / "model.pth")
    torch.save(tlr.reference_state_dict(tlr.LipreaderFrontend()), path)
    cfg["model"]["params"]["lipread_ckpt"] = path
    return cfg


def test_finetune_trainer_inherits_the_warm_start(tmp_path):
    """The lip-reading tune warm-starts its LDM from a bare state_dict (raw
    weights for both parameters and EMA); the lipreader stays as built."""
    cfg = _tune_config(tmp_path)
    src, _ = _random_model(cfg)
    path = str(tmp_path / "weights.pt")
    torch.save(src.state_dict(), path)
    warm_cfg = copy.deepcopy(cfg)
    warm_cfg["model"]["params"]["ckpt_path"] = path
    warm = FinetuneTrainer(warm_cfg, str(tmp_path / "w"), seed=0,
                           device="cpu")
    cold = FinetuneTrainer(cfg, str(tmp_path / "c"), seed=0, device="cpu")
    _assert_sd_equal(warm.ldm.state_dict(), src.state_dict())
    _assert_sd_equal(warm.finetune.lipreader.state_dict(),
                     cold.finetune.lipreader.state_dict())
    state = warm.init_state()
    for name, e in zip(state.names, state.ema_params):
        assert torch.equal(e, src.state_dict()[name]), name


# --------------------------------------------------------------------------
# log_images
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """A trainer whose EMA shadows differ from its weights, one
    ``log_images`` call (2 images, DDIM-4) and what it wrote; the batch and
    the EMA weights as a JAX tree."""
    tmp = tmp_path_factory.mktemp("logged")
    cfg = _config(batch=4, length=8)
    ldm, tree = _random_model(cfg)
    path = str(tmp / "weights.pt")
    torch.save(ldm.state_dict(), path)
    cfg["model"]["params"]["ckpt_path"] = path
    t = Trainer(cfg, str(tmp / "run"), seed=0, device="cpu")
    state = t.init_state()
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for e in state.ema_params:
            e.add_(0.02 * torch.randn(e.shape, generator=gen))
    with state.ema_scope():
        ema_tree = to_jax_params(t.ldm)
    batch = next(iter(t.train_data))
    raw = copy.deepcopy(t.ldm.state_dict())
    t.ldm.train()
    t.log_images(batch, LOG_STEP, n=N_IMAGES, ddim_steps=DDIM_STEPS)
    rows = {f[:-len(f"_step{LOG_STEP:08d}.npy")]: np.load(
        os.path.join(t.logdir, "images", f))
        for f in os.listdir(os.path.join(t.logdir, "images"))
        if f.endswith(".npy")}
    return t, cfg, batch, ema_tree, raw, rows


@pytest.fixture(scope="module")
def jax_rows(logged):
    """The JAX package's rows on the EMA tree, from the noise the port drew
    (one jit; the rows' latents go through one batched decode, which
    decodes each latent alone)."""
    t, cfg, batch, ema_tree, _, _ = logged
    jldm = jbuild_model(cfg["model"])
    shape = (N_IMAGES, 8, 8, 3)
    noise = {k: jnp.asarray(v.numpy())
             for k, v in t.log_image_noise(LOG_STEP, shape).items()}
    b = {k: jnp.asarray(np.asarray(v)[:N_IMAGES]) for k, v in batch.items()
         if isinstance(v, np.ndarray)}
    sched, sf = jldm.schedule, jldm.scale_factor
    key = jax.random.PRNGKey(0)

    @jax.jit
    def latents(params, b, noise):
        z = jldm.encode_first_stage(params, b["image"])
        cond = jldm.encode_conditioning(params, b)
        ddim = jmake_ddim_schedule(sched, DDIM_STEPS)
        eps_fn = jldm.make_eps_fn(params, cond)
        _, traj = jddim_intermediates(ddim, sched, eps_fn, z.shape, key,
                                      x_T=noise["x_T"],
                                      log_every=max(1, ddim.num_steps // 4))

        def quantize(p0):
            q = jldm.first_stage.apply({"params": params["first_stage"]},
                                       p0 / sf,
                                       method=lambda m, zz: m.quantize(zz)[0])
            return q * sf

        out = {
            "reconstruction": z,
            "samples": jldm.sample_ddim(params, cond, z.shape, key,
                                        steps=DDIM_STEPS, x_T=noise["x_T"]),
            "denoise_row": traj[:, 0],
            "diffusion_row": jnp.concatenate([
                jq_sample(sched, z[:1], jnp.full((1,), ti, jnp.int32), e)
                for ti, e in zip(diffusion_row_t(sched.num_timesteps),
                                 noise["diffusion_noise"])]),
            "samples_x0_quantized": jddim_sample(
                ddim, sched, eps_fn, z.shape, key,
                x_T=noise["x_T_quantized"], eta_noise=False,
                x0_postprocess=quantize),
        }
        sizes = [v.shape[0] for v in out.values()]
        images = jldm.decode_first_stage(
            params, jnp.concatenate(list(out.values())))
        return dict(zip(out, jnp.split(images, np.cumsum(sizes)[:-1])))

    params = jax.tree.map(jnp.asarray, ema_tree)
    rows = dict(latents(params, b, noise), inputs=b["image"])
    return {k: np.clip(np.asarray(v), -1, 1) for k, v in rows.items()}


ROWS = ("inputs", "reconstruction", "samples", "denoise_row",
        "diffusion_row", "samples_x0_quantized")


@pytest.mark.parametrize("row", ROWS)
def test_log_images_rows_match_jax(logged, jax_rows, row):
    """Each row under the EMA weights against the JAX package on the same
    weights and noise (fp32, 1e-4 of the [-1, 1] range)."""
    got, want = logged[5][row], jax_rows[row]
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_log_images_files_shapes_and_mode(logged):
    """Every row and the conditioning grids as ``<name>_step<8 digits>``
    ``.npy`` (``.png`` beside, Pillow being installed here), rows in
    [-1, 1]; the model back in training mode on its raw weights."""
    t, _, batch, _, raw, rows = logged
    n, k = N_IMAGES, DDIM_STEPS
    denoise = len({i for i in range(k) if (k - 1 - i) % max(1, k // 4) == 0}
                  | {0, k - 1})
    want = {r: (n, 16, 16, 3) for r in ROWS}
    want.update(denoise_row=(denoise, 16, 16, 3), diffusion_row=(6, 16, 16, 3),
                conditioning_masked_image=(n, 16, 16, 3),
                conditioning_identity=(n, 16, 16, 3))
    assert {r: a.shape for r, a in rows.items()} == want
    for r in ROWS:
        assert np.isfinite(rows[r]).all()
        assert rows[r].min() >= -1.0 and rows[r].max() <= 1.0
    np.testing.assert_array_equal(rows["conditioning_identity"],
                                  batch["identity"][:n])
    pngs = {f for f in os.listdir(os.path.join(t.logdir, "images"))
            if f.endswith(".png")}
    assert pngs == {f"{r}_step{LOG_STEP:08d}.png" for r in want}
    assert t.ldm.training
    _assert_sd_equal(t.ldm.state_dict(), raw)


def test_log_images_launches_are_chip_smokes(tmp_path, monkeypatch):
    """One ``log_images`` call's wrapper calls (the plain versions on the
    CPU) against ``chip_smoke.expected_image_log_launches`` of the same
    model."""
    t = _trainer(tmp_path)
    t.init_state()
    batch = next(iter(t.train_data))
    expect = chip_smoke.expected_image_log_launches(t.ldm, {})
    calls = _wrapper_spy(monkeypatch)
    t.log_images(batch, 1, n=2, ddim_steps=chip_smoke.IMAGE_LOG_DDIM_STEPS)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    assert expect["flash_attention_fproj"] > 0


def test_image_logging_changes_no_training_bit(tmp_path):
    """The logger draws from its own generator: the losses of a run that
    logs at step 1 equal, bit for bit, those of one that logs none."""
    losses = []
    for tag, every in (("quiet", None), ("logging", 1)):
        cfg = _config(batch=2, length=4, val_length=2)
        if every:
            cfg["lightning"] = {"callbacks": {"image_logger": {"params": {
                "batch_frequency": every, "max_images": 1}}}}
        t = _trainer(tmp_path, cfg, tag=tag, max_steps=2)
        t.fit(log_every=1, image_every=None if every is None else 1)
        losses.append([(r["split"], r.get("train/loss", r.get("val_loss")))
                       for r in _records(t.logdir)])
        assert bool(every) == os.path.isdir(os.path.join(t.logdir, "images"))
    assert losses[0] == losses[1] and len(losses[0]) == 3


# --------------------------------------------------------------------------
# the step profiler and the memory statistics
# --------------------------------------------------------------------------

class _FakeProfile:
    calls = []

    def __init__(self, **_kw):
        pass

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")

    def export_chrome_trace(self, path):
        self.calls.append("export")


def _drive(sp, first_step, n_iters, stop_after=None):
    """The trainer's calling pattern: maybe_start(k) before step k (counted
    from 1), maybe_stop(k) after; a break after ``stop_after`` steps."""
    traced, step = [], first_step
    try:
        for i in range(n_iters):
            sp.maybe_start(step + 1)
            if sp.active:
                traced.append(step + 1)
            step += 1
            sp.maybe_stop(step)
            if stop_after is not None and i + 1 == stop_after:
                break
    finally:
        sp.ensure_stopped()
    return traced


@pytest.mark.parametrize("case", ["window", "resumed-past-start",
                                  "break-inside"])
def test_step_profiler_window(tmp_path, monkeypatch, case):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    _FakeProfile.calls = []
    if case == "window":
        sp = profiling.StepProfiler(str(tmp_path), start_step=3, num_steps=5)
        assert _drive(sp, 0, 20) == [3, 4, 5, 6, 7]
    elif case == "resumed-past-start":
        sp = profiling.StepProfiler(str(tmp_path), start_step=50)
        assert _drive(sp, 200, 10) == [201, 202, 203, 204, 205]
    else:
        sp = profiling.StepProfiler(str(tmp_path), start_step=3)
        assert _drive(sp, 0, 20, stop_after=4) == [3, 4]
    assert _FakeProfile.calls == ["start", "stop", "export"]
    assert not sp.active and sp.trace_path.startswith(str(tmp_path))
    sp.maybe_start(1000)   # once closed, never again
    assert not sp.active


def test_fit_profiles_exactly_five_steps(tmp_path):
    """``fit(profile_at_step=2)`` on 6 steps writes one Chrome trace under
    ``profile/`` whose step ranges are steps 2-6; validation on the CPU logs
    no device memory (``device_memory_stats`` is empty there)."""
    t = _trainer(tmp_path, _config(batch=2, length=12, val_length=2),
                 max_steps=6)
    t.fit(log_every=1, profile_at_step=2)
    files = os.listdir(os.path.join(t.logdir, "profile"))
    assert files == ["trace_step00000002.json"]
    with open(os.path.join(t.logdir, "profile", files[0])) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(int(e["name"].split("#")[1]) for e in events
                   if e.get("name", "").startswith("train_step#"))
    assert steps == [2, 3, 4, 5, 6]
    assert profiling.device_memory_stats() == {}
    val = [r for r in _records(t.logdir) if r["split"] == "val"]
    assert val and not any(k.startswith("cuda_") for k in val[-1])


# --------------------------------------------------------------------------
# the shipped YAMLs with their image logger
# --------------------------------------------------------------------------

@pytest.mark.parametrize("yaml_name", ["mead-128-ldm-f4.yaml",
                                       "affectnet-128-ldm-vq-f4.yaml"])
def test_shipped_yaml_with_its_image_logger_builds_a_trainer(tmp_path,
                                                            yaml_name):
    """The YAML as shipped (``main.ImageLogger``: every 5,000 steps, 8
    images) with tiny synthetic data; the model on the meta device."""
    cfg = load_config([os.path.join(ROOT, "configs", "latent-diffusion",
                                    yaml_name)])
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"length": 2, "spec": {"image": [[8, 8, 3], "float32"],
                                             "class_label": [[], "int32"]}}}
    cfg["data"]["params"].update(train=node, validation=node, num_workers=0)
    with torch.device("meta"):
        t = Trainer(cfg, str(tmp_path / "run"), device="meta")
    assert (t.image_every, t.log_max_images) == (5000, 8)
    assert t.ldm.image_size == 32
