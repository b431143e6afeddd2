"""``mead-128-ldm-f4.yaml``, the reference's own talking-face model, on the
port: its UNet sets no dtype and computes in fp32 (in the JAX package too),
with self-attention at every level over 32-wide heads, so on the card every
attention it runs takes a kernel's fp32 D = 32 instantiation. On the CPU:

* The plain versions (what each op runs on a CPU tensor, and what its CUDA
  kernel is held against on the card) against the JAX package's Pallas
  kernels in interpret mode, fp32, D = 32, at mead-128's widths: the
  fused-projection op at C = 160 / 5 heads and C = 640 / 20 heads (N = 64),
  the packed forward and backward, the split-head forward and backward.
  Tolerance 1e-5 of each output's maximum (fp32 sums in another order).
* Admission, on the meta device from the real YAML: in eval every
  self-attention reaches the fused-projection op at any batch, under
  ``DSML_ATTN_FUSED_PROJ=0`` the packed op, under ``DSML_ATTN_PACKED=0`` the
  split-head op, each at a shape its kernel takes (training is
  ``test_torch_port_dh64_training.py``'s admission test).
* The slice: a tiny model with mead-128's structure in fp32 (attention at
  [4, 2, 1], 32-wide heads, in_channels 9, both conditionings; a 16 px
  first stage with attention at its last level) against the JAX package
  with its kernels in interpret mode (``DSML_FLASH_INTERPRET=1``): one train
  step on the packed and the split-head routes (loss 1e-5, every gradient
  leaf 1e-4 of its own maximum, parameters after one AdamW step 1e-5 in all
  but 1e-3 of a leaf's elements and nowhere beyond twice the learning rate,
  as ``test_torch_port_slices.py``), t and noise from the JAX side's own
  draws; a DDIM chain of the video pipeline (2 frames x 4 steps, x_T
  injected; latents 1e-3) on both eval routes.
* ``chip_smoke.py``'s launch arithmetic of the mead-128 runs: the counts
  ``expected_launches`` / ``expected_train_launches`` take from the tiny
  model built on the meta device against spies on the wrappers in one CPU
  UNet call and one CPU training step, and the real YAML's counts.
"""
from __future__ import annotations

import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu.training import train_state as jts
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.convert import from_jax_params, to_jax_params
from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.training import train_state as tts
from test_ldm import TINY_MEAD_CFG
from test_torch_port_pipeline import (F, WINDOW, _run_jax, _run_torch,
                                      random_params)
from test_torch_port_training import (B, _batch, _jax_draws, _jb, _leaves,
                                      _noise_leaves, _tb,
                                      jax_step_with_grads)
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

D = 32
ROUTES = {"packed": {}, "split": {"DSML_ATTN_PACKED": "0"}}


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _heads(seed, b, h, nq, nk):
    """q, k, v, do [B, H, N, 32] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, D)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


def _pack(a):
    b, h, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d))


def _grads(fn, arrays, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(do))


# --------------------------------------------------------------------------
# plain versions against the JAX kernels, fp32 at D = 32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("c,heads", [(160, 5), (640, 20)],
                         ids=["level0-5-heads", "level2-20-heads"])
def test_fproj_reference_matches_jax_kernel(c, heads):
    rng = np.random.default_rng(c)
    b, n = 2, 64
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    h = r(b, n, c)
    wq, wk, wv = (r(c, c) / np.sqrt(c) for _ in range(3))   # [C, H*D]
    wo, bo = r(c, c) / np.sqrt(c), 0.1 * r(c)
    want = jatt.flash_attention_fproj(
        *map(jnp.asarray, (h, wq, wk, wv, wo, bo)), heads, interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    plain = tatt.fproj_reference(t(h), t(wq.T), t(wk.T), t(wv.T), t(wo.T),
                                 t(bo), heads)
    assert plain.dtype == torch.float32
    _close(plain.numpy(), want)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(tatt.flash_attention_fproj(
        t(h), t(wq.T), t(wk.T), t(wv.T), t(wo.T), t(bo), heads), plain)


SHAPES = {"level0": (2, 5, 64, 64), "level1": (1, 10, 256, 256),
          "ragged-nk-ne-nq": (2, 20, 70, 33)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_packed_forward_and_backward_match_jax_kernels(shape):
    b, h, nq, nk = SHAPES[shape]
    q, k, v, do = map(_pack, _heads(1, b, h, nq, nk))
    jx = lambda *a: [jnp.asarray(x) for x in a]
    want = jatt.flash_attention_packed(*jx(q, k, v), h, block_q=64,
                                       interpret=True)
    plain = tatt.packed_reference(*map(torch.from_numpy, (q, k, v)), h)
    _close(plain.numpy(), want)
    want_g = jatt.flash_attention_bwd_packed(*jx(q, k, v, do), h, block_q=64,
                                             interpret=True)
    plain_g = tatt.packed_bwd_reference(*map(torch.from_numpy, (q, k, v, do)),
                                        h)
    through = _grads(lambda *a: tatt.flash_attention_packed(*a, h), (q, k, v),
                     do)
    for w, p, t in zip(want_g, plain_g, through):
        _close(p.numpy(), w)
        assert torch.equal(p, t)   # the Function's CPU backward is the plain one


@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_head_forward_and_backward_match_jax_kernels(shape):
    b, h, nq, nk = SHAPES[shape]
    q, k, v, do = _heads(2, b, h, nq, nk)
    jx = lambda *a: [jnp.asarray(x) for x in a]
    want = jatt.flash_attention(*jx(q, k, v), block_q=64, interpret=True)
    plain = tatt.attention_reference(*map(torch.from_numpy, (q, k, v)))
    _close(plain.numpy(), want)
    want_g = jatt.flash_attention_bwd(*jx(q, k, v, do), block_q=64,
                                      interpret=True)
    plain_g = tatt.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, do)))
    through = _grads(tatt.flash_attention, (q, k, v), do)
    for w, p, t in zip(want_g, plain_g, through):
        _close(p.numpy(), w)
        assert torch.equal(p, t)


def test_fp32_head_width_32_predicates_and_entries():
    """The kernels of the fp32 UNet's path take fp32 at D = 32 and pick the
    ``_f32`` entry point, the streaming pair included; the q/out-fused kernel
    takes bf16 only."""
    f32 = torch.float32
    assert tatt.fproj_kernel_takes(160, D, f32)
    assert tatt.fproj_kernel_takes(640, D, f32)
    assert not tatt.fproj_kernel_takes(176, D, f32)   # C % 32 != 0
    assert not tatt.fproj_kernel_takes(128, 64, f32)
    assert tatt.packed_kernel_takes(D, f32) and tatt.packed_bwd_kernel_takes(
        D, f32)
    assert tatt.flash_kernel_takes(D, f32)
    assert tatt.flash_kernel_takes(D, f32, backward=True)
    assert tatt.streaming_kernel_takes(D, f32)
    assert tatt.streaming_kernel_takes(D, f32, backward=True)
    assert not tatt.qout_kernel_takes(160, 160, D, f32)
    t = torch.zeros(1, 8, 160, dtype=f32)
    for kernel in ("flash_attention_packed", "flash_attention_bwd_packed",
                   "flash_attention_fproj", "flash_attention",
                   "flash_attention_bwd", "flash_attention_streaming",
                   "flash_attention_streaming_bwd"):
        assert tatt._entry(kernel, t, D) == f"dsml_{kernel}_f32"
    with pytest.raises(ValueError, match="head width 64"):
        tatt._entry("flash_attention_streaming", t, 64)


# --------------------------------------------------------------------------
# admission: every eval-mode self-attention of the real YAML
# --------------------------------------------------------------------------

EVAL_ROUTES = {"fused": ({}, "fproj"),
               "no-fused-proj": ({"DSML_ATTN_FUSED_PROJ": "0"}, "packed"),
               "split": ({"DSML_ATTN_PACKED": "0"}, "split")}


@functools.lru_cache(maxsize=None)
def _meta_mead128():
    cfg = load_config([chip_smoke.CONFIG_128])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    return ldm


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("route", list(EVAL_ROUTES))
def test_every_eval_self_attention_is_taken(route, batch, monkeypatch):
    """No batch gate: at batch 1 as at 16, each of the 16 self-attentions of
    a UNet call (5 at N = 1024 / C = 160, 5 at 256 / 320, 6 at 64 / 640) goes
    to the route's op at a shape its fp32 kernel takes."""
    env, op = EVAL_ROUTES[route]
    unet = _meta_mead128().unet.eval()
    seen = []

    def spy(name):
        def call(*args, **kwargs):
            x = args[0]
            if name == "fproj":
                heads = args[6] if len(args) > 6 else kwargs["heads"]
                seen.append((name, x.shape[1], x.shape[-1],
                             args[1].shape[0] // heads, x.dtype))
            elif name == "packed":
                heads = args[3] if len(args) > 3 else kwargs["heads"]
                seen.append((name, x.shape[1], x.shape[-1],
                             x.shape[-1] // heads, x.dtype))
            else:
                seen.append((name, x.shape[2], x.shape[1] * x.shape[3],
                             x.shape[3], x.dtype))
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        return call

    def refuse(*args, **kwargs):
        raise AssertionError("the q/out-fused op on mead-128")

    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tunet, "flash_attention_fproj", spy("fproj"))
    monkeypatch.setattr(tunet, "packed_multi_head_attention", spy("packed"))
    monkeypatch.setattr(tunet, "multi_head_attention", spy("split"))
    monkeypatch.setattr(tunet, "fused_qout_self_attention", refuse)
    ds = {unet.model_channels * m: 2 ** i
          for i, m in enumerate(unet.channel_mult)}
    for m in unet.modules():
        if isinstance(m, tunet.SpatialTransformer):
            n = (32 // ds[m.proj_in.in_channels]) ** 2
            attn = m.block_0.attn1
            x = torch.empty(batch, n, attn.to_q.in_features, device="meta")
            assert attn(x).shape == x.shape
    assert len(seen) == 16 and {s[0] for s in seen} == {op}
    assert sorted((n, c) for _, n, c, _, _ in seen) == sorted(
        [(1024, 160)] * 5 + [(256, 320)] * 5 + [(64, 640)] * 6)
    for name, n, c, d, dtype in seen:
        assert (d, dtype) == (D, torch.float32)
        if name == "fproj":
            assert tatt.fproj_one_q_block(n) and tatt.fproj_kernel_takes(
                c, d, dtype)
        elif name == "packed":
            assert tatt.packed_kernel_takes(d, dtype)
        else:
            assert not tatt.streaming_auto(n, n, d)
            assert tatt.flash_kernel_takes(d, dtype)


# --------------------------------------------------------------------------
# the slice: a tiny model with mead-128's structure against the JAX package
# --------------------------------------------------------------------------

def _tiny_cfg():
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    unet = cfg["model"]["params"]["unet_config"]["params"]
    unet.update(model_channels=32, channel_mult=[1, 2, 4],
                attention_resolutions=[4, 2, 1], num_head_channels=32)
    assert "dtype" not in unet   # fp32, as mead-128's
    cfg["model"]["params"]["cond_stage_config_1"]["params"]["p_uncond"] = 0.0
    return cfg


@pytest.fixture(scope="module")
def tiny128():
    cfg = _tiny_cfg()
    jldm = jax_build_model(cfg["model"])
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), _jb(_batch(0)))
    params = random_params(params, np.random.default_rng(3))
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    heads = {(m.block_0.attn1.dim_head, m.block_0.attn1.heads)
             for m in tldm.unet.modules()
             if isinstance(m, tunet.SpatialTransformer)}
    assert heads == {(32, 1), (32, 2), (32, 4)}
    rng = np.random.default_rng(16)
    inputs = {
        "masked_frames": rng.uniform(-1, 1, (B, F, 16, 16, 3)),
        "audio": rng.standard_normal((B, F + WINDOW, 32)),
        "identity": rng.uniform(-1, 1, (B, 16, 16, 3)),
        "x_T": rng.standard_normal((B, F, 8, 8, 3)),
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs["class_label"] = np.arange(B, dtype=np.int32) % 8
    return cfg, jldm, params, tldm, inputs


def _route(monkeypatch, env):
    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")   # read by the JAX side
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def pipeline_latents_vs_jax(tiny128, monkeypatch, env, jax_env=None):
    """The DDIM chain's latents of the tiny model under the flags ``env``
    against the JAX package's under ``jax_env`` (default: the same flags),
    1e-3."""
    _, jldm, params, tldm, inputs = tiny128
    _route(monkeypatch, env if jax_env is None else jax_env)
    want = _run_jax(jldm, params, inputs, decode=False)
    _route(monkeypatch, env)
    tldm.eval()
    got = _run_torch(tldm, inputs, decode=False)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def train_step_vs_jax(tiny128, monkeypatch, env, jax_env=None):
    """Loss, every gradient leaf and one AdamW + EMA step of the tiny model
    under the flags ``env`` against the JAX step under ``jax_env`` (default:
    the same flags), t and noise from the JAX side's own draws."""
    _, jldm, params, tldm, _ = tiny128
    tldm = copy.deepcopy(tldm)
    batch, rng, base_lr = _batch(31), jax.random.PRNGKey(22), 1e-4
    _route(monkeypatch, env if jax_env is None else jax_env)
    # one jitted step (interpret-mode kernels compile once): its loss,
    # gradients and new state, all at the step's own draws
    jstate, want_m, want_grads = jax_step_with_grads(
        jldm, params, jts.make_optimizer(jldm, params, base_lr), batch, rng)
    want_loss = want_m["train/loss"]
    draws = _jax_draws(jax.random.fold_in(rng, 0))

    _route(monkeypatch, env)
    t, noise = draws
    tldm.train()
    tldm.configure_trainable()
    tldm.zero_grad(set_to_none=True)
    loss, _ = tldm.training_loss(_tb(batch), t=t, noise=noise)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-5, rtol=0)
    got_l = _leaves(to_jax_params(tldm, {
        n: p.grad for n, p in tldm.named_parameters() if p.grad is not None}))
    want_l = _leaves({g: v for g, v in want_grads.items()
                      if g != "first_stage"})
    top = max(np.abs(w).max() for w in want_l.values())
    assert sum("attn1" in k for k in got_l) >= 7 * 4
    for k, g in got_l.items():
        np.testing.assert_allclose(
            g, want_l[k], rtol=0, err_msg=k,
            atol=max(1e-4 * np.abs(want_l[k]).max(), 1e-6 * top))

    class Draws:
        supports_sample_weights = True

        def training_loss(self, b, generator=None, training=True):
            return tldm.training_loss(b, generator, training=training,
                                      t=draws[0], noise=draws[1])

    tldm.zero_grad(set_to_none=True)
    opt = tts.make_optimizer(tldm, base_lr=base_lr)
    state = tts.create_train_state(tldm, opt, base_lr=base_lr)
    m = tts.make_train_step(Draws())(state, _tb(batch), seed=0)
    np.testing.assert_allclose(float(m["train/loss"]),
                               float(want_m["train/loss"]), atol=1e-5, rtol=0)
    noise_leaves = _noise_leaves(want_grads)
    got_p = _leaves(to_jax_params(tldm, dict(zip(state.names, state.params))))
    want_p = _leaves({k: v for k, v in jstate.params.items()
                      if k != "first_stage"})
    for k, w_ in want_p.items():
        diff = np.abs(got_p[k] - w_)
        assert diff.max() <= 2 * base_lr + 1e-7, k
        if k not in noise_leaves:
            assert (diff > 1e-5).mean() <= 1e-3, k


@pytest.mark.parametrize("route", list(ROUTES))
def test_pipeline_latents_match_jax(tiny128, route, monkeypatch):
    pipeline_latents_vs_jax(tiny128, monkeypatch, ROUTES[route])


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_step_matches_jax(tiny128, route, monkeypatch):
    """Loss, every gradient leaf and one AdamW + EMA step, the JAX side's
    packed (rows 3 and 8) or split-head (rows 2 and 7) kernels in interpret
    mode."""
    train_step_vs_jax(tiny128, monkeypatch, ROUTES[route])


# --------------------------------------------------------------------------
# chip_smoke.py's launch arithmetic of the mead-128 runs
# --------------------------------------------------------------------------

def _wrapper_spy(monkeypatch):
    """Counts, per kernel, the wrapper calls that launch that kernel for a
    CUDA tensor (on the CPU they run the plain version); the backward
    kernels by the backward of the autograd Function that launches them."""
    calls = dict.fromkeys(tatt.LAUNCHES, 0)

    def count(mod, attr, kernel, wrap=lambda f: f):
        real = getattr(mod, attr)

        def spy(*args, **kw):
            calls[kernel] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, attr, wrap(spy))

    count(tunet, "flash_attention_fproj", "flash_attention_fproj")
    count(tatt, "flash_attention_packed", "flash_attention_packed")
    count(tatt, "flash_attention", "flash_attention")
    count(tatt, "flash_attention_streaming", "flash_attention_streaming")
    count(tatt._PackedAttention, "backward", "flash_attention_bwd_packed",
          staticmethod)
    count(tatt._FlashAttention, "backward", "flash_attention_bwd",
          staticmethod)
    count(tatt, "flash_attention_streaming_bwd", "flash_attention_streaming_bwd")
    return calls


MEAD128_RUNS = {name: env for name, config, env, _ in chip_smoke.RUNS
                if config == chip_smoke.CONFIG_128}
MEAD128_TRAIN_RUNS = {name: env
                      for name, config, env, _ in chip_smoke.TRAIN_RUNS
                      if config == chip_smoke.CONFIG_128}
# the runs of the packed and split-head routes, whose launches this file
# checks (the streaming and GroupNorm-kernel routes:
# test_torch_port_mead128_routes.py)
SMOKE_RUNS = {n: MEAD128_RUNS[n] for n in ("mead128", "mead128-split")}
SMOKE_TRAIN_RUNS = {n: MEAD128_TRAIN_RUNS[n]
                    for n in ("train-mead128", "train-mead128-split")}


def test_the_smoke_script_has_the_mead128_runs():
    streaming = {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}
    assert MEAD128_RUNS == {"mead128": {},
                            "mead128-split": {"DSML_ATTN_PACKED": "0"},
                            "mead128-streaming": streaming,
                            "mead128-gn": {"DSML_PALLAS_GN": "1"},
                            "mead128-epilogue": {"DSML_GN_EPILOGUE": "1"},
                            "mead128-stats": {"DSML_PALLAS_GN": "stats"}}
    assert MEAD128_TRAIN_RUNS == {
        "train-mead128": {}, "train-mead128-split": {"DSML_ATTN_PACKED": "0"},
        "train-mead128-streaming": streaming,
        "train-mead128-epilogue": {"DSML_GN_EPILOGUE": "res"}}


def _meta_tiny():
    cfg = _tiny_cfg()
    with torch.device("meta"):
        return build_model(cfg["model"])


@pytest.mark.parametrize("run", sorted(SMOKE_RUNS))
def test_smoke_serve_launches_are_one_cpu_calls_wrapper_calls(tiny128, run,
                                                              monkeypatch):
    """One guidance-pair UNet call and one first-stage decode of the tiny
    model (latents 8 x 8: N = 64, 16, 4) against ``expected_launches`` from
    the same model built on the meta device."""
    _, _, _, tldm, _ = tiny128
    env = SMOKE_RUNS[run]
    expect = chip_smoke.expected_launches(_meta_tiny(), env, unet_calls=1,
                                          encodes=0, decodes=1)
    tldm = tldm.eval()
    gen = np.random.default_rng(5)
    r = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    with chip_smoke.flags(**env), torch.no_grad():
        calls = _wrapper_spy(monkeypatch)
        tldm.apply_model(r(2, 8, 8, 3), torch.full((2,), 50),
                         {"crossattn": r(4, 1, 48), "concat": r(2, 8, 8, 6)},
                         cfg_pairs=True)
        tldm.decode_first_stage(r(1, 8, 8, 3), force_not_quantize=True)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    assert expect["flash_attention_fproj" if not env
                  else "flash_attention"] >= 7


@pytest.mark.parametrize("run", sorted(SMOKE_TRAIN_RUNS))
def test_smoke_train_launches_are_one_cpu_steps_wrapper_calls(tiny128, run,
                                                              monkeypatch):
    """One training step of the tiny model (three frozen first-stage encodes,
    the UNet forward and backward) against ``expected_train_launches``."""
    _, _, _, tldm, _ = tiny128
    tldm = copy.deepcopy(tldm).train()
    env = SMOKE_TRAIN_RUNS[run]
    _, per_step = chip_smoke.expected_train_launches(_meta_tiny(), env,
                                                     steps=1, eval_batches=0)
    with chip_smoke.flags(**env):
        calls = _wrapper_spy(monkeypatch)
        tldm.configure_trainable()
        loss, _ = tldm.training_loss(_tb(_batch(4)), t=torch.full((B,), 10),
                                     noise=torch.zeros(B, 8, 8, 3))
        loss.backward()
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in per_step.items() if v}


@pytest.mark.parametrize("run", sorted(SMOKE_RUNS) + sorted(SMOKE_TRAIN_RUNS))
def test_smoke_counts_of_the_real_yaml(run):
    """The real YAML on the meta device: 16 self-attentions a UNet call, all
    of them short (N <= 1024) at 32 x 32 latents; the first stage's
    attention blocks 3 an encode, 4 a decode; a served batch is 2 frames of
    the run's DDIM chain."""
    ldm = _meta_mead128()
    assert ldm.image_size == 32
    assert chip_smoke.count_attentions(ldm.unet, ldm.image_size) == (16, 0)
    assert chip_smoke.count_head_widths(ldm.unet) == {32: 16}
    if run in SMOKE_RUNS:
        env = SMOKE_RUNS[run]
        calls = 2 * chip_smoke.SERVE_DDIM_STEPS[run]
        expect = chip_smoke.expected_launches(ldm, env, unet_calls=calls,
                                              encodes=2, decodes=2)
        want = ({"flash_attention_fproj": 16 * calls, "flash_attention": 14}
                if not env else {"flash_attention": 16 * calls + 14})
    else:
        env = SMOKE_TRAIN_RUNS[run]
        _, expect = chip_smoke.expected_train_launches(ldm, env, steps=1,
                                                       eval_batches=0)
        fwd, bwd = (("flash_attention_packed", "flash_attention_bwd_packed")
                    if not env else ("flash_attention", "flash_attention_bwd"))
        want = {fwd: 16, bwd: 16}
        want["flash_attention"] = want.get("flash_attention", 0) + 9
    assert {k: v for k, v in expect.items() if v} == want
