"""Training ``mead-256-ldm-f4-fullattn-dh64.yaml`` on the card: the attention
at 80-wide heads (its level-0 heads: 160 channels, 2 heads under the legacy
head-width rule) through every kernel a training step reaches, on the CPU.

* The plain versions (what each op runs on a CPU tensor, and what its CUDA
  kernel is held against on the card) against the JAX package's Pallas
  kernels in interpret mode at head width 80: the split-head forward and
  backward and the packed backward in fp32 (2e-5 absolute, the tolerance of
  the other attention tests: the same sums in another order), the streaming
  forward and backward in bf16 (2e-2 of each output's maximum: bf16 keeps 8
  bits and both sides round q times the folded scale, the probabilities and
  the outputs), each at a square shape, at Nk != Nq and with a ragged tail.
* Admission: every shipped two-conditioning MEAD config, built on the meta
  device in training mode, under each of the three attention routes
  (packed; ``DSML_ATTN_PACKED=0``; and with ``DSML_FLASH_STREAMING=1``):
  every attention a UNet step of the four bf16 configs sends to a kernel is
  one whose forward and backward kernels both take it. ``mead-128-ldm-f4``
  computes its UNet in fp32, at 32-wide heads: the packed, split-head and
  streaming kernels take it (their fp32 D = 32 instantiations), forward and
  backward, and each route's wrapper picks the ``_f32`` entry point.
* One train step of a tiny two-conditioning MEAD model whose transformer has
  2 heads of 80, against the JAX step with its kernels in interpret mode
  (``DSML_FLASH_INTERPRET=1``): loss 1e-5, every gradient leaf 1e-4 of its
  own maximum, as ``test_torch_port_training.py``.
* ``chip_smoke.py``'s launch arithmetic of the new train runs and of the
  split-head serve run, from the real YAML on the meta device against spies
  on the attention dispatch.
"""
from __future__ import annotations

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
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.convert import from_jax_params, to_jax_params
from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_ldm import TINY_MEAD_CFG
from test_torch_port_pipeline import random_params
from test_torch_port_training import (_batch, _jax_draws, _jb, _leaves, _tb)
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs", "latent-diffusion")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

SHAPES = {"square": (1, 2, 128, 128), "cross-nk-ne-nq": (2, 2, 100, 37),
          "ragged-tail": (1, 3, 130, 70)}
D = 80


def _inputs(seed, b, h, nq, nk, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


def _packed(a):
    """[B, H, N, D] -> [B, N, H*D]."""
    b, h, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d))


def _grads(fn, q, k, v, do):
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(do))


# --------------------------------------------------------------------------
# plain versions against the JAX kernels at D = 80
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_flash_forward_matches_jax_at_80(shape):
    q, k, v, _ = _inputs(21, *shape)
    want = np.asarray(jatt.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=64, interpret=True))
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_flash_backward_matches_jax_at_80(shape):
    """The split-head op's gradient through its autograd Function."""
    q, k, v, do = _inputs(22, *shape)
    want = jatt.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)),
                                    block_q=64, interpret=True)
    got = _grads(tatt.flash_attention, q, k, v, do)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_packed_backward_matches_jax_at_80(shape):
    """The packed op's gradient through its autograd Function (the default
    training route)."""
    b, heads, nq, nk = shape
    q, k, v, do = map(_packed, _inputs(23, *shape))
    want = jatt.flash_attention_bwd_packed(
        *map(jnp.asarray, (q, k, v, do)), heads, block_q=64, interpret=True)
    got = _grads(lambda *t: tatt.packed_multi_head_attention(*t, heads),
                 q, k, v, do)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=0)


class _OnCard(torch.Tensor):
    """A tensor that says it lies on a CUDA device (this machine has none)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _bf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).bfloat16()


def _close_bf16(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_streaming_forward_matches_jax_at_80(shape):
    q, k, v, _ = _inputs(24, *shape)
    want = jatt.flash_attention_streaming(_bf(q), _bf(k), _bf(v), block_q=32,
                                          block_k=128, interpret=True)
    got = tatt.flash_attention_streaming(_tbf(q), _tbf(k), _tbf(v))
    _close_bf16(got, want)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_streaming_backward_matches_jax_at_80(shape):
    q, k, v, do = _inputs(25, *shape)
    o = jatt.flash_attention_streaming(_bf(q), _bf(k), _bf(v), block_q=32,
                                       block_k=128, interpret=True)
    want = jatt.flash_attention_streaming_bwd(
        _bf(q), _bf(k), _bf(v), o, _bf(do), block_q=32, block_k=128,
        interpret=True)
    got = tatt.flash_attention_streaming_bwd(_tbf(q), _tbf(k), _tbf(v),
                                             _tbf(o), _tbf(do))
    for g, w_ in zip(got, want):
        _close_bf16(g, w_)


# --------------------------------------------------------------------------
# admission: every attention of a training step, every shipped 2-cond config
# --------------------------------------------------------------------------

CONFIGS = ("mead-256-ldm-f4.yaml", "mead-256-ldm-f4-dh64.yaml",
           "mead-256-ldm-f4-fullattn.yaml",
           "mead-256-ldm-f4-fullattn-dh64.yaml")
ROUTES = {"packed": {}, "split": {"DSML_ATTN_PACKED": "0"},
          "streaming": {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}}
# the head widths of each config's UNet self-attentions
WIDTHS = {"mead-256-ldm-f4.yaml": {32}, "mead-256-ldm-f4-dh64.yaml": {64},
          "mead-256-ldm-f4-fullattn.yaml": {32},
          "mead-256-ldm-f4-fullattn-dh64.yaml": {80, 64}}


@functools.lru_cache(maxsize=None)
def _meta_ldm(name):
    cfg = load_config([os.path.join(CONFIG_DIR, name)])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    return cfg, ldm


def _step_attentions(name, env, monkeypatch):
    """Runs every attention module of the UNet of config ``name`` (meta
    device, training mode, bf16 activations at the latent's sequence
    lengths) under the flags ``env`` with the attention dispatch spied on.
    Returns [(op, Nq, Nk, head width, dtype)] of the calls, and the UNet."""
    cfg, ldm = _meta_ldm(name)
    unet = ldm.unet.train()
    latent = cfg["model"]["params"]["unet_config"]["params"]["image_size"]
    calls = []

    def spy(op):
        def call(q, k, v, *args, **kwargs):
            if q.dim() == 4:   # split heads [B, H, N, D]
                calls.append((op, q.shape[2], k.shape[2], q.shape[-1],
                              q.dtype))
            else:              # packed [B, N, H*D] with the heads
                heads = args[0] if args else kwargs["heads"]
                calls.append((op, q.shape[1], k.shape[1],
                              q.shape[-1] // heads, q.dtype))
            return torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return call

    def refuse(*args, **kwargs):
        raise AssertionError("a fused eval-mode op in a training step")

    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tunet, "packed_multi_head_attention", spy("packed"))
    monkeypatch.setattr(tunet, "multi_head_attention", spy("split"))
    monkeypatch.setattr(tunet, "flash_attention_fproj", refuse)
    monkeypatch.setattr(tunet, "fused_qout_self_attention", refuse)
    ds = {unet.model_channels * m: 2 ** i
          for i, m in enumerate(unet.channel_mult)}
    for m in unet.modules():
        if isinstance(m, tunet.SpatialTransformer):
            n = (latent // ds[m.proj_in.in_channels]) ** 2
            for blk in range(m.depth):
                block = getattr(m, f"block_{blk}")
                c = block.attn1.to_q.in_features
                x = torch.empty(2, n, c, dtype=torch.bfloat16, device="meta")
                assert block.attn1(x).shape == x.shape
                # the one-token conditioning: no kernel
                ctx = torch.empty(2, 1, block.attn2.to_k.in_features,
                                  dtype=torch.bfloat16, device="meta")
                assert block.attn2(x, context=ctx).shape == x.shape
    return calls, unet


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", CONFIGS)
def test_every_training_attention_is_taken_forward_and_backward(
        name, route, monkeypatch):
    env = ROUTES[route]
    calls, unet = _step_attentions(name, env, monkeypatch)
    assert len(calls) == sum(chip_smoke.count_head_widths(unet).values())
    assert {d for *_, d, _ in calls} == WIDTHS[name]
    for op, nq, nk, d, dtype in calls:
        assert dtype == torch.bfloat16
        if route == "packed":
            assert op == "packed"
            assert tatt.packed_kernel_takes(d, dtype), (name, d)
            assert tatt.packed_bwd_kernel_takes(d, dtype), (name, d)
            continue
        assert op == "split"
        streams = route == "streaming" or tatt.streaming_auto(nq, nk, d)
        takes = (tatt.streaming_kernel_takes if streams
                 else tatt.flash_kernel_takes)
        assert takes(d, dtype) and takes(d, dtype, backward=True), (name, d)


@pytest.mark.parametrize("route", list(ROUTES))
def test_mead_128_computes_in_fp32_which_no_kernel_takes(route, monkeypatch):
    """mead-128-ldm-f4 sets no UNet dtype: its self-attentions (N = 1024,
    256, 64 at 32-wide heads) run in fp32, as in the JAX package. The packed,
    split-head and streaming kernels and their backward kernels take fp32 at
    D = 32 (``csrc/attention_f32_narrow.cuh``), so a training step of every
    route is admitted forward and backward, through the ``_f32`` entry
    points. (The test's name is older than the streaming pair's fp32 D = 32
    instantiation.)"""
    name = "mead-128-ldm-f4.yaml"
    calls, _ = _step_attentions(name, ROUTES[route], monkeypatch)
    assert len(calls) == 16 and {c[1] for c in calls} == {1024, 256, 64}
    for op, nq, nk, d, dtype in calls:
        assert (op, d, dtype) == ("packed" if route == "packed" else "split",
                                  32, torch.float32)
        if route == "packed":
            assert tatt.packed_kernel_takes(d, dtype)
            assert tatt.packed_bwd_kernel_takes(d, dtype)
        elif route == "split":
            assert not tatt.streaming_auto(nq, nk, d)
            assert tatt.flash_kernel_takes(d, dtype)
            assert tatt.flash_kernel_takes(d, dtype, backward=True)
        else:
            assert tatt.streaming_kernel_takes(d, dtype)
            assert tatt.streaming_kernel_takes(d, dtype, backward=True)
    # the entry points exist: the wrappers go on to build the library
    q = torch.zeros(1, 1, 64, 32).as_subclass(_OnCard)
    kernels = {"packed": ("flash_attention_packed",
                          "flash_attention_bwd_packed"),
               "split": ("flash_attention", "flash_attention_bwd"),
               "streaming": ("flash_attention_streaming",
                             "flash_attention_streaming_bwd")}[route]
    for kernel in kernels:
        assert tatt._entry(kernel, q, 32) == f"dsml_{kernel}_f32"


@pytest.mark.parametrize("d,dtype,fwd,bwd", [
    (80, torch.bfloat16, True, True), (64, torch.bfloat16, True, True),
    (512, torch.bfloat16, True, False), (512, torch.float32, True, True),
    (80, torch.float32, False, False), (128, torch.bfloat16, False, False),
    (16, torch.bfloat16, False, False)])
def test_split_head_predicates(d, dtype, fwd, bwd):
    for takes in (tatt.flash_kernel_takes, tatt.streaming_kernel_takes):
        assert takes(d, dtype) is fwd
        assert takes(d, dtype, backward=True) is bwd
    assert tatt.packed_bwd_kernel_takes(d, dtype) is (
        dtype == torch.bfloat16 and d in (32, 64, 80))


def test_a_cuda_tensor_no_kernel_takes_raises():
    """No fallback on the card: a head width no kernel has raises before any
    build, forward and backward, whatever the route."""
    q = torch.zeros(1, 1, 8, 96, dtype=torch.bfloat16).as_subclass(_OnCard)
    for fn in (tatt._launch_flash_forward, tatt._launch_streaming_forward):
        with pytest.raises(ValueError, match="head width 96"):
            fn(q, q, q, 0.1, *((True,) if fn is tatt._launch_flash_forward
                               else ()))
    lse = torch.zeros(8, dtype=torch.float32).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="head width 96"):
        tatt.flash_attention_bwd(q, q, q, q, lse, q, 0.1)
    p = torch.zeros(1, 8, 192, dtype=torch.bfloat16).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="head width 96"):
        tatt.flash_attention_bwd_packed(p, p, p, p, lse, p, 2, 0.1)


# --------------------------------------------------------------------------
# a train step of a tiny model with 80-wide heads against the JAX step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dh80():
    """The tiny 2-cond MEAD model of the other training tests with one UNet
    level of 160 channels and num_head_channels 64: 2 heads of 80 under the
    legacy rule, at N = 64."""
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    unet = cfg["model"]["params"]["unet_config"]["params"]
    unet.update(model_channels=160, num_head_channels=64, channel_mult=[1],
                attention_resolutions=[1])
    cfg["model"]["params"]["cond_stage_config_1"]["params"]["p_uncond"] = 0.0
    jldm = jax_build_model(cfg["model"])
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), _jb(_batch(0)))
    params = random_params(params, np.random.default_rng(1))
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    assert {m.block_0.attn1.dim_head for m in tldm.unet.modules()
            if isinstance(m, tunet.SpatialTransformer)} == {80}
    return jldm, params, tldm


@pytest.mark.parametrize("route", ["packed", "split"])
def test_train_step_with_80_wide_heads_matches_jax(tiny_dh80, route,
                                                   monkeypatch):
    """Loss and every gradient leaf of one batch, the JAX side's packed (or
    split-head) attention forward and backward kernels in interpret mode."""
    jldm, params, tldm = tiny_dh80
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    batch, rng = _batch(3), jax.random.PRNGKey(9)
    # jitted: one compile, where the eager gradient runs every interpret-mode
    # kernel op by op
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jldm.training_loss(p, _jb(batch), rng), has_aux=True))(params)
    t, noise = _jax_draws(rng)
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
    assert any("attn1" in k for k in got_l) and len(got_l) > 50
    for k, g in got_l.items():
        np.testing.assert_allclose(
            g, want_l[k], rtol=0, err_msg=k,
            atol=max(1e-4 * np.abs(want_l[k]).max(), 1e-6 * top))


# --------------------------------------------------------------------------
# chip_smoke.py's launch arithmetic of the new runs
# --------------------------------------------------------------------------

TRAIN_RUNS = {name: env for name, config, env, _ in chip_smoke.TRAIN_RUNS
              if config == chip_smoke.CONFIG_DH64}


@pytest.mark.parametrize("run", sorted(TRAIN_RUNS))
def test_smoke_train_launches_of_the_dh64_runs(run, monkeypatch):
    """A step's launches as ``expected_train_launches`` counts them from the
    real model on the meta device, against the self-attentions the spied
    dispatch sees there: forward and backward once each (the backward at
    head width 80 five times), the first stage's nine forward launches."""
    env = TRAIN_RUNS[run]
    name = "mead-256-ldm-f4-fullattn-dh64.yaml"
    calls, unet = _step_attentions(name, env, monkeypatch)
    _, ldm = _meta_ldm(name)
    runs, per_step = chip_smoke.expected_train_launches(ldm, env, steps=2,
                                                        eval_batches=1)
    n = len(calls)
    assert n == 16 and chip_smoke.count_head_widths(unet) == {80: 5, 64: 11}
    bwd = chip_smoke.backward_kernel(env)
    fwd = {"flash_attention_bwd_packed": "flash_attention_packed",
           "flash_attention_bwd": "flash_attention",
           "flash_attention_streaming_bwd": "flash_attention_streaming"}[bwd]
    first_stage = "flash_attention_streaming" if "DSML_FLASH_STREAMING" in env \
        else "flash_attention"
    want = {bwd: n}
    want[fwd] = want.get(fwd, 0) + n
    want[first_stage] = want.get(first_stage, 0) + 9
    assert {k: v for k, v in per_step.items() if v} == want
    assert set(run for run, *_ in chip_smoke.TRAIN_RUNS) >= set(TRAIN_RUNS)
    assert runs[bwd] == 2 * n


def test_smoke_counts_the_split_head_dh64_serve_run(monkeypatch):
    """``fullattn-dh64-split``: every self-attention of a UNet call (11 at
    N <= 1024, 5 at N = 4096) through the split-head forward, none through
    the fused or packed kernels; a served batch is 2 frames of the run's
    DDIM chain."""
    env = {"DSML_ATTN_PACKED": "0"}
    assert ("fullattn-dh64-split", chip_smoke.CONFIG_DH64, env, 8) \
        in chip_smoke.RUNS
    calls = 2 * chip_smoke.SERVE_DDIM_STEPS["fullattn-dh64-split"]
    _, ldm = _meta_ldm("mead-256-ldm-f4-fullattn-dh64.yaml")
    expect = chip_smoke.expected_launches(ldm, env, unet_calls=calls,
                                          encodes=2, decodes=2)
    assert {k: v for k, v in expect.items() if v} == {
        "flash_attention": calls * 16 + 2 * 3 + 2 * 4}
