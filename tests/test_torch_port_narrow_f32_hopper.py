"""Rows 3 and 8 in fp32 at head width 32 on their Hopper design
(``csrc/hopper_narrow_f32.cuh``: an images launch, then TF32 ``wgmma``
grids), on the CPU.

Held here:

* the plain packed forward, its row log-sum-exp and the plain packed
  backward (what the card's kernels are held against) against the JAX
  package's kernels in interpret mode, fp32, D = 32, at the edges of the new
  grids' tiles: Nk = 129 and 257 (a key past one and two 128-key spans of
  two 64-key tiles), Nq = 65 (a query past one warpgroup), odd head counts,
  Nk < Nq, Nk < 64. Tolerance 2e-5 absolute, the fp32 backward tests'
  (sums of up to 257 fp32 terms in another order);
* ``narrow_f32_plan`` at every shape ``chip_smoke.py`` and the mead-128
  training runs give the two rows: grids, two blocks an SM, scratch, and
  the ``mma.sync`` grids kept only at the N = 64 level; its constants
  against the header's;
* both fp32 entries get the arguments their C signatures declare (scratch
  of the plan's size, none where the plan keeps the ``mma.sync`` grids),
  the bf16 entries none;
* ``expected_train_launches`` of ``train-mead128`` on the real YAML (meta
  device): the images launch is inside the wrappers, whose calls
  ``LAUNCHES`` counts, so the counts stay 16 and 16 a step.
"""
import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_f32_wrappers import _Entry, _OnCard
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

D = 32
TOL = 2e-5

# (B, Nq, Nk, heads): the edges of the new grids' tiles
EDGES = {"nq65-nk129": (1, 65, 129, 3), "nk257": (2, 65, 257, 5),
         "nk-lt-nq": (1, 200, 129, 3), "nk-lt-64": (2, 100, 50, 3)}


def _packed(seed, b, nq, nk, heads):
    """q, k, v, do [B, N, heads * 32] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, heads * D)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _jax_lse(q, k, heads):
    """The JAX package's row log-sum-exp kernel (its streaming backward's
    recompute pass, in interpret mode) on the heads of packed q and k:
    [B*H*Nq], log2 domain, scores times scale * log2(e)."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    split = lambda t, n: jnp.asarray(
        t.reshape(b, n, heads, D).transpose(0, 2, 1, 3).reshape(b * heads,
                                                                 n, D))
    lse = pl.pallas_call(
        functools.partial(jatt._streaming_lse_kernel, scale=D ** -0.5, nk=nk,
                          block_k=nk),
        out_shape=jax.ShapeDtypeStruct((b * heads, nq, 1), jnp.float32),
        grid=(b * heads, 1, 1),
        in_specs=[pl.BlockSpec((1, nq, D), lambda i, jq, jk: (i, jq, 0)),
                  pl.BlockSpec((1, nk, D), lambda i, jq, jk: (i, jk, 0))],
        out_specs=pl.BlockSpec((1, nq, 1), lambda i, jq, jk: (i, jq, 0)),
        scratch_shapes=[pltpu.VMEM((nq, 1), jnp.float32),
                        pltpu.VMEM((nq, 1), jnp.float32)],
        interpret=True,
    )(split(q, nq), split(k, nk))
    return np.asarray(lse).reshape(-1)


@pytest.mark.parametrize("edge", list(EDGES))
def test_plain_packed_rows_match_jax_kernels_at_the_tile_edges(edge):
    """The plain forward, its log-sum-exp and the plain backward against
    the JAX packed kernels (and its log-sum-exp kernel) in interpret mode;
    the wrapper's CPU path (the autograd Function) is the plain version."""
    b, nq, nk, heads = EDGES[edge]
    q, k, v, do = _packed(nq * 7 + nk, b, nq, nk, heads)
    jx = lambda *a: [jnp.asarray(x) for x in a]
    t = lambda *a: [torch.from_numpy(x) for x in a]
    want = jatt.flash_attention_packed(*jx(q, k, v), heads, block_q=64,
                                       interpret=True)
    plain = tatt.packed_reference(*t(q, k, v), heads)
    _close(plain.numpy(), want)
    _close(tatt.packed_lse_reference(*t(q, k), heads).numpy(),
           _jax_lse(q, k, heads))
    want_g = jatt.flash_attention_bwd_packed(*jx(q, k, v, do), heads,
                                             block_q=64, interpret=True)
    plain_g = tatt.packed_bwd_reference(*t(q, k, v, do), heads)
    leaves = [x.requires_grad_() for x in t(q, k, v)]
    through = torch.autograd.grad(tatt.flash_attention_packed(*leaves, heads),
                                  leaves, torch.from_numpy(do))
    for w, p, a in zip(want_g, plain_g, through):
        _close(p.numpy(), w)
        assert torch.equal(p, a)


# every fp32 D = 32 packed shape of chip_smoke.py's kernels phase and of the
# mead-128 training runs (batch 32 at N = 1024 / 5 heads, 256 / 10, 64 / 20):
# (B, Nq, Nk, heads)
SHAPES = ((32, 1024, 1024, 5), (32, 256, 256, 10), (32, 64, 64, 20),
          (2, 1000, 1000, 5), (2, 333, 77, 10), (2, 200, 129, 5),
          (2, 200, 257, 5), (3, 65, 129, 5), (2, 100, 50, 3))
SM_SHARED = 233472   # bytes of shared memory an SM, 1 KB of it a block's


def _header_constants():
    src = open(os.path.join(_build.CSRC_DIR, "hopper_narrow_f32.cuh")).read()
    return {name: int(value) for name, value in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_plan_constants_are_the_headers():
    c = _header_constants()
    assert (c["D"], c["PAD"], c["WG_ROWS"], c["FWD_KEYS"], c["FWD_STAGES"],
            c["DKDV_STAGES"], c["DQ_STAGES"], c["STR"], c["IMG_ROWS"],
            c["MMA_SYNC_MAX"], c["FWD_WG_PER_SM"]) == (
        tatt.NARROW_F32_HEAD_DIM, tatt.NARROW_F32_PAD,
        tatt.NARROW_F32_WG_ROWS, tatt.NARROW_F32_FWD_KEYS,
        tatt.NARROW_F32_FWD_STAGES, tatt.NARROW_F32_DKDV_STAGES,
        tatt.NARROW_F32_DQ_STAGES, tatt.NARROW_F32_STREAMED,
        tatt.NARROW_F32_IMG_ROWS, tatt.NARROW_F32_MMA_SYNC_MAX,
        tatt.NARROW_F32_FWD_WG_PER_SM)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plan_at_every_shape_of_the_two_rows(shape):
    """Blocks cover every row with one or two warpgroups of 64, each grid
    fits two blocks an SM (the forward's of two warpgroups three, as its
    launch bounds ask), the scratch holds the images at the padded lengths,
    and only the N = 64 level keeps the mma.sync grids."""
    b, nq, nk, heads = shape
    bh = b * heads
    plan = tatt.narrow_f32_plan(bh, nq, nk)
    npq, npk = plan.padded
    assert npq % 64 == 0 and npk % 64 == 0
    assert nq <= npq < nq + 64 and nk <= npk < nk + 64
    assert plan.mma_sync == (nq <= 64 and nk <= 64)
    assert plan.mma_sync == (shape == (32, 64, 64, 20))
    for (blocks, threads, *rest), n, fwd in ((plan.fwd, nq, True),
                                             (plan.dkdv, nk, False),
                                             (plan.dq, nq, False)):
        rows = threads // 128 * 64
        assert threads == (256 if n > 64 else 128)
        assert blocks == bh * -(-n // rows) and (blocks / bh - 1) * rows < n
        smem = rest[-1]
        assert smem <= tatt.SHARED_MEMORY_PER_BLOCK
        per_sm = (tatt.NARROW_F32_FWD_WG_PER_SM // 2 if fwd and threads == 256
                  else 2)
        assert per_sm * (smem + 1024) <= SM_SHARED
    assert plan.fwd[2] == 64
    assert plan.fwd_scratch == 2 * bh * npk * D
    assert plan.bwd_scratch == bh * D * (4 * npq + 3 * npk)


@pytest.fixture
def recording_entry(monkeypatch):
    """A fake library whose every entry records its arguments, the stream
    7, and torch.empty on the host recording the sizes asked for."""
    for kernel in ("flash_attention_packed", "flash_attention_bwd_packed"):
        monkeypatch.setitem(tatt.LAUNCHES, kernel, 0)   # restored after
    entry = _Entry()
    monkeypatch.setattr(_build, "load", lambda: type(
        "Lib", (), {"__getattr__": lambda self, name: entry})())
    monkeypatch.setattr(tatt, "current_stream", lambda t: 7)
    empty, sizes = torch.empty, []

    def host_empty(*a, device=None, **kw):
        out = empty(*a, **kw)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(torch, "empty", host_empty)
    entry.sizes = sizes
    return entry


@pytest.mark.parametrize("shape", [(2, 333, 77, 10), (32, 64, 64, 20),
                                   (3, 65, 129, 5)],
                         ids=["images", "mma-sync", "edges"])
def test_fp32_entries_get_their_declared_arguments(shape, recording_entry):
    """fp32: the forward's scratch after lse, the backward's before the
    stream, each of the plan's size (None where the plan keeps the mma.sync
    grids); the head count, lengths and width in their places."""
    b, nq, nk, heads = shape
    entry = recording_entry
    plan = tatt.narrow_f32_plan(b * heads, nq, nk)
    q = torch.zeros(b, nq, heads * D).as_subclass(_OnCard)
    k = torch.zeros(b, nk, heads * D).as_subclass(_OnCard)
    out, lse = tatt._launch_packed_forward(q, k, k, heads, 0.1, True)
    args = entry.calls[-1]
    assert len(args) == len(_build.SIGNATURES[
        "dsml_flash_attention_packed_f32"])
    assert args[6:11] == (b, nq, nk, heads, D) and args[-1] == 7
    assert (args[5] is None) == plan.mma_sync
    assert plan.mma_sync or plan.fwd_scratch in entry.sizes
    tatt.flash_attention_bwd_packed(q, k, k, out, lse.as_subclass(_OnCard),
                                    q, heads, 0.1)
    args = entry.calls[-1]
    assert len(args) == len(_build.SIGNATURES[
        "dsml_flash_attention_bwd_packed_f32"])
    assert args[10:15] == (b, nq, nk, heads, D) and args[-1] == 7
    assert (args[-2] is None) == plan.mma_sync
    assert plan.mma_sync or plan.bwd_scratch in entry.sizes
    assert tatt.LAUNCHES["flash_attention_packed"] == 1
    assert tatt.LAUNCHES["flash_attention_bwd_packed"] == 1


def test_bf16_entries_take_no_scratch(recording_entry):
    b, n, heads = 2, 100, 5
    q = torch.zeros(b, n, heads * D, dtype=torch.bfloat16).as_subclass(
        _OnCard)
    out, lse = tatt._launch_packed_forward(q, q, q, heads, 0.1, True)
    assert len(recording_entry.calls[-1]) == len(
        _build.SIGNATURES["dsml_flash_attention_packed"])
    tatt.flash_attention_bwd_packed(q, q, q, out, lse.as_subclass(_OnCard),
                                    q, heads, 0.1)
    assert len(recording_entry.calls[-1]) == len(
        _build.SIGNATURES["dsml_flash_attention_bwd_packed"])


def test_train_mead128_launch_counts_are_unchanged():
    """The real YAML on the meta device: a train-mead128 step is 16 packed
    forwards and 16 packed backwards (every self-attention of the UNet) and
    9 first-stage D = 512 forwards, whatever launches each wrapper makes."""
    cfg = load_config([chip_smoke.CONFIG_128])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    _, per_step = chip_smoke.expected_train_launches(ldm, {}, steps=1,
                                                     eval_batches=0)
    assert {k: v for k, v in per_step.items() if v} == {
        "flash_attention_packed": 16, "flash_attention_bwd_packed": 16,
        "flash_attention": 9}
