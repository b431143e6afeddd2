"""Rows 7 and 5 in fp32 at head width 32 on their Hopper design (the
split-head and streaming backwards on ``csrc/hopper_narrow_f32.cuh``: an
images launch, row 5's log-sum-exp grid, then the TF32 ``wgmma`` dk/dv and
dq grids), on the CPU.

Held here:

* the plain split-head and streaming backwards (what the card's kernels are
  held against) against the JAX package's ``flash_attention_bwd`` and
  ``flash_attention_streaming_bwd`` in interpret mode (jitted), fp32,
  D = 32, at the edges of the new grids: Nq = 65 against Nk = 129, Nk = 257,
  Nk < Nq, Nq < 64 < Nk and Nk < 64 < Nq. Tolerance 2e-5 absolute, as the
  fp32 backward tests' (sums of up to 257 fp32 terms in another order); the
  wrappers' CPU paths (the entries on CPU tensors and the autograd
  ``Function``) are the plain versions, bit for bit;
* ``narrow_f32_plan`` at every fp32 D = 32 row-7 and row-5 shape of
  ``chip_smoke.py``'s kernels phase: the log-sum-exp, dk/dv and dq grids
  cover every row and fit the SM as their launch bounds ask, the scratch
  holds the backward's images, and only where both lengths are at most 64
  the ``mma.sync`` grids stay; its constants and the log-sum-exp grid's
  shared memory against the header's;
* the two sources route fp32 D = 32 past that level to kernels of their
  own on the ``hnarrow_f32`` grids;
* both fp32 backward entries get the arguments ``_build.SIGNATURES``
  declares, with scratch of the plan's size (None where the plan keeps
  ``mma.sync``).
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

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_f32_wrappers import _Entry, _OnCard
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

D = 32
TOL = 2e-5

# (B, H, Nq, Nk): the edges of the new grids (one or two warpgroups a block,
# 64-row streamed tiles, 64-key tiles of the log-sum-exp grid)
EDGES = {"nq65-nk129": (1, 3, 65, 129), "nk257": (2, 2, 65, 257),
         "nk-lt-nq": (1, 3, 200, 129), "nq-lt-64-lt-nk": (2, 2, 50, 200),
         "nk-lt-64-lt-nq": (2, 2, 100, 50)}

_jax_bwd = jax.jit(functools.partial(jatt.flash_attention_bwd, block_q=64,
                                     interpret=True))
_jax_streaming = jax.jit(functools.partial(
    jatt.flash_attention_streaming, block_q=64, block_k=64, interpret=True))
_jax_streaming_bwd = jax.jit(functools.partial(
    jatt.flash_attention_streaming_bwd, block_q=64, block_k=64,
    interpret=True))


def _inputs(seed, b, h, nq, nk):
    """q, k, v, do [B, H, N, 32] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, D)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("edge", list(EDGES))
def test_plain_split_backwards_match_jax_kernels_at_the_grid_edges(edge):
    """Row 7: the plain backward against the resident JAX backward, and the
    autograd ``Function`` of ``flash_attention`` on CPU tensors equal to
    it. Row 5: the plain streaming backward against the JAX streaming
    backward, both on the JAX streaming forward's output, and the entry on
    CPU tensors equal to it."""
    b, h, nq, nk = EDGES[edge]
    q, k, v, do = _inputs(nq * 13 + nk, b, h, nq, nk)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    want = _jax_bwd(jq, jk, jv, jdo)
    plain = tatt.flash_attention_bwd_reference(tq, tk, tv, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    through = torch.autograd.grad(tatt.flash_attention(*leaves), leaves, tdo)
    for w, p, a in zip(want, plain, through):
        assert p.dtype == torch.float32
        _close(p.numpy(), w)
        assert torch.equal(p, a)

    o = _jax_streaming(jq, jk, jv)
    want = _jax_streaming_bwd(jq, jk, jv, o, jdo)
    to = torch.from_numpy(np.array(o))
    plain = tatt.streaming_bwd_reference(tq, tk, tv, to, tdo)
    entry = tatt.flash_attention_streaming_bwd(tq, tk, tv, to, tdo)
    for w, p, e in zip(want, plain, entry):
        _close(p.numpy(), w)
        assert torch.equal(p, e)


# every fp32 D = 32 shape of rows 7 and 5 in chip_smoke.py's kernels phase:
# (row, B, H, Nq, Nk)
_CASE = re.compile(r"_(flash|streaming)_bwd_case\(gen, (\d+), (\d+), (\d+), "
                   r"(\d+), 32, (?:True|False), f32")
SMOKE_SHAPES = sorted({(7 if row == "flash" else 5, *map(int, dims))
                       for row, *dims in _CASE.findall(
                           open(chip_smoke.__file__).read())})


def _source(name):
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def _constants(src):
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _lse_smem(wgs):
    """``hnarrow_f32::lse_smem`` as the header writes it, evaluated with the
    header's constants."""
    src = _source("hopper_narrow_f32.cuh")
    body = re.search(r"constexpr int lse_smem\(int wgs\) \{\s*return (.*?);",
                     src, re.S).group(1)
    return eval(" ".join(body.split()), {}, dict(_constants(src), wgs=wgs))


def test_plan_constants_are_the_headers():
    c = _constants(_source("hopper_narrow_f32.cuh"))
    assert (c["FWD_WG_PER_SM"], c["FWD_STAGES"], c["FWD_KEYS"],
            c["DKDV_STAGES"], c["DQ_STAGES"], c["STR"], c["MMA_SYNC_MAX"]) == (
        tatt.NARROW_F32_FWD_WG_PER_SM, tatt.NARROW_F32_FWD_STAGES,
        tatt.NARROW_F32_FWD_KEYS, tatt.NARROW_F32_DKDV_STAGES,
        tatt.NARROW_F32_DQ_STAGES, tatt.NARROW_F32_STREAMED,
        tatt.NARROW_F32_MMA_SYNC_MAX)
    for nq, wgs in ((1024, 2), (50, 1)):
        assert tatt.narrow_f32_plan(1, nq, 200).lse[2] == _lse_smem(wgs)


def test_the_smoke_shapes_are_read():
    """The kernels phase's new edges are among the shapes read."""
    assert {(7, 1, 2, 100, 2000), (7, 2, 3, 200, 129), (7, 2, 2, 50, 200),
            (7, 2, 2, 100, 50), (5, 2, 2, 50, 200), (7, 32, 5, 1024, 1024),
            (5, 32, 5, 1024, 1024)} <= set(SMOKE_SHAPES)


@pytest.mark.parametrize("shape", SMOKE_SHAPES,
                         ids=lambda s: "row%d-%s" % (s[0], "-".join(
                             map(str, s[1:]))))
def test_backward_grids_at_every_smoke_shape(shape):
    """One or two warpgroups of 64 rows a block cover every query (the
    log-sum-exp and dq grids) and every key (dk/dv); the log-sum-exp grid
    fits the blocks an SM its launch bounds ask (six warpgroups), the
    gradient grids two blocks; the scratch holds q, q^T, do, do^T at the
    padded Nq and k, k^T, v at the padded Nk; only where both lengths are
    at most 64 the mma.sync grids stay (the N = 64 level of a step)."""
    _, b, h, nq, nk = shape
    bh = b * h
    plan = tatt.narrow_f32_plan(bh, nq, nk)
    assert plan.mma_sync == (nq <= 64 and nk <= 64)
    assert plan.mma_sync == ((nq, nk) == (64, 64))
    sm = _constants(_source("hopper_narrow_f32.cuh"))["SM_SHARED"]
    for (blocks, threads, smem), n, per_sm in (
            (plan.lse, nq, None), (plan.dkdv, nk, 2), (plan.dq, nq, 2)):
        wgs = threads // 128
        rows = wgs * 64
        assert threads == (256 if n > 64 else 128)
        assert blocks == bh * -(-n // rows) and (blocks // bh - 1) * rows < n
        assert smem <= tatt.SHARED_MEMORY_PER_BLOCK
        if per_sm is None:   # lse_min_blocks
            per_sm = min(tatt.NARROW_F32_FWD_WG_PER_SM // wgs,
                         sm // (smem + 1024))
            assert per_sm == tatt.NARROW_F32_FWD_WG_PER_SM // wgs
        assert per_sm * (smem + 1024) <= sm
    assert plan.lse[:2] == plan.dq[:2]
    npq, npk = plan.padded
    assert nq <= npq < nq + 64 and nk <= npk < nk + 64
    assert plan.bwd_scratch == bh * D * (4 * npq + 3 * npk)


def test_sources_route_past_the_mma_sync_level_to_kernels_of_their_own():
    """Past N = 64 row 7 launches split_bwd_*_f32_kernel and row 5
    streaming_bwd_*_f32_kernel (its log-sum-exp grid included) on the
    hnarrow_f32 grids, with no atomics and no library call; the mma.sync
    grids stay behind keeps_mma_sync."""
    for name, prefix, lse in (("flash_attention_bwd.cu", "split_bwd", False),
                              ("flash_attention_streaming_bwd.cu",
                               "streaming_bwd", True)):
        src = _source(name)
        kinds = ["images", "dkdv", "dq"] + (["lse"] if lse else [])
        for kind in kinds:
            assert f"{prefix}_{kind}_f32_kernel" in src, (name, kind)
        assert "hnarrow_f32::keeps_mma_sync(nq, nk)" in src
        assert "hnarrow_f32::launch_bwd<" in src
        for banned in ("atomicAdd", "cublas", "cudnn"):
            assert banned not in src
    header = _source("hopper_narrow_f32.cuh")
    assert "lse_block" in header and "atomicAdd" not in header
    assert "float mul;" in header


@pytest.fixture
def recording_entry(monkeypatch):
    """A fake library whose every entry records its arguments, the stream
    7, and torch.empty on the host keeping what it made."""
    for kernel in ("flash_attention_bwd", "flash_attention_streaming_bwd"):
        monkeypatch.setitem(tatt.LAUNCHES, kernel, 0)   # restored after
    entry = _Entry()
    monkeypatch.setattr(_build, "load", lambda: type(
        "Lib", (), {"__getattr__": lambda self, name: entry})())
    monkeypatch.setattr(tatt, "current_stream", lambda t: 7)
    empty, made = torch.empty, []

    def host_empty(*a, device=None, **kw):
        out = empty(*a, **kw)
        made.append(out)
        return out
    monkeypatch.setattr(torch, "empty", host_empty)

    def numel(ptr):
        return None if ptr is None else [t.numel() for t in made
                                         if t.data_ptr() == ptr]
    entry.numel = numel
    return entry


@pytest.mark.parametrize("shape", [(2, 5, 333, 77), (32, 20, 64, 64),
                                   (2, 2, 50, 200), (1, 2, 100, 2000)],
                         ids=["images", "mma-sync", "edges", "long-k"])
def test_fp32_backward_entries_get_their_declared_arguments(shape,
                                                            recording_entry):
    """Both fp32 backwards: the plan's images as scratch just before the
    stream (None where the plan keeps the mma.sync grids); heads, lengths,
    width and scale in their places; row 5's folded factor after the
    scale."""
    b, h, nq, nk = shape
    entry = recording_entry
    plan = tatt.narrow_f32_plan(b * h, nq, nk)
    want = None if plan.mma_sync else [plan.bwd_scratch]
    q = torch.zeros(b, h, nq, D).as_subclass(_OnCard)
    k = torch.zeros(b, h, nk, D).as_subclass(_OnCard)
    lse = torch.zeros(b * h * nq).as_subclass(_OnCard)
    tatt.flash_attention_bwd(q, k, k, q, lse, q, 0.1)
    args = entry.calls[-1]
    assert len(args) == len(_build.SIGNATURES["dsml_flash_attention_bwd_f32"])
    assert args[10:15] == (b * h, nq, nk, D, 0.1) and args[-1] == 7
    assert entry.numel(args[-2]) == want
    tatt.flash_attention_streaming_bwd(q, k, k, q, q, 0.1)
    args = entry.calls[-1]
    assert len(args) == len(
        _build.SIGNATURES["dsml_flash_attention_streaming_bwd_f32"])
    assert args[10:16] == (b * h, nq, nk, D, 0.1,
                           tatt._folded_factor(0.1, torch.float32))
    assert args[-1] == 7 and entry.numel(args[-2]) == want
    assert entry.numel(args[5]) == [b * h * nq]   # the lse it writes
    assert tatt.LAUNCHES["flash_attention_bwd"] == 1
    assert tatt.LAUNCHES["flash_attention_streaming_bwd"] == 1
