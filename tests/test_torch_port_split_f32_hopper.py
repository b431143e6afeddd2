"""Rows 2 and 4 in fp32 at head width 32 on their Hopper design (the split-head
and streaming forwards on ``csrc/hopper_narrow_f32.cuh``: an images launch,
then the TF32 ``wgmma`` forward, the streaming one with its own roundings and
its cut of the keys), on the CPU.

Held here:

* the plain split-head and streaming forwards and row 2's row log-sum-exp
  (what the card's kernels are held against) against the JAX package's
  ``flash_attention`` / ``flash_attention_streaming`` and its log-sum-exp
  kernel in interpret mode, fp32, D = 32, at the edges of the new grid's
  tiles: Nq = 65 (a query past one warpgroup), Nk = 129 and 257 (a key past
  one and two 128-key spans), Nk < Nq, Nk < 64, and a streaming shape whose
  keys the kernel cuts 32 ways. Tolerance 2e-5 absolute, as the packed fp32
  tests' (sums of up to 2,000 fp32 terms in another order);
* ``narrow_f32_plan`` at every fp32 D = 32 shape of ``chip_smoke.py``'s
  kernels phase and of the mead-128 flag runs: grids, the streaming
  forward's splits of the keys as ``flash_attention_streaming.cu`` cuts
  them, scratch, three blocks an SM, the ``mma.sync`` grids kept only where
  both lengths are at most 64; its constants against the sources';
* both fp32 forward entries get the arguments their C signatures declare,
  scratch of the plan's size (none where the plan keeps ``mma.sync``);
* ``expected_launches`` / ``expected_train_launches`` of the four mead-128
  flag runs on the real YAML (meta device): the images launch is inside the
  wrappers, whose calls ``LAUNCHES`` counts, so the counts stay.
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

# (B, H, Nq, Nk): the edges of the new grid's tiles, and a shape whose keys
# the streaming forward cuts over 32 blocks
EDGES = {"nq65-nk129": (1, 3, 65, 129), "nk257": (2, 2, 65, 257),
         "nk-lt-nq": (1, 3, 200, 129), "nk-lt-64": (2, 3, 100, 50),
         "split-32-ways": (1, 2, 100, 2000)}


def _split(seed, b, h, nq, nk):
    """q, k, v [B, H, N, 32] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, D)).astype(np.float32)
            for n in (nq, nk, nk)]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _jax_lse(q, k):
    """The JAX package's row log-sum-exp kernel (its streaming backward's
    recompute pass, in interpret mode) on split heads: [B*H*Nq], log2
    domain, scores times scale * log2(e)."""
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    lse = pl.pallas_call(
        functools.partial(jatt._streaming_lse_kernel, scale=D ** -0.5, nk=nk,
                          block_k=nk),
        out_shape=jax.ShapeDtypeStruct((b * h, nq, 1), jnp.float32),
        grid=(b * h, 1, 1),
        in_specs=[pl.BlockSpec((1, nq, D), lambda i, jq, jk: (i, jq, 0)),
                  pl.BlockSpec((1, nk, D), lambda i, jq, jk: (i, jk, 0))],
        out_specs=pl.BlockSpec((1, nq, 1), lambda i, jq, jk: (i, jq, 0)),
        scratch_shapes=[pltpu.VMEM((nq, 1), jnp.float32),
                        pltpu.VMEM((nq, 1), jnp.float32)],
        interpret=True,
    )(jnp.asarray(q.reshape(b * h, nq, D)), jnp.asarray(k.reshape(b * h, nk,
                                                                  D)))
    return np.asarray(lse).reshape(-1)


@pytest.mark.parametrize("edge", list(EDGES))
def test_plain_split_rows_match_jax_kernels_at_the_tile_edges(edge):
    """The plain split-head forward, its row log-sum-exp (the packed plain
    version on one head, as chip_smoke.py holds row 2's) and the plain
    streaming forward against the JAX kernels in interpret mode; the
    wrappers' CPU paths are the plain versions."""
    b, h, nq, nk = EDGES[edge]
    q, k, v = _split(nq * 11 + nk, b, h, nq, nk)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tatt.attention_reference(tq, tk, tv)
    _close(plain.numpy(),
           jatt.flash_attention(jq, jk, jv, block_q=64, interpret=True))
    assert torch.equal(tatt.flash_attention(tq, tk, tv), plain)
    lse = tatt.packed_lse_reference(tq.reshape(b * h, nq, D),
                                    tk.reshape(b * h, nk, D), 1)
    _close(lse.numpy(), _jax_lse(q, k))
    plain_s = tatt.streaming_attention_reference(tq, tk, tv)
    _close(plain_s.numpy(),
           jatt.flash_attention_streaming(jq, jk, jv, block_q=64,
                                          block_k=128, interpret=True))
    assert torch.equal(tatt.flash_attention_streaming(tq, tk, tv), plain_s)


# every fp32 D = 32 split-head shape of chip_smoke.py's kernels phase and of
# the mead-128 flag runs (training batch 32 at N = 1024 / 5 heads, 256 / 10,
# 64 / 20; served batch 16): (B, H, Nq, Nk)
SHAPES = ((32, 5, 1024, 1024), (32, 10, 256, 256), (32, 20, 64, 64),
          (16, 5, 1024, 1024), (16, 10, 256, 256), (16, 20, 64, 64),
          (2, 5, 333, 77), (2, 3, 200, 129), (3, 5, 65, 129),
          (2, 2, 100, 50), (12, 50, 60, 50), (1, 2, 100, 2000),
          (1, 2, 100, 5000), (2, 2, 1000, 333))
MEAD128 = {(32, 5, 1024, 1024), (32, 10, 256, 256), (32, 20, 64, 64),
           (16, 5, 1024, 1024), (16, 10, 256, 256), (16, 20, 64, 64)}


def _constants(name):
    src = open(os.path.join(_build.CSRC_DIR, name)).read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_plan_constants_are_the_sources():
    c = _constants("hopper_narrow_f32.cuh")
    assert (c["D"], c["PAD"], c["WG_ROWS"], c["FWD_KEYS"], c["FWD_STAGES"],
            c["MMA_SYNC_MAX"], c["FWD_WG_PER_SM"]) == (
        tatt.NARROW_F32_HEAD_DIM, tatt.NARROW_F32_PAD,
        tatt.NARROW_F32_WG_ROWS, tatt.NARROW_F32_FWD_KEYS,
        tatt.NARROW_F32_FWD_STAGES, tatt.NARROW_F32_MMA_SYNC_MAX,
        tatt.NARROW_F32_FWD_WG_PER_SM)
    s = _constants("flash_attention_streaming.cu")
    assert s["SPLIT_KEYS"] == tatt.STREAMING_TILE == s["SROWS"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_split_and_streaming_grids_at_every_shape(shape):
    """One or two warpgroups of 64 rows a block cover every query; the
    streaming forward's splits are the host's count, each a whole number of
    64-key units, none empty, together every key (``splits_ok``); three
    blocks an SM of either forward fit the SM's shared memory, as
    ``fwd_min_blocks`` asks; the scratch holds the K and V^T images at the
    padded length; only the N = 64 level keeps the mma.sync grids, and
    mead-128's shapes take one split."""
    b, h, nq, nk = shape
    bh = b * h
    splits = tatt.streaming_splits(bh, nq, nk)
    plan = tatt.narrow_f32_plan(bh, nq, nk, splits)
    assert plan.mma_sync == (nq <= 64 and nk <= 64)
    blocks, threads, keys, smem = plan.fwd
    rows = threads // 128 * 64
    assert threads == (256 if nq > 64 else 128) and keys == 64
    assert blocks == bh * -(-nq // rows) and (blocks // bh - 1) * rows < nq
    c = _constants("hopper_narrow_f32.cuh")
    per_sm = min(c["FWD_WG_PER_SM"] // (threads // 128),
                 c["SM_SHARED"] // (smem + 1024))
    assert per_sm == 3 and smem <= tatt.SHARED_MEMORY_PER_BLOCK
    assert plan.splits == splits <= 65535
    kps = plan.keys_per_split
    assert kps % tatt.STREAMING_TILE == 0
    assert (splits - 1) * kps < nk <= splits * kps
    if shape in MEAD128:
        assert splits == 1 and plan.mma_sync == (nq == 64)
    npk = plan.padded[1]
    assert nk <= npk < nk + 64 and plan.fwd_scratch == 2 * bh * npk * D


@pytest.fixture
def recording_entry(monkeypatch):
    """A fake library whose every entry records its arguments, the stream
    7, and torch.empty on the host keeping what it made."""
    for kernel in ("flash_attention", "flash_attention_streaming"):
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


@pytest.mark.parametrize("shape", [(2, 5, 333, 77), (16, 20, 64, 64),
                                   (3, 5, 65, 129), (1, 2, 100, 2000)],
                         ids=["images", "mma-sync", "edges", "splits"])
def test_fp32_entries_get_their_declared_arguments(shape, recording_entry):
    """Both fp32 forwards: scratch of the plan's size after the outputs
    (None where the plan keeps the mma.sync grids); the streaming one's
    partial outputs sized by its splits; heads, lengths, width and splits
    in their places."""
    b, h, nq, nk = shape
    entry = recording_entry
    splits = tatt.streaming_splits(b * h, nq, nk)
    plan = tatt.narrow_f32_plan(b * h, nq, nk, splits)
    want = None if plan.mma_sync else [plan.fwd_scratch]
    q = torch.zeros(b, h, nq, D).as_subclass(_OnCard)
    k = torch.zeros(b, h, nk, D).as_subclass(_OnCard)
    tatt._launch_flash_forward(q, k, k, 0.1, True)
    args = entry.calls[-1]
    assert len(args) == len(_build.SIGNATURES["dsml_flash_attention_f32"])
    assert args[6:10] == (b * h, nq, nk, D) and args[-1] == 7
    assert entry.numel(args[5]) == want
    assert entry.numel(args[4]) == [b * h * nq]   # the row log-sum-exp
    tatt._launch_streaming_forward(q, k, k, 0.1)
    args = entry.calls[-1]
    assert len(args) == len(
        _build.SIGNATURES["dsml_flash_attention_streaming_f32"])
    assert args[7:12] == (b * h, nq, nk, D, splits) and args[-1] == 7
    assert entry.numel(args[6]) == want
    assert entry.numel(args[4]) == (None if splits == 1
                                    else [splits * b * h * nq * D])
    assert tatt.LAUNCHES["flash_attention"] == 1
    assert tatt.LAUNCHES["flash_attention_streaming"] == 1


@functools.lru_cache(maxsize=1)
def _meta_mead128():
    with torch.device("meta"):
        return build_model(load_config([chip_smoke.CONFIG_128])["model"])


FLAG_RUNS = {name: env for name, _, env, _ in chip_smoke.RUNS
             + chip_smoke.TRAIN_RUNS
             if name in ("mead128-split", "mead128-streaming",
                         "train-mead128-split", "train-mead128-streaming")}


@pytest.mark.parametrize("run", sorted(FLAG_RUNS))
def test_flag_run_launch_counts_are_unchanged(run):
    """The real YAML on the meta device: a served batch (8 clips, F = 2,
    the run's DDIM chain with guidance: 2 x steps UNet calls, 2 encodes, 2
    decodes) is 16 fp32 D = 32 forwards of row 2 or 4 a UNet call and 14
    first-stage ones at D = 512; a training step 16 and 16 backwards, and
    9 first-stage encodes'."""
    assert len(FLAG_RUNS) == 4
    env, ldm = FLAG_RUNS[run], _meta_mead128()
    fwd = ("flash_attention_streaming"
           if env.get("DSML_FLASH_STREAMING") == "1" else "flash_attention")
    if run.startswith("train-"):
        _, got = chip_smoke.expected_train_launches(ldm, env, steps=1,
                                                    eval_batches=0)
        want = {fwd: 16 + 9, fwd + "_bwd": 16}
    else:
        calls = 2 * chip_smoke.SERVE_DDIM_STEPS[run]
        got = chip_smoke.expected_launches(ldm, env, unet_calls=calls,
                                           encodes=2, decodes=2)
        want = {fwd: 16 * calls + 14}
    assert {k: v for k, v in got.items() if v} == want
