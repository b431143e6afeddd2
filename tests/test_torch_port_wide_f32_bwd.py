"""Rows 7 and 5 at fp32 D = 512 (the first stage's attention block in
first-stage training) as redesigned for Hopper on TF32 ``wgmma``
(``csrc/hopper_wide_f32_bwd.cuh``), on the CPU.

* The plain split-head and streaming backwards (what the wrappers run on a
  CPU tensor and what the kernels are held to on the card) against the JAX
  package's ``flash_attention_bwd`` (``block_q=64``) and
  ``flash_attention_streaming_bwd`` in interpret mode, at shapes that end
  mid-tile: Nq = Nk = 65, Nk = 9, two heads with Nk != Nq, Nq = 100 against
  Nk = 65. Tolerance 2e-5 absolute, the fp32 backward tests' bound
  (``test_torch_port_attention_bwd.py``): unit-normal inputs keep every
  gradient within a few units at D = 512, and fp32 sums of 512 products
  taken in another order by the two frameworks differ by some 1e-6.
* ``wide_f32_bwd_plan`` at every shape the runs and the kernels phase give
  the two rows: the grids, shared memory, chunks of keys and scratch; its
  constants against the header's.
* The backward entries get the arguments their C signatures declare: a
  scratch of the plan's size before the stream at fp32 (D = 512, and
  ``narrow_f32_plan``'s images at D = 32), no such argument in bf16.
* ``chip_smoke.expected_ae_launches`` of the real ``vqgan-f4.yaml`` and
  ``kl-f4.yaml`` (meta device) under ``ae-vq``, ``ae-kl`` and
  ``ae-vq-streaming``: one backward launch an AttnBlock a step, as before.
"""
from __future__ import annotations

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.config import load_config
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.training import vqgan_trainer as tvt
from test_torch_port_f32_wrappers import _Entry, _OnCard
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

T = torch.from_numpy
D = 512
ATOL = 2e-5

# [B, H, Nq, Nk]: Nq = Nk = 64 + 1, Nk < 64 with Nq past one q-block, two
# heads with Nk != Nq, Nq = 100 against Nk = 64 + 1
RAGGED = [(1, 1, 65, 65), (1, 1, 70, 9), (1, 2, 33, 50), (1, 1, 100, 65)]
IDS = ["nq-nk-65", "nk-9", "two-heads", "nq-100-nk-65"]


def _inputs(seed, b, h, nq, nk):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, h, n, D)).astype(np.float32)
            for n in (nq, nk, nk, nq)]   # q, k, v, do


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", RAGGED, ids=IDS)
def test_plain_backward_matches_jax_kernel(shape):
    """Row 7: ``flash_attention_bwd_reference`` (the wrapper's plain
    version) against the resident JAX backward in interpret mode."""
    q, k, v, do = _inputs(21, *shape)
    want = jatt.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)),
                                    block_q=64, interpret=True)
    got = tatt.flash_attention_bwd_reference(T(q), T(k), T(v), T(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("shape", RAGGED, ids=IDS)
def test_plain_streaming_backward_matches_jax_kernel(shape):
    """Row 5: ``flash_attention_streaming_bwd`` on CPU tensors (its plain
    version) against the JAX streaming backward in interpret mode, both on
    the JAX streaming forward's output, 64-row q and key blocks."""
    q, k, v, do = _inputs(22, *shape)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o = jatt.flash_attention_streaming(jq, jk, jv, block_q=64, block_k=64,
                                       interpret=True)
    want = jatt.flash_attention_streaming_bwd(jq, jk, jv, o, jdo, block_q=64,
                                              block_k=64, interpret=True)
    got = tatt.flash_attention_streaming_bwd(T(q), T(k), T(v),
                                             T(np.array(o)), T(do))
    for g, w in zip(got, want):
        _close(g, w)


# [B*H, Nq, Nk] of every fp32 D = 512 backward of the runs and the kernels
# phase: vqgan-f4 / kl-f4 (batch 16), 256 px (four chunks of keys), ragged
SHAPES = [(16, 1024, 1024), (8, 4096, 4096), (2, 1000, 1000), (2, 333, 77),
          (2, 333, 333), (2, 100, 65), (2, 70, 9), (1, 130, 257),
          (1, 16384, 16384)]


@pytest.mark.parametrize("bh,nq,nk", SHAPES)
def test_plan_fits_a_block_and_covers_the_call(bh, nq, nk):
    """Both product grids within a Hopper block's 232,448 bytes (1 KB of
    alignment, six 32 KB score stages or four 48 KB gradient stages) on 256
    threads; the lengths padded to 128-row tiles; the chunks of keys cover
    the padded keys in whole tiles, each chunk's P^T, dS^T and dS within
    512 MiB (or one tile); the scratch is the three transposed copies at the
    padded lengths, one chunk and the four rounded copies."""
    plan = tatt.wide_f32_bwd_plan(bh, nq, nk)
    assert plan.scores_smem == plan.grads_smem == 1024 + 6 * 32768 == 197632
    assert plan.grads_smem <= tatt.SHARED_MEMORY_PER_BLOCK
    assert plan.threads == 256
    nqp, nkp = plan.padded
    assert nq <= nqp < nq + 128 and nk <= nkp < nk + 128
    assert nqp % 128 == 0 and nkp % 128 == 0
    assert plan.chunk % 128 == 0 and 128 <= plan.chunk <= nkp
    assert 12 * bh * nqp * plan.chunk <= (512 << 20) or plan.chunk == 128
    assert (plan.chunks - 1) * plan.chunk < nkp <= plan.chunks * plan.chunk
    assert plan.images == (max(nqp, nkp) // 32, D // 32, 4 * bh)
    assert plan.scores == (nqp // 128, plan.chunk // 128, bh)
    assert plan.grads == (2 * max(plan.chunk, nqp) // 128, bh, 3)
    assert plan.scratch == (bh * (D * (2 * nqp + nkp)
                                  + 3 * plan.chunk * nqp
                                  + D * (2 * nq + 2 * nk)),)


@pytest.mark.parametrize("bh,nq,nk,chunks", [(16, 1024, 1024, 1),
                                             (8, 4096, 4096, 4),
                                             (1, 16384, 16384, 7)])
def test_chunks_at_the_timed_shapes(bh, nq, nk, chunks):
    """vqgan-f4's backward takes all keys in one chunk (416 MiB of
    scratch); 256 px takes four and a 512 px image seven, so that the
    scratch stays under 1 GiB."""
    if (bh, nq) == (16, 1024):
        assert tatt.wide_f32_bwd_plan(bh, nq, nk).scratch[0] * 4 == 416 << 20
    plan = tatt.wide_f32_bwd_plan(bh, nq, nk)
    assert plan.chunks == chunks
    assert plan.scratch[0] * 4 < 1 << 30


def test_plan_constants_are_the_header_constants():
    """The Python mirror of ``hwide_f32_bwd``'s tiles, threads, stages,
    image blocks and chunk budget against the header's own text."""
    src = open(os.path.join(_build.CSRC_DIR,
                            "hopper_wide_f32_bwd.cuh")).read()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["D"]) == tatt.WIDE_F32_HEAD_DIM
    assert int(const["TILE"]) == tatt.WIDE_F32_BWD_TILE
    assert int(const["NT"]) == tatt.WIDE_F32_BWD_THREADS
    assert int(const["GN"]) == tatt.WIDE_F32_BWD_COLS
    assert int(const["S_STAGES"]) == tatt.WIDE_F32_BWD_S_STAGES
    assert int(const["G_STAGES"]) == tatt.WIDE_F32_BWD_G_STAGES
    assert int(const["IMG_ROWS"]) == tatt.WIDE_F32_BWD_IMG_ROWS
    assert int(const["IMAGES"]) == tatt.WIDE_F32_BWD_IMAGES
    assert int(const["CHUNK_BUDGET_MB"]) == tatt.WIDE_F32_BWD_CHUNK_BUDGET_MB
    assert int(const["BK"]) == 32
    assert "constexpr int S_STAGE = 2 * ROW_TILE;" in src
    assert "constexpr int G_STAGE = ROW_TILE + GN * 128;" in src
    assert "hopper_wide_f32_bwd.cuh" in _build.HEADERS
    for name in ("flash_attention_bwd.cu", "flash_attention_streaming_bwd.cu"):
        entry = open(os.path.join(_build.CSRC_DIR, name)).read()
        assert '#include "hopper_wide_f32_bwd.cuh"' in entry
        assert "hwide_f32_bwd::launch(" in entry


def test_no_mma_sync_grid_is_left_for_d512():
    """The fused mma.sync grids of the earlier design are gone: what is
    left of ``attention_f32.cuh`` is the delta launch and the pieces of the
    streaming log-sum-exp launch and of the fp32 D = 32 kernels."""
    src = open(os.path.join(_build.CSRC_DIR, "attention_f32.cuh")).read()
    for gone in ("dkdv_block", "dq_block", "partial_scores", "sum_partials",
                 "slice_update", "store_slice", "zero_slice",
                 "bwd_smem_bytes", "launch_bwd_f32"):
        assert gone not in src, gone
    assert "bwd_delta_f32_kernel" in src
    wide = open(os.path.join(_build.CSRC_DIR,
                             "hopper_wide_f32_bwd.cuh")).read()
    assert "mma.sync.aligned" not in wide and "atomicAdd" not in wide \
        and "atom." not in wide and "red." not in wide


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 512),
                                     (torch.float32, 32),
                                     (torch.bfloat16, 64)])
@pytest.mark.parametrize("shape", [(16, 1, 1024, 1024), (1, 2, 70, 9)])
def test_backward_calls_its_entry_by_its_signature(streaming, dtype, d,
                                                   shape, monkeypatch):
    """The backward entries get as many arguments as ``_build.SIGNATURES``
    declares, the head count, lengths and width after the ten tensors and
    the stream last; at fp32 a scratch of the plan's size just before the
    stream (``wide_f32_bwd_plan`` at D = 512, ``narrow_f32_plan``'s images at
    D = 32, None where that plan keeps the mma.sync grids), no such argument
    in bf16."""
    kernel = ("flash_attention_streaming_bwd" if streaming
              else "flash_attention_bwd")
    monkeypatch.setitem(tatt.LAUNCHES, kernel, 0)
    entry = _Entry()
    names = []

    def lib_attr(self, name):
        names.append(name)
        return entry
    monkeypatch.setattr(_build, "load", lambda: type(
        "Lib", (), {"__getattr__": lib_attr})())
    monkeypatch.setattr(tatt, "current_stream", lambda t: 7)
    scratch = []
    empty = torch.empty   # scratch on the host: the CPU tests have no card

    def host_empty(*a, device=None, **kw):
        t = empty(*a, **kw)
        scratch.append(t)
        return t
    monkeypatch.setattr(torch, "empty", host_empty)
    b, h, nq, nk = shape
    q = torch.zeros(b, h, nq, d, dtype=dtype).as_subclass(_OnCard)
    kv = torch.zeros(b, h, nk, d, dtype=dtype).as_subclass(_OnCard)
    if streaming:
        tatt.flash_attention_streaming_bwd(q, kv, kv, q, q, 0.1)
    else:
        lse = torch.zeros(b * h * nq).as_subclass(_OnCard)
        tatt.flash_attention_bwd(q, kv, kv, q, lse, q, 0.1)
    args = entry.calls[-1]
    assert names[-1] == "dsml_" + kernel + (
        "_f32" if dtype == torch.float32 else "")
    assert len(args) == len(_build.SIGNATURES[names[-1]]) and args[-1] == 7
    assert args[10:14] == (b * h, nq, nk, d)
    if dtype == torch.float32 and d == 512:
        want = tatt.wide_f32_bwd_plan(b * h, nq, nk).scratch
        assert [tuple(t.shape) for t in scratch].count(want) == 1
        assert isinstance(args[-2], int)
    elif dtype == torch.float32:
        plan = tatt.narrow_f32_plan(b * h, nq, nk)
        if plan.mma_sync:
            assert args[-2] is None
        else:
            want = (plan.bwd_scratch,)
            assert [tuple(t.shape) for t in scratch].count(want) == 1
            assert isinstance(args[-2], int)
    else:
        assert isinstance(args[-2], float)
        assert len(args) == 16 + streaming
    assert tatt.LAUNCHES[kernel] == 1


def _ae_model(config):
    build = (tvt.build_vqgan if config == chip_smoke.CONFIG_VQ
             else tvt.build_kl_ae)
    with torch.device("meta"):
        return build(load_config([config])["model"])[0]


@pytest.mark.parametrize("run,bwd,per_step", [
    ("ae-vq", "flash_attention_bwd", 7),
    ("ae-kl", "flash_attention_bwd", 2),
    ("ae-vq-streaming", "flash_attention_streaming_bwd", 7)])
def test_backward_launches_of_the_first_stage_runs(run, bwd, per_step):
    """The runs that reach rows 7 and 5 at D = 512 launch the backward once
    an AttnBlock a step (vqgan-f4: 3 in the encoder, 4 in the decoder;
    kl-f4: 1 + 1) and no other backward kernel; a validation batch launches
    none."""
    config, env = {name: (c, e) for name, c, e, _ in chip_smoke.AE_RUNS}[run]
    model = _ae_model(config)
    assert chip_smoke.count_attn_blocks(model) == per_step
    runs, step = chip_smoke.expected_ae_launches(model, env, steps=2,
                                                 eval_batches=1)
    assert step[bwd] == per_step and runs[bwd] == 2 * per_step
    other = ({"flash_attention_bwd", "flash_attention_streaming_bwd"}
             - {bwd}).pop()
    assert step.get(other, 0) == 0
    fwd = bwd.removesuffix("_bwd")
    assert step[fwd] == per_step and runs[fwd] == 3 * per_step
