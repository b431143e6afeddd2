"""Rows 2 and 4 at fp32 D = 512 (the first stage's attention block in fp32)
as redesigned for Hopper on TF32 ``wgmma`` (``csrc/hopper_wide_f32.cuh``),
on the CPU.

* The plain split-head and streaming forwards (what the wrappers run on a
  CPU tensor and what the kernels are held to on the card) against the JAX
  package's ``flash_attention`` / ``flash_attention_streaming`` in interpret
  mode, at shapes that end mid-tile for the design's 64-key tiles and
  64-row q-tiles: Nk = 64 + 1, Nk < 64, Nq not a multiple of 64, two heads,
  Nk != Nq; 1e-5 absolute on outputs within [-4, 4].
* ``wide_f32_plan`` at every shape the runs and the kernels phase give the
  two rows: the shared memory of a block, the grids and clusters, the
  scratch of the tile images; its constants against the header's.
* ``streaming_splits`` at the fp32 D = 512 shapes the runs use.
* The forward entries get the arguments their C signatures declare, the
  scratch of the plan's shape at D = 512 (at D = 32 ``narrow_f32_plan``'s)
  and none in bf16.
* ``chip_smoke.expected_launches`` / ``expected_train_launches`` of the real
  ``mead-128-ldm-f4.yaml`` (meta device): 9 row-2 launches at D = 512 a
  ``train-mead128`` step and 14 a served ``mead128`` batch, and the first
  stage's attention calls at [32 | 8, 1, 1024, 512].
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
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_f32_wrappers import _Entry, _OnCard
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

T = torch.from_numpy
D = 512

# [B, H, Nq, Nk]: Nk = 64 + 1, Nk < 64 with Nq past one q-tile, two heads
# with Nk != Nq, Nq = 64 + 1 against Nk = 2 x 64 + 3
RAGGED = [(1, 1, 40, 65), (1, 1, 70, 9), (1, 2, 33, 50), (1, 1, 65, 131)]


def _qkv(seed, b, h, nq, nk):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, h, n, D)).astype(np.float32)
            for n in (nq, nk, nk)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", RAGGED,
                         ids=["nk-65", "nk-9", "two-heads", "nq-65"])
def test_plain_forward_matches_jax_kernel(shape):
    """Row 2: the wrapper on CPU tensors (its plain version) against the
    resident JAX kernel in interpret mode."""
    q, k, v = _qkv(11, *shape)
    _close(tatt.flash_attention(T(q), T(k), T(v)),
           jatt.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=32,
                                interpret=True))


@pytest.mark.parametrize("shape", RAGGED,
                         ids=["nk-65", "nk-9", "two-heads", "nq-65"])
def test_plain_streaming_forward_matches_jax_kernel(shape):
    """Row 4: the wrapper on CPU tensors against the JAX streaming kernel in
    interpret mode, its K / V blocks of 64 keys as the design's tiles."""
    q, k, v = _qkv(12, *shape)
    _close(tatt.flash_attention_streaming(T(q), T(k), T(v)),
           jatt.flash_attention_streaming(*map(jnp.asarray, (q, k, v)),
                                          block_q=32, block_k=64,
                                          interpret=True))


# [B*H, Nq, Nk, splits] of every fp32 D = 512 call of the runs and of the
# kernels phase: vqgan-f4 / kl-f4 (batch 16), train-mead128 (32), mead128's
# identity encode and decodes (8; 2 splits when streaming), 256 px, ragged
SHAPES = [(16, 1024, 1024, 1), (32, 1024, 1024, 1), (8, 1024, 1024, 1),
          (8, 1024, 1024, 2), (8, 4096, 4096, 1), (2, 1000, 1000, 8),
          (2, 333, 77, 2), (2, 100, 65, 2), (2, 70, 9, 1), (1, 64, 2000, 32)]


@pytest.mark.parametrize("bh,nq,nk,splits", SHAPES)
def test_plan_fits_a_block_and_covers_the_call(bh, nq, nk, splits):
    """Shared memory within a Hopper block's 232,448 bytes; a cluster of two
    blocks of 128 threads a (head, 64-row q-tile, split), and a prep block
    of 256 threads a (head, 16 keys); scratch for the K and V^T images of
    every 64-key tile, each split starting on a tile."""
    plan = tatt.wide_f32_plan(bh, nq, nk, splits)
    # 1 KB of alignment, q / K / V^T halves of 64 KB, two partials of 16 KB
    assert plan.smem == 1024 + 3 * 65536 + 2 * 16384 + 5 * 8 == 230440
    assert plan.smem <= tatt.SHARED_MEMORY_PER_BLOCK
    assert (plan.threads, plan.cluster, plan.prep_threads) == (128, 2, 256)
    assert plan.blocks == (2 * bh * -(-nq // 64), splits)
    assert plan.blocks[0] % plan.cluster == 0
    two, heads, keys, d = plan.scratch
    assert (two, heads, d) == (2, bh, D)
    assert nk <= keys < nk + 64 and keys % 64 == 0
    assert plan.prep_blocks == bh * keys // 16
    per = -(-(-(-nk // 64)) // splits) * 64   # keys of a split
    assert per % 64 == 0 and (splits - 1) * per < nk


def test_plan_constants_are_the_header_constants():
    """The Python mirror of ``hwide_f32``'s rows, keys, threads and cluster,
    and its shared-memory sum (``SMEM``), against the header's own text."""
    src = open(os.path.join(_build.CSRC_DIR, "hopper_wide_f32.cuh")).read()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["ROWS"]) == tatt.WIDE_F32_ROWS
    assert int(const["KEYS"]) == tatt.WIDE_F32_KEYS
    assert int(const["NT"]) == tatt.WIDE_F32_THREADS
    assert int(const["PREP_NT"]) == tatt.WIDE_F32_PREP_THREADS
    assert int(const["D"]) == tatt.WIDE_F32_HEAD_DIM
    assert "constexpr int HALF = D / 2;" in src
    assert "constexpr int BARS = 5;" in src
    assert "attr[0].val.clusterDim.x = 2;" in src
    assert "hopper_wide_f32.cuh" in _build.HEADERS


@pytest.mark.parametrize("bh,nq,nk,splits", [(16, 1024, 1024, 1),
                                             (32, 1024, 1024, 1),
                                             (8, 1024, 1024, 2),
                                             (8, 4096, 4096, 1)])
def test_streaming_splits_at_the_runs_shapes(bh, nq, nk, splits):
    """The streaming forward's cut of the keys at the fp32 D = 512 calls:
    one split where the q-tiles fill the card, two for mead128's decodes
    of 8 latents (128 q-tiles against the 264 blocks it aims for)."""
    assert tatt.streaming_splits(bh, nq, nk) == splits


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 512),
                                     (torch.float32, 32),
                                     (torch.bfloat16, 512)])
def test_forward_calls_its_entry_by_its_signature(streaming, dtype, d,
                                                  monkeypatch):
    """The forward entries get as many arguments as ``_build.SIGNATURES``
    declares, the stream last; in fp32 a scratch of the plan's size after
    the outputs (``wide_f32_plan`` at D = 512, ``narrow_f32_plan``'s images
    at D = 32), no such argument in bf16."""
    kernel = "flash_attention_streaming" if streaming else "flash_attention"
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
    b, h, nq, nk = 8, 1, 1024, 1024
    q = torch.zeros(b, h, nq, d, dtype=dtype).as_subclass(_OnCard)
    if streaming:
        tatt._launch_streaming_forward(q, q, q, 0.1)
    else:
        tatt._launch_flash_forward(q, q, q, 0.1, True)
    args = entry.calls[-1]
    assert len(args) == len(_build.SIGNATURES[names[-1]]) and args[-1] == 7
    assert names[-1] == "dsml_" + kernel + (
        "_f32" if dtype == torch.float32 else "")
    splits = tatt.streaming_splits(b * h, nq, nk) if streaming else 1
    at = 6 if streaming else 5   # after the outputs
    if dtype == torch.float32:
        tail = args[at + 1:at + 5]
        if d == 512:
            want = tatt.wide_f32_plan(b * h, nq, nk, splits).scratch
            assert [tuple(t.shape) for t in scratch].count(want) == 1
        else:
            plan = tatt.narrow_f32_plan(b * h, nq, nk)
            assert not plan.mma_sync
            assert [t.numel() for t in scratch
                    if t.data_ptr() == args[at]] == [plan.fwd_scratch]
        assert args[at] is not None
    else:
        tail = args[at:at + 4]
    assert tail == (b * h, nq, nk, d)
    assert tatt.LAUNCHES[kernel] == 1


def _meta(config):
    with torch.device("meta"):
        return build_model(load_config([config])["model"])


def test_launches_of_the_real_mead128_yaml():
    """Row 2 at D = 512 runs 9 times a ``train-mead128`` step (three frozen
    encodes x three attention blocks) and 14 times a served ``mead128``
    batch at F = 2 (3 for the masked frames, 3 for the identity, 4 for each
    of two decodes); under ``DSML_FLASH_STREAMING=1`` row 4 takes them."""
    ldm = _meta(chip_smoke.CONFIG_128)
    assert chip_smoke.count_attn_blocks(ldm.first_stage.encoder) == 3
    assert chip_smoke.count_attn_blocks(ldm.first_stage.decoder) == 4
    _, step = chip_smoke.expected_train_launches(ldm, {}, steps=1,
                                                 eval_batches=0)
    assert step["flash_attention"] == 9
    batch = chip_smoke.expected_launches(ldm, {}, unet_calls=100, encodes=2,
                                         decodes=2)
    assert batch["flash_attention"] == 14
    assert batch["flash_attention_streaming"] == 0
    stream = chip_smoke.expected_launches(
        ldm, {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"},
        unet_calls=100, encodes=2, decodes=2)
    assert stream["flash_attention"] == 0
    assert stream["flash_attention_streaming"] == 1600 + 14


def test_first_stage_calls_of_the_real_mead128_yaml(monkeypatch):
    """The frozen first stage of the real YAML (meta device) calls the
    split-head forward at [32, 1, 1024, 512] in a training step's encode and
    at [8, 1, 1024, 512] in a served batch's decode, fp32, each taken by
    the plan within a block's shared memory."""
    ldm = _meta(chip_smoke.CONFIG_128)
    shapes = []

    def spy(q, k, v, scale=None):
        shapes.append((tuple(q.shape), tuple(k.shape), q.dtype))
        return torch.empty_like(q)
    monkeypatch.setattr(tatt, "flash_attention", spy)
    size = 4 * ldm.image_size
    with torch.no_grad():
        ldm.first_stage.encode(torch.empty(32, size, size, 3, device="meta"))
        n_enc = len(shapes)
        ldm.first_stage.decode(torch.empty(8, ldm.image_size, ldm.image_size,
                                           3, device="meta"))
    assert n_enc == 3 and len(shapes) == 7
    for i, (qs, ks, dtype) in enumerate(shapes):
        b = 32 if i < n_enc else 8
        assert qs == ks == (b, 1, 1024, D) and dtype == torch.float32
        assert tatt.flash_kernel_takes(D, dtype)
        plan = tatt.wide_f32_plan(b, 1024, 1024)
        assert plan.smem <= tatt.SHARED_MEMORY_PER_BLOCK
        assert plan.blocks == (2 * b * 16, 1)
