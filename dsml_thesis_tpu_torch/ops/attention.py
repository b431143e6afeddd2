"""Attention ops of the port: eight CUDA kernels, their plain PyTorch
versions, and the wrappers that choose between them by where the tensor lies.

``flash_attention``        q [B, H, Nq, D], k / v [B, H, Nk, D] -> [B, H, Nq, D]
    kernel ``csrc/flash_attention.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel`` (``flash_attention``).
    Bound by operations. Head widths 32, 64 and 80 run the packed kernel's
    grid on one head (``csrc/hopper_fwd.cuh``); at the first stage's
    D = 512 the kernel streams K / V tiles through shared memory under an
    online softmax and splits D over two warps to fit the fp32 output in
    registers.

``flash_attention_fproj``  h [B, N, C] + projection weights -> [B, N, C]
    kernels ``csrc/flash_attention_fproj.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed_fproj``
    (``flash_attention_fproj``). Bound by operations; q, k, v go once through
    a scratch (a ``wgmma`` GEMM; in fp32 v transposed per head, the layout
    TF32 ``wgmma`` reads), the attention output and the head split stay in
    shared memory: the head-group blocks of a q-tile form a thread-block
    cluster and read each other's outputs for the output projection. fp32
    (D = 32) runs every product on TF32 ``wgmma`` (``fproj_f32_plan``). A
    call with no gradient to track launches without the autograd
    ``Function``.

``flash_attention_packed`` q [B, Nq, H*D], k / v [B, Nk, H*D] -> [B, Nq, H*D]
    kernel ``csrc/flash_attention_packed.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed``
    (``flash_attention_packed``). Bound by operations; one warpgroup per
    (batch, 64-row tile, head) addresses its head inside the packed rows, so
    no head-split copy exists; K / V tiles through a ``cp.async`` ring on
    mbarriers, S and P V on ``wgmma``. Head widths 32, 64 and 80.
    ``packed_multi_head_attention`` is its dispatch.

``flash_attention_qout``   h [B, N, C], k / v [B, Nk, H*D] + wq, wo, bo
    -> [B, N, C]
    kernel ``csrc/flash_attention_qout.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed_qout``
    (``flash_attention_qout``). Bound by operations; q and the attention
    output stay in shared memory. ``fused_qout_self_attention`` is its
    dispatch.

``flash_attention_bwd``    (q, k, v, o, lse, do) on split heads -> (dq, dk, dv)
    kernels ``csrc/flash_attention_bwd.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel``
    (``flash_attention_bwd``). Bound by operations; head widths 32, 64 and
    80 in bf16 (the packed backward's grids on one head), 512 in fp32.

``flash_attention_bwd_packed``  the same on packed rows
    kernels ``csrc/flash_attention_bwd_packed.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel_packed``
    (``flash_attention_bwd_packed``). Bound by operations; dq, dk, dv are
    written in place in the packed layout; 128 owned rows a block, streamed
    tiles through a ``cp.async`` ring on mbarriers, every product on
    ``wgmma`` (``csrc/hopper_bwd.cuh``). Head widths 32, 64 and 80.

    Both backward kernels read the row log-sum-exp the forward kernel saved
    (the TPU kernels recompute a whole row's softmax, which needs a head's
    K / V resident), form delta = rowsum(do * o) in a small first launch, and
    cut the rest in two grids so that no output is summed with atomics: one
    over key/value tiles writes dk / dv once, one over query tiles writes dq
    once. Equal inputs give equal bits.

``flash_attention_streaming``      q [B, H, Nq, D], k / v [B, H, Nk, D]
    kernel ``csrc/flash_attention_streaming.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel_streaming``
    (``flash_attention_streaming``). Bound by operations; any Nq / Nk, head
    widths 32, 64, 80 and 512 (fp32: 32 and 512). The K / V stream of a query tile is cut over
    several blocks when the call has few query tiles (``streaming_splits``),
    and the splits are combined in index order. q is scaled by
    scale * log2(e) in its own type before the score product and the
    denominator sums the probabilities as cast to v's type, as that kernel
    does (``streaming_attention_reference`` is this arithmetic).

``flash_attention_streaming_bwd``  (q, k, v, o, do) -> (dq, dk, dv)
    kernels ``csrc/flash_attention_streaming_bwd.cu``; replaces the TPU
    kernels of ``dsml_thesis_tpu/ops/attention.py:flash_attention_streaming_bwd``
    (``_streaming_lse_kernel``, ``_streaming_dq_kernel``,
    ``_streaming_dkdv_kernel``). The residuals carry no row statistic: a
    launch of its own (on ``wgmma``) recomputes the row log-sum-exp from q
    and k, then delta and, in bf16, the packed backward's dk / dv and dq
    grids on one head. Head widths 32, 64 and 80 in bf16, 32 and 512 in
    fp32 (at 32 the packed fp32 backward's grids on one head, with q times
    scale * log2(e) in its images and a log-sum-exp grid of its own).

fp32. Each kernel has its own fp32 head widths (``F32_HEAD_DIMS``): 512 for
the split-head forward, the streaming forward and both their backward
kernels (the first stage's single-head attention block in first-stage
training and in mead-128's frozen first stage; the forwards on TF32
``wgmma``, ``csrc/hopper_wide_f32.cuh``, with scratch for their tile images
from ``wide_f32_plan``; the backwards on TF32 ``wgmma`` too,
``csrc/hopper_wide_f32_bwd.cuh``: a scores grid and a grid of the three
gradient GEMMs joined by P and dS in scratch from ``wide_f32_bwd_plan``),
and 32 for the split-head, packed and streaming forwards, their backward
kernels and the fused-projection kernel (the UNet of
``mead-128-ldm-f4.yaml``, which sets no dtype: the packed pair and the
split-head and streaming pairs on TF32 ``wgmma``,
``csrc/hopper_narrow_f32.cuh``, an images launch writing the rounded and
transposed operands into scratch from ``narrow_f32_plan`` first, the
streaming pair with its own roundings, the forward's cut of the keys over
``streaming_splits`` blocks and the backward's log-sum-exp grid; where both
lengths are at most 64 all six on ``csrc/attention_f32_narrow.cuh``). Both run in fp32 as the JAX
package's do, and multiply on the tensor cores in TF32 (operands rounded
once, fp32 accumulation and softmax). The q/out-fused kernel takes bf16
only.

``multi_head_attention`` is the split-head dispatch between
``flash_attention`` and ``flash_attention_streaming`` under
``DSML_FLASH_STREAMING`` (``auto`` | ``1`` | ``0``).

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel (built at first use, ``ops/_build.py``) or
raises: there is no fallback on the card. Each wrapper counts its launches in
``LAUNCHES``.

Gradients. ``flash_attention`` and ``flash_attention_packed`` are
``torch.autograd.Function``s: forward launches the forward kernel, backward
the backward kernel (on the CPU: the plain forward and the plain backward
formula, through the same ``Function``). ``flash_attention_fproj`` and
``flash_attention_qout`` run their kernel forward and differentiate the
composed formula (``fproj_reference``, ``qout_reference``) backward with
ordinary autograd: in the JAX package that backward is XLA's, not a Pallas
kernel (``_fproj_bwd``, ``_qout_bwd`` there), so plain PyTorch ops on the card
are its true counterpart. The training path does not reach those two (the
model keeps the fused branches for eval mode).

Weights follow ``torch.nn.Linear``: ``[out_features, in_features]``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..flags import env_mode, refuse_unported
from ._launch import (LAUNCHES, check_cuda_operand, current_stream,  # noqa: F401
                      raise_on_error, reset_launches, typed_entry)

FLASH_HEAD_DIMS = (32, 64, 80, 512)    # bf16 instantiations in flash_attention.cu
FPROJ_HEAD_DIMS = (32, 64)             # ... in flash_attention_fproj.cu
FPROJ_CHANNEL_MULTIPLE = 32            # depth step of its projection kernel
PACKED_HEAD_DIMS = (32, 64, 80)        # ... in flash_attention_packed.cu
BWD_HEAD_DIMS = (32, 64, 80)           # ... in both flash_attention_bwd*.cu
STREAMING_HEAD_DIMS = (32, 64, 80, 512)  # ... in flash_attention_streaming.cu
STREAMING_BWD_HEAD_DIMS = (32, 64, 80)   # ... in flash_attention_streaming_bwd.cu
# fp32 instantiations (TF32 products), by kernel: D = 512 the first stage's
# attention block in first-stage training, D = 32 the fp32 UNet of
# mead-128-ldm-f4 (packed rows, split heads, streaming, the fused projections)
F32_HEAD_DIMS = {
    "flash_attention": (32, 512), "flash_attention_bwd": (32, 512),
    "flash_attention_packed": (32,), "flash_attention_bwd_packed": (32,),
    "flash_attention_fproj": (32,),
    "flash_attention_streaming": (32, 512),
    "flash_attention_streaming_bwd": (32, 512),
}
STREAMING_TILE = 64                    # query / key rows of its tiles
STREAMING_TARGET_BLOCKS = 264          # two blocks on each of 132 SMs
LOG2E = 1.4426950408889634
QOUT_HEAD_DIMS = (32, 64, 80)          # ... in flash_attention_qout.cu
QOUT_CHANNEL_MULTIPLE = 16             # depth of one tensor-core product
QOUT_ROWS = 64                         # query rows of one of its blocks
SHARED_MEMORY_PER_BLOCK = 232448       # bytes a Hopper block may use

# The fused-projection op is for sequences that one q-block of the JAX
# package covers: its kernel projects K and V inside every q-block, and the
# package admits a shape only when the whole N is a single block
# (dsml_thesis_tpu/ops/attention.py:991-1011, ``_fit_block_q_fproj`` and
# ``fproj_eligible``). In the shipped configs that is N = 1024 and 256 and
# never N = 4096; longer sequences take the packed or the q/out-fused kernel.
FPROJ_MAX_TOKENS = 1024


def fproj_one_q_block(n: int) -> bool:
    """Whether the JAX package sends a self-attention over ``n`` tokens to
    the fused-projection op (one q-block covers the sequence)."""
    return n <= FPROJ_MAX_TOKENS


def streaming_auto(nq: int, nk: int, d: int) -> bool:
    """Whether the JAX package's ``auto`` dispatch sends a split-head
    attention to its streaming kernel: where no q-block of its resident
    kernel fits the TPU's fast memory
    (dsml_thesis_tpu/ops/attention.py:1594-1612, ``_fit_block_q`` returning
    None, at its default request of 1024 rows). The fit is sized in fp32
    whatever the type: six K / V-sized buffers, four [block_q, Nk] score
    buffers and eight q-sized blocks against 100 MiB less 2 MiB; the request
    is halved down to 8 rows, so at D = 512 every Nk above 8,265 streams.
    Kept as a routing rule (it decides which kernel a shape gets), as
    ``fproj_one_q_block`` keeps the fused-projection rule."""
    bq = min(1024, nq)
    while bq >= 8:
        if (6 * nk * d * 4 + 4 * bq * nk * 4 + 8 * bq * d * 4 + (1 << 21)
                <= 100 * (1 << 20)):
            return False
        bq //= 2
    return True


# The fp32 D = 512 forwards of rows 2 and 4 (csrc/hopper_wide_f32.cuh): a
# launch writes the K and V^T tile images into scratch, then a cluster of two
# blocks a 64-row q-tile splits the 512 columns; its constants, mirrored here
# so that the CPU tests reach the plan
WIDE_F32_HEAD_DIM = 512
WIDE_F32_ROWS = 64                     # query rows of a q-tile
WIDE_F32_KEYS = 64                     # keys of a K / V^T tile
WIDE_F32_THREADS = 128                 # one warpgroup a block
WIDE_F32_CLUSTER = 2                   # blocks of a q-tile: halves of D
WIDE_F32_PREP_THREADS = 256            # a tile-image block: 16 keys


class WideF32Plan(NamedTuple):
    """The two launches of an fp32 D = 512 forward: ``prep_blocks`` blocks
    of ``prep_threads`` write the tile images into fp32 scratch of shape
    ``scratch``; then ``blocks`` (block pairs of the q-tiles x splits of the
    keys) of ``threads``, in clusters of ``cluster``, with ``smem`` bytes of
    dynamic shared memory attend."""
    prep_blocks: int
    prep_threads: int
    blocks: Tuple[int, int]
    cluster: int
    threads: int
    smem: int
    scratch: Tuple[int, int, int, int]


def wide_f32_plan(bh: int, nq: int, nk: int, splits: int = 1) -> WideF32Plan:
    """The launches of the fp32 D = 512 forward for ``bh`` heads of ``nq``
    queries against ``nk`` keys (``splits``: the streaming forward's cut of
    the keys). A block's shared memory: alignment slack, its half of the
    q-tile, of a K and of a V^T tile, two buffers of the other block's
    partial scores and five mbarriers, as ``hwide_f32::SMEM`` counts it."""
    d, rows, keys = WIDE_F32_HEAD_DIM, WIDE_F32_ROWS, WIDE_F32_KEYS
    half, tiles = d // WIDE_F32_CLUSTER, -(-nk // keys)
    smem = (1024 + rows * half * 4 + 2 * keys * half * 4 + 2 * rows * keys * 4
            + 5 * 8)
    return WideF32Plan(
        prep_blocks=bh * tiles * keys // 16,
        prep_threads=WIDE_F32_PREP_THREADS,
        blocks=(bh * -(-nq // rows) * WIDE_F32_CLUSTER, splits),
        cluster=WIDE_F32_CLUSTER, threads=WIDE_F32_THREADS, smem=smem,
        scratch=(2, bh, tiles * keys, d))


# The fp32 D = 512 backwards of rows 7 and 5 (csrc/hopper_wide_f32_bwd.cuh):
# delta, a launch writing q / do / k / v rounded to TF32 and q^T / do^T /
# k^T, then a scores grid and a grid of the three gradient GEMMs for each
# chunk of keys, the chunk's P^T, dS^T and dS in scratch; its constants,
# mirrored here so that the CPU tests reach the plan
WIDE_F32_BWD_TILE = 128                # rows of a score / gradient tile
WIDE_F32_BWD_THREADS = 256             # two warpgroups a block
WIDE_F32_BWD_COLS = 256                # output columns of a gradient tile
WIDE_F32_BWD_S_STAGES = 6              # scores: 32-column stages, 32 KB
WIDE_F32_BWD_G_STAGES = 4              # gradients: 32-column stages, 48 KB
WIDE_F32_BWD_IMG_ROWS = 32             # an image block: 32 x 32
WIDE_F32_BWD_CHUNK_BUDGET_MB = 512     # a chunk's P^T, dS^T and dS
WIDE_F32_BWD_IMAGES = 4                # q, do, k, v: rounded, transposed


class WideF32BwdPlan(NamedTuple):
    """The launches of an fp32 D = 512 backward after delta: ``images``
    blocks of ``threads`` write the rounded and the transposed copies; then,
    for each of ``chunks`` chunks of ``chunk`` keys (the last one shorter),
    ``scores`` blocks and ``grads`` blocks (the largest chunk's grids) of
    ``threads`` with ``scores_smem`` / ``grads_smem`` bytes of dynamic shared
    memory. ``scratch`` is the fp32 scratch of one call: the transposed
    copies at the lengths padded to ``padded``, one chunk's P^T, dS^T and
    dS, and the rounded copies."""
    images: Tuple[int, int, int]
    scores: Tuple[int, int, int]
    grads: Tuple[int, int, int]
    threads: int
    scores_smem: int
    grads_smem: int
    padded: Tuple[int, int]
    chunk: int
    chunks: int
    scratch: Tuple[int]


def wide_f32_bwd_plan(bh: int, nq: int, nk: int) -> WideF32BwdPlan:
    """The launches of the fp32 D = 512 backward for ``bh`` heads of ``nq``
    queries against ``nk`` keys, as ``hwide_f32_bwd::launch`` makes them. A
    chunk holds as many 128-key tiles as keep its three [Nq, chunk] arrays
    within the budget (at least one, at most all); a block's shared memory
    is 1 KB of alignment slack and its stages."""
    d, tile, img = WIDE_F32_HEAD_DIM, WIDE_F32_BWD_TILE, WIDE_F32_BWD_IMG_ROWS
    nqp, nkp = -(-nq // tile) * tile, -(-nk // tile) * tile
    chunk = (WIDE_F32_BWD_CHUNK_BUDGET_MB << 20) // (3 * 4 * bh * nqp)
    chunk = min(max(chunk // tile * tile, tile), nkp)
    row_tile = tile * 128
    return WideF32BwdPlan(
        images=(max(nqp, nkp) // img, d // img, bh * WIDE_F32_BWD_IMAGES),
        scores=(nqp // tile, chunk // tile, bh),
        grads=(max(chunk, nqp) // tile * 2, bh, 3),
        threads=WIDE_F32_BWD_THREADS,
        scores_smem=1024 + WIDE_F32_BWD_S_STAGES * 2 * row_tile,
        grads_smem=1024 + WIDE_F32_BWD_G_STAGES * (
            row_tile + WIDE_F32_BWD_COLS * 128),
        padded=(nqp, nkp), chunk=chunk, chunks=-(-nkp // chunk),
        scratch=(bh * (d * (2 * nqp + nkp) + 3 * chunk * nqp
                       + d * (2 * nq + 2 * nk)),))


# The fp32 D = 32 packed rows 3 and 8, the split-head rows 2 and 7 and the
# streaming rows 4 and 5 (csrc/hopper_narrow_f32.cuh): an images launch
# writes the operands rounded to TF32, and transposed where a product
# contracts over keys or queries, as tile images into scratch; then the
# forward, or (row 5: after its log-sum-exp grid) the dk/dv and dq grids,
# stream them on TF32 wgmma. Its constants, mirrored here so that the CPU
# tests reach the plan
NARROW_F32_HEAD_DIM = 32
NARROW_F32_PAD = 64                    # rows an image's length is padded to
NARROW_F32_WG_ROWS = 64                # rows a warpgroup owns
NARROW_F32_FWD_KEYS = 64               # keys of a forward K / V^T tile
NARROW_F32_MMA_SYNC_MAX = 64           # both lengths at most: mma.sync grids
NARROW_F32_FWD_WG_PER_SM = 6           # the forward and row 5's lse grid
NARROW_F32_FWD_STAGES = 3              # K / V^T tiles of the forward's ring
NARROW_F32_DKDV_STAGES = 2             # q, do, q^T, do^T, lse, delta
NARROW_F32_DQ_STAGES = 3               # k, v, k^T
NARROW_F32_STREAMED = 64               # rows of a backward's streamed tile
NARROW_F32_IMG_ROWS = 32               # rows of an images block


class NarrowF32Plan(NamedTuple):
    """The launches of the fp32 D = 32 forwards (packed, split-head or
    streaming) and backwards (packed, split-head or streaming) for ``bh``
    heads: ``mma_sync`` where the entries keep ``attention_f32_narrow.cuh``'s
    grids (the rest then describes the launches they do not make);
    ``padded`` the image lengths (Nq, Nk padded); ``fwd`` (blocks, threads,
    keys a tile, shared memory); ``lse``, the streaming backward's
    log-sum-exp grid, and ``dkdv`` and ``dq`` (blocks, threads, shared
    memory); the fp32 scratch of a forward call and of a backward call of
    rows 7, 5 and 8 (their images); the streaming forward's ``splits`` of
    the keys (its grid's y, each split ``keys_per_split`` keys; one split of
    every key elsewhere)."""
    mma_sync: bool
    padded: Tuple[int, int]
    fwd: Tuple[int, int, int, int]
    lse: Tuple[int, int, int]
    dkdv: Tuple[int, int, int]
    dq: Tuple[int, int, int]
    fwd_scratch: int
    bwd_scratch: int
    splits: int
    keys_per_split: int


@functools.lru_cache(maxsize=256)   # a wrapper asks at every call
def narrow_f32_plan(bh: int, nq: int, nk: int,
                    splits: int = 1) -> NarrowF32Plan:
    """The launches of the fp32 D = 32 kernels for ``bh`` heads of ``nq``
    queries against ``nk`` keys, as ``hnarrow_f32::launch_fwd`` /
    ``launch_bwd`` make them: two warpgroups a block (sharing its ring)
    where the owned length is longer than one warpgroup's 64 rows, one
    otherwise; the ``mma.sync`` grids where both lengths are at most
    ``NARROW_F32_MMA_SYNC_MAX`` (the one-call A/B's choice, PERF.md).
    ``splits``: the streaming forward's cut of the keys
    (``streaming_splits``, counted on 64-row q-tiles whatever q-tile the
    grid uses), in units of ``STREAMING_TILE`` keys as
    ``flash_attention_streaming.cu`` cuts them."""
    pad, rows, d = NARROW_F32_PAD, NARROW_F32_WG_ROWS, NARROW_F32_HEAD_DIM
    npq, npk = -(-nq // pad) * pad, -(-nk // pad) * pad
    tile = NARROW_F32_STREAMED * 128
    wgs = lambda n: 2 if n > rows else 1
    keys = NARROW_F32_FWD_KEYS
    own = lambda n: 2 * wgs(n) * rows * 128
    units = -(-nk // STREAMING_TILE)
    return NarrowF32Plan(
        mma_sync=max(nq, nk) <= NARROW_F32_MMA_SYNC_MAX,
        padded=(npq, npk),
        fwd=(bh * -(-nq // (wgs(nq) * rows)), wgs(nq) * 128, keys,
             1024 + NARROW_F32_FWD_STAGES * 2 * keys * 128
             + wgs(nq) * rows * 128 + 2 * NARROW_F32_FWD_STAGES * 8),
        lse=(bh * -(-nq // (wgs(nq) * rows)), wgs(nq) * 128,
             1024 + NARROW_F32_FWD_STAGES * keys * 128
             + wgs(nq) * rows * 128 + (2 * NARROW_F32_FWD_STAGES + 1) * 8),
        dkdv=(bh * -(-nk // (wgs(nk) * rows)), wgs(nk) * 128,
              1024 + own(nk) + NARROW_F32_DKDV_STAGES * (4 * tile + 1024)
              + (2 * NARROW_F32_DKDV_STAGES + 1) * 8),
        dq=(bh * -(-nq // (wgs(nq) * rows)), wgs(nq) * 128,
            1024 + own(nq) + NARROW_F32_DQ_STAGES * 3 * tile
            + (2 * NARROW_F32_DQ_STAGES + 1) * 8),
        fwd_scratch=2 * bh * npk * d,
        bwd_scratch=bh * d * (4 * npq + 3 * npk),
        splits=splits, keys_per_split=-(-units // splits) * STREAMING_TILE)


def streaming_splits(bh: int, nq: int, nk: int) -> int:
    """Blocks the K / V stream of one query tile is cut over by the streaming
    forward kernel: as many as bring the grid to ``STREAMING_TARGET_BLOCKS``,
    at most one per key tile, every split non-empty."""
    q_tiles = -(-nq // STREAMING_TILE)
    kv_tiles = -(-nk // STREAMING_TILE)
    want = min(max(1, STREAMING_TARGET_BLOCKS // (bh * q_tiles)), kv_tiles)
    per_split = -(-kv_tiles // want)
    return -(-kv_tiles // per_split)


_BF16_HEAD_DIMS = {
    "flash_attention": FLASH_HEAD_DIMS, "flash_attention_bwd": BWD_HEAD_DIMS,
    "flash_attention_packed": PACKED_HEAD_DIMS,
    "flash_attention_bwd_packed": BWD_HEAD_DIMS,
    "flash_attention_fproj": FPROJ_HEAD_DIMS,
    "flash_attention_streaming": STREAMING_HEAD_DIMS,
    "flash_attention_streaming_bwd": STREAMING_BWD_HEAD_DIMS,
}


def _head_dims(kernel: str, dtype: torch.dtype) -> tuple:
    """The head widths ``kernel`` has instantiations for in ``dtype``."""
    table = {torch.bfloat16: _BF16_HEAD_DIMS, torch.float32: F32_HEAD_DIMS}
    return table[dtype][kernel] if dtype in table else ()


def flash_kernel_takes(head_dim: int, dtype: torch.dtype,
                       backward: bool = False) -> bool:
    """Whether the split-head CUDA kernel (``backward``: its backward kernel)
    takes this head width and type."""
    kernel = "flash_attention_bwd" if backward else "flash_attention"
    return head_dim in _head_dims(kernel, dtype)


def streaming_kernel_takes(head_dim: int, dtype: torch.dtype,
                           backward: bool = False) -> bool:
    """Whether the streaming CUDA kernel (``backward``: its backward kernels)
    takes this head width and type."""
    kernel = ("flash_attention_streaming_bwd" if backward
              else "flash_attention_streaming")
    return head_dim in _head_dims(kernel, dtype)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention, the spec of the kernel. q [B, H, Nq, D], k / v
    [B, H, Nk, D] -> [B, H, Nq, D]. Scores and softmax in fp32, the
    probabilities cast to v's type before the second product."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _folded_scale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale * log2(e) rounded to ``dtype``: the factor the streaming kernels
    multiply q by, in q's type, before the score product."""
    return torch.tensor(scale * LOG2E, dtype=torch.float64).to(dtype)


@functools.lru_cache(maxsize=None)
def _folded_factor(scale: float, dtype: torch.dtype) -> float:
    """``_folded_scale`` as the float the kernels' C entries take, made once
    for each (scale, type): a launch then builds no tensor on the host."""
    return float(_folded_scale(scale, dtype))


def streaming_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Plain version of the streaming attention kernel, with its roundings:
    q times scale * log2(e) in q's type, base-2 scores and softmax in fp32,
    the probabilities cast to v's type, and the denominator the sum of the
    cast probabilities. q [B, H, Nq, D], k / v [B, H, Nk, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * _folded_scale(scale, q.dtype).to(q.device)).float()
    s2 = torch.matmul(qs, k.float().transpose(-1, -2))
    p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True)).to(v.dtype).float()
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True
                                             ).clamp_min(1e-30)
    return out.to(q.dtype)


def streaming_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor,
                            scale: Optional[float] = None):
    """Plain version of the streaming attention backward: the row
    log-sum-exp recomputed from q times scale * log2(e) (in q's type) and k,
    p = exp2(s - lse), delta = rowsum(do * o) from the saved output, the rest
    in fp32 -> (dq, dk, dv) in the types of q, k, v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    qs = (q * _folded_scale(scale, q.dtype).to(q.device)).float()
    s2 = torch.matmul(qs, kf.transpose(-1, -2))
    m = s2.amax(dim=-1, keepdim=True)
    lse2 = m + torch.log2(torch.exp2(s2 - m).sum(dim=-1, keepdim=True
                                                 ).clamp_min(1e-30))
    p = torch.exp2(s2 - lse2)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dof * o.float()).sum(dim=-1, keepdim=True))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fproj_reference(h: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                    heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Composed formula the fused kernel implements, with its casts: q, k, v
    and the attention output are each cast to h's type between the stages,
    every product accumulates in fp32. Weights arrive cast to h's type."""
    b, n, _ = h.shape
    hd = wq.shape[0]
    d = hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    hf = h.float()
    proj = lambda w: torch.matmul(hf, w.float().t()).to(h.dtype)
    split = lambda t: t.reshape(b, n, heads, d).permute(0, 2, 1, 3)
    out = attention_reference(split(proj(wq)), split(proj(wk)),
                              split(proj(wv)), scale=scale)
    out = out.permute(0, 2, 1, 3).reshape(b, n, hd).to(h.dtype)
    res = torch.matmul(out.float(), wo.float().t()) + bo.float()
    return res.to(h.dtype)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, hd = t.shape
    return t.reshape(b, n, heads, hd // heads).permute(0, 2, 1, 3)


def packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention on the packed layout: q [B, Nq, H*D], k / v
    [B, Nk, H*D] -> [B, Nq, H*D], the arithmetic of ``attention_reference``
    per head."""
    out = attention_reference(_split_heads(q, heads), _split_heads(k, heads),
                              _split_heads(v, heads), scale=scale)
    return out.permute(0, 2, 1, 3).reshape(q.shape)


def packed_lse_reference(q: torch.Tensor, k: torch.Tensor, heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain row log-sum-exp of the packed forward: q [B, Nq, H*D], k
    [B, Nk, H*D] -> [B*H*Nq] fp32, log2 of the sum of exp(score * scale)
    (the domain of m + log2(l) over s * scale * log2(e) that the packed
    forward kernel saves for its backward)."""
    d = q.shape[-1] // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.matmul(_split_heads(q, heads).float(),
                     _split_heads(k, heads).float().transpose(-1, -2)) * scale
    return (torch.logsumexp(s, dim=-1) * LOG2E).reshape(-1)


def qout_reference(h: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   wq: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                   heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Composed formula the q/out-fused kernel implements, with its casts: q
    and the attention output are each cast to k's type, every product
    accumulates in fp32. Weights arrive cast to h's type."""
    q = torch.matmul(h.float(), wq.float().t()).to(k.dtype)
    out = packed_reference(q, k, v, heads, scale=scale)
    res = torch.matmul(out.float(), wo.float().t()) + bo.float()
    return res.to(h.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  scale: Optional[float] = None):
    """Plain backward of attention on split heads, the spec of the backward
    kernel: q / do [B, H, Nq, D], k / v [B, H, Nk, D] -> (dq, dk, dv) in the
    types of q, k, v. Everything in fp32, step by step."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, heads: int,
                         scale: Optional[float] = None):
    """Plain backward on the packed layout: q / do [B, Nq, H*D], k / v
    [B, Nk, H*D] -> (dq, dk, dv) packed alike, the arithmetic of
    ``flash_attention_bwd_reference`` per head."""
    grads = flash_attention_bwd_reference(
        _split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads),
        _split_heads(do, heads), scale=scale)
    merge = lambda t, like: t.permute(0, 2, 1, 3).reshape(like.shape)
    return merge(grads[0], q), merge(grads[1], k), merge(grads[2], v)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check_split_head_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")


def _entry(kernel: str, t: torch.Tensor, d: int) -> str:
    """The name of a kernel's C entry point for t's type and the head width
    d: ``dsml_`` + ``kernel`` for bf16, + ``_f32`` for fp32, where the kernel
    has an instantiation at d; anything else raises (before any build)."""
    dims = _head_dims(kernel, t.dtype)
    if d not in dims:
        raise ValueError(f"{kernel}: head width {d} not in {dims} for "
                         f"{t.dtype}")
    return typed_entry("dsml_" + kernel, t)


_SPLIT_HEAD_DTYPES = (torch.bfloat16, torch.float32)


def _narrow_f32_scratch(q, bh: int, nq: int, nk: int, which: str) -> tuple:
    """The scratch argument of an fp32 D = 32 entry (its tile images,
    ``narrow_f32_plan``'s ``which``: ``fwd_scratch`` or ``bwd_scratch``;
    None where the plan keeps the ``mma.sync`` grids); nothing for bf16,
    whose entries take no scratch."""
    if q.dtype != torch.float32:
        return ()
    plan = narrow_f32_plan(bh, nq, nk)
    if plan.mma_sync:   # the mma.sync grids read no images
        return (None,)
    return (torch.empty(getattr(plan, which), dtype=torch.float32,
                        device=q.device),)


def _f32_scratch(q, nk: int, splits: int = 1) -> tuple:
    """The scratch argument of a split-head fp32 forward entry, its tile
    images: at D = 512 ``wide_f32_plan``'s, at D = 32 ``narrow_f32_plan``'s
    (``_narrow_f32_scratch``); nothing for bf16."""
    b, h, nq, d = q.shape
    if q.dtype == torch.float32 and d == WIDE_F32_HEAD_DIM:
        return (torch.empty(wide_f32_plan(b * h, nq, nk, splits).scratch,
                            dtype=torch.float32, device=q.device),)
    return _narrow_f32_scratch(q, b * h, nq, nk, "fwd_scratch")


def _f32_bwd_scratch(q, nk: int) -> tuple:
    """The scratch argument of a split-head fp32 backward entry: at D = 512
    ``wide_f32_bwd_plan``'s, at D = 32 ``narrow_f32_plan``'s images
    (``_narrow_f32_scratch``); nothing for bf16."""
    b, h, nq, d = q.shape
    if q.dtype == torch.float32 and d == WIDE_F32_HEAD_DIM:
        return (torch.empty(wide_f32_bwd_plan(b * h, nq, nk).scratch,
                            dtype=torch.float32, device=q.device),)
    return _narrow_f32_scratch(q, b * h, nq, nk, "bwd_scratch")


def _launch_flash_forward(q, k, v, scale: float, want_lse: bool):
    """Check, launch and count the split-head forward kernel. With
    ``want_lse`` it also writes each row's log-sum-exp ([B*H*Nq] fp32), which
    the backward kernel reads; without, the second result is None."""
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda_operand(name, t, q, (q.dtype,))
    b, h, nq, d = q.shape
    from . import _build

    entry = _entry("flash_attention", q, d)
    launch = getattr(_build.load(), entry)
    out = torch.empty_like(q)
    lse = (torch.empty(b * h * nq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    scratch = _f32_scratch(q, k.shape[2])
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch), b * h, nq,
        k.shape[2], d, float(scale), current_stream(q))
    raise_on_error(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float):
    """Launch the split-head backward kernels: q / o / do [B, H, Nq, D], k / v
    [B, H, Nk, D] on the card, lse the forward kernel's [B*H*Nq] fp32 row
    log-sum-exp -> (dq, dk, dv). ``do`` is made contiguous here (autograd may
    hand over an expanded or transposed view)."""
    do = do.contiguous()
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        check_cuda_operand(name, t, q, (q.dtype,))
    check_cuda_operand("lse", lse, q, (torch.float32,))
    b, h, nq, d = q.shape
    from . import _build

    entry = _entry("flash_attention_bwd", q, d)
    launch = getattr(_build.load(), entry)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    scratch = _f32_bwd_scratch(q, k.shape[2])
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * h, nq, k.shape[2], d, float(scale),
        *(None if t is None else t.data_ptr() for t in scratch),
        current_stream(q))
    raise_on_error(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel / backward kernel on the card; the plain forward and the
    plain backward formula on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return attention_reference(q, k, v, scale=scale)
        want = any(ctx.needs_input_grad[:3])
        out, lse = _launch_flash_forward(q, k, v, scale, want)
        if want:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        if do.device.type == "cpu":
            q, k, v = ctx.saved_tensors
            return (*flash_attention_bwd_reference(q, k, v, do,
                                                   scale=ctx.scale), None)
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.scale), None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact-softmax attention. q [B, H, Nq, D], k / v [B, H, Nk, D]. A call
    on the card that needs no gradient launches without the autograd
    ``Function`` around it: the same launch, less host work a call."""
    _check_split_head_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda and not _needs_grad(q, k, v):
        return _launch_flash_forward(q, k, v, float(scale), False)[0]
    return _FlashAttention.apply(q, k, v, float(scale))


def _launch_streaming_forward(q, k, v, scale: float):
    """Check, launch and count the streaming forward kernel."""
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda_operand(name, t, q, (q.dtype,))
    b, h, nq, d = q.shape
    nk = k.shape[2]
    from . import _build

    entry = _entry("flash_attention_streaming", q, d)
    launch = getattr(_build.load(), entry)
    out = torch.empty_like(q)
    splits = streaming_splits(b * h, nq, nk)
    part_o = part_ml = None
    if splits > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_o = torch.empty((splits, b * h * nq, d), **f32)
        part_ml = torch.empty((splits, 2, b * h * nq), **f32)
    scratch = _f32_scratch(q, nk, splits)
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch), b * h, nq,
        nk, d, splits, _folded_factor(scale, q.dtype), current_stream(q))
    raise_on_error(code, "flash_attention_streaming")
    LAUNCHES["flash_attention_streaming"] += 1
    return out


def flash_attention_streaming_bwd(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  do: torch.Tensor,
                                  scale: Optional[float] = None):
    """Backward of the streaming attention from (q, k, v), the saved output
    o and its gradient do: q / o / do [B, H, Nq, D], k / v [B, H, Nk, D]
    -> (dq, dk, dv). The row log-sum-exp is recomputed by a launch of its
    own. ``do`` is made contiguous here."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_split_head_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o{tuple(o.shape)} and do{tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if q.device.type == "cpu":
        return streaming_bwd_reference(q, k, v, o, do, scale=scale)
    do = do.contiguous()
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        check_cuda_operand(name, t, q, (q.dtype,))
    b, h, nq, d = q.shape
    from . import _build

    entry = _entry("flash_attention_streaming_bwd", q, d)
    launch = getattr(_build.load(), entry)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty(b * h * nq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    scratch = _f32_bwd_scratch(q, k.shape[2])
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * h, nq, k.shape[2], d, float(scale),
        _folded_factor(scale, q.dtype),
        *(None if t is None else t.data_ptr() for t in scratch),
        current_stream(q))
    raise_on_error(code, "flash_attention_streaming_bwd")
    LAUNCHES["flash_attention_streaming_bwd"] += 1
    return dq, dk, dv


class _StreamingAttention(torch.autograd.Function):
    """Streaming forward kernel / streaming backward kernels on the card,
    their plain versions on the CPU. The residuals are (q, k, v, o), as the
    JAX package's."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            out = streaming_attention_reference(q, k, v, scale=scale)
        else:
            out = _launch_streaming_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        return (*flash_attention_streaming_bwd(q, k, v, out, do, ctx.scale),
                None)


def flash_attention_streaming(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Exact-softmax attention for sequences of any length. q [B, H, Nq, D],
    k / v [B, H, Nk, D] -> [B, H, Nq, D]. Without a gradient to track, no
    autograd ``Function`` (as ``flash_attention``)."""
    _check_split_head_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda and not _needs_grad(q, k, v):
        return _launch_streaming_forward(q, k, v, float(scale))
    return _StreamingAttention.apply(q, k, v, float(scale))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The split-head dispatch, in the JAX package's order: the resident
    kernel's counterpart ``flash_attention`` unless ``DSML_FLASH_STREAMING``
    is ``1`` or, under ``auto`` (the default), ``streaming_auto`` holds for
    the shape; then ``flash_attention_streaming``. ``0`` never streams."""
    refuse_unported("DSML_FLASH_ATTN")
    mode = env_mode("DSML_FLASH_STREAMING", "auto", ("auto", "1", "0"))
    if mode == "1" or (mode == "auto" and streaming_auto(
            q.shape[2], k.shape[2], q.shape[3])):
        return flash_attention_streaming(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


class _KernelForward(torch.autograd.Function):
    """Forward through a fused kernel, backward by ordinary autograd of the
    composed formula the kernel implements (recomputed from the saved
    operands). The JAX package does the same for these two ops (``_fproj_bwd``
    and ``_qout_bwd`` differentiate the jnp reference; XLA compiles it), so
    plain PyTorch ops on the card are that backward's true counterpart: no
    TPU kernel stands behind it."""

    @staticmethod
    def forward(ctx, launch, reference, heads, scale, *operands):
        ctx.reference, ctx.heads, ctx.scale = reference, heads, scale
        ctx.save_for_backward(*operands)
        return launch(*operands, heads, scale)

    @staticmethod
    def backward(ctx, grad):
        operands = [t.detach().requires_grad_(need) for t, need in
                    zip(ctx.saved_tensors, ctx.needs_input_grad[4:])]
        with torch.enable_grad():
            out = ctx.reference(*operands, ctx.heads, scale=ctx.scale)
        wanted = [t for t in operands if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, None, None,
                *(next(grads) if t.requires_grad else None for t in operands))


def fproj_kernel_takes(c: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the fused-projection CUDA kernel takes this self-attention
    (channel width, head width, activation type). What it does not take goes
    through the composed branch of the caller, never through a plain version
    on the card."""
    return (head_dim in _head_dims("flash_attention_fproj", dtype)
            and c % FPROJ_CHANNEL_MULTIPLE == 0)


def flash_attention_fproj(h: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                          heads: int, scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Projection-fused self-attention. h [B, N, C] (the LayerNorm output),
    wq / wk / wv [H*D, C], wo [C, H*D], bo [C] -> [B, N, C]. Weights must be
    cast to h's type by the caller (once, as the model does)."""
    if h.dim() != 3:
        raise ValueError(f"h must be [B, N, C], got {tuple(h.shape)}")
    b, n, c = h.shape
    hd = wq.shape[0]
    if hd % heads or wq.shape != (hd, c) or wk.shape != (hd, c) \
            or wv.shape != (hd, c) or wo.shape != (c, hd) or bo.shape != (c,):
        raise ValueError(
            f"bad fproj shapes h{tuple(h.shape)} wq{tuple(wq.shape)} "
            f"wk{tuple(wk.shape)} wv{tuple(wv.shape)} wo{tuple(wo.shape)} "
            f"bo{tuple(bo.shape)} heads={heads}")
    d = hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    refuse_unported("DSML_FLASH_ATTN")
    if h.device.type == "cpu":
        return fproj_reference(h, wq, wk, wv, wo, bo, heads, scale=scale)
    if h.device.type != "cuda":
        raise ValueError(f"flash_attention_fproj: unsupported device {h.device}")
    if not _needs_grad(h, wq, wk, wv, wo, bo):
        return _fproj_launch(h, wq, wk, wv, wo, bo, heads, float(scale))
    return _KernelForward.apply(_fproj_launch, fproj_reference, heads,
                                float(scale), h, wq, wk, wv, wo, bo)


# the fp32 D = 32 design's plan (flash_attention_fproj.cu: F_KEYS,
# F_ONE_WG_ROWS, F_FILL, F_MAX_GROUPS, F_MAX_COLS, F_STAGES, F_OUT_STAGES,
# f_attend_smem, f_plan)
F32_FPROJ_KEYS = 64            # keys of a streamed K / V tile
F32_FPROJ_ONE_WG_ROWS = 64     # N up to which a block is one warpgroup
F32_FPROJ_FILL = 64            # blocks a grid should have
F32_FPROJ_MAX_GROUPS = 16      # head-group blocks of a cluster, at most
F32_FPROJ_MAX_COLS = 160       # output columns of a pass, at most
F32_FPROJ_STAGES = 4           # K / V tiles of the ring
F32_FPROJ_OUT_STAGES = 4       # attention and Wo panels of the out ring


def fproj_f32_pass_cols(cg: int) -> int:
    """Output columns of a pass of the fp32 attention launch over a block's
    cg columns (``f_pass_cols``)."""
    return next(w for w in range(F32_FPROJ_MAX_COLS, 0, -32) if cg % w == 0)


def fproj_f32_smem(wgs: int, hg: int, cols: int) -> int:
    """Shared memory of the fp32 attention launch (``f_attend_smem``): the
    q / attention panels of hg heads, then the larger of the K / V ring and
    the output projection's ring."""
    rows = 64 * wgs
    return (1024 + hg * rows * 128
            + max(F32_FPROJ_STAGES * 2 * F32_FPROJ_KEYS * 128,
                  F32_FPROJ_OUT_STAGES * (rows + cols) * 128)
            + (2 * F32_FPROJ_STAGES + 1) * 8)


@functools.lru_cache(maxsize=None)
def fproj_f32_plan(b: int, n: int, c: int, heads: int
                   ) -> Tuple[int, int, int]:
    """(warpgroups a block, head-group blocks a cluster, output columns a
    pass) of the fp32 D = 32 fused-projection kernel
    (``dsml_flash_attention_fproj_f32``; ``f_plan``), or (0, 0, 0) where
    nothing fits. Candidates: two warpgroups (a 128-row q-tile) only past
    ``F32_FPROJ_ONE_WG_ROWS`` tokens, then one; head groups up to
    ``F32_FPROJ_MAX_GROUPS`` that divide the heads and leave each block one
    pass of a multiple of 32 columns, at most ``F32_FPROJ_MAX_COLS``, within
    the shared memory. The first whose grid has ``F32_FPROJ_FILL`` blocks,
    else the one with the most blocks; where no grouping leaves one pass,
    one warpgroup, the fewest groups that fit, several passes."""
    best = (0, 0, 0)
    for wgs in ((2, 1) if n > F32_FPROJ_ONE_WG_ROWS else (1,)):
        for g in range(1, F32_FPROJ_MAX_GROUPS + 1):
            cg = c // g
            if (heads % g or c % (32 * g) or cg > F32_FPROJ_MAX_COLS
                    or fproj_f32_smem(wgs, heads // g, cg)
                    > SHARED_MEMORY_PER_BLOCK):
                continue
            blocks = b * -(-n // (64 * wgs)) * g
            if blocks >= F32_FPROJ_FILL:
                return wgs, g, cg
            if blocks > best[0]:
                best = (blocks, wgs, g)
    if best[0]:
        return best[1], best[2], c // best[2]
    for g in range(1, F32_FPROJ_MAX_GROUPS + 1):
        if (not heads % g and not c % (32 * g)
                and fproj_f32_smem(1, heads // g, fproj_f32_pass_cols(c // g))
                <= SHARED_MEMORY_PER_BLOCK):
            return 1, g, fproj_f32_pass_cols(c // g)
    return 0, 0, 0


F32_FPROJ_QKV_FILL = 192       # blocks the projection launch should have


def fproj_f32_qkv_cols(b: int, n: int, hd: int) -> int:
    """Output columns of a block of the fp32 projection launch
    (``f_qkv_cols``): the widest multiple of 32 up to ``F32_FPROJ_MAX_COLS``
    that divides H*D and gives ``F32_FPROJ_QKV_FILL`` blocks (row tiles of
    64 up to 64 tokens, else 128, per batch element), else 32."""
    rows = 64 if n <= 64 else 128
    tiles = b * -(-n // rows)
    for w in range(F32_FPROJ_MAX_COLS, 31, -32):
        if hd % w == 0 and tiles * (3 * hd // w) >= F32_FPROJ_QKV_FILL:
            return w
    return 32


def fproj_scratch_shape(b: int, n: int, c: int, hd: int,
                        dtype: torch.dtype) -> tuple:
    """The scratch of the fused-projection kernel: q / k / v, [B, N, 3 H*D],
    in bf16; in fp32 B * H*D * (2 N + npad) + C * H*D floats (q and k
    [B, N, H*D], v^T [B, H, 32, npad] with N rounded up to the key tile, Wo
    rounded to TF32)."""
    if dtype == torch.float32:
        npad = -(-n // F32_FPROJ_KEYS) * F32_FPROJ_KEYS
        return (b * hd * (2 * n + npad) + c * hd,)
    return (b, n, 3 * hd)


def _fproj_launch(h, wq, wk, wv, wo, bo, heads: int, scale: float):
    """Check, launch and count the fused-projection kernels."""
    b, n, c = h.shape
    hd = wq.shape[0]
    d = hd // heads
    check_cuda_operand("h", h, h, _SPLIT_HEAD_DTYPES)
    for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                    ("bo", bo)):
        check_cuda_operand(name, t, h, (h.dtype,))
    if c % FPROJ_CHANNEL_MULTIPLE:
        raise ValueError(f"flash_attention_fproj: C={c} must be a multiple of "
                         f"{FPROJ_CHANNEL_MULTIPLE}")
    entry = _entry("flash_attention_fproj", h, d)
    from . import _build

    launch = getattr(_build.load(), entry)
    qkv = torch.empty(fproj_scratch_shape(b, n, c, hd, h.dtype),
                      dtype=h.dtype, device=h.device)
    out = torch.empty_like(h)
    code = launch(
        h.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, c,
        heads, d, float(scale),
        current_stream(h))
    raise_on_error(code, "flash_attention_fproj")
    LAUNCHES["flash_attention_fproj"] += 1
    return out


def packed_kernel_takes(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the packed CUDA kernel takes this head width and type."""
    return head_dim in _head_dims("flash_attention_packed", dtype)


def packed_bwd_kernel_takes(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the packed backward CUDA kernels take this head width and
    type."""
    return head_dim in _head_dims("flash_attention_bwd_packed", dtype)


def _launch_packed_forward(q, k, v, heads: int, scale: float, want_lse: bool):
    """Check, launch and count the packed forward kernel; ``want_lse`` as in
    ``_launch_flash_forward`` ([B*H*Nq] fp32)."""
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda_operand(name, t, q, (q.dtype,))
    b, nq, hd = q.shape
    entry = _entry("flash_attention_packed", q, hd // heads)
    from . import _build

    launch = getattr(_build.load(), entry)
    out = torch.empty_like(q)
    lse = (torch.empty(b * heads * nq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    scratch = _narrow_f32_scratch(q, b * heads, nq, k.shape[1], "fwd_scratch")
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *(t if t is None else t.data_ptr() for t in scratch), b, nq,
        k.shape[1], heads, hd // heads, float(scale), current_stream(q))
    raise_on_error(code, "flash_attention_packed")
    LAUNCHES["flash_attention_packed"] += 1
    return out, lse


def flash_attention_bwd_packed(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor, heads: int,
                               scale: float):
    """Launch the packed backward kernels: q / o / do [B, Nq, H*D], k / v
    [B, Nk, H*D] on the card, lse the forward kernel's [B*H*Nq] fp32 row
    log-sum-exp -> (dq, dk, dv) in the packed layout. ``do`` is made
    contiguous here."""
    do = do.contiguous()
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        check_cuda_operand(name, t, q, (q.dtype,))
    check_cuda_operand("lse", lse, q, (torch.float32,))
    b, nq, hd = q.shape
    d = hd // heads
    entry = _entry("flash_attention_bwd_packed", q, d)
    from . import _build

    launch = getattr(_build.load(), entry)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    scratch = _narrow_f32_scratch(q, b * heads, nq, k.shape[1], "bwd_scratch")
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, nq, k.shape[1], heads, d, float(scale),
        *(t if t is None else t.data_ptr() for t in scratch),
        current_stream(q))
    raise_on_error(code, "flash_attention_bwd_packed")
    LAUNCHES["flash_attention_bwd_packed"] += 1
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """Packed forward kernel / packed backward kernel on the card; the plain
    versions on the CPU. (The JAX package's ``_packed_bwd`` can also go
    through a head split and the split-head backward, when its packed block
    does not fit the TPU's fast memory: no such case exists here.)"""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.heads, ctx.scale = heads, scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return packed_reference(q, k, v, heads, scale=scale)
        want = any(ctx.needs_input_grad[:3])
        out, lse = _launch_packed_forward(q, k, v, heads, scale, want)
        if want:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        heads, scale = ctx.heads, ctx.scale
        if do.device.type == "cpu":
            q, k, v = ctx.saved_tensors
            return (*packed_bwd_reference(q, k, v, do, heads, scale=scale),
                    None, None)
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd_packed(q, k, v, out, lse, do, heads,
                                            scale), None, None)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Exact-softmax attention on the packed layout. q [B, Nq, H*D], k / v
    [B, Nk, H*D] -> [B, Nq, H*D]."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or q.shape[2] % heads:
        raise ValueError(f"bad packed attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2] // heads)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_packed: unsupported device {q.device}")
    return _PackedAttention.apply(q, k, v, heads, float(scale))


def packed_multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Attention for callers that keep activations packed: q [B, Nq, H*D],
    k / v [B, Nk, H*D] -> [B, Nq, H*D]. The packed kernel for the head widths
    and type it takes; on the card, anything else goes through a head split,
    ``multi_head_attention`` and a merge (which raises for what its kernels
    do not take either)."""
    refuse_unported("DSML_FLASH_ATTN")
    d = q.shape[-1] // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda or packed_kernel_takes(d, q.dtype):
        return flash_attention_packed(q, k, v, heads, scale=scale)
    split = lambda t: _split_heads(t, heads).contiguous()
    out = multi_head_attention(split(q), split(k), split(v), scale=scale)
    return out.permute(0, 2, 1, 3).reshape(q.shape)


def _qout_shared_memory(hd: int, head_dim: int) -> int:
    """Bytes of shared memory a block of the q/out-fused kernel needs (as
    ``smem_bytes`` in its source): 1024 of alignment slack, the [rows, H*D]
    attention tile in 64-column panels, three ring stages (each the largest
    of a K and a V tile of 128 rows, an h panel and one head's Wq panel of
    64 channels, a Wo panel of 160 rows of 32 columns, rounded up to 1024)
    and six 8-byte barriers."""
    stage = max(2 * 128 * 2 * head_dim, (QOUT_ROWS + head_dim) * 64 * 2,
                160 * 32 * 2)
    stage = -(-stage // 1024) * 1024
    return 1024 + -(-hd // 64) * QOUT_ROWS * 128 + 3 * stage + 6 * 8


def qout_kernel_takes(c: int, hd: int, head_dim: int,
                      dtype: torch.dtype) -> bool:
    """Whether the q/out-fused CUDA kernel takes this self-attention (channel
    width, packed width H*D, head width, activation type)."""
    return (dtype == torch.bfloat16 and head_dim in QOUT_HEAD_DIMS
            and c % QOUT_CHANNEL_MULTIPLE == 0
            and _qout_shared_memory(hd, head_dim) <= SHARED_MEMORY_PER_BLOCK)


def flash_attention_qout(h: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         wq: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                         heads: int, scale: Optional[float] = None
                         ) -> torch.Tensor:
    """q/out-projection-fused attention. h [B, N, C] (the LayerNorm output),
    k / v [B, Nk, H*D] already projected, wq [H*D, C], wo [C, H*D], bo [C]
    -> [B, N, C]. Weights must be cast to h's type by the caller."""
    if h.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != h.shape[0]:
        raise ValueError(f"bad qout shapes h{tuple(h.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, n, c = h.shape
    nk, hd = k.shape[1], k.shape[2]
    if hd % heads or wq.shape != (hd, c) or wo.shape != (c, hd) \
            or bo.shape != (c,):
        raise ValueError(
            f"bad qout shapes h{tuple(h.shape)} k{tuple(k.shape)} "
            f"wq{tuple(wq.shape)} wo{tuple(wo.shape)} bo{tuple(bo.shape)} "
            f"heads={heads}")
    d = hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if h.device.type == "cpu":
        return qout_reference(h, k, v, wq, wo, bo, heads, scale=scale)
    if h.device.type != "cuda":
        raise ValueError(f"flash_attention_qout: unsupported device {h.device}")
    return _KernelForward.apply(_qout_launch, qout_reference, heads,
                                float(scale), h, k, v, wq, wo, bo)


def _qout_launch(h, k, v, wq, wo, bo, heads: int, scale: float):
    """Check, launch and count the q/out-fused kernel."""
    b, n, c = h.shape
    nk, hd = k.shape[1], k.shape[2]
    d = hd // heads
    for name, t in (("h", h), ("k", k), ("v", v), ("wq", wq), ("wo", wo),
                    ("bo", bo)):
        check_cuda_operand(name, t, h)
    if not qout_kernel_takes(c, hd, d, h.dtype):
        raise ValueError(
            f"flash_attention_qout: C={c} must be a multiple of "
            f"{QOUT_CHANNEL_MULTIPLE}, the head width {d} one of "
            f"{QOUT_HEAD_DIMS}, and its tiles "
            f"({_qout_shared_memory(hd, d)} bytes) must fit the "
            f"{SHARED_MEMORY_PER_BLOCK} bytes of shared memory of a block")
    from . import _build

    lib = _build.load()
    out = torch.empty_like(h)
    code = lib.dsml_flash_attention_qout(
        h.data_ptr(), k.data_ptr(), v.data_ptr(), wq.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), out.data_ptr(), b, n, nk, c, heads, d, float(scale),
        current_stream(h))
    raise_on_error(code, "flash_attention_qout")
    LAUNCHES["flash_attention_qout"] += 1
    return out


def fused_qout_self_attention(h: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, wq: torch.Tensor,
                              wo: torch.Tensor, bo: torch.Tensor, heads: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch of the q/out-fused self-attention: the fused kernel for the
    shapes it takes; on the card, anything else is composed from a linear,
    ``packed_multi_head_attention`` and a linear. Weights are cast to h's
    type here."""
    refuse_unported("DSML_FLASH_ATTN")
    wq, wo, bo = (w.to(h.dtype) for w in (wq, wo, bo))
    hd = k.shape[-1]
    if not h.is_cuda or qout_kernel_takes(h.shape[-1], hd, hd // heads,
                                          h.dtype):
        return flash_attention_qout(h, k, v, wq, wo, bo, heads, scale=scale)
    out = packed_multi_head_attention(F.linear(h, wq), k, v, heads, scale=scale)
    return F.linear(out, wo, bo)
