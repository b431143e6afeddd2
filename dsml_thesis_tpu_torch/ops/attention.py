"""Attention ops of the port: eight CUDA kernels, their plain PyTorch
versions, and the wrappers that choose between them by where the tensor lies.

``flash_attention``        q [B, H, Nq, D], k / v [B, H, Nk, D] -> [B, H, Nq, D]
    kernel ``csrc/flash_attention.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel`` (``flash_attention``).
    Bound by operations at the first stage's shape (N = 4096, D = 512); the
    kernel streams K / V tiles through shared memory under an online softmax
    and splits D over two warps to fit the fp32 output in registers.

``flash_attention_fproj``  h [B, N, C] + projection weights -> [B, N, C]
    kernels ``csrc/flash_attention_fproj.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed_fproj``
    (``flash_attention_fproj``). Bound by operations; q, k, v go once through
    a bf16 scratch, the attention output and the head split stay in shared
    memory.

``flash_attention_packed`` q [B, Nq, H*D], k / v [B, Nk, H*D] -> [B, Nq, H*D]
    kernel ``csrc/flash_attention_packed.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed``
    (``flash_attention_packed``). Bound by operations; one block per (batch,
    head, 64-row tile) addresses its head inside the packed rows, so no
    head-split copy exists. ``packed_multi_head_attention`` is its dispatch.

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
    (``flash_attention_bwd``). Bound by operations; head widths 32 and 64 in
    bf16, 512 in fp32.

``flash_attention_bwd_packed``  the same on packed rows
    kernels ``csrc/flash_attention_bwd_packed.cu``; replaces the TPU kernel
    ``dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel_packed``
    (``flash_attention_bwd_packed``). Bound by operations; dq, dk, dv are
    written in place in the packed layout.

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
    widths 32, 64 and 512. The K / V stream of a query tile is cut over
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
    launch of its own recomputes the row log-sum-exp from q and k, then
    delta, a dk / dv grid and a dq grid as above. Head widths 32 and 64 in
    bf16, 512 in fp32.

fp32. The split-head forward, the streaming forward and both their backward
kernels also take fp32 tensors at head width 512 (``F32_HEAD_DIMS``): the
first stage's single-head attention block in first-stage training, which
runs in fp32 as the JAX package's does. Those instantiations multiply on the
tensor cores in TF32 (operands rounded once, fp32 accumulation and softmax;
``csrc/attention_f32.cuh``); every other kernel takes bf16 only.

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

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..flags import env_mode, refuse_unported
from ._launch import (LAUNCHES, check_cuda_operand, current_stream,  # noqa: F401
                      raise_on_error, reset_launches)

FLASH_HEAD_DIMS = (32, 64, 512)        # instantiations in flash_attention.cu
FPROJ_HEAD_DIMS = (32, 64)             # ... in flash_attention_fproj.cu
FPROJ_CHANNEL_MULTIPLE = 32            # depth step of its projection kernel
PACKED_HEAD_DIMS = (32, 64)            # ... in flash_attention_packed.cu
BWD_HEAD_DIMS = (32, 64)               # ... in both flash_attention_bwd*.cu
STREAMING_HEAD_DIMS = (32, 64, 512)    # ... in flash_attention_streaming.cu
STREAMING_BWD_HEAD_DIMS = (32, 64)     # ... in flash_attention_streaming_bwd.cu
# fp32 instantiations (TF32 products) of the four kernels above that the
# first stage's attention block runs in first-stage training
F32_HEAD_DIMS = (512,)
STREAMING_TILE = 64                    # query / key rows of its tiles
STREAMING_TARGET_BLOCKS = 264          # two blocks on each of 132 SMs
LOG2E = 1.4426950408889634
QOUT_HEAD_DIMS = (32, 64)              # ... in flash_attention_qout.cu
QOUT_CHANNEL_MULTIPLE = 16             # depth of one tensor-core product
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


def streaming_splits(bh: int, nq: int, nk: int) -> int:
    """Blocks the K / V stream of one query tile is cut over by the streaming
    forward kernel: as many as bring the grid to ``STREAMING_TARGET_BLOCKS``,
    at most one per key tile, every split non-empty."""
    q_tiles = -(-nq // STREAMING_TILE)
    kv_tiles = -(-nk // STREAMING_TILE)
    want = min(max(1, STREAMING_TARGET_BLOCKS // (bh * q_tiles)), kv_tiles)
    per_split = -(-kv_tiles // want)
    return -(-kv_tiles // per_split)


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


def _entry(name: str, t: torch.Tensor, bf16_dims, what: str) -> str:
    """The name of a split-head kernel's C entry point for t's type and head
    width: ``name`` for bf16 at ``bf16_dims``, ``name + "_f32"`` for fp32 at
    ``F32_HEAD_DIMS``; anything else raises (before any build)."""
    d = t.shape[-1]
    dims = F32_HEAD_DIMS if t.dtype == torch.float32 else bf16_dims
    if d not in dims:
        raise ValueError(f"{what}: head width {d} not in {dims} for {t.dtype}")
    return name + ("_f32" if t.dtype == torch.float32 else "")


_SPLIT_HEAD_DTYPES = (torch.bfloat16, torch.float32)


def _launch_flash_forward(q, k, v, scale: float, want_lse: bool):
    """Check, launch and count the split-head forward kernel. With
    ``want_lse`` it also writes each row's log-sum-exp ([B*H*Nq] fp32), which
    the backward kernel reads; without, the second result is None."""
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda_operand(name, t, q, (q.dtype,))
    b, h, nq, d = q.shape
    from . import _build

    entry = _entry("dsml_flash_attention", q, FLASH_HEAD_DIMS,
                   "flash_attention")
    launch = getattr(_build.load(), entry)
    out = torch.empty_like(q)
    lse = (torch.empty(b * h * nq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, nq, k.shape[2], d,
        float(scale), current_stream(q))
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

    entry = _entry("dsml_flash_attention_bwd", q, BWD_HEAD_DIMS,
                   "flash_attention backward")
    launch = getattr(_build.load(), entry)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * h, nq, k.shape[2], d, float(scale),
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact-softmax attention. q [B, H, Nq, D], k / v [B, H, Nk, D]."""
    _check_split_head_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale))


def _launch_streaming_forward(q, k, v, scale: float):
    """Check, launch and count the streaming forward kernel."""
    check_cuda_operand("q", q, q, _SPLIT_HEAD_DTYPES)
    for name, t in (("k", k), ("v", v)):
        check_cuda_operand(name, t, q, (q.dtype,))
    b, h, nq, d = q.shape
    nk = k.shape[2]
    from . import _build

    entry = _entry("dsml_flash_attention_streaming", q, STREAMING_HEAD_DIMS,
                   "flash_attention_streaming")
    launch = getattr(_build.load(), entry)
    out = torch.empty_like(q)
    splits = streaming_splits(b * h, nq, nk)
    part_o = part_ml = None
    if splits > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_o = torch.empty((splits, b * h * nq, d), **f32)
        part_ml = torch.empty((splits, 2, b * h * nq), **f32)
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b * h, nq, nk, d,
        splits, float(_folded_scale(scale, q.dtype)), current_stream(q))
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

    entry = _entry("dsml_flash_attention_streaming_bwd", q,
                   STREAMING_BWD_HEAD_DIMS, "flash_attention_streaming backward")
    launch = getattr(_build.load(), entry)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty(b * h * nq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    code = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * h, nq, k.shape[2], d, float(scale),
        float(_folded_scale(scale, q.dtype)), current_stream(q))
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
    k / v [B, H, Nk, D] -> [B, H, Nq, D]."""
    _check_split_head_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
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
    return (dtype == torch.bfloat16 and head_dim in FPROJ_HEAD_DIMS
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
    return _KernelForward.apply(_fproj_launch, fproj_reference, heads,
                                float(scale), h, wq, wk, wv, wo, bo)


def _fproj_launch(h, wq, wk, wv, wo, bo, heads: int, scale: float):
    """Check, launch and count the fused-projection kernels."""
    b, n, c = h.shape
    hd = wq.shape[0]
    d = hd // heads
    for name, t in (("h", h), ("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                    ("bo", bo)):
        check_cuda_operand(name, t, h)
    if not fproj_kernel_takes(c, d, h.dtype):
        raise ValueError(
            f"flash_attention_fproj: C={c} must be a multiple of "
            f"{FPROJ_CHANNEL_MULTIPLE} and the head width {d} one of "
            f"{FPROJ_HEAD_DIMS}")
    from . import _build

    lib = _build.load()
    qkv = torch.empty((b, n, 3 * hd), dtype=h.dtype, device=h.device)
    out = torch.empty_like(h)
    code = lib.dsml_flash_attention_fproj(
        h.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, c,
        heads, d, float(scale),
        current_stream(h))
    raise_on_error(code, "flash_attention_fproj")
    LAUNCHES["flash_attention_fproj"] += 1
    return out


def packed_kernel_takes(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the packed CUDA kernel takes this head width and type."""
    return dtype == torch.bfloat16 and head_dim in PACKED_HEAD_DIMS


def _launch_packed_forward(q, k, v, heads: int, scale: float, want_lse: bool):
    """Check, launch and count the packed forward kernel; ``want_lse`` as in
    ``_launch_flash_forward`` ([B*H*Nq] fp32)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q)
    b, nq, hd = q.shape
    d = hd // heads
    if d not in PACKED_HEAD_DIMS:
        raise ValueError(f"flash_attention_packed: head width {d} not in "
                         f"{PACKED_HEAD_DIMS}")
    from . import _build

    lib = _build.load()
    out = torch.empty_like(q)
    lse = (torch.empty(b * heads * nq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    code = lib.dsml_flash_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, nq, k.shape[1], heads, d,
        float(scale), current_stream(q))
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
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        check_cuda_operand(name, t, q)
    check_cuda_operand("lse", lse, q, (torch.float32,))
    b, nq, hd = q.shape
    d = hd // heads
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_packed backward: head width {d} "
                         f"not in {BWD_HEAD_DIMS}")
    from . import _build

    lib = _build.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    code = lib.dsml_flash_attention_bwd_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, nq, k.shape[1], heads, d, float(scale),
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


def _qout_shared_memory(c: int, hd: int, head_dim: int) -> int:
    """Bytes of shared memory a block of the q/out-fused kernel needs (as
    ``qout_smem_bytes`` in its source): the h / attention tile, the q tile
    and the K / V tiles, rows padded by 8."""
    return 2 * (64 * (max(c, hd) + 8) + 64 * (hd + 8) + 2 * 128 * (head_dim + 8))


def qout_kernel_takes(c: int, hd: int, head_dim: int,
                      dtype: torch.dtype) -> bool:
    """Whether the q/out-fused CUDA kernel takes this self-attention (channel
    width, packed width H*D, head width, activation type)."""
    return (dtype == torch.bfloat16 and head_dim in QOUT_HEAD_DIMS
            and c % QOUT_CHANNEL_MULTIPLE == 0
            and _qout_shared_memory(c, hd, head_dim) <= SHARED_MEMORY_PER_BLOCK)


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
            f"({_qout_shared_memory(c, hd, d)} bytes) must fit the "
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
