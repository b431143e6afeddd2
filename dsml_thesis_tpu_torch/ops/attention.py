"""Attention ops of the port: four CUDA kernels, their plain PyTorch versions,
and the wrappers that choose between them by where the tensor lies.

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

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel (built at first use, ``ops/_build.py``) or
raises: there is no fallback on the card. Each wrapper counts its launches in
``LAUNCHES``. No kernel is differentiated yet (the serving path runs under
``torch.no_grad()``); calling a wrapper on a CUDA tensor that requires grad
raises.

Weights follow ``torch.nn.Linear``: ``[out_features, in_features]``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ._launch import (LAUNCHES, check_cuda_operand, current_stream,  # noqa: F401
                      raise_on_error, reset_launches)

FLASH_HEAD_DIMS = (32, 64, 512)        # instantiations in flash_attention.cu
FPROJ_HEAD_DIMS = (32, 64)             # ... in flash_attention_fproj.cu
FPROJ_CHANNEL_MULTIPLE = 32            # depth step of its projection kernel
PACKED_HEAD_DIMS = (32, 64)            # ... in flash_attention_packed.cu
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


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact-softmax attention. q [B, H, Nq, D], k / v [B, H, Nk, D]."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    from . import _build

    lib = _build.load()
    out = torch.empty_like(q)
    code = lib.dsml_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, nq,
        nk, d, float(scale), current_stream(q))
    raise_on_error(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


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
    if h.device.type == "cpu":
        return fproj_reference(h, wq, wk, wv, wo, bo, heads, scale=scale)
    if h.device.type != "cuda":
        raise ValueError(f"flash_attention_fproj: unsupported device {h.device}")
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
    b, nq, hd = q.shape
    nk, d = k.shape[1], hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return packed_reference(q, k, v, heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q)
    if d not in PACKED_HEAD_DIMS:
        raise ValueError(f"flash_attention_packed: head width {d} not in "
                         f"{PACKED_HEAD_DIMS}")
    from . import _build

    lib = _build.load()
    out = torch.empty_like(q)
    code = lib.dsml_flash_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk,
        heads, d, float(scale), current_stream(q))
    raise_on_error(code, "flash_attention_packed")
    LAUNCHES["flash_attention_packed"] += 1
    return out


def packed_multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Attention for callers that keep activations packed: q [B, Nq, H*D],
    k / v [B, Nk, H*D] -> [B, Nq, H*D]. The packed kernel for the head widths
    and type it takes; on the card, anything else goes through a head split,
    ``flash_attention`` and a merge (which raises for what that kernel does
    not take either)."""
    d = q.shape[-1] // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda or packed_kernel_takes(d, q.dtype):
        return flash_attention_packed(q, k, v, heads, scale=scale)
    split = lambda t: _split_heads(t, heads).contiguous()
    out = flash_attention(split(q), split(k), split(v), scale=scale)
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
    wq, wo, bo = (w.to(h.dtype) for w in (wq, wo, bo))
    hd = k.shape[-1]
    if not h.is_cuda or qout_kernel_takes(h.shape[-1], hd, hd // heads,
                                          h.dtype):
        return flash_attention_qout(h, k, v, wq, wo, bo, heads, scale=scale)
    out = packed_multi_head_attention(F.linear(h, wq), k, v, heads, scale=scale)
    return F.linear(out, wo, bo)
