"""Attention ops of the port: two CUDA kernels, their plain PyTorch versions,
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

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel (built at first use, ``ops/_build.py``) or
raises: there is no fallback on the card. Each wrapper counts its launches in
``LAUNCHES``. Neither kernel is differentiated yet (the serving path runs
under ``torch.no_grad()``); calling a wrapper on a CUDA tensor that requires
grad raises.

Weights follow ``torch.nn.Linear``: ``[out_features, in_features]``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

# launches per kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_fproj": 0}

FLASH_HEAD_DIMS = (32, 64, 512)        # instantiations in flash_attention.cu
FPROJ_HEAD_DIMS = (32, 64)             # ... in flash_attention_fproj.cu
FPROJ_CHANNEL_MULTIPLE = 32            # depth step of its projection kernel


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check_cuda_operand(name: str, t: torch.Tensor, like: torch.Tensor):
    if t.device != like.device:
        raise ValueError(f"{name} lies on {t.device}, expected {like.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes "
                        "torch.bfloat16 only")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} requires grad: the CUDA kernel has no "
                           "backward yet (run under torch.no_grad())")


def _raise_on_error(code: int, what: str):
    if code == -1:
        raise ValueError(f"{what}: shape not taken by the CUDA kernel")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


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
        _check_cuda_operand(name, t, q)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    from . import _build

    lib = _build.load()
    out = torch.empty_like(q)
    code = lib.dsml_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, nq,
        nk, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "flash_attention")
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
        _check_cuda_operand(name, t, h)
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
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on_error(code, "flash_attention_fproj")
    LAUNCHES["flash_attention_fproj"] += 1
    return out
