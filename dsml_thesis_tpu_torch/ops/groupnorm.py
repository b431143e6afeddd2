"""GroupNorm(+SiLU) on channel-last tensors: plain PyTorch ops by default,
two CUDA kernels behind ``DSML_PALLAS_GN`` (the JAX package's flag and its
default: ``0`` plain ops, ``1`` the whole-row kernel, ``stats`` the statistics
kernel followed by a plain apply).

``group_norm_silu_kernel``  x [B, ..., C] -> same shape
    kernel ``csrc/group_norm.cu`` (``dsml_group_norm_silu``, fp32:
    ``dsml_group_norm_silu_f32``); replaces the TPU kernel
    ``dsml_thesis_tpu/ops/groupnorm.py:_gn_kernel``
    (``group_norm_silu_pallas``). Bound by bytes; reduced per channel so
    that C/G = 5 costs nothing. A batch row of up to 192 Ki elements (the
    fp32 rows of mead-128-ldm-f4's 8 x 8 and 32 x 32 levels) takes one
    launch in a cluster of 8 blocks (``gn_plan``: read once into shared
    memory, summed through distributed shared memory, normalised from shared
    memory, no scratch); a larger one three (partial sums, a fixed-order
    finish, the apply). Takes every row size (the TPU kernel's 8 MB limit is
    not carried over).

``gn_channel_stats``        x [B, N, C] -> (sum, sum of squares), [B, C] fp32
    kernel ``csrc/group_norm.cu`` (``dsml_gn_channel_stats``, fp32:
    ``dsml_gn_channel_stats_f32``); replaces the TPU kernel
    ``dsml_thesis_tpu/ops/groupnorm.py:_gn_stats_kernel``
    (``_gn_channel_stats_pallas``). Bound by bytes; one read of x in one
    launch (a thread-block cluster a batch row, ``stats_plan``), sums in a
    fixed order (no atomics), so equal inputs give equal bits.

Types. x is bf16 (the UNet; the first stage in sampling) or fp32 (the first
stage in training, as the JAX package trains it; the UNet of
mead-128-ldm-f4, which sets no dtype); the output has x's type. gamma and
beta are fp32 or bf16 (a model cast for sampling, beside either type of x:
the JAX kernel casts them to fp32 whatever their type), on every device:
another type raises ``TypeError``.

A wrapper takes its plain version (``group_norm_silu_reference``,
``gn_channel_stats_reference``) only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises. Statistics are fp32 per (batch,
group), channel sums first and groups combined on the small [B, C] result.
``eps`` follows the nets: 1e-5 in the UNet, 1e-6 in the first stage.

Gradients. Both kernel modes run their kernel forward and differentiate
``group_norm_silu_reference`` backward with ordinary autograd
(``_ReferenceBackward``). The JAX package does the same
(``dsml_thesis_tpu/ops/groupnorm.py:_gn_reference_bwd`` differentiates the jnp
reference for both modes; XLA compiles it), so plain PyTorch ops on the card
are that backward's true counterpart: no TPU kernel stands behind it.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..flags import env_mode
from ._launch import (ACTIVATION_DTYPES, LAUNCHES, check_cuda_operand,
                      current_stream, raise_on_error, typed_entry)

GN_CHUNK_ELEMENTS = 16384   # elements of x a block of the three passes reduces
GNC_THREADS = 512           # threads of a cluster block (group_norm.cu)
GN_CLUSTER = 8              # blocks of a cluster a batch row, where it fits
GN_CLUSTER_ELEMENTS = 196608   # the largest row the cluster takes
SMEM_LIMIT = 232448         # bytes of shared memory a block may use
SMS = 132                   # streaming multiprocessors of an H100 SXM
STATS_MAX_CLUSTER = 16      # blocks of a statistics cluster, at most
PARAM_DTYPES = (torch.float32, torch.bfloat16)   # of gamma / beta


def _check_groups(c: int, num_groups: int) -> None:
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")


def _check_params(x: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> None:
    """gamma / beta [C] of one type, fp32 or bf16, on every device."""
    c = x.shape[-1]
    if gamma.shape != (c,) or beta.shape != (c,) or gamma.dtype != beta.dtype:
        raise ValueError(f"gamma{tuple(gamma.shape)} / beta{tuple(beta.shape)} "
                         f"must both be [{c}] of one type")
    if gamma.dtype not in PARAM_DTYPES:
        raise TypeError(f"gamma / beta are {gamma.dtype} beside x of "
                        f"{x.dtype}: fp32 or bf16 only")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def gn_channel_stats_reference(x3: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x3 [B, N, C] -> per (batch, channel) sum and sum of squares in fp32."""
    xf = x3.float()
    return xf.sum(dim=1), (xf * xf).sum(dim=1)


def group_norm_silu_from_stats(x: torch.Tensor, ch_sum: torch.Tensor,
                               ch_sq: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, num_groups: int = 32,
                               eps: float = 1e-5, silu: bool = True
                               ) -> torch.Tensor:
    """GroupNorm(+SiLU) of x [B, ..., C] from its per-channel (sum, sum of
    squares) [B, C] fp32: the group fold, the E[x^2] - E[x]^2 variance
    clamped at 0 (cancellation can take it slightly negative), eps inside
    the root, fp32 affine. The sums must cover exactly x's own rows."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, c)
    inv_count = 1.0 / (xf.shape[1] * cg)
    g_mean = ch_sum.reshape(b, num_groups, cg).sum(-1) * inv_count
    g_sq = ch_sq.reshape(b, num_groups, cg).sum(-1) * inv_count
    g_rstd = torch.rsqrt(torch.clamp(g_sq - g_mean * g_mean, min=0.0) + eps)
    c_mean = g_mean.repeat_interleave(cg, dim=-1)[:, None, :]
    c_rstd = g_rstd.repeat_interleave(cg, dim=-1)[:, None, :]
    xn = (xf - c_mean) * c_rstd * gamma.float() + beta.float()
    if silu:
        xn = xn * torch.sigmoid(xn)
    return xn.reshape(x.shape).to(x.dtype)


def group_norm_silu_reference(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, num_groups: int = 32,
                              eps: float = 1e-5, silu: bool = True
                              ) -> torch.Tensor:
    """Plain GroupNorm(+SiLU), the spec of the kernels. x [B, ..., C]
    (channels last) -> same shape and type."""
    b, c = x.shape[0], x.shape[-1]
    _check_groups(c, num_groups)
    ch_sum, ch_sq = gn_channel_stats_reference(x.reshape(b, -1, c))
    return group_norm_silu_from_stats(x, ch_sum, ch_sq, gamma, beta,
                                      num_groups=num_groups, eps=eps, silu=silu)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

class _ReferenceBackward(torch.autograd.Function):
    """Forward through ``forward_fn`` (a kernel mode of this module), backward
    by autograd of ``group_norm_silu_reference`` recomputed from the saved
    operands."""

    @staticmethod
    def forward(ctx, forward_fn, num_groups, eps, silu, x, gamma, beta):
        ctx.args = (num_groups, eps, silu)
        ctx.save_for_backward(x, gamma, beta)
        return forward_fn(x, gamma, beta, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        num_groups, eps, silu = ctx.args
        operands = [t.detach().requires_grad_(need) for t, need in
                    zip(ctx.saved_tensors, ctx.needs_input_grad[4:])]
        with torch.enable_grad():
            out = group_norm_silu_reference(*operands, num_groups=num_groups,
                                            eps=eps, silu=silu)
        wanted = [t for t in operands if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, None, None,
                *(next(grads) if t.requires_grad else None for t in operands))


def gn_chunks(n: int, c: int) -> int:
    """Blocks a batch row of n x c elements is cut into by the whole-row
    kernel's three passes (also the number of partial sums a channel has)."""
    rows = max(1, GN_CHUNK_ELEMENTS // c)
    return (n + rows - 1) // rows


def gn_cluster_smem(rows: int, c: int, dtype: torch.dtype,
                    num_groups: int = 32) -> int:
    """Bytes of shared memory of a cluster block that holds ``rows`` rows
    (``group_norm.cu:gn_cluster_smem``)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    cvs = c * esize // 16
    lanes = GNC_THREADS // min(cvs, GNC_THREADS)
    return rows * c * esize + 4 * (8 * c + -(-2 * num_groups // 4) * 4
                                   + 2 * lanes * c)


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, c: int, dtype: torch.dtype, num_groups: int = 32) -> int:
    """Blocks of the cluster that takes a batch row of n x c, or 0 for the
    three passes: the cluster where the row fits eight blocks' shared memory
    and holds at most ``GN_CLUSTER_ELEMENTS`` elements (past that the three
    passes were the faster in the A/B on an H100: ``PERF.md``)."""
    rows = -(-n // GN_CLUSTER)
    fits = gn_cluster_smem(rows, c, dtype, num_groups) <= SMEM_LIMIT
    return GN_CLUSTER if fits and n * c <= GN_CLUSTER_ELEMENTS else 0


def _stats_scratch(x3: torch.Tensor, chunks: int):
    b, _, c = x3.shape
    f32 = dict(dtype=torch.float32, device=x3.device)
    return torch.empty((b, chunks, 2, c), **f32), torch.empty((2, b, c), **f32)


@functools.lru_cache(maxsize=None)
def stats_plan(b: int, n: int, c: int) -> int:
    """Blocks of the statistics kernel's cluster a batch row of x [b, n, c]
    (``group_norm.cu:channel_stats``): the most, a power of two up to
    ``STATS_MAX_CLUSTER``, that keep b x blocks within the card's ``SMS``
    and leave no block without a row."""
    k = STATS_MAX_CLUSTER
    while k > 1 and (b * k > SMS or k > n):
        k //= 2
    return k


def gn_channel_stats(x3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x3 [B, N, C] -> (ch_sum, ch_sq), each [B, C] fp32, in one read of x
    and one launch."""
    if x3.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got {tuple(x3.shape)}")
    if x3.device.type == "cpu":
        return gn_channel_stats_reference(x3)
    if x3.device.type != "cuda":
        raise ValueError(f"gn_channel_stats: unsupported device {x3.device}")
    check_cuda_operand("x", x3, x3, ACTIVATION_DTYPES)
    b, n, c = x3.shape
    from . import _build

    launch = getattr(_build.load(), typed_entry("dsml_gn_channel_stats", x3))
    sums = torch.empty((2, b, c), dtype=torch.float32, device=x3.device)
    code = launch(x3.data_ptr(), sums.data_ptr(), b, n, c,
                  stats_plan(b, n, c), current_stream(x3))
    raise_on_error(code, "gn_channel_stats")
    LAUNCHES["gn_channel_stats"] += 1
    return tuple(sums.unbind(0))


def group_norm_silu_stats_fused(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, num_groups: int = 32,
                                eps: float = 1e-5, silu: bool = True
                                ) -> torch.Tensor:
    """GroupNorm(+SiLU) with the statistics from ``gn_channel_stats`` and the
    normalize / affine / SiLU as plain ops."""
    _check_groups(x.shape[-1], num_groups)
    _check_params(x, gamma, beta)
    return _ReferenceBackward.apply(_stats_fused_forward, num_groups, eps,
                                    silu, x, gamma, beta)


def _stats_fused_forward(x, gamma, beta, num_groups, eps, silu):
    b, c = x.shape[0], x.shape[-1]
    ch_sum, ch_sq = gn_channel_stats(x.reshape(b, -1, c))
    return group_norm_silu_from_stats(x, ch_sum, ch_sq, gamma, beta,
                                      num_groups=num_groups, eps=eps, silu=silu)


def group_norm_silu_kernel(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, num_groups: int = 32,
                           eps: float = 1e-5, silu: bool = True
                           ) -> torch.Tensor:
    """Whole-row GroupNorm(+SiLU) in one launch. x [B, ..., C] (channels
    last) -> same shape and type; gamma / beta [C] in fp32 or x's type."""
    _check_groups(x.shape[-1], num_groups)
    _check_params(x, gamma, beta)
    return _ReferenceBackward.apply(_whole_row_forward, num_groups, eps, silu,
                                    x, gamma, beta)


def _whole_row_forward(x, gamma, beta, num_groups, eps, silu):
    b, c = x.shape[0], x.shape[-1]
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, gamma, beta, num_groups=num_groups,
                                         eps=eps, silu=silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_kernel: unsupported device {x.device}")
    check_cuda_operand("x", x, x, ACTIVATION_DTYPES)
    for name, t in (("gamma", gamma), ("beta", beta)):
        check_cuda_operand(name, t, x, PARAM_DTYPES)
    from . import _build

    launch = getattr(_build.load(), typed_entry("dsml_group_norm_silu", x))
    x3 = x.reshape(b, -1, c)
    n = x3.shape[1]
    cluster = gn_plan(n, c, x.dtype, num_groups)
    chunks = gn_chunks(n, c)
    partial = sums = None
    if not cluster:
        partial, sums = _stats_scratch(x3, chunks)
    ptr = lambda t: None if t is None else t.data_ptr()
    out = torch.empty_like(x)
    code = launch(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(partial),
        ptr(sums), out.data_ptr(), b, n, c, num_groups, chunks, cluster,
        float(eps), int(silu), int(gamma.dtype == torch.bfloat16),
        current_stream(x))
    raise_on_error(code, "group_norm_silu_kernel")
    LAUNCHES["group_norm_silu"] += 1
    return out


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """Dispatch on ``DSML_PALLAS_GN``: ``0`` (default) plain ops, ``1`` the
    whole-row kernel, ``stats`` the statistics kernel and a plain apply.
    x [B, ..., C] (channels last) -> same shape and type."""
    mode = env_mode("DSML_PALLAS_GN", "0", ("0", "1", "stats"))
    fn = {"0": group_norm_silu_reference, "1": group_norm_silu_kernel,
          "stats": group_norm_silu_stats_fused}[mode]
    return fn(x, gamma, beta, num_groups=num_groups, eps=eps, silu=silu)
