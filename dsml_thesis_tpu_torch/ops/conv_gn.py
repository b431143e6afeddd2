"""Convolution with the GroupNorm statistics of its output in its epilogue,
and the apply that normalizes from such statistics.

``conv_stats``  x [B, H, W, Cin], w [K, K, Cin, Cout] (K = 1 or 3), bias
    [B, Cout] fp32 (+ skip [B, H, W, Cout]; + in_stats, gamma, beta)
    -> (y [B, H, W, Cout], ch_sum [B, Cout] fp32, ch_sq [B, Cout] fp32)
    kernel ``csrc/conv_stats.cuh`` (entry points ``dsml_conv_stats`` in
    ``conv_stats.cu`` for bf16, ``dsml_conv_stats_f32`` in
    ``conv_stats_f32.cu`` for fp32); replaces the TPU kernel
    ``dsml_thesis_tpu/ops/conv_gn.py:_conv_kernel`` (``conv_stats_pallas``).
    SAME stride-1 conv, fp32 accumulation, plus a per-batch bias (the conv
    bias and the timestep vector of a ResBlock), plus an optional skip, one
    cast to x's type, and the per-channel sum and sum of squares of the values
    as stored. With ``in_stats`` the input is first GroupNorm(+SiLU)-normalized
    from those channel sums, and the zero border of the conv is applied after
    that. Bound by operations. Four designs, chosen a call by ``conv_plan``
    from the A/B on the card: pixel patches on mma.sync (0: the stems, and
    the normed 3 x 3 convs of images wider than 32 pixels), and the implicit
    GEMM over flattened output pixels on wgmma (``conv_igemm.cuh``): A
    straight from device memory (1: the 1 x 1 and unnormed convs), or, for a
    normed 3 x 3 conv, from a strip of input rows normalised once a chunk
    (2: one block an SM; 3: two). The public layouts are the JAX package's
    (NHWC, HWIO); designs 1-3 read the weight as [Cout, K, K, Cin], which is
    ``w.permute(3, 0, 1, 2)``: no copy where that view is contiguous (a
    ``channels_last`` Conv2d weight, as the port's are), else one copy a
    call.

Types. x, w and skip are of one type, bf16 (the UNet; the first stage in
sampling) or fp32 (first-stage training), on every device: a mixed call
raises ``TypeError``. bias, the statistics, gamma and beta are fp32 (the op
brings statistics and norm parameters to fp32). In bf16 the kernel multiplies
bf16 operands exactly; in fp32 it multiplies on the tensor cores in TF32
(operands rounded once, fp32 accumulation), where the plain version's cuDNN
conv follows the caller's ``torch.backends.cudnn.allow_tf32``.

``group_norm_silu_apply`` is ``ops.groupnorm.group_norm_silu_from_stats``: the
one fold from channel sums to a normalized tensor, shared with the kernel's
plain version so that the fused and the unfused path cannot drift apart.

The wrapper takes the plain version (``conv_stats_reference``) for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises. One routing
rule is the JAX package's own (``conv_stats`` there, lines 336-341): fewer
than 32 output channels (the 3-channel final convs) do not go to the kernel;
there the input is normalized from the given statistics and the conv is the
plain one, on either device. The JAX package's second rule, the fit of a whole
image in the TPU's fast memory, has no counterpart: every other shape goes to
the kernel.

Gradients. The kernel runs forward; backward differentiates
``conv_stats_reference`` recomputed from the saved operands with ordinary
autograd, as the JAX package's ``_conv_stats_bwd`` differentiates its jnp
reference: no TPU kernel stands behind that backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._launch import (ACTIVATION_DTYPES, LAUNCHES, check_cuda_operand,
                      current_stream, raise_on_error, typed_entry)
from .groupnorm import group_norm_silu_from_stats

CONV_TILE_W = 16                   # output columns of a design-0 block
CONV_MIN_COUT = 32                 # narrower outputs take the plain conv
CONV_MAX_GROUPS = 64               # groups of the input norm the kernel takes
NUM_SMS = 132                      # of an H100 SXM
SMEM_LIMIT = 232448                # bytes of shared memory a block may use
SMEM_TWO_BLOCKS = 115712           # ... and of each of two blocks an SM
# the implicit GEMM (conv_igemm.cuh): pixels a block, design 1's ring stages,
# bytes of a tile row, the output-channel tiles, the most splits of K
IG_BM, IG_STAGES, IG_ROWB = 128, 3, 128
IG_BLOCK_N = (160, 128, 64)
# the strip designs: (B tiles of the ring, A tiles), one block an SM (2) or
# two (3) (conv_igemm.cuh:StripShape)
IG_STRIP = {2: (4, 2), 3: (2, 1)}
IG_MAX_SPLITS = 8

group_norm_silu_apply = group_norm_silu_from_stats


@contextlib.contextmanager
def _exact_fp32_conv(dtype: torch.dtype):
    """bf16 values are exact in TF32 (8 of its 10 mantissa bits), so for bf16
    operands a TF32 convolution on the card IS the product in fp32 with fp32
    accumulation that the kernel computes: allowed inside this block, whatever
    the caller set, and restored after it."""
    saved = torch.backends.cudnn.allow_tf32
    if dtype == torch.bfloat16:
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv_stats_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         skip: Optional[torch.Tensor] = None,
                         in_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         gamma: Optional[torch.Tensor] = None,
                         beta: Optional[torch.Tensor] = None,
                         num_groups: int = 32, eps: float = 1e-5,
                         silu_in: bool = True):
    """Plain version of the kernel (and what its backward differentiates):
    optional GroupNorm(+SiLU) of the input from given channel sums, cast to
    x's type; the conv with fp32 accumulation; + per-batch bias (+ skip) in
    fp32; one cast to x's type; channel sums of the cast values."""
    if in_stats is not None:
        x = group_norm_silu_apply(x, in_stats[0], in_stats[1], gamma, beta,
                                  num_groups=num_groups, eps=eps, silu=silu_in)
    pad = (w.shape[0] - 1) // 2
    with _exact_fp32_conv(x.dtype):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), padding=pad)
    y = y.permute(0, 2, 3, 1) + bias[:, None, None, :].float()
    if skip is not None:
        y = y + skip.float()
    y = y.to(x.dtype)
    yf = y.float().reshape(y.shape[0], -1, y.shape[-1])
    return y, yf.sum(dim=1), (yf * yf).sum(dim=1)


def conv_tile_rows(hh: int, ksize: int) -> int:
    """Output rows of a block's patch in design 0: 16 for a 3x3 conv, 8 for
    a 1x1 conv (too little work a chunk for eight warps) and for an image of
    up to 8 rows (half of a 16-row block's warps would own no pixel)."""
    return 16 if ksize == 3 and hh > 8 else 8


def ig_images(sl: int, hw: int, batch: int) -> int:
    """Images that ``sl`` consecutive flattened pixels can touch
    (``conv_igemm.cuh:ig_images``)."""
    return min(batch, (sl - 2 + hw) // hw + 1)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the kernel runs one call: ``design`` 1-3 (implicit GEMM; 2 and 3
    with the strip) with ``block_n`` output channels a block and K cut into
    ``splits`` ranges, or design 0 (pixel patches) with ``tile_rows`` patch
    rows; ``smem`` the bytes of shared memory a block, ``partial`` the shape
    of the fp32 scratch of the statistics."""
    design: int
    tile_rows: int
    block_n: int
    splits: int
    smem: int
    partial: Tuple[int, ...]

    def k_ranges(self, ksize: int, cin: int, kc: int):
        """The k-tiles [start, stop) of each split, as the kernel cuts them:
        design 1 cuts the k-tiles, designs 2 and 3 whole chunks of nine."""
        chunks = -(-cin // kc)
        if self.design >= 2:
            return [(9 * (r * chunks // self.splits),
                     9 * ((r + 1) * chunks // self.splits))
                    for r in range(self.splits)]
        total = ksize * ksize * chunks
        return [(r * total // self.splits, (r + 1) * total // self.splits)
                for r in range(self.splits)]


def ig_k_chunk(dtype: torch.dtype) -> int:
    """Channels of a k-tile of the implicit GEMM: a 128-byte row."""
    return IG_ROWB // (2 if dtype == torch.bfloat16 else 4)


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, hh: int, ww: int, cin: int, cout: int, ksize: int,
              dtype: torch.dtype, norm: bool = False, num_groups: int = 32,
              designs: Tuple[int, ...] = (0, 1, 2, 3)) -> ConvPlan:
    """The design of one call, among ``designs``, as the A/B of the designs
    on an H100 ranked them (``PERF.md``, kernel table):

    * pixel patches (0) where 16-byte copies do not take Cin (the stems: not
      a multiple of 8 bf16 or 4 fp32 channels);
    * a 3 x 3 conv with the input norm on image rows of at most 32 pixels:
      the strip, two blocks an SM (3) at the 8 x 8 level of a served batch
      (at most 32 output tiles) and where the output tiles fill two blocks
      on every SM and the smaller block fits, else one block an SM (2) where
      the strip is normalised at most W x N tiles <= 64 times over; pixel
      patches (0) for the rest, which normalise a halo tile once for all
      nine taps;
    * everything else: the implicit GEMM (1).

    Designs 1-3 take the widest output-channel tile that divides Cout (else
    64, masked) and split K in two until the blocks would pass the SMs'
    (two blocks an SM in designs 1 and 3, one in 2), a split would hold
    fewer than four k-tiles, or (2, 3) fewer than two chunks."""
    esize = 2 if dtype == torch.bfloat16 else 4
    hw = hh * ww
    bn = next((n for n in IG_BLOCK_N if cout % n == 0), 64)
    m_tiles = -(-b * hw // IG_BM)
    n_tiles = -(-cout // bn)
    chunks = -(-cin // ig_k_chunk(dtype))
    gn_bytes = lambda rows: (ig_images(rows, hw, b) * 2 * num_groups * 4
                             if norm else 0)
    rows = IG_BM + 2 * ww + 2
    strips = 2 * -(-rows * IG_ROWB // 1024) * 1024 + 1024 + gn_bytes(rows)
    vec = cin % (16 // esize) == 0
    smem = {0: None, 1: IG_STAGES * (IG_BM + bn) * IG_ROWB + 1024
            + gn_bytes(IG_BM)}
    for d, (stages, a_tiles) in IG_STRIP.items():
        smem[d] = strips + (stages * bn + a_tiles * IG_BM) * IG_ROWB
    takes = {0: True, 1: vec,
             2: vec and ksize == 3 and smem[2] <= SMEM_LIMIT,
             3: vec and ksize == 3 and smem[3] <= SMEM_TWO_BLOCKS}
    if ksize == 3 and norm:
        two = ((ww <= 8 and m_tiles * n_tiles <= 32)
               or m_tiles * n_tiles >= 2 * NUM_SMS)
        if ww <= 32 and ww * n_tiles <= 64:
            order = (3, 2, 0, 1) if two else (2, 3, 0, 1)
        elif ww <= 32 and two:
            order = (3, 0, 2, 1)
        else:
            order = (0, 2, 3, 1)
    else:
        order = (1, 0, 2, 3)
    design = next(d for d in order if d in designs and takes[d])
    if design == 0:
        rows0 = conv_tile_rows(hh, ksize)
        halo = (rows0 + ksize - 1) * (CONV_TILE_W + ksize - 1)
        kc, padx, s_size = (32, 8, 2) if esize == 2 else (16, 4, 4)
        smem0 = (halo * (kc + padx) + ksize * ksize * kc * (64 + 8)) * s_size
        if norm:
            smem0 += 2 * -(-cin // 8) * 8 * 4
        tiles = -(-hh // rows0) * -(-ww // CONV_TILE_W)
        return ConvPlan(0, rows0, 0, 1, smem0, (b, tiles, 2, cout))
    per_sm = 1 if design == 2 else 2
    splits = 1
    while (splits < IG_MAX_SPLITS
           and m_tiles * n_tiles * splits * 2 <= per_sm * NUM_SMS
           and ksize * ksize * chunks >= 4 * splits * 2
           and (design == 1 or chunks >= 2 * splits * 2)):
        splits *= 2
    return ConvPlan(design, 0, bn, splits, smem[design],
                    (m_tiles * splits, ig_images(IG_BM // splits, hw, b), 2,
                     cout))


def _launch_conv_stats(x, w, bias, skip, in_stats, gamma, beta, num_groups,
                       eps, silu_in):
    """Check, launch and count the kernel. w [K, K, Cin, Cout]; designs 1-3
    read it as [Cout, K, K, Cin]."""
    b, hh, ww, cin = x.shape
    ksize, cout = w.shape[0], w.shape[-1]
    f32 = (torch.float32,)
    plan = conv_plan(b, hh, ww, cin, cout, ksize, x.dtype,
                     in_stats is not None, num_groups)
    wk = (w.permute(3, 0, 1, 2) if plan.design else w).contiguous()
    check_cuda_operand("x", x, x, ACTIVATION_DTYPES)
    check_cuda_operand("w", wk, x, (x.dtype,))
    check_cuda_operand("bias", bias, x, f32)
    if skip is not None:
        check_cuda_operand("skip", skip, x, (x.dtype,))
    if cout % 8:
        raise ValueError(f"conv_stats: Cout={cout} must be a multiple of 8")
    null = [None] * 4
    if in_stats is not None:
        if cin % num_groups or num_groups > CONV_MAX_GROUPS:
            raise ValueError(
                f"conv_stats: Cin={cin} must divide into at most "
                f"{CONV_MAX_GROUPS} groups, got {num_groups}")
        null = [in_stats[0], in_stats[1], gamma, beta]
        for name, t in zip(("in_stats[0]", "in_stats[1]", "gamma", "beta"),
                           null):
            check_cuda_operand(name, t, x, f32)
    from . import _build

    launch = getattr(_build.load(), typed_entry("dsml_conv_stats", x))
    y = torch.empty((b, hh, ww, cout), dtype=x.dtype, device=x.device)
    partial = torch.empty(plan.partial, dtype=torch.float32, device=x.device)
    sums = torch.empty((2, b, cout), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = launch(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), ptr(skip),
        *map(ptr, null), y.data_ptr(), partial.data_ptr(), sums.data_ptr(), b,
        hh, ww, cin, cout, ksize, plan.design, plan.tile_rows, plan.block_n,
        plan.splits, num_groups, float(eps), int(silu_in), current_stream(x))
    raise_on_error(code, "conv_stats")
    LAUNCHES["conv_stats"] += 1
    return y, sums[0], sums[1]


class _ConvStats(torch.autograd.Function):
    """Forward through the kernel, backward by autograd of
    ``conv_stats_reference`` recomputed from the saved operands. ``skip``,
    ``s1``, ``s2``, ``gamma`` and ``beta`` may be None."""

    @staticmethod
    def forward(ctx, num_groups, eps, silu_in, x, w, bias, skip, s1, s2,
                gamma, beta):
        ctx.cfg = (num_groups, eps, silu_in)
        operands = (x, w, bias, skip, s1, s2, gamma, beta)
        ctx.present = [t is not None for t in operands]
        ctx.save_for_backward(*(t for t in operands if t is not None))
        f32 = lambda t: None if t is None else t.float().contiguous()
        return _launch_conv_stats(
            x, w, bias, skip, None if s1 is None else (f32(s1), f32(s2)),
            f32(gamma), f32(beta), num_groups, eps, silu_in)

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        num_groups, eps, silu_in = ctx.cfg
        saved = iter(ctx.saved_tensors)
        operands = [next(saved).detach().requires_grad_(need) if here else None
                    for here, need in zip(ctx.present,
                                          ctx.needs_input_grad[3:])]
        x, w, bias, skip, s1, s2, gamma, beta = operands
        with torch.enable_grad(), _exact_fp32_conv(x.dtype):
            outs = conv_stats_reference(
                x, w, bias, skip, None if s1 is None else (s1, s2), gamma,
                beta, num_groups, eps, silu_in)
            wanted = [t for t in operands if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (gy, gs1, gs2)))
        return (None, None, None,
                *(next(grads) if t is not None and t.requires_grad else None
                  for t in operands))


def conv_stats(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               skip: Optional[torch.Tensor] = None,
               in_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               gamma: Optional[torch.Tensor] = None,
               beta: Optional[torch.Tensor] = None, num_groups: int = 32,
               eps: float = 1e-5, silu_in: bool = True):
    """``[GroupNorm(+SiLU) from in_stats ->] conv K x K (+ per-batch bias,
    + optional skip)`` with the output's channel statistics: returns
    (y, ch_sum, ch_sq). Feed the statistics to the next
    ``conv_stats(in_stats=...)`` or ``group_norm_silu_apply``; they must not
    cross a change of spatial size."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] not in (1, 3) \
            or w.shape[1] != w.shape[0] or w.shape[2] != x.shape[-1]:
        raise ValueError(
            f"conv_stats takes x [B, H, W, Cin] and square 1x1 / 3x3 weights "
            f"[K, K, Cin, Cout], got x{tuple(x.shape)} w{tuple(w.shape)}")
    b, cout = x.shape[0], w.shape[-1]
    if bias.shape != (b, cout):
        raise ValueError(f"bias must be [{b}, {cout}], got {tuple(bias.shape)}")
    if skip is not None and skip.shape != (*x.shape[:3], cout):
        raise ValueError(f"skip{tuple(skip.shape)} must have the output's "
                         f"shape {(*x.shape[:3], cout)}")
    if in_stats is not None and (gamma is None or beta is None):
        raise ValueError("in_stats needs gamma and beta")
    for name, t in (("w", w), ("skip", skip)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"conv_stats: {name} is {t.dtype}, x {x.dtype}: "
                            f"x, w and skip take one type")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_stats: unsupported device {x.device}")
    if x.device.type == "cpu" or cout < CONV_MIN_COUT:
        return conv_stats_reference(x, w, bias, skip, in_stats, gamma, beta,
                                    num_groups, eps, silu_in)
    s1, s2 = in_stats if in_stats is not None else (None, None)
    if in_stats is None:
        gamma = beta = None
    return _ConvStats.apply(num_groups, eps, silu_in, x.contiguous(), w,
                            bias.contiguous(),
                            None if skip is None else skip.contiguous(),
                            s1, s2, gamma, beta)


conv3x3_stats = conv_stats   # the JAX package's older name for the same op
