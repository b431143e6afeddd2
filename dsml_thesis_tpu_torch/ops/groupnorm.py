"""GroupNorm(+SiLU) on channel-last tensors, as plain PyTorch ops.

The JAX package runs GroupNorm as plain ops by default too (its Pallas
GroupNorm kernels are off by default and are not ported yet). Statistics are
taken in fp32 per (batch, group), channel sums first and groups combined on
the small [B, C] result, like ``group_norm_silu_reference`` there. ``eps``
follows the nets: 1e-5 in the UNet, 1e-6 in the first stage.
"""
from __future__ import annotations

import torch


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """x [B, ..., C] (channels last) -> same shape and type."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cg = c // num_groups
    xf = x.float().reshape(b, -1, c)
    inv_count = 1.0 / (xf.shape[1] * cg)
    ch_sum = xf.sum(dim=1)                # [B, C]
    ch_sq = (xf * xf).sum(dim=1)
    g_mean = ch_sum.reshape(b, num_groups, cg).sum(-1) * inv_count
    g_sq = ch_sq.reshape(b, num_groups, cg).sum(-1) * inv_count
    # E[x^2] - E[x]^2 can go slightly negative from cancellation: clamp
    g_rstd = torch.rsqrt(torch.clamp(g_sq - g_mean * g_mean, min=0.0) + eps)
    c_mean = g_mean.repeat_interleave(cg, dim=-1)[:, None, :]
    c_rstd = g_rstd.repeat_interleave(cg, dim=-1)[:, None, :]
    xn = (xf - c_mean) * c_rstd * gamma.float() + beta.float()
    if silu:
        xn = xn * torch.sigmoid(xn)
    return xn.reshape(x.shape).to(x.dtype)
