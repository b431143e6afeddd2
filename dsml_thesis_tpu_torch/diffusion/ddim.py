"""DDIM sampling steps.

Counterpart of ``dsml_thesis_tpu/diffusion/ddim.py`` for the pieces the
serving path uses. ``eps_fn(x, t) -> eps`` is the model closure;
conditioning and classifier-free guidance are composed outside, through
``cfg_eps_fn``, so a step stays generic across the model families. The JAX
package scans a compiled step; here the chain is a Python loop and ``index``
is a Python int.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .schedules import DDIMSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _cat_tree(u, c):
    if isinstance(c, dict):
        return {k: _cat_tree(u[k], c[k]) for k in c}
    if c is None:
        return None
    return torch.cat([u, c], dim=0)


def cfg_eps_fn(apply_fn: Callable, cond, uncond, scale: float) -> EpsFn:
    """Classifier-free guidance closure. ``apply_fn(x, t, cond) -> eps``;
    ``cond`` / ``uncond`` are tensors or dicts of tensors. With scale 1 or no
    ``uncond`` a single conditional pass is used, else one batch-doubled
    call."""
    if uncond is None or scale == 1.0:
        return lambda x, t: apply_fn(x, t, cond)
    c_in = _cat_tree(uncond, cond)

    def eps(x, t):
        out = apply_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), c_in)
        e_uncond, e_cond = out.chunk(2, dim=0)
        return e_uncond + scale * (e_cond - e_uncond)

    return eps


def p_sample_ddim(ddim: DDIMSchedule, eps_fn: EpsFn, x: torch.Tensor,
                  index: int, noise: Optional[torch.Tensor] = None,
                  temperature: float = 1.0,
                  x0_postprocess: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One reverse DDIM step at schedule position ``index``; returns
    (x_prev, pred_x0). The per-step scalars are 0-dim fp32 tensors on the
    CPU, so the step math runs in fp32 on x's device without a host sync."""
    t = torch.full((x.shape[0],), int(ddim.timesteps[index]),
                   dtype=torch.long, device=x.device)
    e_t = eps_fn(x, t)
    a_t, a_prev = ddim.alphas[index], ddim.alphas_prev[index]
    sigma_t = ddim.sigmas[index]
    sqrt_1m_at = ddim.sqrt_one_minus_alphas[index]

    pred_x0 = (x - sqrt_1m_at * e_t) / torch.sqrt(a_t)
    if x0_postprocess is not None:
        pred_x0 = x0_postprocess(pred_x0)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2, min=0.0)) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * temperature * noise
    return x_prev, pred_x0
