"""Gaussian-diffusion training math of the port, as plain functions of a
``DiffusionSchedule``.

Counterpart of ``dsml_thesis_tpu/diffusion/gaussian.py``: ``q_sample``,
``predict_start_from_noise``, ``q_posterior``, ``get_loss`` and ``p_losses``
(simple + VLB-weighted loss with optional per-sample weights), and the DDPM
ancestral sampling loop.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .ddim import draw_noise, initial_noise
from .schedules import DiffusionSchedule, extract


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Diffuse x_start to timestep t: sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    nd = x_start.dim()
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor,
                             t: torch.Tensor, noise: torch.Tensor
                             ) -> torch.Tensor:
    nd = x_t.dim()
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise)


def q_posterior(sched: DiffusionSchedule, x_start: torch.Tensor,
                x_t: torch.Tensor, t: torch.Tensor):
    """Mean, variance and log-variance of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.dim()
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    var = extract(sched.posterior_variance, t, nd)
    log_var = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, var, log_var


def get_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "l2") -> torch.Tensor:
    """Elementwise loss map (no reduction)."""
    if loss_type == "l1":
        return (target - pred).abs()
    if loss_type == "l2":
        return (target - pred) ** 2
    raise NotImplementedError(f"unknown loss type '{loss_type}'")


def p_losses(sched: DiffusionSchedule, model_eps: torch.Tensor,
             x_start: torch.Tensor, noise: torch.Tensor, t: torch.Tensor,
             parameterization: str = "eps", loss_type: str = "l2",
             l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0,
             logvar: Optional[torch.Tensor] = None,
             sample_weights: Optional[torch.Tensor] = None):
    """Simple + VLB-weighted diffusion loss given the model output on
    ``q_sample(x_start, t, noise)``. Returns (loss, aux dict).

    ``sample_weights`` ([B], optional) weights the per-sample means: the
    trainer's validation masks the padding rows of a ragged last batch with
    it."""
    if parameterization == "eps":
        target = noise
    elif parameterization == "x0":
        target = x_start
    else:
        raise NotImplementedError(parameterization)

    loss_map = get_loss(model_eps, target, loss_type)
    loss_simple = loss_map.reshape(loss_map.shape[0], -1).mean(dim=1)
    if logvar is not None:
        logvar_t = logvar.to(t.device)[t.long()]
        loss_gamma = loss_simple / torch.exp(logvar_t) + logvar_t
    else:
        loss_gamma = loss_simple
    loss_vlb = sched.lvlb_weights.to(t.device)[t.long()] * loss_simple
    if sample_weights is None:
        wmean = lambda x: x.mean()
    else:
        w = sample_weights.to(loss_simple.dtype)
        wmean = lambda x: (x * w).sum() / torch.clamp(w.sum(), min=1.0)
    loss = l_simple_weight * wmean(loss_gamma) \
        + original_elbo_weight * wmean(loss_vlb)
    aux = {"loss_simple": wmean(loss_simple), "loss_vlb": wmean(loss_vlb),
           "loss": loss}
    return loss, aux


def ddpm_p_sample_loop(sched: DiffusionSchedule,
                       denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor],
                       shape, generator: Optional[torch.Generator] = None,
                       clip_denoised: bool = True,
                       x_T: Optional[torch.Tensor] = None,
                       noise_seq: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Full ancestral DDPM sampling: ``num_timesteps`` model calls.

    denoise_fn(x_t, t[batch]) -> eps prediction (taken in fp32). x_T and
    noise_seq ([T, *shape], row i used at the i-th reverse step,
    t = T-1-i) inject the initial and per-step noise; otherwise both come
    from ``generator``. The per-step scalars are 0-dim fp32 tensors on the
    CPU, with the same values ``extract`` would gather."""
    img = initial_noise(shape, generator, x_T)
    b, T = shape[0], sched.num_timesteps
    for i in range(T):
        ts = T - 1 - i
        t = torch.full((b,), ts, dtype=torch.long, device=img.device)
        eps = denoise_fn(img, t).float()
        x_recon = (sched.sqrt_recip_alphas_cumprod[ts] * img
                   - sched.sqrt_recipm1_alphas_cumprod[ts] * eps)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean = (sched.posterior_mean_coef1[ts] * x_recon
                + sched.posterior_mean_coef2[ts] * img)
        noise = draw_noise(generator, img, noise_seq, i)
        # no noise at t == 0
        nonzero = 1.0 if ts > 0 else 0.0
        img = mean + nonzero * torch.exp(
            0.5 * sched.posterior_log_variance_clipped[ts]) * noise
    return img
