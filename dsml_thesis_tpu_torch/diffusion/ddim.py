"""DDIM sampling and inversion.

Counterpart of ``dsml_thesis_tpu/diffusion/ddim.py``: the guidance closure,
the reverse step, the full chain (with inpainting, temperature and the
x0 hook), the chain with its pred_x0 trajectory, deterministic inversion, the
reverse chain from a given latent (differentiable: nothing here turns off
autograd), latent manipulation and ``stochastic_encode``.
``eps_fn(x, t) -> eps`` is the model closure; conditioning and
classifier-free guidance are composed outside, through ``cfg_eps_fn``, so a
step stays generic across the model families. The JAX package scans a
compiled step; here the chain is a Python loop, ``index`` is a Python int and
every per-step scalar a 0-dim fp32 tensor on the CPU (no step reads the
device). Random draws come from a ``torch.Generator`` (another stream than
``jax.random`` gives from the same seed); ``noise_seq`` arguments inject
them instead, row i at the chain's i-th step.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .schedules import DDIMSchedule, DiffusionSchedule

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


def draw_noise(generator: Optional[torch.Generator], like: torch.Tensor,
               seq: Optional[torch.Tensor], i: int) -> torch.Tensor:
    """A chain's i-th noise draw: row i of the injected ``seq``, else a
    normal draw like ``like`` from ``generator``."""
    if seq is not None:
        return seq[i]
    if generator is None:
        raise ValueError("pass a torch.Generator (or inject the noise)")
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=torch.float32)


def initial_noise(shape, generator: Optional[torch.Generator],
                  x_T: Optional[torch.Tensor]) -> torch.Tensor:
    """A chain's start: the injected ``x_T``, else a normal draw of
    ``shape`` from ``generator`` on the generator's device."""
    if x_T is not None:
        return x_T
    if generator is None:
        raise ValueError("pass a torch.Generator (or inject x_T)")
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


def ddim_sample(ddim: DDIMSchedule, sched: DiffusionSchedule, eps_fn: EpsFn,
                shape, generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None,
                temperature: float = 1.0, eta_noise: bool = True,
                x0_postprocess: Optional[Callable] = None,
                noise_seq: Optional[torch.Tensor] = None,
                mask_noise_seq: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The full DDIM reverse chain. With ``mask`` the known region
    (mask = 1) is re-noised from ``x0`` to each step's level first
    (``mask_noise_seq`` injects that noise); ``eta_noise`` adds the
    sigma-scaled step noise (``noise_seq`` injects it)."""
    if mask is not None and x0 is None:
        raise ValueError("inpainting mask requires x0 (reference ddim.py:145)")
    img = initial_noise(shape, generator, x_T)
    S = ddim.num_steps
    for i in range(S):
        index = S - 1 - i
        if mask is not None:
            # inpainting: re-noise the known region to the current level
            ts = int(ddim.timesteps[index])
            img_orig = (sched.sqrt_alphas_cumprod[ts] * x0
                        + sched.sqrt_one_minus_alphas_cumprod[ts]
                        * draw_noise(generator, x0, mask_noise_seq, i))
            img = img_orig * mask + (1.0 - mask) * img
        noise = draw_noise(generator, img, noise_seq, i) if eta_noise else None
        img, _ = p_sample_ddim(ddim, eps_fn, img, index, noise=noise,
                               temperature=temperature,
                               x0_postprocess=x0_postprocess)
    return img


def ddim_sample_with_intermediates(ddim: DDIMSchedule, sched: DiffusionSchedule,
                                   eps_fn: EpsFn, shape,
                                   generator: Optional[torch.Generator] = None,
                                   x_T: Optional[torch.Tensor] = None,
                                   log_every: int = 1):
    """Like ``ddim_sample`` (eta = 0) but also returns the pred_x0
    trajectory [K, B, ...]: the steps whose index is a multiple of
    ``log_every``, plus the first and the last."""
    img = initial_noise(shape, generator, x_T)
    S = ddim.num_steps
    keep = sorted({i for i in range(S) if (S - 1 - i) % log_every == 0}
                  | {0, S - 1})
    traj = []
    for i in range(S):
        img, pred_x0 = p_sample_ddim(ddim, eps_fn, img, S - 1 - i)
        if i in keep:
            traj.append(pred_x0)
    return img, torch.stack(traj)


def ddim_invert(ddim: DDIMSchedule, eps_fn: EpsFn,
                x0: torch.Tensor) -> torch.Tensor:
    """Deterministic forward DDIM (inversion) over the whole sub-schedule:
    step i moves x from noise level alphas_prev[i] to alphas[i], evaluating
    the model at t = timesteps[i]."""
    b = x0.shape[0]
    x = x0
    for i in range(ddim.num_steps):
        t = torch.full((b,), int(ddim.timesteps[i]), dtype=torch.long,
                       device=x.device)
        e_t = eps_fn(x, t)
        a_t, a_next = ddim.alphas_prev[i], ddim.alphas[i]
        pred_x0 = (x - ddim.sqrt_one_minus_alphas_prev[i] * e_t) / torch.sqrt(a_t)
        x = torch.sqrt(a_next) * pred_x0 + torch.sqrt(1.0 - a_next) * e_t
    return x


def ddim_reverse_from(ddim: DDIMSchedule, eps_fn: EpsFn, x_lat: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise_seq: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Reverse chain from a given noised latent; deterministic (eta = 0)
    unless ``generator`` or ``noise_seq`` is given, which adds the per-step
    sigma-scaled noise. Differentiable: gradients flow to ``x_lat`` and to
    whatever ``eps_fn`` closes over."""
    S = ddim.num_steps
    noisy = generator is not None or noise_seq is not None
    img = x_lat
    for i in range(S):
        noise = draw_noise(generator, img, noise_seq, i) if noisy else None
        img, _ = p_sample_ddim(ddim, eps_fn, img, S - 1 - i, noise=noise)
    return img


def latent_manipulation(ddim: DDIMSchedule, eps_fn_src: EpsFn,
                        eps_fn_trg: EpsFn, x0: torch.Tensor):
    """Forward DDIM with the source condition, reverse with the target one.
    Returns (edited latent, inverted latent)."""
    x_lat = ddim_invert(ddim, eps_fn_src, x0)
    return ddim_reverse_from(ddim, eps_fn_trg, x_lat), x_lat


def stochastic_encode(ddim: DDIMSchedule, x0: torch.Tensor, t_index,
                      noise: torch.Tensor) -> torch.Tensor:
    """Noise x0 to DDIM sub-schedule position ``t_index`` (an int or a [B]
    tensor of positions)."""
    idx = torch.as_tensor(t_index, dtype=torch.long).cpu()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    sa = torch.sqrt(ddim.alphas)[idx].reshape(shape).to(x0.device)
    sm = ddim.sqrt_one_minus_alphas[idx].reshape(shape).to(x0.device)
    return sa * x0 + sm * noise
