"""PLMS (pseudo-linear multistep) sampler.

Counterpart of ``dsml_thesis_tpu/diffusion/plms.py``: the Adams-Bashforth
style multistep update over eps predictions:
  - step 0: e_t, then a second eval at t_prev to form (e_t + e_t_next)/2
  - step 1: (3 e_t - e_old) / 2
  - step 2: (23 e_t - 16 e_1 + 5 e_2) / 12
  - step 3+: (55 e_t - 59 e_1 + 37 e_2 - 9 e_3) / 24
so a chain of S steps makes S + 1 model calls. The JAX package keeps the eps
history in a fixed buffer and selects the order with ``lax.switch``; here it
is a Python list and the step count picks the formula. Model outputs are
taken in fp32; the per-step scalars are 0-dim fp32 tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ddim import EpsFn, initial_noise
from .schedules import DDIMSchedule


def _x_prev_from_eps(ddim: DDIMSchedule, x, e_t, index: int):
    a_t, a_prev = ddim.alphas[index], ddim.alphas_prev[index]
    sigma_t = ddim.sigmas[index]
    pred_x0 = (x - ddim.sqrt_one_minus_alphas[index] * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2, min=0.0)) * e_t
    return torch.sqrt(a_prev) * pred_x0 + dir_xt, pred_x0


def plms_sample(ddim: DDIMSchedule, eps_fn: EpsFn, shape,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    # the multistep update has no noise term: an eta > 0 schedule would give
    # variance-deficient samples silently (the reference asserts eta == 0;
    # raised here as the same AssertionError, kept under python -O)
    if float(ddim.sigmas.max()) != 0.0:
        raise AssertionError("PLMS requires an eta=0 schedule")
    img = initial_noise(shape, generator, x_T)
    S = ddim.num_steps
    b = shape[0]

    def t_at(index, like):
        return torch.full((b,), int(ddim.timesteps[index]), dtype=torch.long,
                          device=like.device)

    hist = []   # past eps, most recent first (at most 3 are read)
    for i in range(S):
        index = S - 1 - i
        e_t = eps_fn(img, t_at(index, img)).float()
        if not hist:
            # second eval at the previous timestep (the pseudo improved
            # Euler start)
            x_prev1, _ = _x_prev_from_eps(ddim, img, e_t, index)
            e_next = eps_fn(x_prev1, t_at(max(index - 1, 0), img)).float()
            e_prime = (e_t + e_next) / 2
        elif len(hist) == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif len(hist) == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1]
                       - 9 * hist[2]) / 24
        img, _ = _x_prev_from_eps(ddim, img, e_prime, index)
        hist = [e_t] + hist[:2]
    return img
