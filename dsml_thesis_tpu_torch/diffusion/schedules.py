"""Diffusion noise schedules and DDIM sub-schedules.

Counterpart of ``dsml_thesis_tpu/diffusion/schedules.py``: everything is
computed once in float64 numpy and kept as float32 tensors on the CPU. The
samplers are Python loops, so they read per-step scalars from these host
tensors (no device synchronisation) and hand them to device tensors as
0-dim operands.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule in float64, CompVis latent-diffusion semantics."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                 + cosine_s)
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM timestep subsequence (1-indexed into the ddpm chain)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.arange(0, num_ddpm_timesteps, c)
    elif ddim_discr_method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                      num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(
            f"There is no ddim discretization method called "
            f"'{ddim_discr_method}'")
    # +1 so the final alpha scales all the way to data; clamped to the chain
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


def make_strength_ddim_timesteps(num_ddim_timesteps: int,
                                 num_ddpm_timesteps: int,
                                 strength: float) -> np.ndarray:
    """Strength-scaled DDIM subsequence of the editing stack: the first
    ``strength`` fraction of the chain in ``num_ddim_timesteps`` linspace
    steps, the first pinned to 1, so the forward chain ends exactly at
    t = T * strength."""
    ts = (np.linspace(0, 1, num_ddim_timesteps)
          * int(num_ddpm_timesteps * strength))
    ts = np.asarray([int(s) for s in ts], dtype=np.int64)
    ts[0] = 1
    return ts


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """Per-DDIM-step (sigma, alpha_bar, alpha_bar_prev) triples."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([alphacums[:1],
                                  alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM chain quantities sampling and training read, float32 on the
    CPU."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(beta_schedule: str = "linear", timesteps: int = 1000,
                  linear_start: float = 1e-4, linear_end: float = 2e-2,
                  cosine_s: float = 8e-3,
                  given_betas: Optional[np.ndarray] = None,
                  v_posterior: float = 0.0, parameterization: str = "eps"
                  ) -> DiffusionSchedule:
    if given_betas is not None:
        betas = np.asarray(given_betas, dtype=np.float64)
    else:
        betas = make_beta_schedule(beta_schedule, timesteps,
                                   linear_start=linear_start,
                                   linear_end=linear_end, cosine_s=cosine_s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (1 - v_posterior) * betas * (
        1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod) + v_posterior * betas
    if parameterization == "eps":
        # posterior_variance[0] == 0: infinite at index 0, overwritten below
        with np.errstate(divide="ignore"):
            lvlb_weights = betas ** 2 / (
                2 * posterior_variance * alphas * (1 - alphas_cumprod))
    elif parameterization == "x0":
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    else:
        raise NotImplementedError("mu not supported")
    lvlb_weights = np.asarray(lvlb_weights)
    lvlb_weights[0] = lvlb_weights[1]
    return DiffusionSchedule(
        betas=_f32(betas),
        alphas_cumprod=_f32(alphas_cumprod),
        alphas_cumprod_prev=_f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=_f32(posterior_variance),
        posterior_log_variance_clipped=_f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=_f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=_f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod)),
        lvlb_weights=_f32(lvlb_weights),
    )


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-step DDIM quantities, ordered by ascending ddpm timestep."""

    timesteps: torch.Tensor               # int64 [S]: timesteps fed to the model
    alphas: torch.Tensor                  # [S] alpha_bar at t
    alphas_prev: torch.Tensor             # [S] alpha_bar at the previous step
    sqrt_one_minus_alphas: torch.Tensor   # [S]
    sqrt_one_minus_alphas_prev: torch.Tensor  # [S] (deterministic inversion)
    sigmas: torch.Tensor                  # [S] eta-scaled sigma

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_ddim_schedule(schedule: DiffusionSchedule, num_steps: int,
                       eta: float = 0.0, method: str = "uniform",
                       strength: Optional[float] = None) -> DDIMSchedule:
    """``strength`` < 1 traverses only that first fraction of the chain
    (``make_strength_ddim_timesteps``); 1 or more is the full chain."""
    alphacums = schedule.alphas_cumprod.numpy().astype(np.float64)
    n = schedule.num_timesteps
    if strength is not None and strength < 1.0:
        tsteps = make_strength_ddim_timesteps(num_steps, n, strength)
    else:
        tsteps = make_ddim_timesteps(method, num_steps, n)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        alphacums, tsteps, eta)
    return DDIMSchedule(
        timesteps=torch.from_numpy(np.asarray(tsteps, dtype=np.int64).copy()),
        alphas=_f32(alphas),
        alphas_prev=_f32(alphas_prev),
        sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas)),
        sqrt_one_minus_alphas_prev=_f32(np.sqrt(1.0 - alphas_prev)),
        sigmas=_f32(sigmas),
    )


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch scalars from a 1-D schedule tensor and broadcast to
    ``ndim`` dimensions; the result lies where ``t`` lies."""
    out = a.to(t.device)[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))
