"""DPM-Solver / DPM-Solver++ sampler suite for the discrete VP schedule.

Counterpart of ``dsml_thesis_tpu/diffusion/dpm_solver.py``: the 2M sampler
on the rounded DDPM timesteps (``dpm_solver_sample``), the continuous-time
schedule of the reference's ``NoiseScheduleVP('discrete')``
(``VPContinuous``), the first- to third-order single- and multistep updates
(both ``solver_type``s, eps- and x0-prediction), the DPM-Solver-fast order
schedule and the adaptive step-size solver.

The JAX package compiles the chain (``lax.scan`` / ``lax.switch`` /
``lax.while_loop``); here it is a Python loop. Every scalar of a chain (the
time nodes, their log-SNRs, each update's coefficients) is a 0-dim fp32
tensor on the CPU, computed in the JAX package's order of operations before
the chain's first model call; a device tensor meets them only as 0-dim
operands, so no step reads the device. A multistep chain computes only the
update its static order schedule names (the JAX scan computes all three and
selects one). Model outputs are taken in fp32 whatever type ``eps_fn``
returns, so the update math stays fp32.

Math (Lu et al. 2022, arXiv:2206.00927 + 2211.01095): with
lambda = log(alpha/sigma), the exact solution
  x_t = (sigma_t/sigma_s) x_s - alpha_t \\int e^{-lam} x0(lam) dlam
is discretized by Taylor expansions of the model in lambda.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ddim import EpsFn, initial_noise
from .schedules import DiffusionSchedule

Scalar = torch.Tensor  # a 0-dim fp32 tensor on the CPU


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32).copy())


def _scalar(v) -> Scalar:
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.float32)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` on increasing keypoints ``xp``: piecewise linear
    between them, ``fp[0]`` below ``xp[0]`` and ``fp[-1]`` above ``xp[-1]``,
    with its operations in its order (and its guard for a zero-width
    interval)."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _linspace(start, stop, num: int) -> torch.Tensor:
    """``jnp.linspace`` in fp32, endpoints included: start (1 - s) + stop s
    with s = i / (num - 1), the last node ``stop`` itself."""
    start, stop = _scalar(start), _scalar(stop)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(
        div, dtype=torch.float32)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


# ---------------------------------------------------------------------------
# DPM-Solver++(2M) on the rounded DDPM timesteps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPMSolverSchedule:
    timesteps: torch.Tensor  # int64 [S+1], descending (t_0 = T-1 ... t_S = 0)
    alphas: torch.Tensor     # sqrt(alpha_bar) at each node
    sigmas: torch.Tensor     # sqrt(1 - alpha_bar)
    lambdas: torch.Tensor    # log(alpha/sigma)


def make_dpm_schedule(sched: DiffusionSchedule,
                      num_steps: int) -> DPMSolverSchedule:
    n = sched.num_timesteps
    # uniform time steps from T-1 down to 0, inclusive endpoints (S+1 nodes)
    ts = np.linspace(n - 1, 0, num_steps + 1).round().astype(np.int64)
    ac = sched.alphas_cumprod.numpy().astype(np.float64)[ts]
    alphas = np.sqrt(ac)
    sigmas = np.sqrt(1.0 - ac)
    lambdas = np.log(alphas / sigmas)
    return DPMSolverSchedule(timesteps=torch.from_numpy(ts.copy()),
                             alphas=_f32(alphas), sigmas=_f32(sigmas),
                             lambdas=_f32(lambdas))


def dpm_solver_sample(dpm: DPMSolverSchedule, eps_fn: EpsFn, shape,
                      generator: Optional[torch.Generator] = None,
                      x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM-Solver++(2M): second-order multistep, first step is first-order."""
    x = initial_noise(shape, generator, x_T)
    b = shape[0]
    S = dpm.timesteps.shape[0] - 1
    lam, al, sg = dpm.lambdas, dpm.alphas, dpm.sigmas
    x0_prev = None
    for i in range(S):
        t = torch.full((b,), int(dpm.timesteps[i]), dtype=torch.long,
                       device=x.device)
        x0_cur = (x - sg[i] * eps_fn(x, t).float()) / al[i]
        h = lam[i + 1] - lam[i]
        h_last = lam[i] - lam[max(i - 1, 0)]
        # duplicate ROUNDED timesteps (num_steps near/above the schedule
        # length) give h_last = 0 -> r = 0 -> 1/(2r) = inf and an all-NaN
        # sample; degrade that step to first-order instead (x0_prev is the
        # same node's prediction, so the 2M correction carries no info)
        degenerate = bool(h == 0) or bool(h_last == 0)
        if x0_prev is not None and not degenerate:
            r = h_last / h
            D = (1.0 + 1.0 / (2.0 * r)) * x0_cur - (1.0 / (2.0 * r)) * x0_prev
        else:
            D = x0_cur
        x = (sg[i + 1] / sg[i]) * x - al[i + 1] * torch.expm1(-h) * D
        x0_prev = x0_cur
    return x


# ---------------------------------------------------------------------------
# Continuous-time VP schedule (NoiseScheduleVP 'discrete' mode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VPContinuous:
    """log alpha_t interpolated over t in (0, 1], fp32 on the CPU."""

    t_grid: torch.Tensor      # [N] = (1..N)/N
    log_alpha: torch.Tensor   # [N] = 0.5 log(alphas_cumprod)
    total_N: int = 1000

    def marginal_log_alpha(self, t):
        return interp(_scalar(t), self.t_grid, self.log_alpha)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_alpha(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_alpha(t)))

    def marginal_lambda(self, t):
        la = self.marginal_log_alpha(t)
        return la - 0.5 * torch.log(1.0 - torch.exp(2.0 * la))

    def inverse_lambda(self, lam):
        lam = _scalar(lam)
        target = -0.5 * torch.logaddexp(torch.zeros_like(lam), -2.0 * lam)
        # log_alpha decreases in t; flip for increasing interp keypoints
        return interp(target, self.log_alpha.flip(0), self.t_grid.flip(0))

    def model_input_time(self, t):
        """Continuous t -> the discrete model's timestep input."""
        return (_scalar(t) - 1.0 / self.total_N) * 1000.0


def make_vp_continuous(sched: DiffusionSchedule) -> VPContinuous:
    ac = sched.alphas_cumprod.numpy().astype(np.float64)
    n = len(ac)
    return VPContinuous(t_grid=_f32(np.arange(1, n + 1) / n),
                        log_alpha=_f32(0.5 * np.log(ac)), total_N=n)


# ---------------------------------------------------------------------------
# Solver updates (x0-pred = DPM-Solver++, eps-pred = classic). Each has a
# ``_*_coeffs`` half (host scalars only) and the update itself, which takes
# those coefficients precomputed (``k``) or computes them.
# ---------------------------------------------------------------------------

def _coeffs(vp, s, t) -> Dict[str, Scalar]:
    lam_s, lam_t = vp.marginal_lambda(s), vp.marginal_lambda(t)
    return dict(
        h=lam_t - lam_s, lam_s=lam_s, lam_t=lam_t,
        log_a_s=vp.marginal_log_alpha(s), log_a_t=vp.marginal_log_alpha(t),
        sig_s=vp.marginal_std(s), sig_t=vp.marginal_std(t),
        a_t=vp.marginal_alpha(t),
    )


def _first_coeffs(vp, s, t, predict_x0) -> Tuple[Scalar, Scalar]:
    """x_t = k_x x - k_m model_s."""
    c = _coeffs(vp, s, t)
    if predict_x0:
        return c["sig_t"] / c["sig_s"], c["a_t"] * torch.expm1(-c["h"])
    return (torch.exp(c["log_a_t"] - c["log_a_s"]),
            c["sig_t"] * torch.expm1(c["h"]))


def _first_update(vp, x, s, t, model_s, predict_x0, k=None):
    k_x, k_m = k if k is not None else _first_coeffs(vp, s, t, predict_x0)
    return k_x * x - k_m * model_s


def _second_s_coeffs(vp, s, t, r1, predict_x0, solver_type):
    """(s1, x_s1 = k1x x - k1m m_s, x_t = kx x - km m_s - kd (m_s1 - m_s))."""
    c = _coeffs(vp, s, t)
    h = c["h"]
    s1 = vp.inverse_lambda(c["lam_s"] + r1 * h)
    log_a_s1 = vp.marginal_log_alpha(s1)
    sig_s1 = vp.marginal_std(s1)
    a_s1 = torch.exp(log_a_s1)
    if predict_x0:
        k1 = (sig_s1 / c["sig_s"], a_s1 * torch.expm1(-r1 * h))
        kx, km = c["sig_t"] / c["sig_s"], c["a_t"] * torch.expm1(-h)
        if solver_type == "dpm_solver":
            kd = (0.5 / r1) * c["a_t"] * torch.expm1(-h)
        else:  # taylor
            kd = -((1.0 / r1) * c["a_t"] * (torch.expm1(-h) / h + 1.0))
    else:
        k1 = (torch.exp(log_a_s1 - c["log_a_s"]),
              sig_s1 * torch.expm1(r1 * h))
        kx = torch.exp(c["log_a_t"] - c["log_a_s"])
        km = c["sig_t"] * torch.expm1(h)
        if solver_type == "dpm_solver":
            kd = (0.5 / r1) * c["sig_t"] * torch.expm1(h)
        else:
            kd = (1.0 / r1) * c["sig_t"] * (torch.expm1(h) / h - 1.0)
    return s1, k1, (kx, km, kd)


def _second_update_s(vp, model_fn, x, s, t, r1, predict_x0, solver_type,
                     model_s=None, k=None):
    """Singlestep second-order update; returns (x_t, model_s, model_s1)."""
    s1, (k1x, k1m), (kx, km, kd) = (
        k if k is not None
        else _second_s_coeffs(vp, s, t, r1, predict_x0, solver_type))
    if model_s is None:
        model_s = model_fn(x, s)
    model_s1 = model_fn(k1x * x - k1m * model_s, s1)
    x_t = kx * x - km * model_s - kd * (model_s1 - model_s)
    return x_t, model_s, model_s1


def _third_s_coeffs(vp, s, t, r1, r2, predict_x0, solver_type):
    c = _coeffs(vp, s, t)
    h = c["h"]
    s1 = vp.inverse_lambda(c["lam_s"] + r1 * h)
    s2 = vp.inverse_lambda(c["lam_s"] + r2 * h)
    log_a_s1, log_a_s2 = vp.marginal_log_alpha(s1), vp.marginal_log_alpha(s2)
    sig_s1, sig_s2 = vp.marginal_std(s1), vp.marginal_std(s2)
    a_s1, a_s2 = torch.exp(log_a_s1), torch.exp(log_a_s2)
    if predict_x0:
        phi_11, phi_12 = torch.expm1(-r1 * h), torch.expm1(-r2 * h)
        phi_1 = torch.expm1(-h)
        phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        k1 = (sig_s1 / c["sig_s"], a_s1 * phi_11)
        k2 = (sig_s2 / c["sig_s"], a_s2 * phi_12,
              -((r2 / r1) * a_s2 * phi_22))
        kx, km = c["sig_t"] / c["sig_s"], c["a_t"] * phi_1
        if solver_type == "dpm_solver":
            kt = (-((1.0 / r2) * c["a_t"] * phi_2),)
        else:
            kt = (-(c["a_t"] * phi_2), c["a_t"] * phi_3)
    else:
        phi_11, phi_12 = torch.expm1(r1 * h), torch.expm1(r2 * h)
        phi_1 = torch.expm1(h)
        phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        k1 = (torch.exp(log_a_s1 - c["log_a_s"]), sig_s1 * phi_11)
        k2 = (torch.exp(log_a_s2 - c["log_a_s"]), sig_s2 * phi_12,
              (r2 / r1) * sig_s2 * phi_22)
        kx = torch.exp(c["log_a_t"] - c["log_a_s"])
        km = c["sig_t"] * phi_1
        if solver_type == "dpm_solver":
            kt = ((1.0 / r2) * c["sig_t"] * phi_2,)
        else:
            kt = (c["sig_t"] * phi_2, c["sig_t"] * phi_3)
    return s1, s2, r1, r2, k1, k2, (kx, km) + kt


def _third_update_s(vp, model_fn, x, s, t, r1, r2, predict_x0, solver_type,
                    model_s=None, model_s1=None, k=None):
    """Singlestep third-order update; returns (x_t, model_s, model_s1,
    model_s2)."""
    s1, s2, r1, r2, (k1x, k1m), (k2x, k2m, k2d), kt = (
        k if k is not None
        else _third_s_coeffs(vp, s, t, r1, r2, predict_x0, solver_type))
    if model_s is None:
        model_s = model_fn(x, s)
    if model_s1 is None:
        model_s1 = model_fn(k1x * x - k1m * model_s, s1)
    x_s2 = k2x * x - k2m * model_s - k2d * (model_s1 - model_s)
    model_s2 = model_fn(x_s2, s2)
    kx, km = kt[:2]
    if len(kt) == 3:  # dpm_solver
        x_t = kx * x - km * model_s - kt[2] * (model_s2 - model_s)
    else:  # taylor
        D1_0 = (1.0 / r1) * (model_s1 - model_s)
        D1_1 = (1.0 / r2) * (model_s2 - model_s)
        D1 = (r2 * D1_0 - r1 * D1_1) / (r2 - r1)
        D2 = 2.0 * (D1_1 - D1_0) / (r2 - r1)
        x_t = kx * x - km * model_s - kt[2] * D1 - kt[3] * D2
    return x_t, model_s, model_s1, model_s2


def _second_m_coeffs(vp, ts, t, predict_x0, solver_type):
    """x_t = kx x - km m0 - kd D1_0, D1_0 = (1/r0) (m0 - m1)."""
    t1, t0 = ts[-2:]
    lam_1, lam_0, lam_t = (vp.marginal_lambda(t1), vp.marginal_lambda(t0),
                           vp.marginal_lambda(t))
    c = _coeffs(vp, t0, t)
    h = lam_t - lam_0
    r0 = (lam_0 - lam_1) / h
    if predict_x0:
        kx, km = c["sig_t"] / c["sig_s"], c["a_t"] * torch.expm1(-h)
        kd = (0.5 * c["a_t"] * torch.expm1(-h) if solver_type == "dpm_solver"
              else -(c["a_t"] * (torch.expm1(-h) / h + 1.0)))
    else:
        kx = torch.exp(c["log_a_t"] - c["log_a_s"])
        km = c["sig_t"] * torch.expm1(h)
        kd = (0.5 * c["sig_t"] * torch.expm1(h) if solver_type == "dpm_solver"
              else c["sig_t"] * (torch.expm1(h) / h - 1.0))
    return kx, km, 1.0 / r0, kd


def _second_update_m(vp, x, models, ts, t, predict_x0, solver_type, k=None):
    """Multistep second-order update from the last two models."""
    kx, km, inv_r0, kd = (k if k is not None else
                          _second_m_coeffs(vp, ts, t, predict_x0, solver_type))
    m1, m0 = models[-2:]
    D1_0 = inv_r0 * (m0 - m1)
    return kx * x - km * m0 - kd * D1_0


def _third_m_coeffs(vp, ts, t, predict_x0):
    t2, t1, t0 = ts[-3:]
    lam_2, lam_1, lam_0, lam_t = (vp.marginal_lambda(t2), vp.marginal_lambda(t1),
                                  vp.marginal_lambda(t0), vp.marginal_lambda(t))
    c = _coeffs(vp, t0, t)
    h = lam_t - lam_0
    r0, r1 = (lam_0 - lam_1) / h, (lam_1 - lam_2) / h
    mix = (1.0 / r0, 1.0 / r1, r0 / (r0 + r1), 1.0 / (r0 + r1))
    if predict_x0:
        kx, km = c["sig_t"] / c["sig_s"], c["a_t"] * torch.expm1(-h)
        k1 = -(c["a_t"] * (torch.expm1(-h) / h + 1.0))
        k2 = c["a_t"] * ((torch.expm1(-h) + h) / h ** 2 - 0.5)
    else:
        kx = torch.exp(c["log_a_t"] - c["log_a_s"])
        km = c["sig_t"] * torch.expm1(h)
        k1 = c["sig_t"] * (torch.expm1(h) / h - 1.0)
        k2 = c["sig_t"] * ((torch.expm1(h) - h) / h ** 2 - 0.5)
    return (kx, km, k1, k2) + mix


def _third_update_m(vp, x, models, ts, t, predict_x0, k=None):
    """Multistep third-order update from the last three models."""
    kx, km, k1, k2, inv_r0, inv_r1, c01, inv_r01 = (
        k if k is not None else _third_m_coeffs(vp, ts, t, predict_x0))
    m2, m1, m0 = models[-3:]
    D1_0 = inv_r0 * (m0 - m1)
    D1_1 = inv_r1 * (m1 - m2)
    D1 = D1_0 + c01 * (D1_0 - D1_1)
    D2 = inv_r01 * (D1_0 - D1_1)
    return kx * x - km * m0 - k1 * D1 - k2 * D2


# ---------------------------------------------------------------------------
# The samplers
# ---------------------------------------------------------------------------

def _make_model_fn(vp: VPContinuous, eps_fn: EpsFn, batch: int,
                   predict_x0: bool) -> Callable:
    """Continuous-time model wrapper (model_wrapper + data_prediction_fn).
    The model gets t as a float32 timestep (never rounded), and its output
    is taken in fp32."""

    def fn(x, t):
        t_in = torch.full((batch,), float(vp.model_input_time(t)),
                          dtype=torch.float32, device=x.device)
        eps = eps_fn(x, t_in).float()
        if not predict_x0:
            return eps
        return (x - vp.marginal_std(t) * eps) / vp.marginal_alpha(t)

    return fn


def _time_nodes(vp, skip_type, t_T, t_0, n) -> torch.Tensor:
    if skip_type == "time_uniform":
        return _linspace(t_T, t_0, n + 1)
    if skip_type == "logSNR":
        lam = _linspace(vp.marginal_lambda(t_T), vp.marginal_lambda(t_0), n + 1)
        return vp.inverse_lambda(lam)
    if skip_type == "time_quadratic":
        return _linspace(t_T ** 0.5, t_0 ** 0.5, n + 1) ** 2
    raise ValueError(skip_type)


def _singlestep_orders(steps: int, order: int) -> Sequence[int]:
    """DPM-Solver-fast order schedule (dpm_solver.py:470-495)."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2, or 3 (got {order})")
    if order == 3:
        k = steps // 3 + 1
        return ([3] * (k - 2) + [2, 1] if steps % 3 == 0 else
                [3] * (k - 1) + [1] if steps % 3 == 1 else [3] * (k - 1) + [2])
    if order == 2:
        return [2] * (steps // 2) if steps % 2 == 0 else \
            [2] * (steps // 2) + [1]
    return [1] * steps


def _multistep_orders(steps: int, order: int,
                      lower_order_final: bool) -> List[int]:
    """Per-step effective order: the warm-up ramp, then ``order``, with the
    lower-order tail when steps < 15 (dpm_solver.py:1090-1094)."""
    orders = np.minimum(np.arange(1, steps + 1), order)
    if lower_order_final and steps < 15:
        orders = np.minimum(orders, steps - np.arange(steps))
    return [int(o) for o in orders]


def _multistep(vp, model_fn, x, nodes, orders, predict_x0, solver_type):
    # every step's coefficients before the first model call: host scalars
    plan = []
    for i, o in enumerate(orders):
        ts, t = [nodes[j] for j in range(i - o + 1, i + 1)], nodes[i + 1]
        plan.append(
            _first_coeffs(vp, ts[-1], t, predict_x0) if o == 1 else
            _second_m_coeffs(vp, ts, t, predict_x0, solver_type) if o == 2
            else _third_m_coeffs(vp, ts, t, predict_x0))
    models = [model_fn(x, nodes[0])]
    for i, (o, k) in enumerate(zip(orders, plan)):
        if o == 1:
            x = _first_update(vp, x, None, None, models[-1], predict_x0, k=k)
        elif o == 2:
            x = _second_update_m(vp, x, models, None, None, predict_x0,
                                 solver_type, k=k)
        else:
            x = _third_update_m(vp, x, models, None, None, predict_x0, k=k)
        # the last node's model value is never consumed (the reference's
        # `if step < steps` guard, :1105-1106)
        if i + 1 < len(orders):
            models = models[-2:] + [model_fn(x, nodes[i + 1])]
    return x


def _singlestep(vp, model_fn, x, method, skip_type, steps, order, t_T, t_0,
                predict_x0, solver_type):
    if method == "singlestep":
        orders = _singlestep_orders(steps, order)
        if skip_type == "logSNR":
            outer = _time_nodes(vp, skip_type, t_T, t_0, len(orders))
        else:
            all_nodes = _time_nodes(vp, skip_type, t_T, t_0, steps)
            outer = all_nodes[torch.from_numpy(
                np.cumsum([0] + list(orders)))]
    else:
        k = steps // order
        orders = [order] * k
        outer = _time_nodes(vp, skip_type, t_T, t_0, k)
    plan = []
    for i, o in enumerate(orders):
        s_i, t_i = outer[i], outer[i + 1]
        lam = vp.marginal_lambda(_time_nodes(vp, skip_type, s_i, t_i, o))
        h = lam[-1] - lam[0]
        if o == 1:
            plan.append(_first_coeffs(vp, s_i, t_i, predict_x0))
        elif o == 2:
            plan.append(_second_s_coeffs(vp, s_i, t_i, (lam[1] - lam[0]) / h,
                                         predict_x0, solver_type))
        else:
            plan.append(_third_s_coeffs(vp, s_i, t_i, (lam[1] - lam[0]) / h,
                                        (lam[2] - lam[0]) / h, predict_x0,
                                        solver_type))
    for i, (o, k) in enumerate(zip(orders, plan)):
        s_i = outer[i]
        if o == 1:
            x = _first_update(vp, x, s_i, None, model_fn(x, s_i), predict_x0,
                              k=k)
        elif o == 2:
            x, _, _ = _second_update_s(vp, model_fn, x, s_i, None, None,
                                       predict_x0, solver_type, k=k)
        else:
            x, _, _, _ = _third_update_s(vp, model_fn, x, s_i, None, None,
                                         None, predict_x0, solver_type, k=k)
    return x


def dpm_solver_sample_suite(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    shape,
    generator: Optional[torch.Generator] = None,
    steps: int = 20,
    order: int = 2,
    method: str = "multistep",
    skip_type: str = "time_uniform",
    predict_x0: bool = True,
    solver_type: str = "dpm_solver",
    lower_order_final: bool = True,
    denoise_to_zero: bool = False,
    x_T: Optional[torch.Tensor] = None,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
) -> torch.Tensor:
    """DPM_Solver.sample (dpm_solver.py:965-1128) for the discrete schedule.

    predict_x0=True is DPM-Solver++; method 'multistep' makes ``steps``
    model calls, 'singlestep' (DPM-Solver-fast order schedule) and
    'singlestep_fixed' the sum of their orders; ``denoise_to_zero`` one
    more. Runs on the device of ``x_T`` (or of ``generator``)."""
    if solver_type not in ("dpm_solver", "taylor"):
        raise ValueError(f"solver_type must be 'dpm_solver' or 'taylor' "
                         f"(got {solver_type!r})")
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2, or 3 (got {order})")
    if method == "multistep" and steps < order:
        raise ValueError(f"multistep needs steps >= order "
                         f"(got steps={steps}, order={order}); the reference "
                         "asserts the same")
    vp = make_vp_continuous(sched)
    t_T = t_start if t_start is not None else 1.0
    t_0 = t_end if t_end is not None else 1.0 / vp.total_N
    if not (0 < t_0 < t_T <= 1.0) or t_0 < 1.0 / vp.total_N - 1e-12:
        # the discrete-mode schedule is only defined on [1/N, 1]: interp
        # clamps outside the keypoint grid where the reference extrapolates
        raise ValueError(
            f"t range [{t_0}, {t_T}] outside the discrete schedule's "
            f"[{1.0 / vp.total_N}, 1.0]")
    b = shape[0]
    model_fn = _make_model_fn(vp, eps_fn, b, predict_x0)
    if method not in ("multistep", "singlestep", "singlestep_fixed"):
        raise ValueError(method)
    x = initial_noise(shape, generator, x_T)

    if method == "multistep":
        nodes = _time_nodes(vp, skip_type, t_T, t_0, steps)
        x = _multistep(vp, model_fn, x, nodes,
                       _multistep_orders(steps, order, lower_order_final),
                       predict_x0, solver_type)
    else:
        x = _singlestep(vp, model_fn, x, method, skip_type, steps, order, t_T,
                        t_0, predict_x0, solver_type)
    if denoise_to_zero:
        t0v = _scalar(t_0)
        t_in = torch.full((b,), float(vp.model_input_time(t0v)),
                          dtype=torch.float32, device=x.device)
        eps = eps_fn(x, t_in).float()
        x = (x - vp.marginal_std(t0v) * eps) / vp.marginal_alpha(t0v)
    return x


def dpm_solver_sample_adaptive(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    shape,
    generator: Optional[torch.Generator] = None,
    order: int = 2,
    h_init: float = 0.05,
    atol: float = 0.0078,
    rtol: float = 0.05,
    theta: float = 0.9,
    t_err: float = 1e-5,
    predict_x0: bool = True,
    solver_type: str = "dpm_solver",
    x_T: Optional[torch.Tensor] = None,
    max_iters: int = 200,
    return_info: bool = False,
):  # -> torch.Tensor, or (torch.Tensor, dict) when return_info=True
    """Adaptive step-size solver (dpm_solver_adaptive, dpm_solver.py:909-963):
    embedded lower/higher-order pair, accept when the scaled error E <= 1,
    step h <- min(theta h E^{-1/order}, remaining). return_info=True also
    returns {'converged': bool, 'iterations': int}; the max_iters backstop
    can exit with a partially integrated sample.

    The one sampler here that reads the device inside its loop: the accept
    test and the next step size need E, read to the host once an iteration
    (as the JAX package's while_loop reads it on the device)."""
    if order not in (2, 3):
        raise ValueError("adaptive solver needs order 2 or 3")
    vp = make_vp_continuous(sched)
    b = shape[0]
    model_fn = _make_model_fn(vp, eps_fn, b, predict_x0)
    t_T, t_0 = 1.0, 1.0 / vp.total_N
    x = initial_noise(shape, generator, x_T)
    lam_0 = vp.marginal_lambda(_scalar(t_0))

    def lower_higher(x, s, t):
        if order == 2:
            x_high, model_s, _ = _second_update_s(
                vp, model_fn, x, s, t, 0.5, predict_x0, solver_type)
            x_low = _first_update(vp, x, s, t, model_s, predict_x0)
        else:
            x_low, model_s, model_s1 = _second_update_s(
                vp, model_fn, x, s, t, 1.0 / 3.0, predict_x0, solver_type)
            x_high, _, _, _ = _third_update_s(
                vp, model_fn, x, s, t, 1.0 / 3.0, 2.0 / 3.0, predict_x0,
                solver_type, model_s=model_s, model_s1=model_s1)
        return x_low, x_high

    s, h, x_prev, it = _scalar(t_T), _scalar(h_init), x, 0
    while bool(torch.abs(s - t_0) > t_err) and it < max_iters:
        t = vp.inverse_lambda(vp.marginal_lambda(s) + h)
        x_low, x_high = lower_higher(x, s, t)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()),
                            min=atol)
        err = ((x_high - x_low) / delta) ** 2
        E = torch.sqrt(err.reshape(b, -1).mean(dim=-1)).max().cpu()
        if bool(E <= 1.0):
            x, s, x_prev = x_high, t, x_low
        h = torch.minimum(theta * h * E ** (-1.0 / order),
                          lam_0 - vp.marginal_lambda(s))
        it += 1
    if return_info:
        return x, {"converged": bool(torch.abs(s - t_0) <= t_err),
                   "iterations": it}
    return x
