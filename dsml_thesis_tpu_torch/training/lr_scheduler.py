"""LR multiplier schedules as plain functions of the optimizer-step count n.

Counterpart of ``dsml_thesis_tpu/training/lr_scheduler.py`` (the reference's
LambdaWarmUpCosineScheduler, LambdaWarmUpCosineScheduler2 and
LambdaLinearScheduler): multipliers over a base LR of 1.0. Arithmetic is
numpy float32, as the JAX functions compute in float32.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

_f = np.float32


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                  lr_start: float, max_decay_steps: int) -> Callable:
    def schedule(n) -> float:
        n = _f(n)
        if n < warm_up_steps:
            return float(_f(lr_max - lr_start) / _f(max(warm_up_steps, 1)) * n
                         + _f(lr_start))
        t = min(_f(n - warm_up_steps) / _f(max_decay_steps - warm_up_steps),
                _f(1.0))
        return float(_f(lr_min) + _f(0.5) * _f(lr_max - lr_min)
                     * (_f(1) + np.cos(_f(t * _f(np.pi)))))

    return schedule


def _cycle_index(cum: np.ndarray, n) -> int:
    # interval i such that cum[i] < n <= cum[i + 1], clipped to the last
    return int(np.clip(np.sum(cum[1:].astype(np.float32) < n), 0,
                       len(cum) - 2))


def _cycles(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    cum = np.cumsum([0] + list(cycle_lengths))
    arr = lambda x: np.asarray(x, np.float32)
    return (cum, arr(warm_up_steps), arr(f_min), arr(f_max), arr(f_start),
            arr(cycle_lengths))


def warmup_cosine2(warm_up_steps: Sequence[int], f_min: Sequence[float],
                   f_max: Sequence[float], f_start: Sequence[float],
                   cycle_lengths: Sequence[int]) -> Callable:
    cum, wu, fmn, fmx, fst, cl = _cycles(warm_up_steps, f_min, f_max, f_start,
                                         cycle_lengths)

    def schedule(n) -> float:
        n = _f(n)
        c = _cycle_index(cum, n)
        nn = n - _f(cum[c])
        if nn < wu[c]:
            return float((fmx[c] - fst[c]) / wu[c] * nn + fst[c])
        t = min((nn - wu[c]) / (cl[c] - wu[c]), _f(1.0))
        return float(fmn[c] + _f(0.5) * (fmx[c] - fmn[c])
                     * (_f(1) + np.cos(_f(t * _f(np.pi)))))

    return schedule


def lambda_linear(warm_up_steps: Sequence[int], f_min: Sequence[float],
                  f_max: Sequence[float], f_start: Sequence[float],
                  cycle_lengths: Sequence[int]) -> Callable:
    cum, wu, fmn, fmx, fst, cl = _cycles(warm_up_steps, f_min, f_max, f_start,
                                         cycle_lengths)

    def schedule(n) -> float:
        n = _f(n)
        c = _cycle_index(cum, n)
        # past sum(cycle_lengths) the multiplier holds at f_min
        nn = min(n - _f(cum[c]), cl[c])
        if nn < wu[c]:
            return float((fmx[c] - fst[c]) / wu[c] * nn + fst[c])
        return float(fmn[c] + (fmx[c] - fmn[c]) * (cl[c] - nn) / cl[c])

    return schedule


_SCHEDULES = {
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": warmup_cosine,
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2": warmup_cosine2,
    "ldm.lr_scheduler.LambdaLinearScheduler": lambda_linear,
}


def build_lr_multiplier(scheduler_config: dict) -> Callable:
    """A ``scheduler_config`` node of a model config -> multiplier(n)."""
    target = scheduler_config["target"]
    params = dict(scheduler_config.get("params", {}))
    params.pop("verbosity_interval", None)
    make = _SCHEDULES.get(target)
    if make is None:
        raise NotImplementedError(target)
    return make(**params)
