"""EMA of parameters, in place on a list of shadow tensors.

Counterpart of ``dsml_thesis_tpu/training/ema.py``: warm-up decay
``min(decay, (1 + n) / (10 + n))`` with n the update count after this step;
each shadow keeps its own type. Using the shadows is "swap them in for the
parameters" (``TrainState.ema_scope``), no copy.
"""
from __future__ import annotations

from typing import Sequence

import torch


def ema_decay(num_updates: int, decay: float = 0.9999) -> float:
    return min(decay, (1.0 + num_updates) / (10.0 + num_updates))


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], num_updates: int,
               decay: float = 0.9999) -> None:
    """One EMA step, in place: e <- e - (1 - d) (e - p). ``num_updates`` is
    the count after this optimizer step."""
    w = 1.0 - ema_decay(num_updates, decay)
    ema_params, params = list(ema_params), list(params)
    if not ema_params:
        return
    if all(e.dtype == p.dtype for e, p in zip(ema_params, params)):
        torch._foreach_lerp_(ema_params, params, w)   # e + w (p - e)
    else:
        for e, p in zip(ema_params, params):
            e.copy_((e.float() - w * (e.float() - p.float())).to(e.dtype))
