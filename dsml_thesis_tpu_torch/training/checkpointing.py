"""Top-k checkpoint bookkeeping (``save_top_k`` with metric-embedded names).

Counterpart of ``dsml_thesis_tpu/training/checkpointing.py``; one process, so
no rank check around the eviction.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, List, Tuple


def save_topk(topk: List[Tuple[float, str]], save_top_k: int, score: float,
              name: str, save_fn: Callable[[str], None], ckpt_dir: str,
              mode: str = "min") -> None:
    """Insert (score, name) into the best-first ``topk`` list in place,
    saving through ``save_fn`` and evicting the worst on overflow; a score
    that cannot enter the top-k is not saved at all. ``save_top_k == 0``
    disables monitored checkpoints, ``save_top_k < 0`` keeps every one."""
    if mode not in ("min", "max"):
        raise ValueError(f"mode {mode!r}: expected 'min' or 'max'")
    if save_top_k == 0:
        return
    worse = (lambda a, b: a >= b) if mode == "min" else (lambda a, b: a <= b)
    if 0 < save_top_k <= len(topk) and worse(score, topk[-1][0]):
        return
    save_fn(name)
    topk.append((score, name))
    topk.sort(key=lambda t: t[0], reverse=(mode == "max"))
    while 0 < save_top_k < len(topk):
        _, worst = topk.pop()
        shutil.rmtree(os.path.join(ckpt_dir, worst), ignore_errors=True)
