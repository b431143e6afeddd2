"""Profiling hooks of the trainer.

Counterpart of ``dsml_thesis_tpu/training/profiling.py``:
``device_memory_stats()`` gives the peak and current device memory of each
card (the reference's CUDACallback peak memory), and ``StepProfiler`` traces
a window of training steps with ``torch.profiler`` into a Chrome trace
(``chrome://tracing``, Perfetto) under the run's ``profile/`` directory.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch


def device_memory_stats() -> Dict[str, float]:
    """``cuda_<i>_peak_mib`` / ``cuda_<i>_in_use_mib`` of every card (the
    caching allocator's peak since its last reset, and now); ``{}`` without
    a card."""
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda_{i}_peak_mib"] = torch.cuda.max_memory_allocated(i) / 2 ** 20
        out[f"cuda_{i}_in_use_mib"] = torch.cuda.memory_allocated(i) / 2 ** 20
    return out


class StepProfiler:
    """Trace a window of exactly ``num_steps`` dispatched training steps.

    The trainer calls ``maybe_start(k)`` just before it dispatches step k
    (counted from 1) and ``maybe_stop(k)`` just after. The window opens at
    the first dispatched step at or past ``start_step`` (so a run resumed
    past it still traces), spans ``num_steps`` steps from there and never
    reopens; with ``start_step`` None it never opens. Each traced step is a
    ``train_step#<k>`` range of the trace (``step_range``).
    ``ensure_stopped`` closes a window that a break or an exception left
    open, so that its trace is still written."""

    def __init__(self, logdir: str, start_step: Optional[int],
                 num_steps: int = 5):
        self.logdir = logdir
        self.start_step = start_step
        self.num_steps = num_steps
        self.first_step = self.stop_step = None
        self.trace_path = None
        self._prof = None
        self._done = False

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, step: int) -> None:
        if (self._prof is None and not self._done
                and self.start_step is not None and step >= self.start_step):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.first_step, self.stop_step = step, step + self.num_steps
            self._prof = profile(activities=acts)
            self._prof.start()

    def step_range(self, step: int):
        """A ``train_step#<step>`` range around a traced step (nothing
        outside the window)."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"train_step#{step}")

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step + 1 >= self.stop_step:
            self._stop()

    def ensure_stopped(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.trace_path = os.path.join(
            self.logdir, f"trace_step{self.first_step:08d}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._done = True
