"""Experiment-logger backends of the Trainer, selected by
``lightning.logger.target`` on top of the always-written ``metrics.jsonl``.

Counterpart of ``dsml_thesis_tpu/training/loggers.py``. Ported: the csv
backend (``TestTubeLogger`` / ``CSVLogger`` targets). A target the port lacks
(``WandbLogger`` or any other) raises ``NotImplementedError``: it does not
fall back to csv without a word.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional


class CsvBackend:
    """Long-format metrics csv next to ``metrics.jsonl``."""

    def __init__(self, logdir: str, name: str = "metrics"):
        self.path = os.path.join(logdir, f"{name}.csv")
        new = not os.path.exists(self.path)
        self._f = open(self.path, "a", newline="")
        self._w = csv.writer(self._f)
        if new:
            self._w.writerow(["step", "split", "metric", "value"])

    def log_metrics(self, metrics: Dict, step: int, split: str):
        for k, v in metrics.items():
            self._w.writerow([step, split, k, float(v)])
        self._f.flush()

    def finalize(self):
        self._f.close()


def build_logger(lightning_cfg: Dict, logdir: str) -> Optional[CsvBackend]:
    """``lightning.logger`` config -> backend instance (None = jsonl only)."""
    lg = (lightning_cfg or {}).get("logger")
    if not lg:
        return None
    target = lg.get("target", "")
    params = dict(lg.get("params", {}))
    if target.endswith(("TestTubeLogger", "CSVLogger")):
        return CsvBackend(logdir, params.get("name", "metrics"))
    raise NotImplementedError(
        f"logger target {target!r} is not ported (supported: TestTubeLogger, "
        "CSVLogger); remove lightning.logger to log to metrics.jsonl only")
