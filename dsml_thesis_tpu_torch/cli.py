"""Shared argparse fragments of the port's sampling and serving CLIs.

Counterpart of ``dsml_thesis_tpu/cli.py``: every video-pipeline CLI offers
the same ``--sampler`` surface, so the flag trio lives in one place.
"""
from __future__ import annotations

import argparse


def add_sampler_args(ap: argparse.ArgumentParser, note: str = "") -> None:
    """Add the --sampler / --sampler-steps / --sampler-order trio.

    `note`: optional suffix appended to the --sampler help line (e.g. how the
    choice interacts with this script's artifact/metric semantics).
    """
    help_txt = ("per-frame reverse chain: reference-faithful DDIM (default) "
                "or DPM-Solver++ multistep at --sampler-steps model evals "
                "(the fewer-steps serving mode)")
    if note:
        help_txt += f"; {note}"
    ap.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim",
                    help=help_txt)
    ap.add_argument("--sampler-steps", type=int, default=20,
                    help="model evals per frame when --sampler dpm")
    ap.add_argument("--sampler-order", type=int, default=2,
                    choices=(1, 2, 3),
                    help="DPM-Solver++ order when --sampler dpm")
