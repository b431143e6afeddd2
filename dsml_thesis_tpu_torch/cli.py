"""Shared fragments of the port's CLIs: the sampler arguments, the device
choice, the ``--ckpt`` help, the PNG row beside a saved result.

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


CKPT_HELP = ("weights: a reference PyTorch Lightning .ckpt (the thesis's "
             "published weights; EMA preferred), a checkpoint of "
             "scripts/train_torch.py (checkpoints/<name>/state.pt or its "
             "directory) or a torch.save'd state_dict of the port's model")


def device_of(cpu: bool):
    """The device of a script: the card, or the CPU when ``--cpu`` asks for
    it; no card is an error."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --cpu to run on the CPU)")
    return torch.device("cuda")


def save_png_row(images, path: str) -> None:
    """[N, H, W, 3] images in [-1, 1] side by side as one PNG, where Pillow
    is installed (the ``.npy`` beside it is the result)."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        return
    row = np.concatenate(list((images + 1.0) * 127.5), axis=1)
    Image.fromarray(row.astype(np.uint8)).save(path)
