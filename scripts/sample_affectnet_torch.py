#!/usr/bin/env python3
"""Class-conditional AffectNet sampling of the PyTorch port, with
classifier-free guidance (the port's ``scripts/sample_affectnet.py``).

    python3 scripts/sample_affectnet_torch.py \
        --config configs/latent-diffusion/affectnet-128-ldm-vq-f4.yaml \
        --outdir out/ [--ckpt weights.pt] [--n-samples 8 --steps 50
        --scale 3.0] [--sampler ddim|plms|dpm|dpm++ --order 2]
        [--classes 0 1 2] [--eta 0.0] [--seed 0] [--no-ema] [--cpu]

For each class: ``--n-samples`` images through the sampler's chain, the
unconditional branch of the guidance being the class embedder's null
embedding, decoded by the VQ first stage and clamped to [-1, 1]; saved as
``class_<c>.npy`` ([n, 128, 128, 3]) and, where Pillow is installed, a PNG
row. ``--ckpt`` is a reference PyTorch Lightning ``.ckpt`` (the thesis's
published weights, converted on load), a checkpoint of
``scripts/train_torch.py`` or a ``torch.save``d state_dict of the port's
LatentDiffusion (``dsml_thesis_tpu_torch.convert.from_jax_params`` makes
one from a JAX parameter tree): its EMA weights where it has them, unless
``--no-ema``; without it the weights are random, from ``--seed``. Sampling runs on the card; ``--cpu`` runs the kernels'
plain PyTorch versions on the CPU, for debugging only.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch.cli import CKPT_HELP, device_of, save_png_row
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.reenactment import (SAMPLERS, load_weights,
                                               sample_class)
from dsml_thesis_tpu_torch.utils_io import cast_sampling_params


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=CKPT_HELP)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--n-samples", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=3.0)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--sampler", default="ddim", choices=SAMPLERS,
                    help="ddim (the reference's), plms, dpm++ (DPM-Solver++ "
                         "multistep, data prediction), dpm (noise prediction)")
    ap.add_argument("--order", type=int, default=2, choices=(1, 2, 3),
                    help="the DPM-Solver's order")
    ap.add_argument("--classes", type=int, nargs="*", default=list(range(8)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    device = device_of(args.cpu)
    cfg = load_config([args.config])
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        load_weights(ldm, args.ckpt, cfg["model"], use_ema=not args.no_ema)
    ldm = cast_sampling_params(ldm).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    for c in args.classes:
        imgs = sample_class(ldm, c, args.n_samples, steps=args.steps,
                            scale=args.scale, sampler=args.sampler,
                            order=args.order, eta=args.eta, generator=gen)
        imgs = imgs.float().cpu().numpy()
        np.save(os.path.join(args.outdir, f"class_{c}.npy"), imgs)
        save_png_row(imgs, os.path.join(args.outdir, f"class_{c}.png"))
        print(f"class {c}: saved {imgs.shape}")


if __name__ == "__main__":
    main()
