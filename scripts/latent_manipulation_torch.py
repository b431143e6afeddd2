#!/usr/bin/env python3
"""Emotion manipulation by deterministic DDIM inversion and re-generation,
in the PyTorch port (the port's ``scripts/latent_manipulation.py``).

    python3 scripts/latent_manipulation_torch.py --config <affectnet cfg> \
        --images img1.jpg img2.jpg --src-class 0 --targets 1 2 6 \
        --outdir out/ [--ckpt weights.pt] [--steps 40 --strength 0.5]
        [--scale 1.0] [--size 128] [--cpu]
    python3 scripts/latent_manipulation_torch.py --config <cfg> \
        --from-latents latents/test/latents.npy --src-class 0 --targets 1 \
        --outdir out/ [--ckpt finetuned.pt]

Encodes each image with the VQ first stage, runs the forward DDIM chain
under the SOURCE class, then the reverse chain under each TARGET class
(guided against the null embedding when ``--scale`` is not 1), decodes and
saves ``edited_to_<t>.npy`` (and a PNG row where Pillow is installed).
``--from-latents`` starts from a cache of inverted latents
(``scripts/compute_latents_torch.py``) and runs the reverse chains only, as
over a finetuned model. ``main`` wraps
``dsml_thesis_tpu_torch.reenactment.manipulate``. ``--ckpt`` as in
``scripts/sample_affectnet_torch.py``. Runs on the card; ``--cpu`` on the
CPU, for debugging only.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch.cli import CKPT_HELP, device_of, save_png_row
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.data.datasets import load_images
from dsml_thesis_tpu_torch.reenactment import (inversion_schedule,
                                               load_weights, manipulate)
from dsml_thesis_tpu_torch.utils_io import cast_sampling_params


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=CKPT_HELP)
    ap.add_argument("--images", nargs="*", default=[])
    ap.add_argument("--from-latents", default=None,
                    help="npy of DDIM-inverted latents: reverse chains only")
    ap.add_argument("--src-class", type=int, required=True)
    ap.add_argument("--targets", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--strength", type=float, default=1.0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="the random weights' seed when there is no --ckpt")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if not args.from_latents and not args.images:
        ap.error("need --images or --from-latents")

    device = device_of(args.cpu)
    cfg = load_config([args.config])
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        load_weights(ldm, args.ckpt, cfg["model"], use_ema=not args.no_ema)
    ldm = cast_sampling_params(ldm).to(device).eval()
    ddim = inversion_schedule(ldm, args.steps, args.strength)

    x_lat = z0 = None
    if args.from_latents:
        x_lat = torch.from_numpy(np.load(args.from_latents)).float().to(device)
    else:
        x = torch.from_numpy(load_images(args.images, args.size)).to(device)
        with torch.no_grad():
            z0 = ldm.encode_first_stage(x)
    os.makedirs(args.outdir, exist_ok=True)
    for trg in args.targets:
        out, _ = manipulate(ldm, ddim, trg, src_label=args.src_class, z0=z0,
                            x_lat=x_lat, scale=args.scale)
        out = out.float().cpu().numpy()
        np.save(os.path.join(args.outdir, f"edited_to_{trg}.npy"), out)
        save_png_row(out, os.path.join(args.outdir, f"edited_to_{trg}.png"))
        print(f"target {trg}: saved {out.shape}")


if __name__ == "__main__":
    main()
