#!/usr/bin/env python3
"""The DDIM-inversion latent cache of the PyTorch port, for editing and the
DiffusionCLIP finetune (the port's ``scripts/compute_latents.py``).

    python3 scripts/compute_latents_torch.py --config <affectnet cfg> \
        --list train_aligned.txt --outdir latents/train [--ckpt weights.pt]
        [--steps 40 --strength 0.5] [--batch 16] [--size 128] [--limit N]
        [--reconstruct] [--cpu]

For every image of the list (one path a line; the label is the file name's
prefix, ``<label>_...``): the VQ encode, the deterministic DDIM inversion
over the first ``--strength`` of the diffusion in ``--steps`` steps under
the source label and, with ``--reconstruct``, the reverse chain decoded.
Writes ``origin.npy`` (images in [0, 1]), ``latents.npy``, ``recon.npy``
(with ``--reconstruct``) and ``files.npy`` (the paths), which
``ldm.data.latents.LatentTrain`` / ``LatentTest`` read. ``main`` wraps
``dsml_thesis_tpu_torch.reenactment.compute_latent_cache``. ``--ckpt`` as
in ``scripts/sample_affectnet_torch.py``; images are decoded by Pillow.
Runs on the card; ``--cpu`` on the CPU, for debugging only.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch.cli import CKPT_HELP, device_of
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.data.datasets import load_images
from dsml_thesis_tpu_torch.reenactment import (compute_latent_cache,
                                               load_weights)


def save_cache(outdir: str, cache, files) -> None:
    """The cache's arrays and the file list under the names LatentDataset
    reads."""
    os.makedirs(outdir, exist_ok=True)
    for key in ("origin", "latents", "recon"):
        if key in cache:
            np.save(os.path.join(outdir, f"{key}.npy"), cache[key])
    np.save(os.path.join(outdir, "files.npy"), np.array(files))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=CKPT_HELP)
    ap.add_argument("--list", required=True, help="image path list file")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--strength", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--reconstruct", action="store_true",
                    help="also run the reverse chain and store recon.npy")
    ap.add_argument("--seed", type=int, default=0,
                    help="the random weights' seed when there is no --ckpt")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    device = device_of(args.cpu)
    cfg = load_config([args.config])
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        load_weights(ldm, args.ckpt, cfg["model"], use_ema=not args.no_ema)
    ldm = ldm.to(device).eval()

    with open(args.list) as f:
        paths = [ln for ln in f.read().splitlines() if ln]
    if args.limit:
        paths = paths[:args.limit]
    labels = np.array([int(os.path.basename(p).split("_")[0]) for p in paths],
                      np.int64)
    parts = []
    for s in range(0, len(paths), args.batch):
        chunk = paths[s:s + args.batch]
        parts.append(compute_latent_cache(
            ldm, load_images(chunk, args.size), labels[s:s + args.batch],
            steps=args.steps, strength=args.strength,
            reconstruct=args.reconstruct, batch_size=args.batch))
        print(f"{s + len(chunk)}/{len(paths)}")
    cache = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    save_cache(args.outdir, cache, paths)
    print(f"saved {len(paths)} latents to {args.outdir}")


if __name__ == "__main__":
    main()
