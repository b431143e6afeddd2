#!/usr/bin/env python3
"""Per-video PSNR / SSIM against ground-truth frames, of the PyTorch port
(the port's ``scripts/image_metrics.py``).

    python3 scripts/image_metrics_torch.py --gen <dir of pkls or frame dirs> \
        --gt <dir of ground-truth frame dirs> [--log metric_logs.txt]
        [--size N] [--cpu]

Each generated video (a ``progressive_sampling_torch.py`` pickle, or a
directory of ``*.jpg`` / ``*.png`` frames) is held against the frame
directory of its name under ``--gt`` over the frames both have, in [0, 1]
(``data_range`` 1): one line a video, then the mean over the videos;
every line is also appended to ``--log``. Frames are read with Pillow at
``--size`` (the generated frames' size for the ground truth by default).
It runs on the card (SSIM without TF32); without one it fails unless
``--cpu`` is given. ``main()`` returns {name: (psnr, ssim)}.
"""
import argparse
import glob
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli


def load_frames(path, size=None):
    """A pickle (its ``video``) or a directory of images -> float32
    [F, H, W, 3] in [-1, 1]."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return np.asarray(pickle.load(f)["video"], np.float32)
    from dsml_thesis_tpu_torch.data import load_images

    files = sorted(glob.glob(os.path.join(path, "*.jpg"))
                   + glob.glob(os.path.join(path, "*.png")))
    return load_images(files, size)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gen", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--log", default="metric_logs.txt")
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.metrics import psnr, ssim, to_unit_range

    gen_items = sorted(
        glob.glob(os.path.join(args.gen, "*.pkl"))
        or [d for d in glob.glob(os.path.join(args.gen, "*"))
            if os.path.isdir(d)])
    scores = {}
    with open(args.log, "a") as logf:
        for item in gen_items:
            name = os.path.splitext(os.path.basename(item))[0]
            gt_dir = os.path.join(args.gt, name)
            if not os.path.isdir(gt_dir):
                print(f"skip {name}: no GT at {gt_dir}")
                continue
            gen = load_frames(item, args.size)
            gt = load_frames(gt_dir, args.size or gen.shape[1])
            n = min(len(gen), len(gt))
            a = to_unit_range(torch.from_numpy(gen[:n]).to(device))
            b = to_unit_range(torch.from_numpy(gt[:n]).to(device))
            p, s = psnr(a, b).mean().item(), ssim(a, b).mean().item()
            scores[name] = (p, s)
            line = f"{name} psnr={p:.3f} ssim={s:.4f} frames={n}"
            print(line)
            logf.write(line + "\n")
        if scores:
            ps, ss = zip(*scores.values())
            summary = (f"MEAN psnr={np.mean(ps):.3f} ssim={np.mean(ss):.4f} "
                       f"videos={len(scores)}")
            print(summary)
            logf.write(summary + "\n")
    return scores


if __name__ == "__main__":
    main()
