#!/usr/bin/env python3
"""Frame-progressive talking-face video synthesis of the PyTorch port (the
port's ``scripts/progressive_sampling.py``).

    python3 scripts/progressive_sampling_torch.py --config <mead cfg> \
        --tuples val.pkl --data-root <MEAD_v2> --audio-dir <features> \
        --outdir out/ [--ckpt weights] [--steps 50 --scale 2.0]
        [--sampler ddim|dpm --sampler-steps 20 --sampler-order 2]
        [--clips 4] [--frames 96] [--size 128] [--audio-window 8]
        [--seed 0] [--cpu]

For each clip of the tuples pickle (``MEADTalkingFace`` in ``sample``
mode: every frame mouth-masked, the whole audio track of
``scripts/mead_audio_features_torch.py``): the clip's frames one after the
other, each a guided reverse chain (classifier-free guidance over the
class + audio-window token) whose latent becomes the next frame's identity
latent, decoded by the first stage; written as
``<subj>_<emo>_<lvl>_<clip>.pkl`` holding ``{"video": float32
[F, H, W, 3] in [-1, 1], "identity", "info"}``, which
``scripts/save_videos.py`` muxes and ``scripts/image_metrics_torch.py``
scores. ``--frames`` pads (by repeating
the last frame) or cuts every clip to that many frames; the audio keeps
F + window rows, the last frames' windows reaching into the clip's future
audio (repeated past its end, as the reference clamps there). Clip i draws
its noise from a ``torch.Generator`` seeded with
``server.batch_seed(seed, i)``.

``--ckpt`` is a reference PyTorch Lightning ``.ckpt`` (the thesis's
published weights, converted on load), a checkpoint of
``scripts/train_torch.py`` or a ``torch.save``d state_dict of the port's
LatentDiffusion, its EMA weights where it has them; without it the weights
are random, from ``--seed``. It runs on the card; without one it fails
unless ``--cpu`` is given (the kernels' plain versions, for debugging).
"""
import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli
from dsml_thesis_tpu_torch.data import pad_clip


def sample_clip(pipeline, example, frames, audio_window, generator,
                x_T=None):
    """One clip through a ``make_video_pipeline`` pipeline: its frames as a
    float32 array [F, H, W, 3] in [-1, 1] (the pipeline's latents where it
    does not decode). ``example`` holds ``masked_image``, ``audio``,
    ``identity``, ``class_label`` (and ``num_frames`` when ``frames`` is
    None); the inputs go where the generator lies (the model's device), or
    where ``x_T`` [1, F, h, w, c] lies, which replaces its noise."""
    device = generator.device if generator is not None else x_T.device
    masked, audio = pad_clip(example, frames, audio_window)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))[
        None].to(device)
    label = torch.tensor([int(example["class_label"])], device=device)
    vid = pipeline(to(masked), to(audio), to(example["identity"]), label,
                   generator, x_T=x_T)
    return vid[0].float().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=cli.CKPT_HELP)
    ap.add_argument("--tuples", required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--steps", type=int, default=50)
    cli.add_sampler_args(ap)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--clips", type=int, default=None, help="limit #clips")
    ap.add_argument("--frames", type=int, default=None,
                    help="pad/trim every clip to this many frames")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--audio-window", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.config import build_model, load_config
    from dsml_thesis_tpu_torch.data import MEADTalkingFace
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.server import batch_seed
    from dsml_thesis_tpu_torch.utils_io import (cast_sampling_params,
                                                load_params)

    cfg = load_config([args.config])
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        ldm.load_state_dict(load_params(args.ckpt, ldm, cfg["model"]))
    ldm = cast_sampling_params(ldm).to(device).eval()

    ds = MEADTalkingFace(args.tuples, args.data_root, args.audio_dir,
                         audio_window=args.audio_window, size=args.size,
                         mode="sample")
    n_clips = min(args.clips or len(ds), len(ds))
    ddim = make_ddim_schedule(ldm.schedule, args.steps, eta=0.0)
    pipeline = make_video_pipeline(
        ldm, ddim, args.audio_window, guidance_scale=args.scale,
        sampler=args.sampler, sampler_steps=args.sampler_steps,
        sampler_order=args.sampler_order)

    os.makedirs(args.outdir, exist_ok=True)
    for ci in range(n_clips):
        ex = ds[ci]
        gen = torch.Generator(device=device).manual_seed(
            batch_seed(args.seed, ci))
        vid = sample_clip(pipeline, ex, args.frames, args.audio_window, gen)
        name = f"{ex['subj']}_{ex['human_label']}_{ex['lvl']}_{ex['nbr']}"
        with open(os.path.join(args.outdir, f"{name}.pkl"), "wb") as f:
            pickle.dump({
                "video": vid, "identity": np.asarray(ex["identity"]),
                "info": {k: ex[k] for k in ("subj", "human_label", "lvl",
                                            "nbr")},
            }, f)
        print(f"[{ci + 1}/{n_clips}] {name}: {vid.shape}")


if __name__ == "__main__":
    main()
