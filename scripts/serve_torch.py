#!/usr/bin/env python
"""Online talking-face synthesis server of the PyTorch port (micro-batching
HTTP front end over ``dsml_thesis_tpu_torch``).

Concurrent single-clip requests are collected into the batch tier and run as
one batched pipeline call on the GPU (dsml_thesis_tpu_torch/server.py).

Usage:
  python scripts/serve_torch.py
      --config configs/latent-diffusion/mead-256-ldm-f4.yaml
      [--ckpt last.ckpt | state.pt | weights.pt] [--batch 8 --frames 8 --steps 50 --scale 2.0]
      [--sampler dpm --sampler-steps 20 --sampler-order 2]
      [--size N] [--port 8000 --max-wait-ms 50] [--device cuda]

``--config`` is one of the MEAD talking-face YAMLs: the headline
``mead-256-ldm-f4.yaml``, ``mead-256-ldm-f4-fullattn.yaml`` with
self-attention at every level, 64 x 64 (4096 tokens) included, or the
reference's own ``mead-128-ldm-f4.yaml`` (128 px frames, an fp32 UNet).
``--size`` defaults to the config's frame size (its first stage's).
``--steps`` is the DDIM chain's length; ``--sampler dpm`` serves each frame
with DPM-Solver++ multistep instead, ``--sampler-steps`` UNet calls a frame
(20 by default, against DDIM's 50) of order ``--sampler-order``, on the same
weights.

Environment flags, the JAX package's own (dsml_thesis_tpu_torch/flags.py):
  DSML_ATTN_PACKED=0         split-head attention instead of the packed kernel
  DSML_ATTN_FUSED_PROJ=0     no projection-fused self-attention (N <= 1024)
  DSML_ATTN_FPROJ_PARTIAL=1  q/out-fused kernel for longer self-attention
  DSML_PALLAS_GN=1|stats     GroupNorm through the whole-row kernel, or
                             through the statistics kernel + plain apply

``--ckpt`` is a reference PyTorch Lightning ``.ckpt`` (the thesis's published
weights, converted on load), a checkpoint of ``scripts/train_torch.py`` or a
``torch.save``d state_dict of the port's LatentDiffusion
(``dsml_thesis_tpu_torch.convert.from_jax_params`` makes one from a JAX
parameter tree), its EMA weights where it has them; without it the weights
are random, from ``--seed``.
The device is the GPU; ``--device cpu`` runs the kernels' plain PyTorch
versions and is for debugging only.

Client contract (npz in, npz out):
  POST /synthesize  npz{masked_frames[F,H,W,3], audio[T,D], identity[H,W,3],
                        class_label ()}  ->  npz{frames[F,H,W,3]}
  GET /healthz, GET /stats
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                             make_video_pipeline)
from dsml_thesis_tpu_torch.server import (MicroBatcher, PipelineServer,
                                          make_pipeline_runner)
from dsml_thesis_tpu_torch.utils_io import cast_sampling_params, load_params


def main():
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=cli.CKPT_HELP)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--audio-window", type=int, default=8)
    ap.add_argument("--audio-seq", type=int, default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="batching window after the first pending request")
    ap.add_argument("--seed", type=int, default=0,
                    help="server seed; batch i samples with "
                         "batch_seed(seed, i): fully reproducible")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up batch (it also builds the CUDA "
                         "kernels) before binding")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission cap on queued requests; beyond it new "
                         "requests get 503 at once")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    cli.add_sampler_args(ap)
    args = ap.parse_args()

    device = torch.device(args.device)
    cfg = load_config([args.config])
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        ldm.load_state_dict(load_params(args.ckpt, ldm, cfg["model"]))
    ldm = cast_sampling_params(ldm).to(device).eval()
    c2 = cfg["model"]["params"]["cond_stage_config_2"]["params"]
    size = args.size or cfg["model"]["params"]["first_stage_config"][
        "params"]["ddconfig"]["resolution"]
    audio_seq = args.audio_seq or (args.frames + args.audio_window)

    ddim = make_ddim_schedule(ldm.schedule, args.steps, eta=0.0)
    pipeline = make_video_pipeline(
        ldm, ddim, args.audio_window, guidance_scale=args.scale,
        sampler=args.sampler, sampler_steps=args.sampler_steps,
        sampler_order=args.sampler_order)
    runner = make_pipeline_runner(pipeline, seed=args.seed, device=device)
    chain = (f"{args.steps} DDIM steps" if args.sampler == "ddim" else
             f"DPM-Solver++ o{args.sampler_order} "
             f"{args.sampler_steps} evals")
    print(f"# serving {args.config} on {device} ({chain}, cfg {args.scale})")
    clip_shapes = {
        "masked_frames": (args.frames, size, size, 3),
        "audio": (audio_seq, c2["subspace_dim"]),
        "identity": (size, size, 3),
        "class_label": (),
    }
    if not args.no_warmup:
        t0 = time.monotonic()
        dummy = {k: np.zeros((args.batch,) + tuple(s), np.float32)
                 for k, s in clip_shapes.items()}
        dummy["class_label"] = dummy["class_label"].astype(np.int32)
        runner(dummy, 0)
        print(f"# warm-up batch {time.monotonic() - t0:.1f}s")

    batcher = MicroBatcher(runner, args.batch, max_wait_ms=args.max_wait_ms,
                           max_queue=args.max_queue)
    server = PipelineServer(batcher, clip_shapes)
    print(f"# listening on {args.host}:{args.port} "
          f"(batch tier {args.batch}, window {args.max_wait_ms}ms)")
    server.serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
