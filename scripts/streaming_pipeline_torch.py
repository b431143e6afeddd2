#!/usr/bin/env python3
"""Batched multi-speaker streaming synthesis of the PyTorch port (the
port's ``scripts/streaming_pipeline.py``): audio features -> denoise ->
first-stage decode -> metrics as a continuously fed pipeline.

    python3 scripts/streaming_pipeline_torch.py --config <mead cfg> \
        (--tuples val.pkl --data-root <MEAD_v2> --audio-dir <features>
         --outdir out/ [--metrics] | --synthetic N [--prep-delay S]
         [--outdir out/]) [--ckpt weights] [--batch 4 --frames 32
        --steps 50 --scale 2.0 --size 128 --audio-window 8]
        [--sampler ddim|dpm --sampler-steps 20 --sampler-order 2]
        [--seed 0] [--cpu]

A host thread reads and pads the clips of the next batch (``--batch``
speakers of ``--frames`` frames each; the tail batch is padded with copies
of its last clip, which are not written) into a queue of two batches,
while the consumer copies each batch to the device and runs it through
``make_video_pipeline``; batch i draws its noise from a
``torch.Generator`` seeded with ``server.batch_seed(seed, i)``. The
consumer issues a batch, then drains the previous one (the copy to the
host, ``<outdir>/<name>.npy``, the printed line), so that the host's work
on batch i - 1 sits behind the device's on batch i; ``--metrics`` drains
first (its PSNR / SSIM of each batch's first clip against the ground-truth
frames are device work of their own). Each line gives the cumulative
frames/s and, after the first batch, the steady frames/s: the frames of
batches 1, 2, ... over the time since batch 1's dispatch began.
``--synthetic N`` runs N random in-memory clips instead of a dataset,
``--prep-delay`` adding host seconds to each clip's preparation (the
producer's share of the host against the consumer's).

``--ckpt`` takes the files of ``progressive_sampling_torch.py``'s; without
it the weights are random, from ``--seed``. It runs on the card; without
one it fails unless ``--cpu`` is given. ``main()`` returns a summary of the
run (batches, frames, seconds, frames/s, the printed lines).
"""
import argparse
import os
import queue
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli
from dsml_thesis_tpu_torch.data import pad_clip


class _SyntheticClips:
    """In-memory random clips with the ``sample``-mode fields of
    ``MEADTalkingFace``: the pipeline without a dataset."""

    def __init__(self, n, size, frames, window, adim, prep_delay=0.0):
        self.n, self.size = n, size
        self.frames, self.window, self.adim = frames, window, adim
        self.prep_delay = prep_delay
        self._rs = np.random.RandomState(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.prep_delay:
            time.sleep(self.prep_delay)
        F, w, s = self.frames, self.window, self.size
        return {
            "masked_image": self._rs.rand(F, s, s, 3).astype(np.float32) - .5,
            "identity": self._rs.rand(s, s, 3).astype(np.float32) - .5,
            "class_label": i % 8,
            "audio": self._rs.randn(F + w, self.adim).astype(np.float32),
            "subj": f"synth{i}", "human_label": "neutral",
            "lvl": "level_1", "nbr": "001",
        }


def prepare(ds, idx_list, frames, audio_window, gt_size=None):
    """The host side of a batch, in numpy: masked frames [B, F, H, W, 3],
    audio [B, F + w, D], identities [B, H, W, 3], labels [B], the clips'
    names and, with ``gt_size``, each clip's first F ground-truth frames
    (None otherwise)."""
    ms, feats, ids, labels, names, gts = [], [], [], [], [], []
    for ci in idx_list:
        ex = ds[ci]
        masked, audio = pad_clip(ex, frames, audio_window)
        gt = None
        if gt_size is not None:
            from dsml_thesis_tpu_torch.data import load_images

            clip_dir = ds._clip_dir(ex["subj"], ex["human_label"], ex["lvl"],
                                    ex["nbr"])
            gt = load_images([os.path.join(clip_dir, f) for f in
                              sorted(os.listdir(clip_dir))[:frames]], gt_size)
        ms.append(masked)
        feats.append(audio)
        ids.append(ex["identity"])
        labels.append(int(ex["class_label"]))
        names.append(f"{ex['subj']}_{ex['human_label']}_{ex['lvl']}_"
                     f"{ex['nbr']}")
        gts.append(gt)
    return (np.stack(ms), np.stack(feats),
            np.stack(ids).astype(np.float32), np.asarray(labels, np.int64),
            names, gts)


def batch_plan(n_clips, batch):
    """Clip indices of each batch, the tail padded with copies of its last
    clip, and how many clips of the tail are real."""
    batches = [list(range(s, min(s + batch, n_clips)))
               for s in range(0, n_clips, batch)]
    n_real_last = len(batches[-1]) if batches else batch
    if batches and n_real_last < batch:
        batches[-1] = batches[-1] + [batches[-1][-1]] * (batch - n_real_last)
    return batches, n_real_last


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=cli.CKPT_HELP)
    ap.add_argument("--tuples", default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--audio-dir", default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="N random in-memory clips instead of a dataset "
                         "(no --tuples / --outdir needed)")
    ap.add_argument("--prep-delay", type=float, default=0.0,
                    help="with --synthetic: host seconds added to each "
                         "clip's preparation, as file reads would add them")
    ap.add_argument("--batch", type=int, default=4, help="speakers a batch")
    ap.add_argument("--frames", type=int, default=32,
                    help="frames a clip (padded or cut)")
    ap.add_argument("--steps", type=int, default=50)
    cli.add_sampler_args(ap)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--audio-window", type=int, default=8)
    ap.add_argument("--metrics", action="store_true",
                    help="PSNR / SSIM of generated against ground-truth "
                         "frames")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.synthetic and args.metrics:
        ap.error("--synthetic clips have no ground truth; --metrics needs "
                 "the dataset")
    if not args.synthetic and not (args.tuples and args.data_root
                                   and args.audio_dir and args.outdir):
        ap.error("--tuples / --data-root / --audio-dir / --outdir are "
                 "required without --synthetic")
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.config import build_model, load_config
    from dsml_thesis_tpu_torch.data import MEADTalkingFace
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.metrics import psnr, ssim, to_unit_range
    from dsml_thesis_tpu_torch.server import batch_seed
    from dsml_thesis_tpu_torch.utils_io import (cast_sampling_params,
                                                load_params)

    cfg = load_config([args.config])
    adim = cfg["model"]["params"]["cond_stage_config_2"]["params"][
        "subspace_dim"]
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        ldm.load_state_dict(load_params(args.ckpt, ldm, cfg["model"]))
    ldm = cast_sampling_params(ldm).to(device).eval()
    if args.synthetic:
        ds = _SyntheticClips(args.synthetic, args.size, args.frames,
                             args.audio_window, adim, args.prep_delay)
    else:
        ds = MEADTalkingFace(args.tuples, args.data_root, args.audio_dir,
                             audio_window=args.audio_window, size=args.size,
                             mode="sample")
    ddim = make_ddim_schedule(ldm.schedule, args.steps, eta=0.0)
    B, F, w = args.batch, args.frames, args.audio_window
    pipeline = make_video_pipeline(
        ldm, ddim, w, guidance_scale=args.scale, sampler=args.sampler,
        sampler_steps=args.sampler_steps, sampler_order=args.sampler_order)

    batches, n_real_last = batch_plan(len(ds), B)
    if n_real_last < B:
        print(f"note: final batch padded with {B - n_real_last} repeated "
              f"clip(s)")
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for bi, idxs in enumerate(batches):
                put((bi, prepare(ds, idxs, F, w,
                                 args.size if args.metrics else None)))
        except BaseException as e:  # noqa: BLE001 - raised by the consumer
            put(e)
            return
        put(None)

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
    t0 = time.monotonic()
    state = {"frames": 0, "steady_t0": None, "steady_base": 0,
             "steady": None, "lines": []}

    def drain(pending):
        """The device -> host copy of a finished batch, its files and its
        line."""
        bi, names, gts, out = pending
        vids = out.float().cpu().numpy()
        state["frames"] += len(names) * vids.shape[1]
        line = f"batch {bi}: {vids.shape}"
        if args.metrics and gts[0] is not None:
            n = len(gts[0])
            a = to_unit_range(out[0, :n].float())
            b = to_unit_range(torch.from_numpy(gts[0]).to(device))
            line += (f" psnr={psnr(a, b).mean().item():.2f}"
                     f" ssim={ssim(a, b).mean().item():.3f}")
        if args.outdir:
            for i, name in enumerate(names):
                np.save(os.path.join(args.outdir, f"{name}.npy"), vids[i])
        now = time.monotonic()
        line += f" | cumulative {state['frames'] / (now - t0):.2f} frames/s"
        # the rate of a pipeline in flow: batches 1, 2, ... from the start
        # of batch 1's dispatch (batch 0 pays the first launches' set-up;
        # the host issues a batch's kernels before it drains the last one,
        # so a window from batch 0's drain would hold one device tail)
        if bi == 0:
            state["steady_base"] = state["frames"]
        else:
            state["steady"] = ((state["frames"] - state["steady_base"])
                               / (now - state["steady_t0"]))
            line += f" | steady {state['steady']:.2f} frames/s"
        print(line, flush=True)
        state["lines"].append(line)

    pending = None
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            bi, (masked, feats, ids, labels, names, gts) = item
            if bi == len(batches) - 1:
                names = names[:n_real_last]   # padded copies are not written
            if args.metrics and pending is not None:
                drain(pending)
                pending = None
            to = lambda a: torch.from_numpy(a).to(device)
            gen = torch.Generator(device=device).manual_seed(
                batch_seed(args.seed, bi))
            if bi == 1:
                state["steady_t0"] = time.monotonic()
            out = pipeline(to(masked), to(feats), to(ids), to(labels), gen)
            if pending is not None:
                drain(pending)
            pending = (bi, names, gts, out)
        if pending is not None:
            drain(pending)
    finally:
        stop.set()
        worker.join()
    seconds = time.monotonic() - t0
    return {"batches": len(batches), "frames": state["frames"],
            "seconds": seconds,
            "cumulative_frames_per_s": state["frames"] / seconds,
            "steady_frames_per_s": state["steady"], "lines": state["lines"]}


if __name__ == "__main__":
    main()
