#!/usr/bin/env python3
"""Single-frame MEAD talking-face sampling of the PyTorch port (the port's
``scripts/sample_mead_frame.py``).

    python3 scripts/sample_mead_frame_torch.py \
        --config configs/latent-diffusion/mead-128-ldm-f4.yaml \
        --masked masked.jpg --identity id.jpg --audio-pkl feats.pkl \
        --out frame.png [--ckpt weights] [--frame-idx 10 --class-label 1
        --steps 50 --scale 2.0 --size 128 --audio-window 8 --seed 0] [--cpu]

One frame of the progressive sampler: a mouth-masked frame, an identity
frame, an emotion label and the wav2vec2 features of the clip
(``--audio-pkl``, one row a frame, as ``scripts/mead_audio_features_torch.py``
writes them) around ``--frame-idx`` go through the 4-cond LDM (class +
audio cross-attention token, masked and identity latents concatenated to
the noise) in one guided DDIM chain, and the latent is decoded. The audio
window is clamped at the clip's edges; ``--audio-window`` must give the
config's ``seq_len`` rows (2 w + 1; by default w = (seq_len - 1) / 2).
Writes ``--out`` (a PNG, where Pillow is installed) and the float32 image
in [-1, 1] beside it as ``.npy``.

``--ckpt`` takes the files of ``progressive_sampling_torch.py``'s; without
it the weights are random, from ``--seed``, which also seeds the noise. It
runs on the card; without one it fails unless ``--cpu`` is given.
"""
import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli


def audio_window_rows(audio, frame_idx, window):
    """The 2 w + 1 feature rows around ``frame_idx``, clamped at the
    clip's edges."""
    idx = [min(max(frame_idx + i, 0), len(audio) - 1)
           for i in range(-window, window + 1)]
    return np.asarray(audio, np.float32)[idx]


@torch.no_grad()
def sample_frame(ldm, masked, identity, audio, frame_idx, class_label,
                 window, latent_size, steps, scale, generator, x_T=None,
                 decode=True):
    """One frame: float32 [H, W, 3] in [-1, 1] (the latent [h, w, c]
    when not ``decode``). ``masked`` / ``identity`` are [H, W, 3] images in
    [-1, 1], ``audio`` the clip's features [T, D]; the noise comes from
    ``generator`` (on the model's device), or ``x_T`` [1, h, w, c]
    replaces it."""
    device = next(ldm.parameters()).device
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))[
        None].to(device)
    batch = {
        "image": torch.zeros_like(to(masked)),
        "masked_image": to(masked),
        "identity": to(identity),
        "class_label": torch.tensor([int(class_label)], device=device),
        "audio": to(audio_window_rows(audio, frame_idx, window)),
    }
    cond = ldm.encode_conditioning(batch)
    uncond = ldm.null_conditioning(batch, batch_size=1)
    z = ldm.sample_ddim(cond, (1, latent_size, latent_size, ldm.channels),
                        generator, steps=steps, uncond=uncond,
                        guidance_scale=scale, x_T=x_T)
    if not decode:
        return z[0].float().cpu().numpy()
    img = ldm.decode_first_stage(z).float().clamp(-1.0, 1.0)
    return img[0].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help=cli.CKPT_HELP)
    ap.add_argument("--masked", required=True)
    ap.add_argument("--identity", required=True)
    ap.add_argument("--audio-pkl", required=True)
    ap.add_argument("--frame-idx", type=int, default=0)
    ap.add_argument("--class-label", type=int, default=0)
    ap.add_argument("--audio-window", type=int, default=None,
                    help="defaults to (config seq_len - 1) // 2; other "
                         "values mismatch the audio encoder's seq_len")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.config import build_model, load_config
    from dsml_thesis_tpu_torch.data import load_image
    from dsml_thesis_tpu_torch.utils_io import (cast_sampling_params,
                                                load_params)

    cfg = load_config([args.config])
    params = cfg["model"]["params"]
    seq_len = params["cond_stage_config_2"]["params"]["seq_len"]
    # the audio encoder reshapes its input to seq_len rows
    w = (seq_len - 1) // 2 if args.audio_window is None else args.audio_window
    if 2 * w + 1 != seq_len:
        raise SystemExit(
            f"--audio-window {w} gives {2 * w + 1} rows but the config's "
            f"audio encoder expects seq_len={seq_len}")
    torch.manual_seed(args.seed)
    ldm = build_model(cfg["model"])
    if args.ckpt:
        ldm.load_state_dict(load_params(args.ckpt, ldm, cfg["model"]))
    ldm = cast_sampling_params(ldm).to(device).eval()

    with open(args.audio_pkl, "rb") as f:
        audio = np.asarray(pickle.load(f), np.float32)
    ch_mult = params["first_stage_config"]["params"]["ddconfig"]["ch_mult"]
    latent = args.size // (2 ** (len(ch_mult) - 1))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    img = sample_frame(ldm, load_image(args.masked, args.size),
                       load_image(args.identity, args.size), audio,
                       args.frame_idx, args.class_label, w, latent,
                       args.steps, args.scale, gen)
    np.save(os.path.splitext(args.out)[0] + ".npy", img)
    cli.save_png_row(img[None], args.out)
    print(f"saved {args.out} {img.shape}")
    return img


if __name__ == "__main__":
    main()
