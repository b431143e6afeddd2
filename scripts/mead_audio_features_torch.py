#!/usr/bin/env python3
"""Per-clip wav2vec2 audio features of the MEAD dataset (the port's
``scripts/mead_audio_features.py``).

    python3 scripts/mead_audio_features_torch.py --tuples <tuples.pkl> \
        --audio-root <root> --frames-root <root> --outdir <dir> \
        [--variant base|bundle] (--model <snapshot dir> | --seed N) [--cpu]

For each (subj, emo, lvl, clip) of the tuples pickle: the wav at
``<audio-root>/<subj>/audio/<emo>/<lvl>/<clip>.wav``, brought to 16 kHz
mono (``load_wav_16k``) and normalized as ``transformers``'
``Wav2Vec2FeatureExtractor`` normalizes (``normalize_audio``), then
wav2vec2 with one output row per video frame (the frames are counted in
``<frames-root>/<subj>/video/front/<emo>/<lvl>/<clip>/``), written as
``<outdir>/<subj>_<emo>_<lvl>_<clip>.pkl`` (float32 [frames, D]).

``base``: hidden states, the CNN features resampled to the frame count
before the encoder (768 wide for wav2vec2-base). ``bundle``: the CTC
logits of a ForCTC model (``LARGE_960H``: 32 wide) at the native rate,
resampled to the frame count after the model.

``--model`` names a local snapshot directory: ``config.json`` (read with
``json``), ``pytorch_model.bin`` (read with ``torch.load``) and, where
present, ``preprocessor_config.json`` (its ``do_normalize``). ``--seed``
builds random weights from that seed instead, at the snapshot's
``config.json`` when ``--model`` is also given, else at wav2vec2-base
(``base``) or ``LARGE_960H`` (``bundle``). Neither needs ``transformers``.
It runs on the card; without one it fails unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_WAV_DTYPES = {1: np.uint8, 2: np.int16, 4: np.int32}


def resample_linear(data: np.ndarray, out_len: int) -> np.ndarray:
    """``jax.image.resize(data, (out_len,), "linear")`` of a 1-D float32
    signal: the triangle kernel at half-pixel centres, widened by the ratio
    when downsampling (antialiasing), weights normalized over the samples
    inside the signal; float32 throughout, as the JAX function computes."""
    n = len(data)
    if out_len == n:
        return data
    f32 = np.float32
    inv_scale = f32(1.0 / (out_len / n))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_len, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    radius = int(np.ceil(kernel_scale))
    base = np.floor(sample).astype(np.int64)
    taps = base[:, None] + np.arange(-radius, radius + 2)[None, :]
    weights = np.maximum(
        f32(0.0),
        f32(1.0) - np.abs(sample[:, None] - taps.astype(f32)) / kernel_scale)
    inside = (taps >= 0) & (taps < n)
    weights = np.where(inside, weights, f32(0.0)).astype(f32)
    total = weights.sum(axis=1, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    weights[(sample < -0.5) | (sample > n - 0.5)] = 0.0
    values = data.astype(f32)[np.clip(taps, 0, n - 1)]
    return (values * weights).sum(axis=1, dtype=f32)


def load_wav_16k(path: str) -> np.ndarray:
    """A wav (8-, 16- or 32-bit PCM, any rate, mono or not) as float32 mono
    at 16 kHz, peak-normalized to 1 before the resample (stdlib ``wave``)."""
    with wave.open(path, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        data = np.frombuffer(w.readframes(n),
                             dtype=_WAV_DTYPES[w.getsampwidth()]
                             ).astype(np.float32)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
        data = data / np.abs(data).max().clip(1e-6)
    if sr != 16000:
        data = resample_linear(data, int(round(len(data) * 16000 / sr)))
    return data


def normalize_audio(wav: np.ndarray, do_normalize: bool = True) -> np.ndarray:
    """``Wav2Vec2FeatureExtractor``'s input values of one unpadded clip:
    with ``do_normalize`` zero mean and unit variance, (x - mean) /
    sqrt(var + 1e-7), the variance biased."""
    wav = np.asarray(wav, dtype=np.float32)
    if not do_normalize:
        return wav
    return ((wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)).astype(np.float32)


def build_model(variant: str, model_dir=None, seed=None):
    """(wav2vec2 module, do_normalize) from a snapshot directory or random
    weights from ``seed``."""
    import torch

    from dsml_thesis_tpu_torch.models.wav2vec2 import (
        LARGE_960H, Wav2Vec2, Wav2Vec2Config, config_from_hf,
        convert_wav2vec2)

    bundle = variant == "bundle"
    do_normalize = True
    if model_dir is not None:
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = config_from_hf(json.load(f), ctc=bundle)
        pre = os.path.join(model_dir, "preprocessor_config.json")
        if os.path.exists(pre):
            with open(pre) as f:
                do_normalize = json.load(f).get("do_normalize", True)
    else:
        cfg = LARGE_960H if bundle else Wav2Vec2Config()
    if seed is not None:
        torch.manual_seed(seed)
    model = Wav2Vec2(cfg)
    if seed is None:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
        model.load_state_dict(convert_wav2vec2(sd, cfg), strict=True)
    return model.eval(), do_normalize


def featurize(model, wav, num_frames: int, bundle: bool, device):
    """[num_frames, D] features of one normalized clip."""
    import torch

    from dsml_thesis_tpu_torch.models.wav2vec2 import interp_align_corners

    x = torch.from_numpy(wav)[None].to(device)
    with torch.no_grad():
        if bundle:
            out = interp_align_corners(model(x), num_frames)
        else:
            out = model(x, num_frames=num_frames)
    return out[0].float().cpu().numpy()


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tuples", required=True,
                    help="pickle of (subj, emo, lvl, clip) tuples")
    ap.add_argument("--audio-root", required=True,
                    help="<root>/<subj>/audio/<emo>/<lvl>/<clip>.wav")
    ap.add_argument("--frames-root", required=True,
                    help="<root>/<subj>/video/front/<emo>/<lvl>/<clip>/")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--model", default=None,
                    help="local snapshot directory (config.json, "
                         "pytorch_model.bin)")
    ap.add_argument("--seed", type=int, default=None,
                    help="random weights from this seed instead of "
                         "pytorch_model.bin")
    ap.add_argument("--variant", choices=["base", "bundle"], default="base",
                    help="base: hidden states, CNN features resampled to "
                         "the frame count before the encoder; bundle: CTC "
                         "logits resampled after the model")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card, and no "
                         "card is an error)")
    return ap


def main(argv=None):
    """Runs the CLI; returns {clip name: features}."""
    import torch

    args = get_parser().parse_args(argv)
    if args.model is None and args.seed is None:
        raise SystemExit("mead_audio_features_torch: give --model <snapshot "
                         "dir> or --seed N")
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise SystemExit("mead_audio_features_torch: no CUDA device (pass "
                         "--cpu to run on the CPU)")
    model, do_normalize = build_model(args.variant, args.model, args.seed)
    model = model.to(device)
    with open(args.tuples, "rb") as f:
        tuples = sorted(list(pickle.load(f)))
    os.makedirs(args.outdir, exist_ok=True)
    out = {}
    for i, (subj, emo, lvl, clip) in enumerate(tuples):
        wav = normalize_audio(load_wav_16k(os.path.join(
            args.audio_root, subj, "audio", emo, lvl, f"{clip}.wav")),
            do_normalize)
        num_frames = len(os.listdir(os.path.join(
            args.frames_root, subj, "video", "front", emo, lvl, clip)))
        x = featurize(model, wav, num_frames, args.variant == "bundle",
                      device)
        if x.shape[0] != num_frames:
            raise AssertionError(f"{x.shape[0]} rows for {num_frames} frames")
        name = f"{subj}_{emo}_{lvl}_{clip}"
        with open(os.path.join(args.outdir, f"{name}.pkl"), "wb") as f:
            pickle.dump(x, f, protocol=pickle.HIGHEST_PROTOCOL)
        out[name] = x
        print(f"[{i + 1}/{len(tuples)}] {name}: {x.shape}", flush=True)
    return out


if __name__ == "__main__":
    main()
