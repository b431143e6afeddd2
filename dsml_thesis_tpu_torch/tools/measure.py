"""Measurements of the port on the GPU, beyond what chip_smoke.py checks.

    python -m dsml_thesis_tpu_torch.tools.measure --gate --profile

--gate     the fused self-attention op against the composed branch
           (three linears, split-head flash_attention, one linear) at the
           UNet's two shapes and batch 1, 2, 8, 16, in turns (fused,
           composed, composed, fused), CUDA events, median of the rounds
--profile  one warm batch of mead-256-ldm-f4 (batch 8, DDIM-50, guidance
           2.0, random weights): phase times from CUDA events, then one
           frame under torch.profiler: device time by kernel family and the
           device's idle share (traced, and estimated against the same
           frame's untraced wall time)

Prints one JSON line per measurement, each with the card's name and power
limit. Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from ..config import build_model, load_config
from ..diffusion import make_ddim_schedule, make_video_pipeline
from ..models.unet import CrossAttention
from ..ops import attention as A
from ..utils_io import cast_sampling_params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "latent-diffusion",
                      "mead-256-ldm-f4.yaml")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def event_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gate(smi: str):
    """Fused op vs the composed branch of the same CrossAttention module."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c, heads in ((1024, 320, 10), (256, 640, 20)):
        attn = CrossAttention(c, None, heads, c // heads, dtype=torch.bfloat16)
        attn = cast_sampling_params(attn).cuda()
        for b in (1, 2, 8, 16):
            x = torch.randn(b, n, c, generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            with torch.no_grad():
                fused = lambda: attn.eval()(x)
                composed = lambda: attn.train()(x)  # the composed branch
                err = (fused().float() - composed().float()).abs().max().item()
                for fn in (fused, composed):
                    event_ms(fn, 5)  # warm-up
                rounds = {"fused": [], "composed": []}
                for _ in range(5):
                    rounds["fused"].append(event_ms(fused, 20))
                    rounds["composed"].append(event_ms(composed, 20))
                    rounds["composed"].append(event_ms(composed, 20))
                    rounds["fused"].append(event_ms(fused, 20))
            print(json.dumps({
                "measure": "gate", "card": smi, "shape": [b, n, c, heads],
                "fused_ms": statistics.median(rounds["fused"]),
                "composed_ms": statistics.median(rounds["composed"]),
                "fused_ms_range": [min(rounds["fused"]), max(rounds["fused"])],
                "composed_ms_range": [min(rounds["composed"]),
                                      max(rounds["composed"])],
                "max_abs_diff": err}), flush=True)


_FAMILIES = (
    ("fproj_attention_kernel", "attention: fproj (attention + to_out)"),
    ("qkv_proj_kernel", "attention: fproj (q, k, v projection)"),
    ("flash_attention_kernel", "attention: flash_attention"),
    ("cudnn", "convolution"), ("conv", "convolution"), ("wgrad", "convolution"),
    ("nchwToNhwc", "convolution"), ("nhwcToNchw", "convolution"),
    ("gemm", "linear (cuBLAS)"), ("cutlass", "linear (cuBLAS)"),
    ("gemv", "linear (cuBLAS)"), ("nvjet", "linear (cuBLAS)"),
    ("reduce", "reductions (norm statistics)"),
    ("layer_norm", "LayerNorm"),
    ("Memcpy", "copies"), ("copy", "copies"), ("Cat", "concatenate"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
)


def _family(name: str) -> str:
    for key, fam in _FAMILIES:
        if key.lower() in name.lower():
            return fam
    return "other"


def profile(smi: str, frames: int):
    device = torch.device("cuda")
    batch, steps, size, window = 8, 50, 256, 8
    cfg = load_config([CONFIG])
    torch.manual_seed(0)
    ldm = build_model(cfg["model"])
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    ldm = cast_sampling_params(ldm).to(device).eval()
    ddim = make_ddim_schedule(ldm.schedule, steps, eta=0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    adim = cfg["model"]["params"]["cond_stage_config_2"]["params"]["subspace_dim"]

    def inputs(f):
        return (r(batch, f, size, size, 3).clamp(-1, 1),
                r(batch, f + window, adim), r(batch, size, size, 3).clamp(-1, 1),
                torch.arange(batch, device=device) % 8)

    pipe = make_video_pipeline(ldm, ddim, window, guidance_scale=2.0)
    pipe(*inputs(1), gen)  # warm-up: kernel build, cuDNN algorithm choice
    torch.cuda.synchronize()

    # phase times of one warm batch, by CUDA events around the phases
    with torch.no_grad():
        mf, au, idn, lab = inputs(frames)
        t0 = time.monotonic()
        enc_ms = event_ms(lambda: (
            ldm.encode_first_stage(mf.reshape((-1,) + mf.shape[2:])),
            ldm.encode_first_stage(idn)), 1)
        lat = make_video_pipeline(ldm, ddim, window, guidance_scale=2.0,
                                  decode=False)
        chain_ms = event_ms(lambda: lat(mf, au, idn, lab, gen), 1) - enc_ms
        z = r(batch, 64, 64, 3)
        dec_ms = event_ms(lambda: ldm.decode_first_stage(z), 3)
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        total_ms = event_ms(lambda: pipe(mf, au, idn, lab, gen), 1)
        wall = time.monotonic() - t0
    print(json.dumps({
        "measure": "phases", "card": smi, "batch": batch, "frames": frames,
        "ddim_steps": steps, "batch_ms": total_ms,
        "encode_ms": enc_ms, "ddim_chain_ms": chain_ms,
        "unet_call_ms": chain_ms / (frames * steps),
        "decode_ms_per_frame": dec_ms, "launches": dict(A.LAUNCHES),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_seconds_all": wall}), flush=True)

    # one frame under the profiler: device time by kernel family, idle share.
    # Tracing slows the host, so the same frame is also timed untraced: the
    # traced device-busy time over the untraced wall time estimates the idle
    # share a user sees.
    t0 = time.monotonic()
    pipe(*inputs(1), gen)
    torch.cuda.synchronize()
    wall_untraced_ms = 1e3 * (time.monotonic() - t0)
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        pipe(*inputs(1), gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    fams, kernels = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us <= 0 or ev.device_type.name != "CUDA":
            continue
        fams[_family(ev.key)] = fams.get(_family(ev.key), 0.0) + dev_us / 1e3
        kernels[ev.key] = (dev_us / 1e3, ev.count)
    busy_ms = sum(fams.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({
        "measure": "profile", "card": smi, "batch": batch, "frames": 1,
        "wall_ms_traced": wall_ms, "wall_ms_untraced": wall_untraced_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_traced": (1 - busy_ms / wall_ms) if busy_ms
        else None,
        "device_idle_share_untraced_estimate":
            (1 - busy_ms / wall_untraced_ms) if busy_ms else None,
        "family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "family_share": {k: v / busy_ms for k, v in sorted(
            fams.items(), key=lambda kv: -kv[1])} if busy_ms else None,
        "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                        for k, v in top]}), flush=True)
    if not busy_ms:
        print(json.dumps({"measure": "profile", "note":
                          "the profiler recorded no device time here; only "
                          "the event-timed phases above are device times"}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = card()
    if args.gate:
        gate(smi)
    if args.profile:
        profile(smi, args.frames)


if __name__ == "__main__":
    main()
