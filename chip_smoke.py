#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # all phases; exit code 0 = every phase ok

Phases, each printing one JSON line (any failure exits non-zero):
  device   the card's name and power limit as nvidia-smi gives them
  build    compiles the CUDA kernels from dsml_thesis_tpu_torch/csrc/
  kernels  every kernel against its plain PyTorch version on the card, at the
           shapes the serving path gives it, with times: the kernel, the
           plain version, one library call computing the same function
           (timed as a yardstick only; the port never calls it) and the
           least time the card could take (bytes over 3.35 TB/s against
           operations over 989 TFLOP/s bf16, the larger)
  model    mead-256-ldm-f4.yaml at full width and depth, random weights from
           a seed: one UNet call and one first-stage decode through the
           kernels against the same calls through the plain versions
  serve    the same model: a MicroBatcher of batch 8 answers 16 single-clip
           requests (two batches) of F frames, DDIM-50, guidance 2.0; checks
           shapes, finiteness, range, launch counts, that the batches differ
           and that (seed, batch index) reproduces a batch bit for bit
then the line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

`--phases device,build,kernels` runs a subset (no final ok line then).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CONFIG = os.path.join(HERE, "configs", "latent-diffusion", "mead-256-ldm-f4.yaml")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
# bf16 keeps 8 significant bits (2^-8 = 3.9e-3 relative per rounding). The
# kernels round P, q / k / v, the attention output and the result once each,
# in another order than the plain version; a few such roundings on values up
# to the output's maximum stay under 2e-2 of that maximum, while a wrong
# tile, index or mask shows as an error of the order of the maximum itself.
REL_TOL = 2e-2
TIME_LIMIT_S = 1150


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases

def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    smi = out.stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from dsml_thesis_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.load()
    report = [ln.strip() for ln in _build.build_log.splitlines()
              if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 2),
          "nvcc_seconds": _build.build_seconds, "sources": list(_build.SOURCES),
          "ptxas": report})


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            ).to(torch.bfloat16)


def _compare(out, ref):
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return float("inf"), float("inf")
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-12)


def _flash_case(gen, b, h, nq, nk, d, timed):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v = (_rand(gen, b, h, n, d) for n in (nq, nk, nk))
    scale = d ** -0.5
    out = A.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    ref = A.attention_reference(q, k, v, scale=scale)
    err, rel = _compare(out, ref)
    case = {"shape": [b, h, nq, nk, d], "max_abs_err": err, "rel_err": rel}
    if timed:
        nbytes = 2 * b * h * (2 * nq + 2 * nk) * d
        flops = 4 * b * h * nq * nk * d
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        case.update(
            ms=time_ms(lambda: A.flash_attention(q, k, v, scale=scale), 10),
            plain_ms=time_ms(
                lambda: A.attention_reference(q, k, v, scale=scale), 3, 1),
            library_ms=time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                5),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes > t_ops else "operations")
    return case


def _fproj_case(gen, b, n, c, heads, timed):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = c  # the UNet's self-attention keeps heads * head_dim == channels
    d = hd // heads
    h = _rand(gen, b, n, c)
    wq, wk, wv = (_rand(gen, hd, c, scale=c ** -0.5) for _ in range(3))
    wo = _rand(gen, c, hd, scale=hd ** -0.5)
    bo = _rand(gen, c, scale=0.1)
    scale = d ** -0.5
    args = (h, wq, wk, wv, wo, bo, heads)
    out = A.flash_attention_fproj(*args, scale=scale)
    torch.cuda.synchronize()
    ref = A.fproj_reference(*args, scale=scale)
    err, rel = _compare(out, ref)
    case = {"shape": [b, n, c, heads], "max_abs_err": err, "rel_err": rel}
    if timed:
        def library():
            sp = lambda t: t.view(b, n, heads, d).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                sp(F.linear(h, wq)), sp(F.linear(h, wk)), sp(F.linear(h, wv)),
                scale=scale)
            return F.linear(o.transpose(1, 2).reshape(b, n, hd), wo, bo)

        nbytes = 2 * (2 * b * n * c + 4 * c * hd + c)
        flops = 2 * b * n * c * hd * 4 + 4 * b * n * n * hd
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        case.update(
            ms=time_ms(lambda: A.flash_attention_fproj(*args, scale=scale), 20),
            plain_ms=time_ms(lambda: A.fproj_reference(*args, scale=scale), 3, 1),
            library_ms=time_ms(library, 10),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes > t_ops else "operations")
    return case


def phase_kernels():
    """Each kernel against its plain version, at the serving path's shapes
    (batch 8, and 16 after the guidance pair is tiled; F = 2 frames a clip)
    plus ragged and other-head-width cases. The first timed case of a kernel
    is the one its entry in the "kernels" line reports."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = [
        _flash_case(gen, 8, 1, 4096, 4096, 512, True),    # decode, identity
        _flash_case(gen, 16, 1, 4096, 4096, 512, True),   # B*F masked frames
        _flash_case(gen, 2, 1, 1000, 1000, 512, False),   # ragged N
        _flash_case(gen, 2, 5, 333, 77, 32, False),       # composed branch
        _flash_case(gen, 2, 3, 200, 200, 64, False),
    ]
    fproj = [
        _fproj_case(gen, 16, 1024, 320, 10, True),   # 2B after the pair tiles
        _fproj_case(gen, 8, 1024, 320, 10, True),    # B: first transformer
        _fproj_case(gen, 16, 256, 640, 20, True),
        _fproj_case(gen, 3, 200, 320, 10, False),    # ragged N
        _fproj_case(gen, 2, 100, 128, 2, False),     # 64-wide heads
        _fproj_case(gen, 2, 300, 160, 5, False),     # H*D not a multiple of 64
    ]
    cases = {"flash_attention": flash, "flash_attention_fproj": fproj}
    worst = max(c["rel_err"] for cs in cases.values() for c in cs)
    emit({"phase": "kernels", "rel_tol": REL_TOL, "dtype": "bfloat16",
          "worst_rel_err": worst, "cases": cases})
    if not worst <= REL_TOL:
        fail(f"a kernel disagrees with its plain version: rel err {worst} "
             f"> {REL_TOL}")
    return cases


def build_ldm(seed=0):
    """mead-256-ldm-f4 at full width and depth on the card, weights from
    PyTorch's default inits under a seed, cast for sampling."""
    from dsml_thesis_tpu_torch.config import build_model, load_config
    from dsml_thesis_tpu_torch.utils_io import cast_sampling_params

    cfg = load_config([CONFIG])
    torch.manual_seed(seed)
    ldm = build_model(cfg["model"])
    # The codebook's own init, U(-1/K, 1/K), is where training starts: every
    # code sits at the origin, so any latent decodes to the same image. A
    # trained codebook spans the latents' range; unit normal stands in for it.
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    return cfg, cast_sampling_params(ldm).to("cuda").eval()


def phase_model(ldm):
    """The two models that hold the kernels, each run once on the card
    through its kernel and once with the kernel's plain version put in its
    place (patched in here, for this comparison only), on the same inputs:
    one guidance-pair UNet call at batch 8 and one first-stage decode. A
    whole bf16 model compounds the kernels' rounding differences through its
    layers: tolerance 5e-2 of the output's maximum."""
    from unittest import mock

    from dsml_thesis_tpu_torch.models import autoencoder, unet
    from dsml_thesis_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, cc, ctx = r(8, 64, 64, 3), r(8, 64, 64, 6), r(16, 1, 1024)
    t = torch.full((8,), 500, device="cuda")
    z = r(2, 64, 64, 3)

    def run():
        with torch.no_grad():
            eps = ldm.apply_model(x, t, {"crossattn": ctx, "concat": cc},
                                  cfg_pairs=True)
            img = ldm.decode_first_stage(z, force_not_quantize=True)
        torch.cuda.synchronize()
        return eps.float(), img.float()

    A.reset_launches()
    eps_k, img_k = run()
    launched = dict(A.LAUNCHES)
    with mock.patch.object(unet, "flash_attention_fproj", A.fproj_reference), \
            mock.patch.object(autoencoder, "flash_attention",
                              A.attention_reference):
        eps_p, img_p = run()
    out = {"phase": "model", "rel_tol": 5e-2, "launches": launched}
    for name, k, p in (("unet", eps_k, eps_p), ("decode", img_k, img_p)):
        err, rel = _compare(k, p)
        out[name] = {"shape": list(k.shape), "max_abs_err": err,
                     "rel_err": rel}
    emit(out)
    ok = (launched == {"flash_attention": 4, "flash_attention_fproj": 11}
          and all(out[n]["rel_err"] <= 5e-2 for n in ("unet", "decode")))
    if not ok:
        fail(f"model: kernel path and plain path disagree: {out}")


def phase_serve(cfg, ldm, frames, smi, seed=0):
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.server import MicroBatcher, make_pipeline_runner

    batch, n_requests, steps, guidance, size, window = 8, 16, 50, 2.0, 256, 8
    device = torch.device("cuda")
    ddim = make_ddim_schedule(ldm.schedule, steps, eta=0.0)
    pipeline = make_video_pipeline(ldm, ddim, window, guidance_scale=guidance)
    runner = make_pipeline_runner(pipeline, seed=seed, device=device)

    log = []  # (batch_index, inputs, output, seconds) of every dispatched batch

    def run_batch(stacked, batch_index):
        t0 = time.monotonic()
        out = runner(stacked, batch_index)
        torch.cuda.synchronize()
        log.append((batch_index, stacked, out, time.monotonic() - t0))
        return out

    c2 = cfg["model"]["params"]["cond_stage_config_2"]["params"]
    rng = np.random.default_rng(seed)
    requests = [{
        "masked_frames": rng.uniform(-1, 1, (frames, size, size, 3)
                                     ).astype(np.float32),
        "audio": rng.standard_normal((frames + window, c2["subspace_dim"])
                                     ).astype(np.float32),
        "identity": rng.uniform(-1, 1, (size, size, 3)).astype(np.float32),
        "class_label": np.int32(i % 8),
    } for i in range(n_requests)]

    A.reset_launches()   # counts below are of the served requests alone
    batcher = MicroBatcher(run_batch, batch, max_wait_ms=5000.0)
    results = [None] * n_requests
    errors = []

    def client(i):
        try:
            results[i] = batcher.submit(requests[i], timeout=TIME_LIMIT_S)
        except Exception as e:  # noqa: BLE001 - reported below, run fails
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_requests)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    launches = dict(A.LAUNCHES)
    batcher.shutdown()
    if errors:
        fail(f"serve: requests failed: {errors[:3]}")

    n_batches = n_requests // batch
    # first stage: 3 attention blocks an encode (one encode of the B*F masked
    # frames, one of the B identity frames), 4 a decode (one decode a frame);
    # UNet: 11 self-attentions a call (4 down, 1 mid, 6 up), one call a DDIM
    # step with the guidance pair deduplicated
    expect = {
        "flash_attention": n_batches * (3 + 3 + 4 * frames),
        "flash_attention_fproj": n_batches * frames * steps * 11,
    }
    checks = {
        "batches": len(log) == n_batches,
        "shape": all(r is not None and r.shape == (frames, size, size, 3)
                     for r in results),
        "finite": all(bool(np.isfinite(r).all()) for r in results),
        "range": all(float(np.abs(r).max()) <= 1.0 for r in results),
        "varied": all(float(r.std()) > 1e-3 for r in results),
        "launches": launches == expect,
    }
    if checks["batches"]:
        (_, in0, out0, _), (_, _, out1, _) = log[0], log[1]
        checks["batches_differ"] = not np.array_equal(out0, out1)
        again = runner(in0, log[0][0])
        checks["reproducible"] = bool(np.array_equal(again, out0))
    secs = [round(s, 3) for *_, s in log]
    emit({"phase": "serve", "config": os.path.relpath(CONFIG, HERE),
          "card": smi, "batch": batch, "frames": frames, "ddim_steps": steps,
          "guidance": guidance, "requests": n_requests, "checks": checks,
          "launches": launches, "launches_expected": expect,
          "launch_arithmetic": "flash: batches*(3+3+4*F); fproj: "
                               "batches*F*steps*11",
          "seconds_per_batch": secs, "wall_seconds": round(wall, 3),
          "frames_per_s": round(n_requests * frames / wall, 4),
          "stats": batcher.stats()})
    if not all(checks.values()):
        fail(f"serve: checks failed: {checks}")
    return launches


def kernels_line(cases, launches):
    meta = {
        "flash_attention": (
            "dsml_thesis_tpu_torch/csrc/flash_attention.cu",
            "dsml_thesis_tpu/ops/attention.py:328"),
        "flash_attention_fproj": (
            "dsml_thesis_tpu_torch/csrc/flash_attention_fproj.cu",
            "dsml_thesis_tpu/ops/attention.py:950"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        timed = [c for c in cases[name] if "ms" in c]
        first = timed[0]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "shape": first["shape"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "other_shapes": timed[1:],
        })
    return {"kernels": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,model,serve")
    ap.add_argument("--frames", type=int, default=2,
                    help="frames a clip in the serve phase")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on the "
              "card and has no CPU mode", file=sys.stderr)
        sys.exit(2)
    # nothing is printed before the program itself is known to be here
    if not os.path.exists(CONFIG):
        print(f"chip_smoke: {CONFIG} is missing: run from a checkout",
              file=sys.stderr)
        sys.exit(3)
    import dsml_thesis_tpu_torch.ops.attention  # noqa: F401
    signal.signal(signal.SIGALRM,
                  lambda *_: fail(f"time limit of {TIME_LIMIT_S} s reached"))
    signal.alarm(TIME_LIMIT_S)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    if "build" in phases:
        phase_build()
    cases = phase_kernels() if "kernels" in phases else None
    launches = None
    if "model" in phases or "serve" in phases:
        cfg, ldm = build_ldm()
        if "model" in phases:
            phase_model(ldm)
        if "serve" in phases:
            launches = phase_serve(cfg, ldm, args.frames, smi)
    if cases is None or launches is None:
        return
    emit(kernels_line(cases, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
