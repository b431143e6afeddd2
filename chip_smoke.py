#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # all phases; exit code 0 = every phase ok

Phases, each printing one JSON line (any failure exits non-zero):
  device   the card's name and power limit as nvidia-smi gives them
  build    compiles the CUDA kernels from dsml_thesis_tpu_torch/csrc/
  kernels  every kernel against its plain PyTorch version on the card, at the
           shapes the serving paths give it, with times: the kernel, the
           plain version, one library call computing the same function
           (timed as a yardstick only; the port never calls it) and the
           least time the card could take (bytes over 3.35 TB/s against
           operations over 989 TFLOP/s bf16, 494.7 TF32 for the fp32
           attention kernels, or 67 TFLOP/s fp32 outside the tensor cores,
           the larger); the fp32 kernels (first-stage training's D = 512
           attention) are held to fp32 plain versions with TF32 off
  model    mead-256-ldm-f4.yaml and its -fullattn twin at full width and
           depth, random weights from a seed: one UNet call and one
           first-stage decode through the kernels against the same calls
           through the plain versions, under each flag set of the serve runs
  serve    a MicroBatcher of batch 8 answers single-clip requests of F
           frames, DDIM-50, guidance 2.0, in seven runs:
             fullattn        -fullattn, no flag, 16 requests (two batches)
             fullattn-flags  -fullattn, DSML_ATTN_FPROJ_PARTIAL=1 and
                             DSML_PALLAS_GN=1, one batch
             headline-stats  headline config, DSML_PALLAS_GN=stats, one batch
             headline        headline config, no flag, one batch
             headline-streaming     DSML_FLASH_STREAMING=1, one batch
             headline-epilogue-res  DSML_GN_EPILOGUE=res, one batch
             headline-epilogue      DSML_GN_EPILOGUE=1, one batch
           each checks shapes, finiteness, range, launch counts, and that
           (seed, batch index) reproduces a batch bit for bit
  train    scripts/train_torch.py's own main() on SyntheticDataset at the
           real shapes (256 px, audio [17, 768]), batch 8, full width and
           depth, fp32 parameters with bf16 compute, in six runs:
             train           headline config, no flag, 6 optimizer steps, one
                             validation batch, `last` written, then resumed
                             with --resume for one more step
             train-fullattn  -fullattn, no flag, 2 steps
             train-split     headline, DSML_ATTN_PACKED=0, 2 steps
             train-gn        headline, DSML_PALLAS_GN=1, 2 steps
             train-streaming headline, DSML_ATTN_PACKED=0 and
                             DSML_FLASH_STREAMING=1, 2 steps
             train-epilogue  headline, DSML_GN_EPILOGUE=res, 2 steps
           each checks: finite losses, parameters that moved, launch counts
           against those counted from the model's own blocks, equal loss bits
           from a second run with the same seed, and loss and a handful of
           gradients on the kernel path against the plain path on the card;
           then first-stage training (fp32, the AttnBlock at D = 512) of
           configs/autoencoder/*.yaml at full width, batch 16, 128 px,
           SyntheticDataset images, LPIPS files written from seed 0,
           disc_start 0 (the GAN term and its adaptive weight run), in
           three runs:
             ae-vq           vqgan-f4, 4 steps, one validation batch, `last`,
                             then resumed with --resume for one more step
             ae-vq-streaming vqgan-f4, DSML_FLASH_STREAMING=1, 2 steps
             ae-kl           kl-f4, 2 steps
           each checks the same, plus a d_weight above zero and moved
           discriminator parameters
then the line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

`--phases device,build,kernels` runs a subset (no final ok line then).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CONFIG_DIR = os.path.join(HERE, "configs", "latent-diffusion")
CONFIG = os.path.join(CONFIG_DIR, "mead-256-ldm-f4.yaml")
CONFIG_FULLATTN = os.path.join(CONFIG_DIR, "mead-256-ldm-f4-fullattn.yaml")
CONFIG_VQ = os.path.join(HERE, "configs", "autoencoder", "vqgan-f4.yaml")
CONFIG_KL = os.path.join(HERE, "configs", "autoencoder", "kl-f4.yaml")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12   # H100 SXM dense TF32 tensor cores (the fp32
                             # attention kernels multiply there)
# bf16 keeps 8 significant bits (2^-8 = 3.9e-3 relative per rounding). The
# kernels round P, q / k / v, the attention output and the result once each,
# in another order than the plain version; a few such roundings on values up
# to the output's maximum stay under 2e-2 of that maximum, while a wrong
# tile, index or mask shows as an error of the order of the maximum itself.
REL_TOL = 2e-2
# The statistics kernel returns fp32 sums of up to 65,536 bf16 values a
# channel, taken in another order than torch.sum takes them: 1e-4 of the
# largest sum is some tens of fp32 roundings, a dropped row is 1 / N of it.
STATS_REL_TOL = 1e-4
TIME_LIMIT_S = 1150


@contextlib.contextmanager
def flags(**values):
    """The port's kernel flags set to ``values`` (every other one unset)
    inside the block, and restored after it."""
    from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS

    saved = {k: os.environ.pop(k, None) for k in KERNEL_FLAGS}
    os.environ.update(values)
    try:
        yield
    finally:
        for k in KERNEL_FLAGS:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


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


def _rand(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def _width(dtype):
    """(bytes an element, peak rate of the unit the kernel multiplies on)."""
    return (4, PEAK_TF32_FLOPS) if dtype == torch.float32 else (2,
                                                                PEAK_BF16_FLOPS)


def _compare(out, ref):
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return float("inf"), float("inf")
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-12)


def _case(shape, timed, kernel, plain, library, nbytes, flops, peak_flops,
          iters=10, stats_from=None, **extra):
    """One kernel call against its plain version on the same inputs and,
    if ``timed``, the times of the kernel, the plain version and the library
    yardstick beside the bound: bytes moved once over the memory rate against
    operations over the peak rate of their type, the larger. A kernel with
    several outputs returns a tuple: each output is held against its own
    maximum and the worst is reported. With ``stats_from`` the kernel's
    outputs after the first are statistics of its first output, and are held
    (under the tolerance of statistics, as "stats_rel_err") against
    ``stats_from(first output)`` instead of the plain version's."""
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    extra = dict(extra)
    if stats_from is not None:
        stat_errs = [_compare(o, r)
                     for o, r in zip(out[1:], stats_from(out[0]))]
        extra.update(stats_rel_err=max(r for _, r in stat_errs),
                     tol_stats=STATS_REL_TOL)
        out, ref = out[:1], ref[:1]
    errs = [_compare(o, r) for o, r in zip(out, ref)]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    case = {"shape": list(shape), **extra, "max_abs_err": err, "rel_err": rel}
    if timed:
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
        case.update(ms=time_ms(kernel, iters), plain_ms=time_ms(plain, 3, 1),
                    library_ms=time_ms(library, max(iters // 2, 3)),
                    bound_ms=1e3 * max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes > t_ops else "operations")
    return case


def _flash_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v = (_rand(gen, b, h, n, d, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    esize, peak = _width(dtype)
    return _case(
        (b, h, nq, nk, d), timed,
        lambda: A.flash_attention(q, k, v, scale=scale),
        lambda: A.attention_reference(q, k, v, scale=scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        esize * b * h * (2 * nq + 2 * nk) * d, 4 * b * h * nq * nk * d,
        peak, dtype=str(dtype).split(".")[1])


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

    def library():
        sp = lambda t: t.view(b, n, heads, d).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            sp(F.linear(h, wq)), sp(F.linear(h, wk)), sp(F.linear(h, wv)),
            scale=scale)
        return F.linear(o.transpose(1, 2).reshape(b, n, hd), wo, bo)

    return _case(
        (b, n, c, heads), timed,
        lambda: A.flash_attention_fproj(*args, scale=scale),
        lambda: A.fproj_reference(*args, scale=scale), library,
        2 * (2 * b * n * c + 4 * c * hd + c),
        2 * b * n * c * hd * 4 + 4 * b * n * n * hd, PEAK_BF16_FLOPS, iters=20)


def _packed_case(gen, b, nq, nk, heads, d, timed):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = heads * d
    q, k, v = (_rand(gen, b, n, hd) for n in (nq, nk, nk))
    scale = d ** -0.5
    sp = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
    return _case(
        (b, nq, nk, heads, d), timed,
        lambda: A.flash_attention_packed(q, k, v, heads, scale=scale),
        lambda: A.packed_reference(q, k, v, heads, scale=scale),
        lambda: F.scaled_dot_product_attention(sp(q), sp(k), sp(v),
                                               scale=scale),
        2 * b * (2 * nq + 2 * nk) * hd, 4 * b * nq * nk * hd, PEAK_BF16_FLOPS)


def _bwd_case(shape, timed, q, k, v, do, forward, backward, through_autograd,
              plain, sdpa_inputs, scale, lse_bytes=4):
    esize, peak = _width(q.dtype)
    """An attention backward kernel on the forward kernel's own output and
    row log-sum-exp (``forward`` returns both; the streaming pair has no
    saved log-sum-exp, ``lse_bytes=0``): (dq, dk, dv) against the plain
    backward formula ``plain(out)``, each
    within REL_TOL of its own maximum; a second launch and the same gradient
    asked for through autograd (the ``Function`` the model uses) must both
    give the same bits. The yardstick is the backward of
    ``scaled_dot_product_attention`` through autograd."""
    import torch.nn.functional as F

    b_h, nq, nk, d = shape[-4:]
    out, lse = forward()
    sq, sk, sv, sdo = (t.detach().requires_grad_(t is not sdpa_inputs[3])
                       for t in sdpa_inputs)
    so = F.scaled_dot_product_attention(sq, sk, sv, scale=scale)
    case = _case(
        shape, timed, lambda: backward(out, lse), lambda: plain(out),
        lambda: torch.autograd.grad(so, (sq, sk, sv), sdo, retain_graph=True),
        esize * b_h * (4 * nq + 4 * nk) * d + lse_bytes * b_h * nq,
        10 * b_h * nq * nk * d, peak, dtype=str(q.dtype).split(".")[1])
    first, again = backward(out, lse), backward(out, lse)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(through_autograd(*leaves), leaves, do)
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(first, again, auto))
    if not same:
        case["rel_err"] = float("inf")
    case["repeatable_and_equal_through_autograd"] = same
    return case


def _flash_bwd_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16):
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v, do = (_rand(gen, b, h, n, d, dtype=dtype)
                   for n in (nq, nk, nk, nq))
    scale = d ** -0.5
    return _bwd_case(
        (b, h, nq, nk, d)[:1] + (b * h, nq, nk, d), timed, q, k, v, do,
        lambda: A._launch_flash_forward(q, k, v, scale, True),
        lambda o, lse: A.flash_attention_bwd(q, k, v, o, lse, do, scale),
        lambda q_, k_, v_: A.flash_attention(q_, k_, v_, scale=scale),
        lambda _: A.flash_attention_bwd_reference(q, k, v, do, scale=scale),
        (q, k, v, do), scale)


def _streaming_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v = (_rand(gen, b, h, n, d, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    esize, peak = _width(dtype)
    return _case(
        (b, h, nq, nk, d), timed,
        lambda: A.flash_attention_streaming(q, k, v, scale=scale),
        lambda: A.streaming_attention_reference(q, k, v, scale=scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        esize * b * h * (2 * nq + 2 * nk) * d, 4 * b * h * nq * nk * d,
        peak, kv_splits=A.streaming_splits(b * h, nq, nk),
        dtype=str(dtype).split(".")[1])


def _streaming_bwd_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16):
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v, do = (_rand(gen, b, h, n, d, dtype=dtype)
                   for n in (nq, nk, nk, nq))
    scale = d ** -0.5
    return _bwd_case(
        (b, b * h, nq, nk, d), timed, q, k, v, do,
        lambda: (A._launch_streaming_forward(q, k, v, scale), None),
        lambda o, _: A.flash_attention_streaming_bwd(q, k, v, o, do, scale),
        lambda q_, k_, v_: A.flash_attention_streaming(q_, k_, v_, scale=scale),
        lambda o: A.streaming_bwd_reference(q, k, v, o, do, scale=scale),
        (q, k, v, do), scale, lse_bytes=0)


def _packed_bwd_case(gen, b, nq, nk, heads, d, timed):
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = heads * d
    q, k, v, do = (_rand(gen, b, n, hd) for n in (nq, nk, nk, nq))
    scale = d ** -0.5
    sp = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
    return _bwd_case(
        (b, b * heads, nq, nk, d), timed, q, k, v, do,
        lambda: A._launch_packed_forward(q, k, v, heads, scale, True),
        lambda o, lse: A.flash_attention_bwd_packed(q, k, v, o, lse, do, heads,
                                                    scale),
        lambda q_, k_, v_: A.flash_attention_packed(q_, k_, v_, heads,
                                                    scale=scale),
        lambda _: A.packed_bwd_reference(q, k, v, do, heads, scale=scale),
        (sp(q), sp(k), sp(v), sp(do)), scale)


def _qout_case(gen, b, n, nk, c, heads, timed):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = c  # the UNet's self-attention keeps heads * head_dim == channels
    d = hd // heads
    h = _rand(gen, b, n, c)
    k, v = _rand(gen, b, nk, hd), _rand(gen, b, nk, hd)
    wq = _rand(gen, hd, c, scale=c ** -0.5)
    wo = _rand(gen, c, hd, scale=hd ** -0.5)
    bo = _rand(gen, c, scale=0.1)
    scale = d ** -0.5
    args = (h, k, v, wq, wo, bo, heads)

    def library():
        sp = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
        o = F.scaled_dot_product_attention(sp(F.linear(h, wq)), sp(k), sp(v),
                                           scale=scale)
        return F.linear(o.transpose(1, 2).reshape(b, n, hd), wo, bo)

    return _case(
        (b, n, nk, c, heads), timed,
        lambda: A.flash_attention_qout(*args, scale=scale),
        lambda: A.qout_reference(*args, scale=scale), library,
        2 * (2 * b * n * c + 2 * b * nk * hd + 2 * c * hd + c),
        2 * b * n * c * hd * 2 + 4 * b * n * nk * hd, PEAK_BF16_FLOPS)


def _gn_input(gen, b, n, c, mean=0.5, std=2.0):
    x = torch.randn(b, n, c, generator=gen, device="cuda") * std + mean
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x.to(torch.bfloat16), gamma, beta


def _gn_case(gen, b, n, c, eps, silu, timed, mean=0.5, std=2.0,
             bf16_params=False):
    """Whole-row GroupNorm(+SiLU). A large-mean row (|mean| >> std) is held
    to finiteness only: there E[x^2] - E[x]^2 cancels in fp32 and the two
    summation orders legitimately disagree."""
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    x, gamma, beta = _gn_input(gen, b, n, c, mean, std)
    g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    if bf16_params:
        gamma, beta = g16, b16
    kw = dict(num_groups=32, eps=eps, silu=silu)

    def library():
        y = F.group_norm(x.transpose(1, 2), 32, g16, b16, eps)
        return F.silu(y) if silu else y

    case = _case(
        (b, n, c), timed, lambda: G.group_norm_silu_kernel(x, gamma, beta, **kw),
        lambda: G.group_norm_silu_reference(x, gamma, beta, **kw), library,
        2 * 2 * b * n * c + 2 * 4 * c, 10 * b * n * c, PEAK_FP32_FLOPS,
        eps=eps, silu=silu)
    if abs(mean) > 10 * std and case["rel_err"] != float("inf"):
        case["large_mean_rel_err"], case["rel_err"] = case["rel_err"], 0.0
    return case


def _stats_case(gen, b, n, c, timed):
    """Channel statistics: sum and sum of squares differ in size, so each is
    held against its own maximum; a second call must give the same bits."""
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    x, _, _ = _gn_input(gen, b, n, c)
    f32 = torch.float32
    case = _case(
        (b, n, c), timed, lambda: torch.stack(G.gn_channel_stats(x)),
        lambda: torch.stack(G.gn_channel_stats_reference(x)),
        lambda: (x.sum(1, dtype=f32), x.square().sum(1, dtype=f32)),
        2 * b * n * c + 2 * 4 * b * c, 3 * b * n * c, PEAK_FP32_FLOPS,
        tol=STATS_REL_TOL)
    out, again = (torch.stack(G.gn_channel_stats(x)) for _ in range(2))
    ref = torch.stack(G.gn_channel_stats_reference(x))
    case["rel_err"] = (max(_compare(o, r)[1] for o, r in zip(out, ref))
                       if torch.equal(out, again) else float("inf"))
    return case


def _conv_case(gen, b, hh, ww, cin, cout, ksize, prologue, skip, timed,
               eps=1e-5, silu_in=True):
    """conv_stats: y against the plain version's; the statistics against the
    sums of the kernel's own stored y (a y that rounds the other way at a bf16
    tie moves a sum by more than the sums' tolerance, and is no fault), with
    the same bits from a second call. The yardstick: ``F.group_norm`` +
    ``F.silu`` (prologue cases), ``F.conv2d``, + bias (+ skip), two sums."""
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import conv_gn as C
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    f32 = torch.float32
    x = _rand(gen, b, hh, ww, cin, scale=2.0) + 0.5
    w = _rand(gen, ksize, ksize, cin, cout, scale=(ksize * ksize * cin) ** -0.5)
    bias = 0.5 * torch.randn(b, cout, generator=gen, device="cuda")
    res = _rand(gen, b, hh, ww, cout) if skip else None
    kw = {}
    if prologue:
        gamma = 1 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(cin, generator=gen, device="cuda")
        kw = dict(in_stats=G.gn_channel_stats_reference(x.reshape(b, -1, cin)),
                  gamma=gamma, beta=beta, num_groups=32, eps=eps,
                  silu_in=silu_in)
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bias16 = bias.to(torch.bfloat16)[:, :, None, None]
    res_nchw = None if res is None else res.permute(0, 3, 1, 2)

    def library():
        h = x_nchw
        if prologue:
            h = F.group_norm(h, 32, g16, b16, eps)
            h = F.silu(h) if silu_in else h
        y = F.conv2d(h, w_oihw, padding=(ksize - 1) // 2) + bias16
        if res_nchw is not None:
            y = y + res_nchw
        return y, y.sum((2, 3), dtype=f32), y.square().sum((2, 3), dtype=f32)

    run = lambda: C.conv_stats(x, w, bias, skip=res, **kw)
    stats_of = lambda y: G.gn_channel_stats_reference(y.reshape(b, -1, cout))
    case = _case(
        (b, hh, ww, cin, cout), timed, run,
        lambda: C.conv_stats_reference(x, w, bias, skip=res, **kw), library,
        2 * (x.numel() + w.numel() + b * hh * ww * cout * (2 if skip else 1))
        + 4 * b * cout * 3 + (4 * (2 * b * cin + 2 * cin) if prologue else 0),
        2 * b * hh * ww * ksize * ksize * cin * cout, PEAK_BF16_FLOPS,
        stats_from=stats_of, ksize=ksize, prologue=prologue, skip=skip)
    first, again = run(), run()
    if not all(torch.equal(a, c) for a, c in zip(first, again)):
        case["rel_err"] = float("inf")
    return case


def phase_kernels():
    """Each kernel against its plain version, at the serving path's shapes
    (batch 8, and 16 after the guidance pair is tiled; F = 2 frames a clip)
    plus ragged and other-head-width cases. The first timed case of a kernel
    is the one its entry in the "kernels" line reports."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32   # the fp32 instantiations: first-stage training
    flash = [
        _flash_case(gen, 8, 1, 4096, 4096, 512, True),    # decode, identity
        _flash_case(gen, 16, 1, 4096, 4096, 512, True),   # B*F masked frames
        _flash_case(gen, 2, 1, 1000, 1000, 512, False),   # ragged N
        _flash_case(gen, 2, 5, 333, 77, 32, False),       # composed branch
        _flash_case(gen, 2, 3, 200, 200, 64, False),
        _flash_case(gen, 16, 1, 1024, 1024, 512, True, f32),   # vqgan-f4
        _flash_case(gen, 8, 1, 4096, 4096, 512, True, f32),    # 256 px
        _flash_case(gen, 2, 1, 1000, 1000, 512, False, f32),   # ragged N
        _flash_case(gen, 1, 2, 333, 77, 512, False, f32),      # Nk != Nq
    ]
    fproj = [
        _fproj_case(gen, 16, 1024, 320, 10, True),   # 2B after the pair tiles
        _fproj_case(gen, 8, 1024, 320, 10, True),    # B: first transformer
        _fproj_case(gen, 16, 256, 640, 20, True),
        _fproj_case(gen, 3, 200, 320, 10, False),    # ragged N
        _fproj_case(gen, 2, 100, 128, 2, False),     # 64-wide heads
        _fproj_case(gen, 2, 300, 160, 5, False),     # H*D not a multiple of 64
    ]
    packed = [
        _packed_case(gen, 16, 4096, 4096, 5, 32, True),   # -fullattn, 64x64
        _packed_case(gen, 8, 4096, 4096, 5, 32, True),    # its first block
        _packed_case(gen, 2, 1000, 1000, 5, 32, False),   # ragged N
        _packed_case(gen, 2, 333, 77, 10, 32, False),     # cross: Nk != Nq
        _packed_case(gen, 2, 200, 200, 3, 64, False),     # 64-wide heads
    ]
    qout = [
        _qout_case(gen, 16, 4096, 4096, 160, 5, True),
        _qout_case(gen, 8, 4096, 4096, 160, 5, True),
        _qout_case(gen, 3, 200, 200, 320, 10, False),     # ragged N
        _qout_case(gen, 2, 300, 77, 160, 5, False),       # Nk != N
        _qout_case(gen, 2, 100, 100, 128, 2, False),      # 64-wide heads
        _qout_case(gen, 2, 256, 256, 640, 20, False),     # widest tiles
    ]
    gn = [
        _gn_case(gen, 16, 4096, 160, 1e-5, True, True),   # UNet, 64x64
        _gn_case(gen, 16, 4096, 480, 1e-5, True, True),   # ... after a concat
        _gn_case(gen, 16, 1024, 640, 1e-5, True, True),
        _gn_case(gen, 16, 256, 1280, 1e-5, True, True),
        _gn_case(gen, 8, 65536, 128, 1e-6, True, True),   # first stage, 256 px
        _gn_case(gen, 16, 4096, 160, 1e-6, False, True),  # transformer's norm
        _gn_case(gen, 8, 4096, 512, 1e-6, False, False),  # first-stage attn
        _gn_case(gen, 16, 1024, 320, 1e-5, True, False, bf16_params=True),
        _gn_case(gen, 3, 1000, 160, 1e-5, False, False),  # ragged N, C/G = 5
        _gn_case(gen, 2, 77, 2080, 1e-5, True, False),    # two column slabs
        _gn_case(gen, 2, 4096, 64, 1e-5, True, False, mean=100.0, std=0.5),
    ]
    stats = [
        _stats_case(gen, 16, 4096, 160, True),
        _stats_case(gen, 16, 1024, 640, True),
        _stats_case(gen, 16, 256, 1280, True),
        _stats_case(gen, 8, 65536, 128, True),
        _stats_case(gen, 3, 1000, 160, False),
        _stats_case(gen, 2, 77, 2080, False),
    ]
    # shapes as [B, B*H, Nq, Nk, D]; training at batch 8
    # the first timed case of rows 5 and 7 is first-stage training's (their
    # kernels line's run); the bf16 cases are the UNet's
    flash_bwd = [
        _flash_bwd_case(gen, 16, 1, 1024, 1024, 512, True, f32),   # vqgan-f4
        _flash_bwd_case(gen, 8, 1, 4096, 4096, 512, True, f32),    # 256 px
        _flash_bwd_case(gen, 2, 1, 1000, 1000, 512, False, f32),   # ragged
        _flash_bwd_case(gen, 1, 2, 333, 77, 512, False, f32),      # Nk != Nq
        _flash_bwd_case(gen, 8, 10, 1024, 1024, 32, True),   # DSML_ATTN_PACKED=0
        _flash_bwd_case(gen, 8, 20, 256, 256, 32, True),
        _flash_bwd_case(gen, 2, 5, 333, 77, 32, False),      # ragged, Nk != Nq
        _flash_bwd_case(gen, 2, 3, 200, 200, 64, False),     # 64-wide heads
    ]
    packed_bwd = [
        _packed_bwd_case(gen, 8, 1024, 1024, 10, 32, True),  # training step
        _packed_bwd_case(gen, 8, 256, 256, 20, 32, True),
        _packed_bwd_case(gen, 8, 4096, 4096, 5, 32, True),   # -fullattn
        _packed_bwd_case(gen, 2, 1000, 1000, 5, 32, False),  # ragged N
        _packed_bwd_case(gen, 2, 333, 77, 10, 32, False),    # Nk != Nq
        _packed_bwd_case(gen, 2, 200, 200, 3, 64, False),    # 64-wide heads
    ]
    streaming = [
        _streaming_case(gen, 8, 1, 4096, 4096, 512, True),   # first stage
        _streaming_case(gen, 16, 1, 4096, 4096, 512, True),
        _streaming_case(gen, 8, 10, 1024, 1024, 32, True),   # UNet, training
        _streaming_case(gen, 1, 1, 16384, 16384, 512, True),  # streams by auto
        _streaming_case(gen, 2, 3, 333, 77, 64, False),      # ragged both ways
        _streaming_case(gen, 1, 2, 100, 5000, 64, False),    # K/V cut 40 ways
        _streaming_case(gen, 1, 1, 64, 2000, 512, False),    # 32 ways, D = 512
        _streaming_case(gen, 16, 1, 1024, 1024, 512, True, f32),   # vqgan-f4
        _streaming_case(gen, 2, 1, 1000, 1000, 512, False, f32),   # ragged N
        _streaming_case(gen, 1, 1, 64, 2000, 512, False, f32),     # 32 ways
    ]
    streaming_bwd = [
        _streaming_bwd_case(gen, 16, 1, 1024, 1024, 512, True, f32),  # vqgan
        _streaming_bwd_case(gen, 2, 1, 1000, 1000, 512, False, f32),  # ragged
        _streaming_bwd_case(gen, 1, 2, 333, 77, 512, False, f32),     # Nk != Nq
        _streaming_bwd_case(gen, 8, 10, 1024, 1024, 32, True),
        _streaming_bwd_case(gen, 8, 20, 256, 256, 32, True),
        _streaming_bwd_case(gen, 2, 3, 333, 77, 64, False),  # ragged, D = 64
        _streaming_bwd_case(gen, 2, 5, 200, 200, 32, False),
    ]
    conv = [   # b, H, W, Cin, Cout, K, input norm, skip
        _conv_case(gen, 16, 64, 64, 160, 160, 3, True, True, True),
        _conv_case(gen, 16, 64, 64, 160, 160, 3, False, False, True),
        _conv_case(gen, 16, 32, 32, 960, 320, 3, True, False, True),
        _conv_case(gen, 16, 16, 16, 1280, 640, 3, True, False, True),
        _conv_case(gen, 8, 256, 256, 128, 128, 3, True, True, True, eps=1e-6),
        _conv_case(gen, 16, 64, 64, 160, 160, 1, False, True, True),
        _conv_case(gen, 16, 32, 32, 960, 320, 3, False, True, False),
        _conv_case(gen, 16, 16, 16, 1280, 640, 3, False, True, False),
        _conv_case(gen, 2, 13, 9, 64, 96, 3, True, True, False),   # odd H != W
        _conv_case(gen, 2, 13, 9, 64, 40, 1, True, False, False, eps=1e-6,
                   silu_in=False),
        _conv_case(gen, 2, 20, 20, 9, 160, 3, False, False, False),  # stem Cin
    ]
    cases = {"flash_attention": flash, "flash_attention_fproj": fproj,
             "flash_attention_packed": packed, "flash_attention_qout": qout,
             "flash_attention_bwd": flash_bwd,
             "flash_attention_bwd_packed": packed_bwd,
             "flash_attention_streaming": streaming,
             "flash_attention_streaming_bwd": streaming_bwd,
             "group_norm_silu": gn, "gn_channel_stats": stats,
             "conv_stats": conv}
    bad = [(name, c["shape"], c["rel_err"], c.get("tol", REL_TOL))
           for name, cs in cases.items() for c in cs
           if not c["rel_err"] <= c.get("tol", REL_TOL)
           or not c.get("stats_rel_err", 0.0) <= STATS_REL_TOL]
    emit({"phase": "kernels", "rel_tol": REL_TOL,
          "stats_rel_tol": STATS_REL_TOL,
          "dtype": "bfloat16 unless a case says float32",
          "worst_rel_err": {name: max(c["rel_err"] for c in cs)
                            for name, cs in cases.items()},
          "cases": cases})
    if bad:
        fail(f"a kernel disagrees with its plain version (kernel, shape, "
             f"rel err, tolerance): {bad}")
    return cases


def build_ldm(config, seed=0):
    """A model config at full width and depth on the card, weights from
    PyTorch's default inits under a seed, cast for sampling."""
    from dsml_thesis_tpu_torch.config import build_model, load_config
    from dsml_thesis_tpu_torch.utils_io import cast_sampling_params

    cfg = load_config([config])
    torch.manual_seed(seed)
    ldm = build_model(cfg["model"])
    # The codebook's own init, U(-1/K, 1/K), is where training starts: every
    # code sits at the origin, so any latent decodes to the same image. A
    # trained codebook spans the latents' range; unit normal stands in for it.
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    return cfg, cast_sampling_params(ldm).to("cuda").eval()


def count_norms(module):
    """GroupNorms of a module; a forward runs each once."""
    from dsml_thesis_tpu_torch.models.unet import GroupNormSiLU

    return sum(isinstance(m, GroupNormSiLU) for m in module.modules())


def count_attentions(unet):
    """(self-attentions the fused-projection op takes, longer ones) of a UNet
    call at 64 x 64 latents: the code's own routing rule on its own blocks."""
    from dsml_thesis_tpu_torch.models.unet import SpatialTransformer
    from dsml_thesis_tpu_torch.ops.attention import fproj_one_q_block

    short = long = 0
    ds = {unet.model_channels * m: 2 ** i
          for i, m in enumerate(unet.channel_mult)}
    for m in unet.modules():
        if isinstance(m, SpatialTransformer):
            n = (64 // ds[m.proj_in.in_channels]) ** 2
            if fproj_one_q_block(n):
                short += m.depth
            else:
                long += m.depth
    return short, long


def count_fused_convs(net, mode):
    """Launches of the conv + statistics kernel in one forward of a UNet, an
    Encoder or a Decoder under ``DSML_GN_EPILOGUE=mode``, from its own
    blocks: both 3x3 convs of every ResBlock / ResnetBlock; under ``1`` also
    the stem conv, the 1x1 projection into every attention block (it follows
    a block that leaves statistics) and the one out of it, unless a resampler
    follows (then no norm reads the statistics and the projection stays
    plain). A conv with fewer than 32 output channels (the final convs) is
    not launched."""
    from dsml_thesis_tpu_torch.models.autoencoder import (AttnBlock, Decoder,
                                                          ResnetBlock)
    from dsml_thesis_tpu_torch.models.unet import ResBlock, SpatialTransformer
    from dsml_thesis_tpu_torch.ops.conv_gn import CONV_MIN_COUT

    if mode == "0":
        return 0
    mods = list(net.modules())
    n = 2 * sum(isinstance(m, (ResBlock, ResnetBlock)) for m in mods)
    if mode == "res":
        return n
    n += net.conv_in.out_channels >= CONV_MIN_COUT
    n += net.conv_out.out_channels >= CONV_MIN_COUT
    n += 2 * sum(isinstance(m, (SpatialTransformer, AttnBlock)) for m in mods)
    if hasattr(net, "attn_levels"):   # first stage: a level's last attention
        resampled = 0 if isinstance(net, Decoder) else len(net.ch_mult) - 1
        n -= sum(on and level != resampled
                 for level, on in enumerate(net.attn_levels))
    return n


def expected_launches(ldm, env, unet_calls, encodes, decodes):
    """Launches of every kernel for a number of UNet calls, first-stage
    encodes and decodes under a flag set, from the model's own blocks."""
    short, long = count_attentions(ldm.unet)
    fs = ldm.first_stage
    gn_mode = env.get("DSML_PALLAS_GN", "0")
    epilogue = env.get("DSML_GN_EPILOGUE", "0")
    partial = env.get("DSML_ATTN_FPROJ_PARTIAL", "0") == "1"
    streaming = env.get("DSML_FLASH_STREAMING", "auto") == "1"
    parts = ((unet_calls, ldm.unet), (encodes, fs.encoder),
             (decodes, fs.decoder))
    norms = sum(n * count_norms(net) for n, net in parts)
    # first stage: 3 attention blocks an encode, 4 a decode
    first_stage = 3 * encodes + 4 * decodes
    return {
        "flash_attention": 0 if streaming else first_stage,
        "flash_attention_streaming": first_stage if streaming else 0,
        "flash_attention_fproj": unet_calls * short,
        "flash_attention_packed": 0 if partial else unet_calls * long,
        "flash_attention_qout": unet_calls * long if partial else 0,
        "flash_attention_bwd": 0, "flash_attention_bwd_packed": 0,
        "flash_attention_streaming_bwd": 0,
        "group_norm_silu": norms if gn_mode == "1" else 0,
        "gn_channel_stats": norms if gn_mode == "stats" else 0,
        "conv_stats": sum(n * count_fused_convs(net, epilogue)
                          for n, net in parts),
    }


@contextlib.contextmanager
def plain_path(env):
    """Every kernel's plain version put in its place in the models (for a
    comparison on the card only): the attention ops by name, the conv op by
    name, GroupNorm by leaving its flag unset. The flags that route stay."""
    from unittest import mock

    from dsml_thesis_tpu_torch.models import autoencoder, unet
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.ops import conv_gn as C

    def plain_qout(h, k, v, wq, wo, bo, heads, scale=None):
        wq, wo, bo = (w.to(h.dtype) for w in (wq, wo, bo))
        return A.qout_reference(h, k, v, wq, wo, bo, heads, scale=scale)

    split_head = (A.streaming_attention_reference
                  if env.get("DSML_FLASH_STREAMING") == "1"
                  else A.attention_reference)
    with flags(**{k: v for k, v in env.items() if k != "DSML_PALLAS_GN"}), \
            mock.patch.object(unet, "flash_attention_fproj", A.fproj_reference), \
            mock.patch.object(unet, "packed_multi_head_attention",
                              A.packed_reference), \
            mock.patch.object(unet, "fused_qout_self_attention", plain_qout), \
            mock.patch.object(unet, "multi_head_attention", split_head), \
            mock.patch.object(autoencoder, "multi_head_attention", split_head), \
            mock.patch.object(unet, "conv_stats", C.conv_stats_reference):
        yield


def phase_model(name, ldm, env):
    """The two models that hold the kernels, each run once on the card
    through its kernels under a flag set and once with every kernel's plain
    version put in its place (patched in here, for this comparison only; the
    GroupNorm flag unset selects its plain ops), on the same inputs: one
    guidance-pair UNet call at batch 8 and one first-stage decode. A whole
    bf16 model compounds the kernels' rounding differences through its
    layers: tolerance 5e-2 of the output's maximum."""
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

    with flags(**env):
        A.reset_launches()
        eps_k, img_k = run()
        launched = dict(A.LAUNCHES)
    with plain_path(env):
        A.reset_launches()
        eps_p, img_p = run()
        launched_plain = dict(A.LAUNCHES)
    expect = expected_launches(ldm, env, unet_calls=1, encodes=0, decodes=1)
    out = {"phase": "model", "config": name, "flags": env, "rel_tol": 5e-2,
           "launches": launched, "launches_expected": expect}
    for part, k, p in (("unet", eps_k, eps_p), ("decode", img_k, img_p)):
        err, rel = _compare(k, p)
        out[part] = {"shape": list(k.shape), "max_abs_err": err,
                     "rel_err": rel}
    emit(out)
    ok = (launched == expect and not any(launched_plain.values())
          and all(out[n]["rel_err"] <= 5e-2 for n in ("unet", "decode")))
    if not ok:
        fail(f"model: kernel path and plain path disagree: {out}")


def phase_serve(name, cfg, ldm, env, n_requests, frames, smi, seed=0):
    """One serve run: ``n_requests`` single-clip requests through a
    MicroBatcher of batch 8 under a flag set. Returns the launch counts of
    the served requests alone."""
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.server import MicroBatcher, make_pipeline_runner

    batch, steps, guidance, size, window = 8, 50, 2.0, 256, 8
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

    results = [None] * n_requests
    errors = []
    with flags(**env):
        A.reset_launches()   # counts below are of the served requests alone
        batcher = MicroBatcher(run_batch, batch, max_wait_ms=5000.0)

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
            fail(f"serve {name}: requests failed: {errors[:3]}")
        again = runner(log[0][1], log[0][0]) if log else None

    n_batches = n_requests // batch
    # a batch: one encode of the B*F masked frames and one of the B identity
    # frames, one UNet call a DDIM step and frame (the guidance pair is
    # deduplicated inside the call), one decode a frame
    expect = expected_launches(ldm, env, unet_calls=n_batches * frames * steps,
                               encodes=2 * n_batches,
                               decodes=n_batches * frames)
    checks = {
        "batches": len(log) == n_batches,
        "shape": all(r is not None and r.shape == (frames, size, size, 3)
                     for r in results),
        "finite": all(bool(np.isfinite(r).all()) for r in results),
        "range": all(float(np.abs(r).max()) <= 1.0 for r in results),
        "varied": all(float(r.std()) > 1e-3 for r in results),
        "launches": launches == expect,
        "reproducible": again is not None
        and bool(np.array_equal(again, log[0][2])),
    }
    if len(log) > 1:
        checks["batches_differ"] = not np.array_equal(log[0][2], log[1][2])
    secs = [round(s, 3) for *_, s in log]
    emit({"phase": "serve", "run": name,
          "config": os.path.relpath(cfg["path"], HERE), "flags": env,
          "card": smi, "batch": batch, "frames": frames, "ddim_steps": steps,
          "guidance": guidance, "requests": n_requests, "checks": checks,
          "launches": launches, "launches_expected": expect,
          "seconds_per_batch": secs, "wall_seconds": round(wall, 3),
          "frames_per_s": round(n_requests * frames / wall, 4),
          "stats": batcher.stats()})
    if not all(checks.values()):
        fail(f"serve {name}: checks failed: {checks}")
    return launches


SYNTHETIC_SPEC = {
    "image": [[256, 256, 3], "float32"],
    "masked_image": [[256, 256, 3], "float32"],
    "identity": [[256, 256, 3], "float32"],
    "class_label": [[], "int32"],
    "audio": [[17, 768], "float32"],
}
# parameters whose gradients the kernel path and the plain path are held to
GRAD_PROBES = (
    "unet.conv_in.weight",
    "unet.down_1_0_attn.block_0.attn1.to_q.weight",
    "unet.down_1_0_attn.block_0.attn1.to_out.weight",
    "unet.down_0_0_res.in_norm.weight",
    "cond.class_label.embedding.weight",
    "unet.down_0_1_res.in_norm.weight",   # folded into in_conv by the epilogue
    "unet.down_0_1_res.out_conv.weight",
)


def expected_train_launches(ldm, env, steps, eval_batches):
    """Launches of every kernel for ``steps`` training steps and
    ``eval_batches`` validation batches (two loss evaluations each, raw and
    EMA weights, in eval-mode routing), from the model's own blocks. A step:
    three frozen first-stage encodes (image and the two concat streams), and
    every UNet self-attention once forward and once backward through the
    packed kernels (or the split-head ones under DSML_ATTN_PACKED=0). The
    GroupNorm kernel runs forward only: its backward differentiates the
    plain version, as in the JAX package."""
    short, long = count_attentions(ldm.unet)
    packed = env.get("DSML_ATTN_PACKED", "1") == "1"
    streaming = env.get("DSML_FLASH_STREAMING", "auto") == "1"
    # the split-head kernels: forward (first stage, and the UNet when its
    # attention is not packed) and backward (the UNet alone: the first stage
    # is frozen)
    fwd, bwd = (("flash_attention_streaming", "flash_attention_streaming_bwd")
                if streaming else ("flash_attention", "flash_attention_bwd"))
    step = expected_launches(ldm, env, unet_calls=1, encodes=3, decodes=0)
    step.update({
        "flash_attention_fproj": 0, "flash_attention_qout": 0,   # eval only
        fwd: 9 + (0 if packed else short + long),
        "flash_attention_packed": short + long if packed else 0,
        "flash_attention_bwd_packed": short + long if packed else 0,
        bwd: 0 if packed else short + long,
    })
    evals = expected_launches(ldm, env, unet_calls=1, encodes=3, decodes=0)
    if not packed:   # no fused branch: every self-attention splits its heads
        evals.update({fwd: 9 + short + long, "flash_attention_fproj": 0,
                      "flash_attention_packed": 0})
    return {k: steps * step[k] + 2 * eval_batches * evals[k] for k in step}, step


def _train_losses(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r["train/loss"] for r in recs if r["split"] == "train"],
            [r for r in recs if r["split"] == "val"])


def _kernel_vs_plain(run, env):
    """``run()`` -> (loss, {name: gradient}) once through the kernels and
    once through the plain versions (patched in here, for this comparison
    only; the GroupNorm flag unset selects its plain ops): both within 5e-2,
    and no kernel launched on the plain path."""
    from dsml_thesis_tpu_torch.ops import attention as A

    with flags(**env):
        A.reset_launches()
        loss_k, grads_k = run()
        launched = dict(A.LAUNCHES)
    with plain_path(env):
        A.reset_launches()
        loss_p, grads_p = run()
        launched_plain = dict(A.LAUNCHES)
    rel = {n: _compare(grads_k[n], grads_p[n])[1] for n in grads_k}
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    ok = (loss_rel <= 5e-2 and all(r <= 5e-2 for r in rel.values())
          and not any(launched_plain.values()))
    return ok, {"loss_kernels": loss_k, "loss_plain": loss_p,
                "loss_rel_err": loss_rel, "grad_rel_err": rel, "rel_tol": 5e-2,
                "launches_one_step": {k: v for k, v in launched.items() if v}}


def _grad_check(trainer, env):
    """Loss and the probe gradients of one batch, kernels against plain
    versions, same draws."""
    ldm = trainer.ldm
    batch = trainer._to_device(next(iter(trainer.train_data)))
    probes = dict(ldm.named_parameters())
    gen = torch.Generator(device="cuda")

    def run():
        gen.manual_seed(7)
        ldm.zero_grad(set_to_none=True)
        loss, _ = ldm.training_loss(batch, gen)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: probes[n].grad.detach().float().clone()
                 for n in GRAD_PROBES}
        ldm.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    return _kernel_vs_plain(run, env)


def _train_torch():
    """scripts/train_torch.py as a module (its main() is the entry point the
    train runs drive)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(HERE, "scripts", "train_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_train(name, config, env, steps, smi, tmp, resume=False):
    """One train run through scripts/train_torch.py's main(). Returns the
    launch counts of the run (steps + one validation batch)."""
    from dsml_thesis_tpu_torch.ops import attention as A

    train_torch = _train_torch()
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"spec": SYNTHETIC_SPEC, "length": 64}}
    val = {"target": node["target"],
           "params": {"spec": SYNTHETIC_SPEC, "length": 8, "seed": 1000}}
    # key=value overrides replace the YAML's MEAD dataset nodes whole (JSON is
    # YAML's flow form); batch_size 8 is the YAML's own
    data = [f"data.params.train={json.dumps(node)}",
            f"data.params.validation={json.dumps(val)}"]

    def run(tag, n_steps):
        argv = ["--base", config, "-t", "--max-steps", str(n_steps),
                "--logdir", os.path.join(tmp, tag), "--name", name,
                "--seed", "0", "--no-test", "--log-every", "1", *data]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer = train_torch.main(argv)
        torch.cuda.synchronize()
        return trainer, time.monotonic() - t0

    with flags(**env):
        A.reset_launches()   # counts below are of this run alone
        trainer, wall = run(f"{name}-a", steps)
        launches = dict(A.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        state = trainer._state
        losses, vals = _train_losses(trainer.logdir)
        moved = sum(not torch.equal(p, e)
                    for p, e in zip(state.params, state.ema_params))
        # warm steps, timed on the trained model: CUDA events around whole steps
        batch = trainer._to_device(next(iter(trainer.train_data)))
        step_ms = time_ms(lambda: trainer._train_step(state, batch, 0), 4, 1)
        ckpt = os.path.join(trainer.logdir, "checkpoints", "last", "state.pt")
        ckpt_bytes = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
        resumed_step = None
        if resume:
            again = train_torch.main(
                ["--resume", trainer.logdir, "-t", "--max-steps",
                 str(steps + 1), "--no-test", "--log-every", "1"])
            resumed_step = again._state.step
            resumed_losses, _ = _train_losses(trainer.logdir)
            del again
        # a run leaves `last` and one top-k checkpoint (2.7 GB each): cleared
        # as soon as they have been read, so that the script's peak use of
        # the temporary directory is one run's
        shutil.rmtree(os.path.join(tmp, f"{name}-a"))
        del trainer, state, batch
        torch.cuda.empty_cache()
        twin, _ = run(f"{name}-b", steps)
        twin_losses, _ = _train_losses(twin.logdir)
        shutil.rmtree(os.path.join(tmp, f"{name}-b"))
        grads_ok, grads = _grad_check(twin, env)
        expect, per_step = expected_train_launches(twin.ldm, env, steps, 1)
        del twin
        torch.cuda.empty_cache()

    checks = {
        "steps": len(losses) == steps,
        "finite": all(np.isfinite(losses)) and len(vals) == 1
        and all(np.isfinite(v) for v in vals[0].values()
                if isinstance(v, float)),
        "val_raw_and_ema": bool(vals) and "val_loss" in vals[0]
        and "val_loss_ema" in vals[0],
        "parameters_moved": moved > 0,
        "launches": launches == expect,
        "same_seed_same_loss_bits": losses == twin_losses,
        "checkpoint_written": ckpt_bytes > 0,
        "kernel_path_agrees_with_plain_path": grads_ok,
    }
    if resume:
        checks["resumed_at_saved_step"] = (
            resumed_step == steps + 1 and len(resumed_losses) == steps + 1
            and resumed_losses[:steps] == losses
            and bool(np.isfinite(resumed_losses[-1])))
    emit({"phase": "train", "run": name,
          "config": os.path.relpath(config, HERE), "flags": env, "card": smi,
          "batch": 8, "optimizer_steps": steps, "checks": checks,
          "losses": losses, "val": vals[0] if vals else None,
          "tensors_moved": moved, "launches": launches,
          "launches_expected": expect, "launches_per_step": per_step,
          "warm_step_ms": step_ms, "img_per_s": 8e3 / step_ms,
          "peak_memory_bytes": peak, "checkpoint_bytes": ckpt_bytes,
          "run_wall_seconds": round(wall, 3), "gradients": grads})
    if not all(checks.values()):
        fail(f"train {name}: checks failed: {checks}")
    return launches


AE_SPEC = {"image": [[128, 128, 3], "float32"]}
# parameters whose gradients the kernel path and the plain path are held to:
# q / k / v of AttnBlocks of the encoder and the decoder, and layers before,
# between and after them
AE_GRAD_PROBES = {
    "VQModel": ("encoder.down_2_attn_0.q.weight", "encoder.mid_attn_1.k.weight",
           "decoder.up_2_attn_2.v.weight", "decoder.mid_attn_1.q.weight",
           "encoder.conv_in.weight", "decoder.conv_out.weight",
           "quantize.embedding.weight"),
    "AutoencoderKL": ("encoder.mid_attn_1.q.weight", "encoder.mid_attn_1.k.weight",
           "decoder.mid_attn_1.v.weight", "encoder.conv_in.weight",
           "decoder.conv_out.weight"),
}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block. Its default choice
    for some fp32 convs' weight gradients sums in no fixed order, so two
    first-stage runs from one seed part after the first update; the port's
    own kernels give equal bits either way."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def write_lpips_files(tmp):
    """LPIPS weights from seed 0 in the torchvision / taming key layout the
    first-stage configs' loss reads (the real files are not in the
    repository)."""
    from dsml_thesis_tpu_torch.losses.lpips import LPIPS, lpips_weight_files

    torch.manual_seed(0)
    paths = (os.path.join(tmp, "vgg16_features.pth"),
             os.path.join(tmp, "lpips_lin.pth"))
    for path, part in zip(paths, lpips_weight_files(LPIPS().state_dict())):
        torch.save(part, path)
    return paths


def count_attn_blocks(model):
    from dsml_thesis_tpu_torch.models.autoencoder import AttnBlock

    return sum(isinstance(m, AttnBlock) for m in model.modules())


def expected_ae_launches(model, env, steps, eval_batches):
    """Launches of every kernel for ``steps`` first-stage training steps and
    ``eval_batches`` validation batches, from the model's own blocks: each
    AttnBlock once forward and once backward a step (the adaptive weight's
    two gradients stop at the decoder's last conv), once forward a
    validation batch. No other kernel runs in fp32 first-stage training."""
    n = count_attn_blocks(model)
    streaming = env.get("DSML_FLASH_STREAMING", "auto") == "1"
    fwd, bwd = (("flash_attention_streaming", "flash_attention_streaming_bwd")
                if streaming else ("flash_attention", "flash_attention_bwd"))
    from dsml_thesis_tpu_torch.ops.attention import LAUNCHES

    out = dict.fromkeys(LAUNCHES, 0)
    out.update({fwd: n * (steps + eval_batches), bwd: n * steps})
    return out, {fwd: n, bwd: n}


def _ae_grad_check(trainer, env):
    """The generator loss of one batch and the probe gradients, kernels
    against plain versions, same batch and, for the KL model, the same
    posterior noise."""
    from dsml_thesis_tpu_torch.models.autoencoder import AutoencoderKL

    model, loss = trainer.model, trainer.loss
    x = trainer._to_device(next(iter(trainer.train_data)))
    named = dict(model.named_parameters())
    probes = AE_GRAD_PROBES[type(model).__name__]
    kl = isinstance(model, AutoencoderKL)
    noise = None
    if kl:
        with torch.no_grad():
            shape = model.encode(x).mean.shape
        noise = torch.randn(shape, generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda")

    def run():
        if kl:
            rec, post = model(x, noise=noise)
            reg = post.kl()
        else:
            rec, reg, _ = model(x)
        total, _ = loss.generator_loss(
            reg, x, rec, trainer._state.step,
            last_layer=model.decoder.conv_out.weight)
        grads = torch.autograd.grad(total, [named[n] for n in probes])
        torch.cuda.synchronize()
        return float(total.detach()), {n: g.float().clone()
                                       for n, g in zip(probes, grads)}

    return _kernel_vs_plain(run, env)


def phase_ae_train(name, config, env, steps, smi, tmp, lpips_files,
                   resume=False):
    """One first-stage train run through scripts/train_torch.py's main().
    Returns the launch counts of the run (steps + one validation batch)."""
    from dsml_thesis_tpu_torch.ops import attention as A

    train_torch = _train_torch()
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"spec": AE_SPEC, "length": 64}}
    val = {"target": node["target"],
           "params": {"spec": AE_SPEC, "length": 16, "seed": 1000}}
    lc = "model.params.lossconfig.params"
    overrides = [f"data.params.train={json.dumps(node)}",
                 f"data.params.validation={json.dumps(val)}",
                 f"{lc}.disc_start=0", f"{lc}.vgg_ckpt={lpips_files[0]}",
                 f"{lc}.lpips_lin_ckpt={lpips_files[1]}"]

    def run(tag, n_steps):
        argv = ["--base", config, "-t", "--max-steps", str(n_steps),
                "--logdir", os.path.join(tmp, tag), "--name", name,
                "--seed", "0", "--log-every", "1", *overrides]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer = train_torch.main(argv)
        torch.cuda.synchronize()
        return trainer, time.monotonic() - t0

    def records(logdir):
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return ([r for r in recs if r["split"] == "train"],
                [r for r in recs if r["split"] == "val"])

    with flags(**env), deterministic_cudnn():
        A.reset_launches()   # counts below are of this run alone
        trainer, wall = run(f"{name}-a", steps)
        launches = dict(A.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        train, vals = records(trainer.logdir)
        losses = [r["train/total_loss"] for r in train]
        # parameters against a fresh build from the run's seed
        torch.manual_seed(0)
        fresh_model, fresh_loss = type(trainer)._build(trainer.config["model"])
        moved = lambda now, was: sum(
            not torch.equal(a.detach().cpu(), b) for a, b in
            zip(now.parameters(), was.parameters()))
        ae_moved = moved(trainer.model, fresh_model)
        disc_moved = moved(trainer.loss.discriminator,
                           fresh_loss.discriminator)
        n_attn = count_attn_blocks(trainer.model)
        x = trainer._to_device(next(iter(trainer.train_data)))
        step_ms = time_ms(lambda: trainer._step(trainer._state, x), 3, 1)
        ckpt = os.path.join(trainer.logdir, "checkpoints", "last", "state.pt")
        ckpt_bytes = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
        resumed_step = resumed = None
        if resume:
            again = train_torch.main(
                ["--resume", trainer.logdir, "-t", "--max-steps",
                 str(steps + 1), "--log-every", "1"])
            resumed_step = again._state.step
            resumed = [r["train/total_loss"] for r in records(trainer.logdir)[0]]
            del again
        shutil.rmtree(os.path.join(tmp, f"{name}-a"))
        del trainer, x
        torch.cuda.empty_cache()
        twin, _ = run(f"{name}-b", steps)
        twin_losses = [r["train/total_loss"] for r in records(twin.logdir)[0]]
        shutil.rmtree(os.path.join(tmp, f"{name}-b"))
        grads_ok, grads = _ae_grad_check(twin, env)
        expect, per_step = expected_ae_launches(twin.model, env, steps, 1)
        del twin
        torch.cuda.empty_cache()

    checks = {
        "steps": len(losses) == steps,
        "finite": all(np.isfinite(losses)) and len(vals) == 1
        and all(np.isfinite(v) for v in vals[0].values()
                if isinstance(v, float)),
        "d_weight_above_zero": all(r["train/d_weight"] > 0 for r in train),
        "autoencoder_moved": ae_moved > 0,
        "discriminator_moved": disc_moved > 0,
        "launches": launches == expect,
        "same_seed_same_loss_bits": losses == twin_losses,
        "checkpoint_written": ckpt_bytes > 0,
        "kernel_path_agrees_with_plain_path": grads_ok,
    }
    if resume:
        checks["resumed_at_saved_step"] = (
            resumed_step == steps + 1 and len(resumed) == steps + 1
            and resumed[:steps] == losses and bool(np.isfinite(resumed[-1])))
    emit({"phase": "train", "run": name,
          "config": os.path.relpath(config, HERE), "flags": env, "card": smi,
          "batch": 16, "dtype": "float32", "cudnn_deterministic": True,
          "optimizer_steps": steps,
          "attn_blocks": n_attn, "checks": checks, "losses": losses,
          "d_weight": [r["train/d_weight"] for r in train],
          "val": vals[0] if vals else None,
          "tensors_moved": {"autoencoder": ae_moved,
                            "discriminator": disc_moved},
          "launches": launches, "launches_expected": expect,
          "launches_per_step": per_step, "warm_step_ms": step_ms,
          "img_per_s": 16e3 / step_ms, "peak_memory_bytes": peak,
          "checkpoint_bytes": ckpt_bytes, "run_wall_seconds": round(wall, 3),
          "gradients": grads})
    if not all(checks.values()):
        fail(f"train {name}: checks failed: {checks}")
    return launches


# kernel -> (source, the TPU kernel it replaces, the run that is its path)
KERNELS = {
    "flash_attention_fproj": (
        "flash_attention_fproj.cu", "attention.py:950", "fullattn"),
    "flash_attention": (
        "flash_attention.cu", "attention.py:328", "fullattn"),
    "flash_attention_packed": (
        "flash_attention_packed.cu", "attention.py:339", "fullattn"),
    "flash_attention_qout": (
        "flash_attention_qout.cu", "attention.py:1069", "fullattn-flags"),
    "group_norm_silu": (
        "group_norm.cu", "groupnorm.py:103", "fullattn-flags"),
    "gn_channel_stats": (
        "group_norm.cu", "groupnorm.py:162", "headline-stats"),
    "flash_attention_bwd": (
        "flash_attention_bwd.cu", "attention.py:1353", "ae-vq"),
    "flash_attention_bwd_packed": (
        "flash_attention_bwd_packed.cu", "attention.py:1378", "train"),
    "flash_attention_streaming": (
        "flash_attention_streaming.cu", "attention.py:453",
        "headline-streaming"),
    "flash_attention_streaming_bwd": (
        "flash_attention_streaming_bwd.cu", "attention.py:610",
        "ae-vq-streaming"),
    "conv_stats": ("conv_stats.cu", "conv_gn.py:83", "headline-epilogue-res"),
}


def kernels_line(cases, launches_by_run):
    rows = []
    for name, (source, replaces, run) in KERNELS.items():
        timed = [c for c in cases[name] if "ms" in c]
        first = timed[0]
        launches = launches_by_run[run][name]
        if launches < 1:
            fail(f"kernel {name} was launched no time in run {run}")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dsml_thesis_tpu_torch/csrc/{source}",
            "replaces": f"dsml_thesis_tpu/ops/{replaces}",
            "launches": launches, "launches_in_run": run,
            "launches_by_run": {r: l.get(name, 0)
                                for r, l in launches_by_run.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "shape": first["shape"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "other_shapes": timed[1:],
        })
    return {"kernels": rows}


# serve runs and model checks: (name, config, flags, requests)
RUNS = (
    ("fullattn", CONFIG_FULLATTN, {}, 16),
    ("fullattn-flags", CONFIG_FULLATTN,
     {"DSML_ATTN_FPROJ_PARTIAL": "1", "DSML_PALLAS_GN": "1"}, 8),
    ("headline-stats", CONFIG, {"DSML_PALLAS_GN": "stats"}, 8),
    ("headline", CONFIG, {}, 8),
    ("headline-streaming", CONFIG, {"DSML_FLASH_STREAMING": "1"}, 8),
    ("headline-epilogue-res", CONFIG, {"DSML_GN_EPILOGUE": "res"}, 8),
    ("headline-epilogue", CONFIG, {"DSML_GN_EPILOGUE": "1"}, 8),
)
# train runs: (name, config, flags, optimizer steps)
TRAIN_RUNS = (
    ("train", CONFIG, {}, 6),
    ("train-fullattn", CONFIG_FULLATTN, {}, 2),
    ("train-split", CONFIG, {"DSML_ATTN_PACKED": "0"}, 2),
    ("train-gn", CONFIG, {"DSML_PALLAS_GN": "1"}, 2),
    ("train-streaming", CONFIG,
     {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}, 2),
    ("train-epilogue", CONFIG, {"DSML_GN_EPILOGUE": "res"}, 2),
)
# first-stage train runs: (name, config, flags, optimizer steps)
AE_RUNS = (
    ("ae-vq", CONFIG_VQ, {}, 4),
    ("ae-vq-streaming", CONFIG_VQ, {"DSML_FLASH_STREAMING": "1"}, 2),
    ("ae-kl", CONFIG_KL, {}, 2),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,model,serve,train")
    ap.add_argument("--frames", type=int, default=2,
                    help="frames a clip in the serve phase")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on the "
              "card and has no CPU mode", file=sys.stderr)
        sys.exit(2)
    # nothing is printed before the program itself is known to be here
    for config in (CONFIG, CONFIG_FULLATTN, CONFIG_VQ, CONFIG_KL):
        if not os.path.exists(config):
            print(f"chip_smoke: {config} is missing: run from a checkout",
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
    launches = {}
    if "model" in phases or "serve" in phases:
        models = {}
        for name, config, env, n_requests in RUNS:
            if config not in models:
                cfg, ldm = build_ldm(config)
                models[config] = (dict(cfg, path=config), ldm)
            cfg, ldm = models[config]
            if "model" in phases:
                phase_model(name, ldm, env)
            if "serve" in phases:
                launches[name] = phase_serve(name, cfg, ldm, env, n_requests,
                                             args.frames, smi)
        del models, ldm   # free the card for the train runs
        torch.cuda.empty_cache()
    if "train" in phases:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            for name, config, env, steps in TRAIN_RUNS:
                launches[name] = phase_train(name, config, env, steps, smi, tmp,
                                             resume=(name == "train"))
            lpips_files = write_lpips_files(tmp)
            for name, config, env, steps in AE_RUNS:
                launches[name] = phase_ae_train(name, config, env, steps, smi,
                                                tmp, lpips_files,
                                                resume=(name == "ae-vq"))
    if cases is None or not all(
            r[0] in launches for r in RUNS + TRAIN_RUNS + AE_RUNS):
        return
    emit(kernels_line(cases, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
