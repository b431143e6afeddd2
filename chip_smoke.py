#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # all phases; exit code 0 = every phase ok

Phases, each printing one JSON line (any failure exits non-zero):
  device   the card's name and power limit as nvidia-smi gives them
  build    compiles the CUDA kernels from dsml_thesis_tpu_torch/csrc/
  kernels  every kernel against its plain PyTorch version on the card, at
           the shapes the serving and training paths give it, with times:
           the kernel, the plain version, one library call computing the
           same function (timed as a yardstick only; the port never calls
           it) and the least time the card could take (bytes over 3.35 TB/s
           against operations over 989 TFLOP/s bf16, 494.7 TF32 for the fp32
           attention and conv kernels, or 67 TFLOP/s fp32 outside the tensor
           cores, the larger); the fp32 instantiations (first-stage
           training: the D = 512 attention, GroupNorm, channel statistics,
           conv + statistics; mead-128-ldm-f4's UNet: the D = 32 attention of
           rows 1, 2, 3, 4, 5, 7, 8, and GroupNorm and conv + statistics at
           its widths and image sizes) are held to fp32 plain versions with
           TF32 off;
           every kernel must also give the same bits from two launches (the
           backward kernels also through autograd)
  model    mead-256-ldm-f4.yaml, its -fullattn twin, -fullattn-dh64 and
           mead-128-ldm-f4.yaml at full width and depth, random weights from a
           seed: one UNet call and one first-stage decode at the config's
           latent size through the kernels against the same calls through the
           plain versions, under each flag set of the serve runs
  serve    a MicroBatcher of batch 8 answers single-clip requests of F
           frames at the config's frame size, guidance 2.0, in fifteen
           runs, then the AffectNet model's class batches; each config's run
           without a flag serves DDIM-50, each flag run DDIM-10
           (SERVE_DDIM_STEPS):
             fullattn        -fullattn, no flag, 16 requests (two batches)
             fullattn-dh64   -fullattn-dh64 (level-0 heads of 80 through the
                             packed kernel), no flag, one batch
             fullattn-dh64-split  -fullattn-dh64, DSML_ATTN_PACKED=0 (every
                             self-attention through the split-head kernel,
                             D = 80 and 64), one batch
             fullattn-flags  -fullattn, DSML_ATTN_FPROJ_PARTIAL=1 and
                             DSML_PALLAS_GN=1, one batch
             headline-stats  headline config, DSML_PALLAS_GN=stats, one batch
             headline        headline config, no flag, one batch
             headline-streaming     DSML_FLASH_STREAMING=1, one batch
             headline-epilogue-res  DSML_GN_EPILOGUE=res, one batch
             headline-epilogue      DSML_GN_EPILOGUE=1, one batch
             mead128         mead-128-ldm-f4 (fp32 UNet, 128 px), no flag:
                             every self-attention through row 1 in fp32
             mead128-split   mead-128-ldm-f4, DSML_ATTN_PACKED=0 (row 2 in
                             fp32 at D = 32), one batch
             mead128-streaming  mead-128-ldm-f4, DSML_ATTN_PACKED=0 and
                             DSML_FLASH_STREAMING=1 (row 4 in fp32 at
                             D = 32; the first stage's at D = 512), one batch
             mead128-gn      mead-128-ldm-f4, DSML_PALLAS_GN=1 (row 9 at
                             the fp32 UNet's widths), one batch
             mead128-epilogue  mead-128-ldm-f4, DSML_GN_EPILOGUE=1 (row 11
                             at its widths, the Cin = 9 stem and the 8 x 8
                             level), one batch
             mead128-stats   mead-128-ldm-f4, DSML_PALLAS_GN=stats (row 10
                             at the fp32 UNet's shapes), one batch
             affectnet       affectnet-128-ldm-vq-f4 (face reenactment: fp32
                             UNet of mead-128's shape, VQ-f4 of 16,384
                             codes), 2 classes x 8 samples through
                             reenactment.sample_class (the call of
                             scripts/sample_affectnet_torch.py), DDIM-50,
                             guidance 3.0 against the null embedding, after
                             one guided UNet call and one decode held kernel
                             path against plain path
           then in two runs DPM-Solver++ multistep (the fewer-steps
           serving mode, --sampler dpm) in place of DDIM-50:
             headline-dpm20  headline config, order 2, 20 UNet calls a frame
             mead128-dpm10   mead-128-ldm-f4, order 3, 10 UNet calls a frame
                             (update orders 1, 2, 3, 3, 3, 3, 3, 3, 2, 1)
           each checks shapes, finiteness, range, launch counts, and that
           (seed, batch index) reproduces a batch bit for bit
  samplers one mead128-dpm10 batch's latents (8 clips, F frames) through the
           kernels against the same batch through every kernel's plain
           version, same seed (tolerance 1e-2 of the latents' maximum);
           every sampler of diffusion/ (DPM-Solver++ multistep, singlestep,
           singlestep_fixed, adaptive, 2M; PLMS; DDPM; DDIM with a mask,
           with intermediates, inversion, reverse, manipulation,
           stochastic_encode; tiled_apply) on the card against itself on
           the CPU on closed-form models at [8, 32, 32, 3] (1e-5 of each
           output's maximum, the adaptive iterations equal); then through
           mead-128-ldm-f4's fp32 UNet at batch 8, full width, a few steps
           each: PLMS (4 steps), DPM singlestep (6 evaluations, order 3),
           adaptive (order 2, at most 3 iterations), ddim_invert then
           ddim_reverse_from, a masked ddim_sample, one tiled UNet call and
           decode (9 patches of 16 x 16 latents, also against the plain
           path) and ddpm_p_sample_loop on a schedule cut to T = 20; each
           checked for shape, finiteness and launch counts
  video    the talking-face generate-and-score path (video-eval) on
           mead-128-ldm-f4.yaml at full width, random weights from seed 0:
           scripts/streaming_pipeline_torch.py's own main() on 4 synthetic
           clips (--synthetic 4 --batch 2 --frames 4 --steps 10, guidance
           2.0: two batches; the first stage's weights as a --ckpt file),
           its launches against those counted from the model's blocks,
           batch 0's written clips bit for bit against a direct
           make_video_pipeline call on the same inputs and generator, that
           batch's wall and device-busy ms and the steady frames/s; one
           clip through progressive_sampling_torch.sample_clip and one frame
           through sample_mead_frame_torch.sample_frame with their launches;
           then the metrics layer on the generated frames: PSNR / SSIM on
           the card against the CPU (1e-5), the FID InceptionV3 (a random
           pt_inception-layout state_dict) on the card without TF32 against
           the CPU (1e-4 of the maximum; the deviation at TF32 printed
           beside it), FID / KID / PRC / IS between the two batches, and
           the edit-distance library built on this machine against the
           pure-Python distances
  train    scripts/train_torch.py's own main() on SyntheticDataset at the
           real shapes (the config's frame size, audio [17, 768]) and the
           YAML's batch size (8 at 256 px, fp32 parameters with bf16 compute;
           32 at 128 px in fp32 for mead-128), full width and depth, in
           fourteen runs:
             train           headline config, no flag, 6 optimizer steps, one
                             validation batch, `last` written, then resumed
                             with --resume for one more step
             train-fullattn  -fullattn, no flag, 2 steps
             train-split     headline, DSML_ATTN_PACKED=0, 2 steps
             train-gn        headline, DSML_PALLAS_GN=1, 2 steps
             train-streaming headline, DSML_ATTN_PACKED=0 and
                             DSML_FLASH_STREAMING=1, 2 steps
             train-epilogue  headline, DSML_GN_EPILOGUE=res, 2 steps
             train-fullattn-dh64   -fullattn-dh64 (level-0 heads of 80), no
                             flag, 2 steps
             train-dh64-split      -fullattn-dh64, DSML_ATTN_PACKED=0, 2 steps
             train-dh64-streaming  -fullattn-dh64, DSML_ATTN_PACKED=0 and
                             DSML_FLASH_STREAMING=1, 2 steps
             train-mead128   mead-128-ldm-f4, no flag (rows 3 + 8 in fp32 at
                             D = 32), 2 steps, an image log at step 2;
                             its `last` kept for the tune phase
             train-mead128-split   mead-128-ldm-f4, DSML_ATTN_PACKED=0 (rows
                             2 + 7 in fp32 at D = 32), 2 steps
             train-mead128-streaming  mead-128-ldm-f4, DSML_ATTN_PACKED=0
                             and DSML_FLASH_STREAMING=1 (rows 4 + 5 in fp32
                             at D = 32), 2 steps
             train-mead128-epilogue   mead-128-ldm-f4, DSML_GN_EPILOGUE=res
                             (rows 3 + 8 in fp32, row 11 forward), 2 steps
             train-affectnet affectnet-128-ldm-vq-f4 at its YAML's batch of
                             24 (image, class_label; rows 3 + 8 in fp32,
                             row 2 at D = 512 in the encode), 2 steps, an
                             image log at step 2
           each checks: finite losses, parameters that moved, launch counts
           against those counted from the model's own blocks, the backward
           kernel's calls by head width against the model's self-attentions,
           equal loss bits from a second run with the same seed, and loss and
           a handful of gradients on the kernel path against the plain path
           on the card; the image logger runs as each YAML ships it, and in
           the first run of train-mead128 and train-affectnet once, at the
           last step (max_images 8, DDIM-20 chains with rows 1 and 2,
           decodes): every row file of its shape, finite, in [-1, 1]
           (images_logged), its launches in the counts;
           then first-stage training (fp32, the AttnBlock at D = 512) of
           configs/autoencoder/*.yaml at full width, batch 16, 128 px,
           SyntheticDataset images, LPIPS files written from seed 0,
           disc_start 0 (the GAN term and its adaptive weight run), in
           seven runs:
             ae-vq           vqgan-f4, 4 steps, one validation batch, `last`,
                             then resumed with --resume for one more step
             ae-vq-streaming vqgan-f4, DSML_FLASH_STREAMING=1, 2 steps
             ae-kl           kl-f4, 2 steps
             ae-vq-gn        vqgan-f4, DSML_PALLAS_GN=1, 2 steps
             ae-kl-stats     kl-f4, DSML_PALLAS_GN=stats, 2 steps
             ae-vq-epilogue  vqgan-f4, DSML_GN_EPILOGUE=1, 2 steps
             ae-kl-epilogue-res  kl-f4, DSML_GN_EPILOGUE=res, 2 steps
           each checks the same, plus a d_weight above zero and moved
           discriminator parameters;
           then the AffectNet editing stack (affectnet-edit): the latent
           cache of 8 synthetic images (reenactment.compute_latent_cache:
           VQ encode, DDIM inversion of 40 steps at strength 0.5, the
           reconstruction), 2 steps of the DiffusionCLIP finetune
           (affectnet-128-clip-ldm-vq-f4, batch 4, through
           scripts/train_torch.py's main() on that cache via LatentTrain; a
           random full-width CLIP ViT-B/16, a random IR-SE50 and a synthetic
           BPE table written to the temporary directory keep the l2, id and
           CLIP-direction losses live), with one validation batch and one
           image log, and one reenactment.manipulate call on the finetuned
           model; checks: launch counts (row 1 through its autograd Function
           in the differentiated chain, rows 2 and 7 in the decode and its
           backward at [4, 1, 1024, 512]), the towers and the first stage
           unchanged, parameters moved, the first step's loss and gradients
           kernel path against plain path, the peak memory
  audio    scripts/mead_audio_features_torch.py's main() at full width on two
           synthetic 48 kHz clips of about 3 s (random weights from seed 0):
           wav2vec2-base (base: 7 x 512 convs, 12 layers of 768) and
           LARGE_960H (bundle: 24 layers of 1024, CTC logits of 32); each
           pickle against the same model on the CPU in fp32 (TF32 off, 1e-4
           of the maximum) and at cuDNN's default TF32 (2e-2), a warm clip's
           ms at both
  tune     the lip-reading finetune (mead-128-ldm-f4-tune.yaml: the fp32
           mead-128 model, an 8-step eta = 1.0 chain, the lipreader loss)
           through scripts/train_torch.py's main() at its own batch of 8, 2
           steps and one validation batch, warm-started from train-mead128's
           checkpoint (model.params.ckpt_path; needs the train phase), a
           random LRS3 lipreader written to the temporary directory
           (lipread_ckpt), synthetic data with landmarks (the card's machine
           has no Pillow for MEAD's frames); checks: the model, EMA and step
           0 as saved before the first step (warm_started), the lr term
           present, launch counts (row 1 through its autograd Function, rows
           2 and 7 at [8, 1, 1024, 512]), the lipreader as built and the
           first stage as loaded, parameters moved, the first step's loss
           and gradients kernel path against plain path, the peak memory and
           a warm step's ms
then the line {"kernels": [...]} (a row per kernel, a sub-row per fp32
D = 32 and D = 512 instantiation, one for row 7 at each of the DiffusionCLIP
finetune's [4, 1, 1024, 512] and the lip-reading finetune's [8, 1, 1024, 512]
and one each for GroupNorm and conv + statistics at the fp32 UNet's shapes),
the card's name and power limit, and, last,
{"ok": true, "device": {...}}.

`--phases device,build,kernels` runs a subset (no final ok line then); a
list with tune must hold train.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CONFIG_DIR = os.path.join(HERE, "configs", "latent-diffusion")
CONFIG = os.path.join(CONFIG_DIR, "mead-256-ldm-f4.yaml")
CONFIG_FULLATTN = os.path.join(CONFIG_DIR, "mead-256-ldm-f4-fullattn.yaml")
CONFIG_DH64 = os.path.join(CONFIG_DIR, "mead-256-ldm-f4-fullattn-dh64.yaml")
# the reference's own talking-face model: fp32 UNet (no dtype), 128 px, 32 x 32
# latents, self-attention at every level (32-wide heads), batch 32 in training
CONFIG_128 = os.path.join(CONFIG_DIR, "mead-128-ldm-f4.yaml")
# the face-reenactment family: the AffectNet emotion-conditioned LDM (fp32
# UNet of mead-128's shape, VQ-f4 first stage of 16,384 codes) and its
# DiffusionCLIP finetune
CONFIG_AFFECTNET = os.path.join(CONFIG_DIR, "affectnet-128-ldm-vq-f4.yaml")
CONFIG_AFFECTNET_CLIP = os.path.join(CONFIG_DIR,
                                     "affectnet-128-clip-ldm-vq-f4.yaml")
# the talking-face lip-reading finetune (mead-128-ldm-f4's model under the
# reference's ddpm2condtune: an 8-step eta = 1.0 chain and a lipreader loss)
CONFIG_TUNE = os.path.join(CONFIG_DIR, "mead-128-ldm-f4-tune.yaml")
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
# The split-head forward's row log-sum-exp (base 2) is fp32 throughout: the
# exp2 of the special-function unit (2 ulp) and sums of up to 4096 terms in
# another order than torch.logsumexp keep it within some hundred fp32
# roundings of the largest row; a wrong maximum or a dropped tile moves it by
# whole units.
LSE_REL_TOL = 1e-4
# The packed forward's log-sum-exp at fp32 D = 32 forms its scores from q and
# k rounded to TF32 (2^-11 relative each): over 32 products a score moves by
# about 1e-3 of its scale, and with few keys to average over (Nk = 77) that
# alone puts the row log-sum-exp up to about 2e-4 of the largest row away
# from the fp32 one. Each such case also reports that floor on its own
# inputs ("tf32_floor_rel_err": the plain formula on TF32-rounded q and k);
# a wrong maximum or a dropped tile still moves it by whole units.
LSE_TF32_REL_TOL = 5e-4
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


T0 = time.monotonic()


def emit(obj):
    """One JSON line on stdout; the seconds since start on stderr, so that
    a run that nears TIME_LIMIT_S shows which phase took the time."""
    print(json.dumps(obj), flush=True)
    print(f"chip_smoke: {time.monotonic() - T0:.1f} s: {obj.get('phase')} "
          f"{obj.get('run', obj.get('name', ''))}", file=sys.stderr,
          flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, iters=10):
    """Device time of a call of ``fn``: its kernels' device time under
    torch.profiler, summed over ``iters`` warm calls and divided by
    ``iters`` (the host's time to launch them left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _device_us(prof) / 1e3 / iters


def _device_us(prof):
    """The device time of the kernels a torch.profiler run traced, in us,
    summed over the trace's own records (``key_averages`` first builds a
    Python object a record: many seconds for a traced sampling chain);
    annotations mirrored onto the device track are left out
    (``tools/measure.py:is_annotation``)."""
    from torch.autograd import DeviceType

    from dsml_thesis_tpu_torch.tools.measure import is_annotation

    return sum(ev.duration_ns()
               for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA
               and not is_annotation(ev.name())) / 1e3


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
              if ln.startswith("== ") or "registers" in ln or "spill" in ln
              or "Compiling entry function" in ln
              or "Performance Loss" in ln]
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 2),
          "nvcc_seconds": _build.build_seconds, "sources": list(_build.SOURCES),
          "ptxas": report})
    # ptxas C7510-C7520: wgmma serialized, a design that lost its overlap
    serialized = [ln for ln in report
                  if "wgmma" in ln and "serialized" in ln]
    if serialized:
        fail(f"ptxas serialized wgmma: {serialized}")


def _rand(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def _width(dtype):
    """(bytes an element, peak rate of the unit the kernel multiplies on)."""
    return (4, PEAK_TF32_FLOPS) if dtype == torch.float32 else (2,
                                                                PEAK_BF16_FLOPS)


def _dtype_name(dtype):
    return str(dtype).split(".")[1]


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


def _with_device_ms(case, kernel, library, by_kernel=False):
    """A timed case with the device time of the kernel's call and of the
    library's beside their event times: where a call is a few microseconds
    of device work, the event times are the host's launch rate. With
    ``by_kernel`` the kernel's device time is also given by launch."""
    case.update(device_ms=device_ms(kernel),
                library_device_ms=device_ms(library))
    if by_kernel:
        from dsml_thesis_tpu_torch.tools.variants import device_kernels_ms

        case["device_ms_by_kernel"] = {
            name: round(ms, 4)
            for name, ms in device_kernels_ms(kernel).items()}
    return case


def _flash_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16,
                device=False):
    """The split-head forward, and the same bits from a second launch
    (``device``: the device times beside the event times)."""
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v = (_rand(gen, b, h, n, d, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    esize, peak = _width(dtype)
    run = lambda: A.flash_attention(q, k, v, scale=scale)
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    case = _repeatable(_case(
        (b, h, nq, nk, d), timed, run,
        lambda: A.attention_reference(q, k, v, scale=scale), library,
        esize * b * h * (2 * nq + 2 * nk) * d, 4 * b * h * nq * nk * d,
        peak, dtype=_dtype_name(dtype), head_dim=d), run)
    return _with_device_ms(case, run, library) if device else case


def _flash_lse_case(gen, b, h, nq, nk, d, dtype=torch.bfloat16):
    """The split-head forward's row log-sum-exp ([B*H*Nq]: log2 of the sum
    of exp(score times scale)) against the plain one, and the same bits
    again. At fp32 D = 32 the scores come from q and k rounded to TF32:
    held at LSE_TF32_REL_TOL with the error that rounding alone gives on
    the same inputs beside it, as the packed forward's are."""
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v = (_rand(gen, b, h, n, d, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    run = lambda: A._launch_flash_forward(q, k, v, scale, True)[1]

    def plain(q=q, k=k):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        return (torch.logsumexp(s, dim=-1) * A.LOG2E).reshape(-1)
    extra = dict(tol=LSE_REL_TOL)
    if dtype == torch.float32 and d == 32:
        extra = dict(tol=LSE_TF32_REL_TOL, tf32_floor_rel_err=_compare(
            plain(_tf32(q), _tf32(k)), plain())[1])
    case = _case((b, h, nq, nk, d), False, run, plain, None, 0, 0, 1,
                 output="lse", **extra, dtype=_dtype_name(dtype), head_dim=d)
    return _repeatable(case, run)


def _fproj_case(gen, b, n, c, heads, timed, dtype=torch.bfloat16):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = c  # the UNet's self-attention keeps heads * head_dim == channels
    d = hd // heads
    h = _rand(gen, b, n, c, dtype=dtype)
    wq, wk, wv = (_rand(gen, hd, c, scale=c ** -0.5, dtype=dtype)
                  for _ in range(3))
    wo = _rand(gen, c, hd, scale=hd ** -0.5, dtype=dtype)
    bo = _rand(gen, c, scale=0.1, dtype=dtype)
    esize, peak = _width(dtype)
    scale = d ** -0.5
    args = (h, wq, wk, wv, wo, bo, heads)

    def library():
        sp = lambda t: t.view(b, n, heads, d).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            sp(F.linear(h, wq)), sp(F.linear(h, wk)), sp(F.linear(h, wv)),
            scale=scale)
        return F.linear(o.transpose(1, 2).reshape(b, n, hd), wo, bo)

    run = lambda: A.flash_attention_fproj(*args, scale=scale)
    return _repeatable(_case(
        (b, n, c, heads), timed, run,
        lambda: A.fproj_reference(*args, scale=scale), library,
        esize * (2 * b * n * c + 4 * c * hd + c),
        2 * b * n * c * hd * 4 + 4 * b * n * n * hd, peak,
        iters=20, dtype=_dtype_name(dtype), head_dim=d), run)


def _packed_case(gen, b, nq, nk, heads, d, timed, dtype=torch.bfloat16):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = heads * d
    q, k, v = (_rand(gen, b, n, hd, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    esize, peak = _width(dtype)
    sp = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
    run = lambda: A.flash_attention_packed(q, k, v, heads, scale=scale)
    return _repeatable(_case(
        (b, nq, nk, heads, d), timed, run,
        lambda: A.packed_reference(q, k, v, heads, scale=scale),
        lambda: F.scaled_dot_product_attention(sp(q), sp(k), sp(v),
                                               scale=scale),
        esize * b * (2 * nq + 2 * nk) * hd, 4 * b * nq * nk * hd, peak,
        dtype=_dtype_name(dtype), head_dim=d), run)


def _tf32(x):
    """x (fp32) rounded to TF32 as the kernels round their operands."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _packed_lse_case(gen, b, nq, nk, heads, d, dtype=torch.float32):
    """The packed forward's row log-sum-exp ([B*H*Nq], base 2, of the scores
    times scale) of the fp32 D = 32 instantiation against the plain one, the
    error TF32 rounding of q and k alone gives on the same inputs beside it,
    and the same bits again."""
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = heads * d
    q, k, v = (_rand(gen, b, n, hd, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    run = lambda: A._launch_packed_forward(q, k, v, heads, scale, True)[1]
    plain = lambda: A.packed_lse_reference(q, k, heads, scale=scale)
    floor = _compare(A.packed_lse_reference(_tf32(q), _tf32(k), heads,
                                            scale=scale), plain())[1]
    case = _case((b, nq, nk, heads, d), False, run, plain, None, 0, 0, 1,
                 output="lse", tol=LSE_TF32_REL_TOL, tf32_floor_rel_err=floor,
                 dtype=_dtype_name(dtype), head_dim=d)
    return _repeatable(case, run)


def _bwd_case(shape, timed, q, k, v, do, forward, backward, through_autograd,
              plain, sdpa_inputs, scale, lse_bytes=4, device=False):
    """An attention backward kernel on the forward kernel's own output and
    row log-sum-exp (``forward`` returns both; the streaming pair has no
    saved log-sum-exp, ``lse_bytes=0``): (dq, dk, dv) against the plain
    backward formula ``plain(out)``, each
    within REL_TOL of its own maximum; a second launch and the same gradient
    asked for through autograd (the ``Function`` the model uses) must both
    give the same bits. The yardstick is the backward of
    ``scaled_dot_product_attention`` through autograd. ``device``: the
    device times beside the event times, the kernel's by launch."""
    import torch.nn.functional as F

    esize, peak = _width(q.dtype)
    b_h, nq, nk, d = shape[-4:]
    out, lse = forward()
    sq, sk, sv, sdo = (t.detach().requires_grad_(t is not sdpa_inputs[3])
                       for t in sdpa_inputs)
    so = F.scaled_dot_product_attention(sq, sk, sv, scale=scale)
    run = lambda: backward(out, lse)
    library = lambda: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                          retain_graph=True)
    case = _case(
        shape, timed, run, lambda: plain(out), library,
        esize * b_h * (4 * nq + 4 * nk) * d + lse_bytes * b_h * nq,
        10 * b_h * nq * nk * d, peak, dtype=_dtype_name(q.dtype), head_dim=d)
    if device:
        _with_device_ms(case, run, library, by_kernel=True)
    first, again = backward(out, lse), backward(out, lse)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(through_autograd(*leaves), leaves, do)
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(first, again, auto))
    if not same:
        case["rel_err"] = float("inf")
    case["repeatable_and_equal_through_autograd"] = same
    return case


def _flash_bwd_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16,
                    device=False):
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
        (q, k, v, do), scale, device=device)


def _repeatable(case, run):
    """Marks a case whose kernel gives other bits on a second launch on the
    same inputs as failed."""
    same = torch.equal(run(), run())
    if not same:
        case["rel_err"] = float("inf")
    case["repeatable"] = same
    return case


def _streaming_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16,
                    device=False):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    q, k, v = (_rand(gen, b, h, n, d, dtype=dtype) for n in (nq, nk, nk))
    scale = d ** -0.5
    esize, peak = _width(dtype)
    run = lambda: A.flash_attention_streaming(q, k, v, scale=scale)
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    case = _repeatable(_case(
        (b, h, nq, nk, d), timed, run,
        lambda: A.streaming_attention_reference(q, k, v, scale=scale),
        library,
        esize * b * h * (2 * nq + 2 * nk) * d, 4 * b * h * nq * nk * d,
        peak, kv_splits=A.streaming_splits(b * h, nq, nk),
        dtype=_dtype_name(dtype), head_dim=d), run)
    return _with_device_ms(case, run, library) if device else case


def _streaming_bwd_case(gen, b, h, nq, nk, d, timed, dtype=torch.bfloat16,
                        device=False):
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
        (q, k, v, do), scale, lse_bytes=0, device=device)


def _packed_bwd_case(gen, b, nq, nk, heads, d, timed, dtype=torch.bfloat16):
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = heads * d
    q, k, v, do = (_rand(gen, b, n, hd, dtype=dtype) for n in (nq, nk, nk, nq))
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


def _qout_case(gen, b, n, nk, c, heads, timed, hd=None):
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import attention as A

    hd = hd or c  # the UNet's self-attention keeps heads * head_dim == C
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

    run = lambda: A.flash_attention_qout(*args, scale=scale)
    return _repeatable(_case(
        (b, n, nk, c, heads), timed, run,
        lambda: A.qout_reference(*args, scale=scale), library,
        2 * (2 * b * n * c + 2 * b * nk * hd + 2 * c * hd + c),
        2 * b * n * c * hd * 2 + 4 * b * n * nk * hd, PEAK_BF16_FLOPS,
        dtype="bfloat16", head_dim=d), run)


def _gn_input(gen, b, n, c, mean=0.5, std=2.0, dtype=torch.bfloat16):
    x = torch.randn(b, n, c, generator=gen, device="cuda") * std + mean
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x.to(dtype), gamma, beta


def _gn_case(gen, b, n, c, eps, silu, timed, mean=0.5, std=2.0,
             bf16_params=False, dtype=torch.bfloat16):
    """Whole-row GroupNorm(+SiLU); the same bits from a second call. A
    large-mean row (|mean| >> std) is held to finiteness only: there E[x^2] -
    E[x]^2 cancels in fp32 and the two summation orders legitimately
    disagree. ``bf16_params``: gamma and beta cast to bf16, as a model cast
    for sampling holds them (beside bf16 or fp32 x). The library yardstick
    takes parameters of x's type."""
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    x, gamma, beta = _gn_input(gen, b, n, c, mean, std, dtype)
    gx, bx = gamma.to(dtype), beta.to(dtype)
    if bf16_params:
        gamma, beta = gamma.bfloat16(), beta.bfloat16()
    kw = dict(num_groups=32, eps=eps, silu=silu)

    def library():
        y = F.group_norm(x.transpose(1, 2), 32, gx, bx, eps)
        return F.silu(y) if silu else y

    run = lambda: G.group_norm_silu_kernel(x, gamma, beta, **kw)
    esize = x.element_size()
    case = _case(
        (b, n, c), timed, run,
        lambda: G.group_norm_silu_reference(x, gamma, beta, **kw), library,
        2 * esize * b * n * c + 2 * 4 * c, 10 * b * n * c, PEAK_FP32_FLOPS,
        eps=eps, silu=silu, dtype=_dtype_name(dtype),
        cluster=G.gn_plan(n, c, dtype))
    if not torch.equal(run(), run()):
        case["rel_err"] = float("inf")
    if abs(mean) > 10 * std and case["rel_err"] != float("inf"):
        case["large_mean_rel_err"], case["rel_err"] = case["rel_err"], 0.0
    return case


def _stats_case(gen, b, n, c, timed, dtype=torch.bfloat16):
    """Channel statistics: sum and sum of squares differ in size, so each is
    held against its own maximum; a second call must give the same bits."""
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    x, _, _ = _gn_input(gen, b, n, c, dtype=dtype)
    f32 = torch.float32
    case = _case(
        (b, n, c), timed, lambda: G.gn_channel_stats(x),
        lambda: G.gn_channel_stats_reference(x),
        lambda: (x.sum(1, dtype=f32), x.square().sum(1, dtype=f32)),
        x.element_size() * b * n * c + 2 * 4 * b * c, 3 * b * n * c,
        PEAK_FP32_FLOPS, tol=STATS_REL_TOL, dtype=_dtype_name(dtype))
    out, again = (torch.stack(G.gn_channel_stats(x)) for _ in range(2))
    ref = torch.stack(G.gn_channel_stats_reference(x))
    case["rel_err"] = (max(_compare(o, r)[1] for o, r in zip(out, ref))
                       if torch.equal(out, again) else float("inf"))
    return case


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's convolutions in TF32 inside the block (PyTorch's default; the
    script turns it off for its fp32 references)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _conv_case(gen, b, hh, ww, cin, cout, ksize, prologue, skip, timed,
               eps=1e-5, silu_in=True, dtype=torch.bfloat16, groups=32):
    """conv_stats: y against the plain version's (in fp32 with TF32 off: the
    disagreement is the kernel's TF32 rounding); the statistics against the
    sums of the kernel's own stored y (a y that rounds the other way at a bf16
    tie moves a sum by more than the sums' tolerance, and is no fault), with
    the same bits from a second call. The yardstick: ``F.group_norm`` +
    ``F.silu`` (prologue cases), ``F.conv2d`` (in fp32 under TF32, as the
    kernel multiplies), + bias (+ skip), two sums."""
    import torch.nn.functional as F
    from dsml_thesis_tpu_torch.ops import conv_gn as C
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    f32 = torch.float32
    x = _rand(gen, b, hh, ww, cin, scale=2.0, dtype=dtype) + 0.5
    w = _rand(gen, ksize, ksize, cin, cout, scale=(ksize * ksize * cin) ** -0.5,
              dtype=dtype)
    bias = 0.5 * torch.randn(b, cout, generator=gen, device="cuda")
    res = _rand(gen, b, hh, ww, cout, dtype=dtype) if skip else None
    kw = {}
    if prologue:
        gamma = 1 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(cin, generator=gen, device="cuda")
        kw = dict(in_stats=G.gn_channel_stats_reference(x.reshape(b, -1, cin)),
                  gamma=gamma, beta=beta, num_groups=groups, eps=eps,
                  silu_in=silu_in)
        gx, bx = gamma.to(dtype), beta.to(dtype)
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    # the kernel gets w as the UNet hands it over: a [K, K, Cin, Cout] view of
    # a channels_last Conv2d weight, which the implicit GEMM reads uncopied
    w = w_oihw.permute(2, 3, 1, 0)
    bias_x = bias.to(dtype)[:, :, None, None]
    res_nchw = None if res is None else res.permute(0, 3, 1, 2)

    def library():
        h = x_nchw
        if prologue:
            h = F.group_norm(h, groups, gx, bx, eps)
            h = F.silu(h) if silu_in else h
        with cudnn_tf32():
            y = F.conv2d(h, w_oihw, padding=(ksize - 1) // 2) + bias_x
        if res_nchw is not None:
            y = y + res_nchw
        return y, y.sum((2, 3), dtype=f32), y.square().sum((2, 3), dtype=f32)

    run = lambda: C.conv_stats(x, w, bias, skip=res, **kw)
    esize, peak = _width(dtype)
    stats_of = lambda y: G.gn_channel_stats_reference(y.reshape(b, -1, cout))
    extra = {}
    if dtype == f32:
        extra = {"plain_version": "fp32, cuDNN with TF32 off",
                 "library_call": "F.conv2d under TF32 (+ F.group_norm, "
                                 "F.silu, bias, skip, two sums)"}
    case = _case(
        (b, hh, ww, cin, cout), timed, run,
        lambda: C.conv_stats_reference(x, w, bias, skip=res, **kw), library,
        esize * (x.numel() + w.numel()
                 + b * hh * ww * cout * (2 if skip else 1))
        + 4 * b * cout * 3 + (4 * (2 * b * cin + 2 * cin) if prologue else 0),
        2 * b * hh * ww * ksize * ksize * cin * cout, peak,
        stats_from=stats_of, ksize=ksize, prologue=prologue, skip=skip,
        silu_in=silu_in if prologue else None, dtype=_dtype_name(dtype),
        plan=dataclasses.asdict(C.conv_plan(b, hh, ww, cin, cout, ksize, dtype,
                                            prologue, groups)), **extra)
    first, again = run(), run()
    if not all(torch.equal(a, c) for a, c in zip(first, again)):
        case["rel_err"] = float("inf")
    return case


# conv shapes of mead-128-ldm-f4's UNet under DSML_GN_EPILOGUE=1 besides
# the five cases above, from a spy on the kernel's wrapper in one UNet call
# of the model built on the meta device: (H = W, Cin, Cout, K, input norm,
# skip); the first ones are the 8 x 8 level's
MEAD128_CONVS_8X8 = [
    (8, 320, 640, 3, False, False), (8, 640, 640, 1, False, True),
    (8, 640, 640, 1, True, False), (8, 640, 640, 3, True, False),
    (8, 640, 640, 3, True, True), (8, 960, 640, 3, False, False),
    (8, 1280, 640, 3, True, False)]
MEAD128_CONVS = MEAD128_CONVS_8X8[:-1] + [
    (16, 160, 320, 3, False, False), (16, 320, 320, 1, False, True),
    (16, 320, 320, 1, True, False), (16, 320, 320, 3, True, False),
    (16, 320, 320, 3, True, True), (16, 480, 320, 3, False, False),
    (16, 640, 320, 3, True, False), (16, 960, 320, 3, False, False),
    (32, 160, 160, 1, False, True), (32, 160, 160, 1, True, False),
    (32, 160, 160, 3, True, False), (32, 320, 160, 3, True, False),
    (32, 480, 160, 3, False, False)]


def gn_cluster_rows(c, dtype):
    """The most rows of a batch row of c channels that the GroupNorm
    kernel's cluster design takes."""
    from dsml_thesis_tpu_torch.ops import groupnorm as G

    n = 1
    while G.gn_plan(2 * n, c, dtype):
        n *= 2
    lo, hi = n, 2 * n   # gn_plan(lo) > 0, gn_plan(hi) == 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if G.gn_plan(mid, c, dtype) else (lo, mid)
    return lo


def phase_kernels():
    """Each kernel against its plain version, at the serving path's shapes
    (batch 8, and 16 after the guidance pair is tiled; F = 2 frames a clip)
    and the training path's, plus ragged and other-head-width cases. The
    first timed case of a kernel is the one its entry in the "kernels" line
    reports; its fp32 D = 32 sub-row (``F32_NARROW``) reports the first
    timed case at that type and width."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32   # the fp32 instantiations: first-stage training
    flash = [
        _flash_case(gen, 8, 1, 4096, 4096, 512, True),    # decode, identity
        _flash_case(gen, 16, 1, 4096, 4096, 512, True),   # B*F masked frames
        _flash_case(gen, 2, 1, 1000, 1000, 512, False),   # ragged N
        _flash_case(gen, 1, 2, 333, 77, 512, False),      # Nk = 64 + 13
        _flash_lse_case(gen, 1, 2, 333, 77, 512),         # its lse
        _flash_lse_case(gen, 2, 1, 1000, 1000, 512),
        _flash_case(gen, 2, 5, 333, 77, 32, False),       # composed branch
        _flash_case(gen, 2, 3, 200, 200, 64, False),
        # bf16 D = 32 / 80: the UNet under DSML_ATTN_PACKED=0 (train-split,
        # train-dh64-split, fullattn-dh64-split), the packed kernel's grid
        _flash_case(gen, 8, 10, 1024, 1024, 32, True),
        _flash_case(gen, 8, 20, 256, 256, 32, True),
        _flash_case(gen, 8, 2, 4096, 4096, 80, True),     # -fullattn-dh64
        _flash_case(gen, 8, 5, 1024, 1024, 64, True),     # its levels 1, 2
        _flash_case(gen, 8, 10, 256, 256, 64, True),
        _flash_case(gen, 2, 1, 150, 150, 80, False),      # one head of 80
        _flash_case(gen, 2, 3, 300, 300, 80, False),      # 3 heads of 80
        _flash_case(gen, 2, 2, 333, 77, 80, False),       # Nk != Nq
        _flash_case(gen, 2, 2, 200, 129, 80, False),      # Nk = 128 + 1
        _flash_case(gen, 2, 2, 100, 50, 80, False),       # Nk < 64
        _flash_case(gen, 16, 1, 1024, 1024, 512, True, f32),   # vqgan-f4
        # mead-128-ldm-f4's frozen first stage: train-mead128's encodes
        # (batch 32), mead128's identity encode and decodes (batch 8)
        _flash_case(gen, 32, 1, 1024, 1024, 512, True, f32),
        _flash_case(gen, 8, 1, 1024, 1024, 512, True, f32),
        _flash_case(gen, 8, 1, 4096, 4096, 512, True, f32),    # 256 px
        _flash_case(gen, 2, 1, 1000, 1000, 512, False, f32),   # ragged N
        _flash_case(gen, 1, 2, 333, 77, 512, False, f32),      # Nk != Nq
        _flash_case(gen, 2, 1, 100, 65, 512, False, f32),      # Nk = 64 + 1
        _flash_case(gen, 1, 2, 70, 9, 512, False, f32),        # Nk < 64
        _flash_lse_case(gen, 1, 2, 333, 77, 512, f32),         # its lse
        _flash_lse_case(gen, 2, 1, 1000, 1000, 512, f32),
        _flash_lse_case(gen, 32, 1, 1024, 1024, 512, f32),     # row 7 reads
        # fp32 D = 32: mead-128-ldm-f4's UNet under DSML_ATTN_PACKED=0,
        # training batch 32 (the packed fp32 forward's grid on one head)
        _flash_case(gen, 32, 5, 1024, 1024, 32, True, f32),
        _flash_case(gen, 32, 10, 256, 256, 32, True, f32),
        _flash_case(gen, 32, 20, 64, 64, 32, True, f32),
        _flash_case(gen, 2, 5, 333, 77, 32, False, f32),       # Nk != Nq
        _flash_case(gen, 2, 3, 200, 129, 32, False, f32),      # Nk = 128 + 1
        _flash_case(gen, 2, 2, 100, 50, 32, False, f32),       # Nk < 64
        _flash_case(gen, 3, 5, 65, 129, 32, False, f32),       # Nq = 64 + 1
        # served (mead128-split: 8 clips x the guidance pair), the N = 64
        # level with the library's device time beside its event time
        _flash_case(gen, 16, 20, 64, 64, 32, True, f32, device=True),
        _flash_case(gen, 16, 5, 1024, 1024, 32, True, f32),
        _flash_case(gen, 16, 10, 256, 256, 32, True, f32),
        _flash_case(gen, 12, 50, 60, 50, 32, False, f32),      # Nk < Nq < 64
        # its row log-sum-exp, which row 7 reads
        _flash_lse_case(gen, 32, 5, 1024, 1024, 32, f32),
        _flash_lse_case(gen, 2, 5, 333, 77, 32, f32),
        _flash_lse_case(gen, 2, 3, 200, 129, 32, f32),
    ]
    fproj = [
        _fproj_case(gen, 16, 1024, 320, 10, True),   # 2B after the pair tiles
        _fproj_case(gen, 8, 1024, 320, 10, True),    # B: first transformer
        _fproj_case(gen, 16, 256, 640, 20, True),
        _fproj_case(gen, 3, 200, 320, 10, False),    # ragged N
        _fproj_case(gen, 2, 100, 128, 2, False),     # 64-wide heads
        _fproj_case(gen, 2, 300, 160, 5, False),     # H*D not a multiple of 64
        _fproj_case(gen, 16, 250, 640, 20, False),   # widest, clusters, ragged
        # 64-wide heads (fullattn-dh64 serves through them): levels 1, 2
        _fproj_case(gen, 16, 1024, 320, 5, True),
        _fproj_case(gen, 16, 256, 640, 10, True),
        # fp32 D = 32: mead-128-ldm-f4 served (8 clips x the guidance pair)
        _fproj_case(gen, 16, 1024, 160, 5, True, f32),
        _fproj_case(gen, 16, 256, 320, 10, True, f32),
        _fproj_case(gen, 16, 64, 640, 20, True, f32),
        _fproj_case(gen, 3, 200, 160, 5, False, f32),     # ragged N
        _fproj_case(gen, 2, 100, 640, 20, False, f32),    # ragged, widest
        _fproj_case(gen, 2, 70, 96, 3, False, f32),       # H*D % 64 != 0
        _fproj_case(gen, 1, 1024, 160, 5, True, f32),     # one clip's frame
    ]
    packed = [
        _packed_case(gen, 16, 4096, 4096, 5, 32, True),   # -fullattn, 64x64
        _packed_case(gen, 8, 4096, 4096, 5, 32, True),    # its first block
        _packed_case(gen, 8, 1024, 1024, 10, 32, True),   # training step
        _packed_case(gen, 8, 256, 256, 20, 32, True),
        _packed_case(gen, 8, 4096, 4096, 2, 80, True),    # -fullattn-dh64
        _packed_case(gen, 8, 1024, 1024, 5, 64, True),    # its levels 1, 2
        _packed_case(gen, 8, 256, 256, 10, 64, True),
        _packed_case(gen, 2, 1000, 1000, 5, 32, False),   # ragged N
        _packed_case(gen, 2, 333, 77, 10, 32, False),     # cross: Nk != Nq
        _packed_case(gen, 2, 200, 200, 3, 64, False),     # 64-wide heads
        _packed_case(gen, 2, 300, 300, 3, 80, False),     # H*D % 32 == 16
        _packed_case(gen, 2, 150, 150, 1, 80, False),     # one head of 80
        _packed_case(gen, 2, 333, 77, 2, 80, False),      # Nk != Nq at 80
        _packed_case(gen, 2, 64, 64, 5, 32, False),       # one q-tile exactly
        _packed_case(gen, 2, 200, 129, 5, 32, False),     # Nk = 128 + 1
        _packed_case(gen, 2, 100, 50, 3, 64, False),      # Nk < one K tile
        # fp32 D = 32: mead-128-ldm-f4 in training, batch 32
        _packed_case(gen, 32, 1024, 1024, 5, 32, True, f32),
        _packed_case(gen, 32, 256, 256, 10, 32, True, f32),
        _packed_case(gen, 32, 64, 64, 20, 32, True, f32),
        _packed_case(gen, 2, 1000, 1000, 5, 32, False, f32),   # ragged N
        _packed_case(gen, 2, 333, 77, 10, 32, False, f32),     # Nk != Nq
        _packed_case(gen, 2, 200, 129, 5, 32, False, f32),     # Nk = 128 + 1
        _packed_case(gen, 2, 200, 257, 5, 32, False, f32),     # 2 x 128 + 1
        _packed_case(gen, 3, 65, 129, 5, 32, False, f32),      # Nq = 64 + 1
        _packed_case(gen, 2, 100, 50, 3, 32, False, f32),      # Nk < 64
        _packed_lse_case(gen, 32, 1024, 1024, 5, 32),          # row 8 reads
        _packed_lse_case(gen, 2, 200, 257, 5, 32),             # its lse
        _packed_lse_case(gen, 3, 65, 129, 5, 32),
        _packed_lse_case(gen, 2, 333, 77, 10, 32),
    ]
    qout = [
        _qout_case(gen, 16, 4096, 4096, 160, 5, True),
        _qout_case(gen, 8, 4096, 4096, 160, 5, True),
        _qout_case(gen, 3, 200, 200, 320, 10, False),     # ragged N
        _qout_case(gen, 2, 300, 77, 160, 5, False),       # Nk != N
        _qout_case(gen, 2, 100, 100, 128, 2, False),      # 64-wide heads
        _qout_case(gen, 2, 256, 256, 640, 20, False),     # widest tiles
        _qout_case(gen, 2, 200, 200, 224, 7, False),      # 7 heads: G = 7
        _qout_case(gen, 2, 130, 130, 192, 6, False),      # 6: G = 6
        _qout_case(gen, 2, 130, 130, 288, 9, False),      # 9: G = 3, 3 each
        _qout_case(gen, 2, 333, 1000, 160, 5, False),     # Nk % 128 != 0
        _qout_case(gen, 2, 1000, 1000, 128, 2, False),    # N % 128, D = 64
        _qout_case(gen, 2, 150, 150, 80, 2, False, hd=64),  # C % 32 == 16
        _qout_case(gen, 8, 4096, 4096, 160, 2, True),     # -fullattn-dh64
        _qout_case(gen, 2, 300, 77, 160, 2, False),       # 80-wide, ragged
        _qout_case(gen, 2, 300, 300, 240, 3, False),      # H*D % 32 == 16
        _qout_case(gen, 2, 150, 150, 80, 1, False),       # one head of 80
        _qout_case(gen, 2, 130, 130, 1280, 40, False),    # widest: 8 x 214 KB
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
        # fp32: first-stage training, vqgan-f4 / kl-f4 at 128 px, batch 16
        _gn_case(gen, 16, 16384, 128, 1e-6, True, True, dtype=f32),
        _gn_case(gen, 16, 4096, 256, 1e-6, True, True, dtype=f32),
        _gn_case(gen, 16, 1024, 512, 1e-6, False, True, dtype=f32),  # attn
        _gn_case(gen, 3, 1000, 160, 1e-6, True, False, dtype=f32),   # ragged
        _gn_case(gen, 2, 77, 2080, 1e-6, False, False, dtype=f32),   # 3 slabs
        # fp32: mead-128-ldm-f4's UNet under DSML_PALLAS_GN=1, served (16;
        # its parameters cast to bf16 for sampling)
        _mead128(_gn_case(gen, 16, 1024, 160, 1e-5, True, True,
                          bf16_params=True, dtype=f32)),
        _mead128(_gn_case(gen, 16, 256, 960, 1e-5, True, True,
                          bf16_params=True, dtype=f32)),
        _mead128(_gn_case(gen, 16, 64, 1280, 1e-5, True, True,
                          bf16_params=True, dtype=f32)),
        # the largest row the cluster design takes at C = 160 in fp32, and
        # one row more (the three passes)
        _gn_case(gen, 2, gn_cluster_rows(160, f32), 160, 1e-5, True, False,
                 dtype=f32),
        _gn_case(gen, 2, gn_cluster_rows(160, f32) + 1, 160, 1e-5, True,
                 False, dtype=f32),
    ]
    stats = [
        _stats_case(gen, 16, 4096, 160, True),
        _stats_case(gen, 16, 1024, 640, True),
        _stats_case(gen, 16, 256, 1280, True),
        _stats_case(gen, 8, 65536, 128, True),
        _stats_case(gen, 3, 1000, 160, False),
        _stats_case(gen, 2, 77, 2080, False),
        _stats_case(gen, 16, 16384, 128, True, f32),   # first-stage training
        _stats_case(gen, 16, 4096, 256, True, f32),
        _stats_case(gen, 16, 1024, 512, True, f32),
        _stats_case(gen, 3, 1000, 160, False, f32),
        _stats_case(gen, 1, 4096, 160, True),          # the smallest grid
        # fp32: mead-128-ldm-f4's UNet under DSML_PALLAS_GN=stats, served
        _mead128(_stats_case(gen, 16, 1024, 160, True, f32)),
        _mead128(_stats_case(gen, 16, 256, 960, True, f32)),
        _mead128(_stats_case(gen, 16, 64, 1280, True, f32)),
    ]
    # shapes as [B, B*H, Nq, Nk, D]; training at batch 8
    # the first timed case of rows 5 and 7 is first-stage training's (their
    # kernels line's run); the bf16 cases are the UNet's
    flash_bwd = [
        _flash_bwd_case(gen, 16, 1, 1024, 1024, 512, True, f32),   # vqgan-f4
        _flash_bwd_case(gen, 8, 1, 4096, 4096, 512, True, f32),    # 256 px
        _flash_bwd_case(gen, 2, 1, 1000, 1000, 512, False, f32),   # ragged
        _flash_bwd_case(gen, 1, 2, 333, 77, 512, False, f32),      # Nk != Nq
        _flash_bwd_case(gen, 2, 1, 333, 333, 512, False, f32),     # 32 + 13
        # the 128-row tiles of hopper_wide_f32_bwd.cuh: Nk = 64 + 1, Nk < 64
        # on two heads, Nq and Nk just past one and two tiles
        _flash_bwd_case(gen, 2, 1, 100, 65, 512, False, f32),
        _flash_bwd_case(gen, 1, 2, 70, 9, 512, False, f32),
        _flash_bwd_case(gen, 1, 1, 130, 257, 512, False, f32),
        # the DiffusionCLIP finetune's decoder backward (affectnet-edit)
        _affectnet_clip(_flash_bwd_case(gen, 4, 1, 1024, 1024, 512, True,
                                        f32)),
        # the lip-reading finetune's prediction decode (train-mead128-tune)
        _lipread_tune(_flash_bwd_case(gen, 8, 1, 1024, 1024, 512, True,
                                      f32)),
        _flash_bwd_case(gen, 8, 10, 1024, 1024, 32, True),   # DSML_ATTN_PACKED=0
        _flash_bwd_case(gen, 8, 20, 256, 256, 32, True),
        _flash_bwd_case(gen, 2, 5, 333, 77, 32, False),      # ragged, Nk != Nq
        _flash_bwd_case(gen, 2, 3, 200, 200, 64, False),     # 64-wide heads
        _flash_bwd_case(gen, 8, 2, 4096, 4096, 80, True),    # train-dh64-split
        _flash_bwd_case(gen, 8, 5, 1024, 1024, 64, True),    # its levels 1, 2
        _flash_bwd_case(gen, 8, 10, 256, 256, 64, True),
        _flash_bwd_case(gen, 2, 1, 150, 150, 80, False),     # one head of 80
        _flash_bwd_case(gen, 2, 3, 300, 300, 80, False),     # 3 heads of 80
        _flash_bwd_case(gen, 2, 2, 333, 77, 80, False),      # Nk != Nq
        _flash_bwd_case(gen, 2, 2, 200, 129, 80, False),     # Nk = 128 + 1
        _flash_bwd_case(gen, 2, 2, 100, 50, 80, False),      # Nk < 64
        _flash_bwd_case(gen, 2, 2, 1000, 333, 80, False),    # tiles + tails
        # fp32 D = 32: mead-128-ldm-f4 in training under DSML_ATTN_PACKED=0
        # (device ms by launch at N = 1024)
        _flash_bwd_case(gen, 32, 5, 1024, 1024, 32, True, f32, device=True),
        _flash_bwd_case(gen, 32, 10, 256, 256, 32, True, f32),
        _flash_bwd_case(gen, 32, 20, 64, 64, 32, True, f32),
        _flash_bwd_case(gen, 2, 5, 333, 77, 32, False, f32),    # Nk != Nq
        _flash_bwd_case(gen, 2, 2, 1000, 333, 32, False, f32),  # tiles + tails
        _flash_bwd_case(gen, 3, 5, 65, 129, 32, False, f32),    # Nq = 64 + 1
        # the edges of the TF32 wgmma grids: long K, Nk = 128 + 1, Nq < 64
        # < Nk (one warpgroup's q), Nk < 64 < Nq (one warpgroup's keys)
        _flash_bwd_case(gen, 1, 2, 100, 2000, 32, False, f32),
        _flash_bwd_case(gen, 2, 3, 200, 129, 32, False, f32),
        _flash_bwd_case(gen, 2, 2, 50, 200, 32, False, f32),
        _flash_bwd_case(gen, 2, 2, 100, 50, 32, False, f32),
    ]
    packed_bwd = [
        _packed_bwd_case(gen, 8, 1024, 1024, 10, 32, True),  # training step
        _packed_bwd_case(gen, 8, 256, 256, 20, 32, True),
        _packed_bwd_case(gen, 8, 4096, 4096, 5, 32, True),   # -fullattn
        _packed_bwd_case(gen, 2, 1000, 1000, 5, 32, False),  # ragged N
        _packed_bwd_case(gen, 2, 333, 77, 10, 32, False),    # Nk != Nq
        _packed_bwd_case(gen, 2, 200, 200, 3, 64, False),    # 64-wide heads
        _packed_bwd_case(gen, 2, 1000, 1000, 3, 64, False),  # ragged, D = 64
        _packed_bwd_case(gen, 8, 4096, 4096, 2, 80, True),   # -fullattn-dh64
        _packed_bwd_case(gen, 8, 1024, 1024, 5, 64, True),   # its levels 1, 2
        _packed_bwd_case(gen, 8, 256, 256, 10, 64, True),
        _packed_bwd_case(gen, 2, 150, 150, 1, 80, False),    # one head of 80
        _packed_bwd_case(gen, 2, 300, 300, 3, 80, False),    # H*D % 32 == 16
        _packed_bwd_case(gen, 2, 333, 77, 2, 80, False),     # Nk != Nq
        _packed_bwd_case(gen, 2, 200, 129, 2, 80, False),    # Nk = 128 + 1
        _packed_bwd_case(gen, 2, 100, 50, 2, 80, False),     # Nk < 64
        _packed_bwd_case(gen, 2, 1000, 333, 2, 80, False),   # tiles + tails
        # fp32 D = 32: mead-128-ldm-f4 in training, batch 32
        _packed_bwd_case(gen, 32, 1024, 1024, 5, 32, True, f32),
        _packed_bwd_case(gen, 32, 256, 256, 10, 32, True, f32),
        _packed_bwd_case(gen, 32, 64, 64, 20, 32, True, f32),
        _packed_bwd_case(gen, 2, 1000, 1000, 5, 32, False, f32),  # ragged N
        _packed_bwd_case(gen, 2, 333, 77, 10, 32, False, f32),    # Nk != Nq
        _packed_bwd_case(gen, 2, 100, 50, 3, 32, False, f32),     # Nk < 64
        _packed_bwd_case(gen, 2, 200, 257, 5, 32, False, f32),    # 2 x 128 + 1
        _packed_bwd_case(gen, 3, 65, 129, 5, 32, False, f32),     # 64 + 1
    ]
    streaming = [
        _streaming_case(gen, 8, 1, 4096, 4096, 512, True),   # first stage
        _streaming_case(gen, 16, 1, 4096, 4096, 512, True),
        _streaming_case(gen, 8, 10, 1024, 1024, 32, True),   # UNet, training
        _streaming_case(gen, 1, 1, 16384, 16384, 512, True),  # streams by auto
        _streaming_case(gen, 2, 3, 333, 77, 64, False),      # ragged both ways
        _streaming_case(gen, 1, 2, 100, 5000, 64, False),    # K/V cut 40 ways
        _streaming_case(gen, 1, 2, 100, 5000, 32, False),    # the same, D = 32
        _streaming_case(gen, 2, 2, 1000, 333, 64, False),    # Nq % 128 != 0
        _streaming_case(gen, 1, 1, 64, 2000, 512, False),    # 32 ways, D = 512
        _streaming_case(gen, 2, 1, 1000, 333, 512, False),   # 6 ways, 333 keys
        _streaming_case(gen, 8, 2, 4096, 4096, 80, True),    # -dh64 level 0
        _streaming_case(gen, 8, 5, 1024, 1024, 64, True),    # levels 1, 2
        _streaming_case(gen, 8, 10, 256, 256, 64, True),
        _streaming_case(gen, 2, 1, 150, 150, 80, False),     # one head of 80
        _streaming_case(gen, 2, 3, 300, 300, 80, False),     # 3 heads of 80
        _streaming_case(gen, 2, 2, 333, 77, 80, False),      # Nk != Nq
        _streaming_case(gen, 2, 2, 200, 129, 80, False),     # Nk = 128 + 1
        _streaming_case(gen, 2, 2, 100, 50, 80, False),      # Nk < 64
        _streaming_case(gen, 1, 2, 100, 5000, 80, False),    # K/V cut 40 ways
        _streaming_case(gen, 16, 1, 1024, 1024, 512, True, f32),   # vqgan-f4
        # mead-128-ldm-f4's frozen first stage under DSML_FLASH_STREAMING=1:
        # training encodes (batch 32), served decodes (batch 8: 2 splits)
        _streaming_case(gen, 32, 1, 1024, 1024, 512, True, f32),
        _streaming_case(gen, 8, 1, 1024, 1024, 512, True, f32),
        _streaming_case(gen, 8, 1, 4096, 4096, 512, True, f32),    # 256 px
        _streaming_case(gen, 2, 1, 1000, 1000, 512, False, f32),   # ragged N
        _streaming_case(gen, 1, 1, 64, 2000, 512, False, f32),     # 32 ways
        _streaming_case(gen, 1, 2, 333, 77, 512, False, f32),      # Nk != Nq
        _streaming_case(gen, 2, 1, 100, 65, 512, False, f32),      # Nk = 64 + 1
        _streaming_case(gen, 1, 2, 70, 9, 512, False, f32),        # Nk < 64
        # fp32 D = 32: mead-128-ldm-f4 under DSML_ATTN_PACKED=0
        # DSML_FLASH_STREAMING=1, training batch 32, then served (16)
        _streaming_case(gen, 32, 5, 1024, 1024, 32, True, f32),
        _streaming_case(gen, 32, 10, 256, 256, 32, True, f32),
        _streaming_case(gen, 32, 20, 64, 64, 32, True, f32),
        _streaming_case(gen, 16, 5, 1024, 1024, 32, True, f32),
        _streaming_case(gen, 16, 20, 64, 64, 32, True, f32,
                        device=True),                              # served
        _streaming_case(gen, 16, 10, 256, 256, 32, True, f32),
        _streaming_case(gen, 12, 50, 60, 50, 32, False, f32),      # Nk < Nq
        _streaming_case(gen, 2, 5, 333, 77, 32, False, f32),       # Nk != Nq
        _streaming_case(gen, 2, 3, 200, 129, 32, False, f32),      # 128 + 1
        _streaming_case(gen, 2, 2, 100, 50, 32, False, f32),       # Nk < 64
        _streaming_case(gen, 1, 2, 100, 5000, 32, False, f32),     # 40 ways
        _streaming_case(gen, 1, 2, 100, 2000, 32, False, f32),     # 32 ways
        _streaming_case(gen, 3, 5, 65, 129, 32, False, f32),       # 64 + 1
    ]
    streaming_bwd = [
        _streaming_bwd_case(gen, 16, 1, 1024, 1024, 512, True, f32),  # vqgan
        _streaming_bwd_case(gen, 8, 1, 4096, 4096, 512, True, f32),   # 256 px
        _streaming_bwd_case(gen, 2, 1, 1000, 1000, 512, False, f32),  # ragged
        _streaming_bwd_case(gen, 1, 2, 333, 77, 512, False, f32),     # Nk != Nq
        _streaming_bwd_case(gen, 2, 1, 333, 333, 512, False, f32),    # 32 + 13
        _streaming_bwd_case(gen, 2, 1, 100, 65, 512, False, f32),     # 64 + 1
        _streaming_bwd_case(gen, 1, 2, 70, 9, 512, False, f32),       # Nk < 64
        _streaming_bwd_case(gen, 1, 1, 130, 257, 512, False, f32),    # tiles + 1
        _streaming_bwd_case(gen, 8, 10, 1024, 1024, 32, True),
        _streaming_bwd_case(gen, 8, 20, 256, 256, 32, True),
        _streaming_bwd_case(gen, 2, 3, 333, 77, 64, False),  # ragged, D = 64
        _streaming_bwd_case(gen, 2, 5, 200, 200, 32, False),
        _streaming_bwd_case(gen, 2, 5, 129, 129, 32, False),  # 128 rows + 1
        _streaming_bwd_case(gen, 2, 5, 1000, 40, 32, False),  # Nk < a tile
        _streaming_bwd_case(gen, 1, 2, 100, 5000, 32, False),  # long K
        _streaming_bwd_case(gen, 8, 2, 4096, 4096, 80, True),  # -dh64 level 0
        _streaming_bwd_case(gen, 8, 5, 1024, 1024, 64, True),  # levels 1, 2
        _streaming_bwd_case(gen, 8, 10, 256, 256, 64, True),
        _streaming_bwd_case(gen, 2, 1, 150, 150, 80, False),   # one head of 80
        _streaming_bwd_case(gen, 2, 3, 300, 300, 80, False),   # 3 heads of 80
        _streaming_bwd_case(gen, 2, 2, 333, 77, 80, False),    # Nk != Nq
        _streaming_bwd_case(gen, 2, 2, 200, 129, 80, False),   # Nk = 128 + 1
        _streaming_bwd_case(gen, 2, 2, 100, 50, 80, False),    # Nk < 64
        _streaming_bwd_case(gen, 2, 2, 1000, 333, 80, False),  # tiles + tails
        # fp32 D = 32: mead-128-ldm-f4 in training under DSML_ATTN_PACKED=0
        # DSML_FLASH_STREAMING=1, batch 32 (device ms by launch at N = 1024)
        _streaming_bwd_case(gen, 32, 5, 1024, 1024, 32, True, f32,
                            device=True),
        _streaming_bwd_case(gen, 32, 10, 256, 256, 32, True, f32),
        _streaming_bwd_case(gen, 32, 20, 64, 64, 32, True, f32),
        _streaming_bwd_case(gen, 16, 5, 1024, 1024, 32, True, f32),
        _streaming_bwd_case(gen, 2, 5, 333, 77, 32, False, f32),   # Nk != Nq
        _streaming_bwd_case(gen, 2, 3, 200, 129, 32, False, f32),  # 128 + 1
        _streaming_bwd_case(gen, 2, 2, 100, 50, 32, False, f32),   # Nk < 64
        _streaming_bwd_case(gen, 2, 2, 1000, 333, 32, False, f32),  # tails
        _streaming_bwd_case(gen, 1, 2, 100, 5000, 32, False, f32),  # long K
        _streaming_bwd_case(gen, 3, 5, 65, 129, 32, False, f32),   # 64 + 1
        _streaming_bwd_case(gen, 2, 2, 50, 200, 32, False, f32),   # 50 < 64
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
        # fp32 (TF32 products): first-stage training at 128 px, batch 16
        _conv_case(gen, 16, 128, 128, 128, 128, 3, True, False, True,
                   eps=1e-6, dtype=f32),                     # level-0 conv1
        _conv_case(gen, 16, 64, 64, 256, 256, 3, True, True, True, eps=1e-6,
                   dtype=f32),                               # conv2 + skip
        _conv_case(gen, 16, 32, 32, 512, 512, 3, True, False, True, eps=1e-6,
                   dtype=f32),
        _conv_case(gen, 16, 64, 64, 128, 256, 1, False, False, True,
                   dtype=f32),                               # 1x1, 128->256
        _conv_case(gen, 16, 32, 32, 512, 1536, 1, True, False, True, eps=1e-6,
                   silu_in=False, dtype=f32),                # AttnBlock qkv
        _conv_case(gen, 16, 32, 32, 512, 512, 1, False, True, True,
                   dtype=f32),                               # proj_out + skip
        _conv_case(gen, 16, 128, 128, 3, 128, 3, False, False, True,
                   dtype=f32),                               # stem, Cin = 3
        _conv_case(gen, 2, 13, 9, 64, 96, 3, True, True, False, dtype=f32),
        _conv_case(gen, 2, 13, 9, 64, 40, 1, True, False, False, eps=1e-6,
                   silu_in=False, dtype=f32),
        _conv_case(gen, 2, 20, 20, 9, 160, 3, False, False, False, dtype=f32),
        _conv_case(gen, 2, 9, 7, 3, 512, 3, False, False, False,
                   dtype=f32),                               # decoder stem
        # fp32: mead-128-ldm-f4's UNet under DSML_GN_EPILOGUE=1, served (16)
        _mead128(_conv_case(gen, 16, 32, 32, 160, 160, 3, True, True, True,
                            dtype=f32)),                     # norm + skip
        _mead128(_conv_case(gen, 16, 16, 16, 960, 320, 3, True, False, True,
                            dtype=f32)),
        _mead128(_conv_case(gen, 16, 8, 8, 1280, 640, 3, True, False, True,
                            dtype=f32)),                     # 8-row tiles
        _mead128(_conv_case(gen, 16, 32, 32, 9, 160, 3, False, False, True,
                            dtype=f32)),                     # stem, Cin = 9
        _mead128(_conv_case(gen, 16, 16, 16, 480, 320, 1, False, False, True,
                            dtype=f32)),                     # 1x1 skip conv
        # ragged: 105 pixels, three images of 35 in one 128-pixel tile, a
        # k-tile of 40 channels, 48 outputs of a 64-wide tile, K split
        _conv_case(gen, 3, 5, 7, 40, 48, 3, True, True, False, groups=8),
        _conv_case(gen, 3, 5, 7, 40, 48, 3, True, True, False, groups=8,
                   dtype=f32),
    ]
    # every other shape mead-128-ldm-f4's UNet sends to the kernel under
    # DSML_GN_EPILOGUE=1 at batch 16 (fp32), and its 8 x 8 level at the
    # training batch of 32: (H, Cin, Cout, K, input norm, skip)
    for b, shapes in ((16, MEAD128_CONVS), (32, MEAD128_CONVS_8X8)):
        conv += [_mead128(_conv_case(gen, b, hh, hh, cin, cout, k, norm, res,
                                     (b, hh, cin, cout) == (32, 8, 1280, 640),
                                     dtype=f32))
                 for hh, cin, cout, k, norm, res in shapes]
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


def self_attentions(unet, latent):
    """[(tokens, head width)] of every self-attention of a UNet call at
    ``latent`` x ``latent`` latents (the config's ``image_size``), from its
    own blocks."""
    from dsml_thesis_tpu_torch.models.unet import SpatialTransformer

    ds = {unet.model_channels * m: 2 ** i
          for i, m in enumerate(unet.channel_mult)}
    return [((latent // ds[m.proj_in.in_channels]) ** 2,
             m.block_0.attn1.dim_head)
            for m in unet.modules() if isinstance(m, SpatialTransformer)
            for _ in range(m.depth)]


def count_attentions(unet, latent):
    """(self-attentions the fused-projection op takes, longer ones) of a UNet
    call: the code's own routing rule on its own blocks."""
    from dsml_thesis_tpu_torch.ops.attention import fproj_one_q_block

    short = sum(fproj_one_q_block(n) for n, _ in self_attentions(unet, latent))
    return short, len(self_attentions(unet, latent)) - short


def count_auto_streams(unet, latent):
    """Self-attentions of a UNet call that the split-head dispatch sends to
    the streaming kernel under ``DSML_FLASH_STREAMING=auto`` (none in the
    shipped configs; a sequence shorter than 8 tokens in a tiny model)."""
    from dsml_thesis_tpu_torch.ops.attention import streaming_auto

    return sum(streaming_auto(n, n, d) for n, d in self_attentions(unet, latent))


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


def expected_launches(ldm, env, unet_calls, encodes, decodes, latent=None):
    """Launches of every kernel for a number of UNet calls, first-stage
    encodes and decodes under a flag set, from the model's own blocks. Under
    DSML_ATTN_PACKED=0 every UNet self-attention splits its heads and goes
    to the split-head forward (or the streaming one). ``latent`` is the
    UNet's latent size where it is not the config's (a tiled call's
    patches)."""
    latent = latent or ldm.image_size
    short, long = count_attentions(ldm.unet, latent)
    fs = ldm.first_stage
    gn_mode = env.get("DSML_PALLAS_GN", "0")
    epilogue = env.get("DSML_GN_EPILOGUE", "0")
    partial = env.get("DSML_ATTN_FPROJ_PARTIAL", "0") == "1"
    stream_mode = env.get("DSML_FLASH_STREAMING", "auto")
    streaming = stream_mode == "1"
    packed = env.get("DSML_ATTN_PACKED", "1") == "1"
    parts = ((unet_calls, ldm.unet), (encodes, fs.encoder),
             (decodes, fs.decoder))
    norms = sum(n * count_norms(net) for n, net in parts)
    # first stage: its attention blocks (3 an encode, 4 a decode at
    # num_res_blocks 2)
    split_head = (encodes * count_attn_blocks(fs.encoder)
                  + decodes * count_attn_blocks(fs.decoder))
    auto = 0
    if not packed:
        split_head += unet_calls * (short + long)
        if stream_mode == "auto":
            auto = unet_calls * count_auto_streams(ldm.unet, latent)
    return {
        "flash_attention": 0 if streaming else split_head - auto,
        "flash_attention_streaming": split_head if streaming else auto,
        "flash_attention_fproj": unet_calls * short if packed else 0,
        "flash_attention_packed": (unet_calls * long
                                   if packed and not partial else 0),
        "flash_attention_qout": unet_calls * long if packed and partial else 0,
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
    guidance-pair UNet call at batch 8 and one first-stage decode, at the
    config's latent size. A whole bf16 model compounds the kernels' rounding
    differences through its layers (an fp32 one its TF32 products):
    tolerance 5e-2 of the output's maximum."""
    from dsml_thesis_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    lat, ch = ldm.image_size, ldm.channels
    x, ctx = r(8, lat, lat, ch), r(16, 1, ldm.unet.context_dim)
    cc = r(8, lat, lat, ldm.unet.conv_in.in_channels - ch)
    t = torch.full((8,), 500, device="cuda")
    z = r(2, lat, lat, ch)

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


def phase_serve(name, cfg, ldm, env, n_requests, frames, smi, seed=0,
                dpm=None, ddim_steps=50):
    """One serve run: ``n_requests`` single-clip requests through a
    MicroBatcher of batch 8 under a flag set, DDIM-``ddim_steps``, or with
    ``dpm`` =
    (evals, order) DPM-Solver++ multistep (``evals`` UNet calls a frame).
    Returns the launch counts of the served requests alone."""
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.server import MicroBatcher, make_pipeline_runner

    batch, guidance, window = 8, 2.0, 8
    ddim = make_ddim_schedule(ldm.schedule, ddim_steps, eta=0.0)
    steps = ddim.num_steps if dpm is None else dpm[0]   # UNet calls a frame
    size = image_size(cfg)
    device = torch.device("cuda")
    chain = ({"sampler": "ddim"} if dpm is None else
             {"sampler": "dpm", "sampler_steps": dpm[0],
              "sampler_order": dpm[1]})
    pipeline = make_video_pipeline(ldm, ddim, window, guidance_scale=guidance,
                                   **chain)
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
    # frames, one UNet call a DDIM step (or DPM evaluation) and frame (the
    # guidance pair is deduplicated inside the call), one decode a frame
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
          "card": smi, "batch": batch, "frames": frames, **chain,
          "unet_calls_per_frame": steps, "guidance": guidance,
          "requests": n_requests, "checks": checks,
          "launches": launches, "launches_expected": expect,
          "seconds_per_batch": secs, "wall_seconds": round(wall, 3),
          "frames_per_s": round(n_requests * frames / wall, 4),
          "stats": batcher.stats()})
    if not all(checks.values()):
        fail(f"serve {name}: checks failed: {checks}")
    return launches


# Latents of one served batch through DPM-Solver++ on the kernel path against
# the plain path: the fp32 UNet's TF32 attention against fp32 plain versions
# (5.6e-5 of a UNet call's maximum), carried through ten evaluations whose
# x0-prediction divides by alpha_t (0.0064 at t = 1) and through the
# identity carry: 1e-2 of the latents' maximum. A wrong kernel moves latents
# by their own scale.
DPM_LATENT_REL_TOL = 1e-2
# The samplers on the card against themselves on the CPU, closed-form models:
# the same fp32 operations, reductions and transcendental functions in
# another order or another libm.
SAMPLER_REL_TOL = 1e-5


def phase_dpm_latents(name, cfg, ldm, env, frames, dpm, seed=0):
    """One served batch's latents (8 clips, ``frames`` frames, DPM-Solver++
    of ``dpm`` = (evals, order), guidance 2.0) through the kernels and
    through every kernel's plain version, from the same seed."""
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.ops import attention as A

    device = torch.device("cuda")
    pipe = make_video_pipeline(
        ldm, make_ddim_schedule(ldm.schedule, 50, eta=0.0), 8,
        guidance_scale=2.0, decode=False, sampler="dpm",
        sampler_steps=dpm[0], sampler_order=dpm[1])
    size = image_size(cfg)
    c2 = cfg["model"]["params"]["cond_stage_config_2"]["params"]
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sh: torch.randn(*sh, generator=gen, device=device)
    inputs = (r(8, frames, size, size, 3).clamp(-1, 1),
              r(8, frames + 8, c2["subspace_dim"]),
              r(8, size, size, 3).clamp(-1, 1),
              torch.arange(8, device=device) % 8)

    def run():
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        out = pipe(*inputs, gen)
        torch.cuda.synchronize()
        return out

    with flags(**env):
        A.reset_launches()
        lat_k = run()
        launched = dict(A.LAUNCHES)
    with plain_path(env):
        A.reset_launches()
        lat_p = run()
        launched_plain = dict(A.LAUNCHES)
    expect = expected_launches(ldm, env, unet_calls=frames * dpm[0],
                               encodes=2, decodes=0)
    err, rel = _compare(lat_k, lat_p)
    out = {"phase": "dpm_latents", "run": name, "flags": env,
           "evals": dpm[0], "order": dpm[1], "frames": frames,
           "shape": list(lat_k.shape), "max_abs_err": err, "rel_err": rel,
           "rel_tol": DPM_LATENT_REL_TOL,
           "latent_max": float(lat_p.abs().max()),
           "launches": launched, "launches_expected": expect}
    emit(out)
    if not (bool(torch.isfinite(lat_k).all()) and launched == expect
            and not any(launched_plain.values())
            and rel <= DPM_LATENT_REL_TOL):
        fail(f"dpm latents {name}: kernel path and plain path disagree: {out}")


def _closed_form_samplers():
    """(name, fn(device) -> tensor or (tensor, info)) of every sampler of
    the sampler layer on closed-form models at mead-128's served latent
    shape [8, 32, 32, 3]: inputs and injected noise made on the CPU and
    moved to ``device``."""
    from dsml_thesis_tpu_torch.diffusion import (ddim, dpm_solver, gaussian,
                                                 plms, schedules, tiling)

    shape = (8, 32, 32, 3)
    g = torch.Generator().manual_seed(3)
    r = lambda *sh: torch.randn(*sh, generator=g)
    x_T, x0, seq = r(*shape), r(*shape).clamp(-1, 1), r(50, *shape)
    mask = torch.zeros(shape)
    mask[:, :, :16] = 1.0
    sched = schedules.make_schedule("linear", 1000, 0.0015, 0.0205)
    short = schedules.make_schedule("linear", 50, 0.0015, 0.0205)
    d_eta = schedules.make_ddim_schedule(sched, 10, eta=0.5)
    d0 = schedules.make_ddim_schedule(sched, 10)
    smooth = lambda x, t: (0.3 * torch.tanh(x)
                           + 0.1 * torch.sin(0.01 * t.reshape(-1, 1, 1, 1)))

    def oracle(s, target):
        def eps(x, t):
            sa = schedules.extract(s.sqrt_alphas_cumprod, t, 4)
            sm = schedules.extract(s.sqrt_one_minus_alphas_cumprod, t, 4)
            return (x - sa * target) / sm + 0.05 * torch.tanh(x)
        return eps

    def on(dev, *ts):
        return [t.to(dev) for t in ts]

    def suite(dev, **kw):
        return dpm_solver.dpm_solver_sample_suite(
            sched, smooth, shape, x_T=x_T.to(dev), **kw)

    def adaptive(dev, order):
        return dpm_solver.dpm_solver_sample_adaptive(
            sched, smooth, shape, order=order, x_T=x_T.to(dev),
            return_info=True)

    def ddim_masked(dev):
        xt, tgt, m, s = on(dev, x_T, x0, mask, seq)
        return ddim.ddim_sample(d_eta, sched, oracle(sched, tgt), shape,
                                x_T=xt, mask=m, x0=tgt, temperature=0.7,
                                noise_seq=s[:10], mask_noise_seq=s[10:20])

    def inversion(dev):
        tgt, s = on(dev, x0, seq)
        lat = ddim.ddim_invert(d_eta, oracle(sched, 0.8 * tgt), tgt)
        back = ddim.ddim_reverse_from(d_eta, oracle(sched, -0.5 * tgt), lat,
                                      noise_seq=s[:10])
        edit, _ = ddim.latent_manipulation(d0, oracle(sched, tgt),
                                           oracle(sched, -tgt), tgt)
        enc = ddim.stochastic_encode(d0, tgt, torch.arange(8) % 10, s[0])
        return torch.stack([lat, back, edit, enc])

    def tiled(dev):
        xt, = on(dev, x_T)
        w = torch.linspace(-1, 1, 9).reshape(3, 3).to(dev)
        up = lambda z, L: torch.tanh(z @ w).repeat_interleave(
            4, 1).repeat_interleave(4, 2)
        params = {"ks": [16, 16], "stride": [8, 8], "tie_braker": True}
        return torch.cat([
            tiling.tiled_apply(lambda z, L: torch.tanh(z @ w), xt, params
                               ).flatten(),
            tiling.tiled_apply(up, xt, params, uf=4).flatten()])

    return [
        ("dpm_multistep_o2_x0", lambda d: suite(d, steps=20, order=2)),
        ("dpm_multistep_o3_eps_taylor_logSNR", lambda d: suite(
            d, steps=10, order=3, predict_x0=False, solver_type="taylor",
            skip_type="logSNR")),
        ("dpm_singlestep_o3_quadratic_denoise", lambda d: suite(
            d, steps=12, order=3, method="singlestep",
            skip_type="time_quadratic", denoise_to_zero=True)),
        ("dpm_singlestep_fixed_o2", lambda d: suite(
            d, steps=8, order=2, method="singlestep_fixed",
            t_start=0.9, t_end=0.01)),
        ("dpm_adaptive_o2", lambda d: adaptive(d, 2)),
        ("dpm_adaptive_o3", lambda d: adaptive(d, 3)),
        ("dpm_2m", lambda d: dpm_solver.dpm_solver_sample(
            dpm_solver.make_dpm_schedule(sched, 15),
            lambda x, t: 0.3 * torch.tanh(x) + 0.001 * t.reshape(-1, 1, 1, 1),
            shape, x_T=x_T.to(d))),
        ("plms", lambda d: plms.plms_sample(
            d0, oracle(sched, x0.to(d)), shape, x_T=x_T.to(d))),
        ("ddpm_t50", lambda d: gaussian.ddpm_p_sample_loop(
            short, oracle(short, x0.to(d)), shape, x_T=x_T.to(d),
            noise_seq=seq.to(d))),
        ("ddim_sample_masked", ddim_masked),
        ("ddim_with_intermediates", lambda d: ddim.ddim_sample_with_intermediates(
            d0, sched, oracle(sched, x0.to(d)), shape, x_T=x_T.to(d),
            log_every=3)[1]),
        ("ddim_invert_reverse_manipulate_encode", inversion),
        ("tiled_apply", tiled),
    ]


def _unet_samplers(cfg, ldm):
    """(name, UNet calls, decodes, latent size of the UNet call, fn) of each
    sampler through the model's UNet at batch 8, a few steps each, on
    random conditioning from a seed; and a dict that the adaptive solver
    fills with its info."""
    from dsml_thesis_tpu_torch.diffusion import (ddim, dpm_solver, gaussian,
                                                 plms, schedules)

    lat, ch = ldm.image_size, ldm.channels
    gen = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    shape = (8, lat, lat, ch)
    cond = {"crossattn": r(8, 1, ldm.unet.context_dim),
            "concat": r(8, lat, lat, ldm.unet.conv_in.in_channels - ch)}
    eps = lambda x, t: ldm.apply_model(x, t, cond)
    x_T, x0 = r(*shape), r(*shape).clamp(-1, 1)
    mask = torch.zeros(shape, device="cuda")
    mask[:, :, :lat // 2] = 1.0
    d3, d4 = (schedules.make_ddim_schedule(ldm.schedule, n) for n in (3, 4))
    # the cut: the DDPM chain on a 20-step schedule of the config's beta range
    p = cfg["model"]["params"]
    t20 = schedules.make_schedule("linear", 20, p["linear_start"],
                                  p["linear_end"])
    info = {}

    def adaptive():
        out, info["adaptive"] = dpm_solver.dpm_solver_sample_adaptive(
            ldm.schedule, eps, shape, order=2, x_T=x_T, max_iters=3,
            return_info=True)
        return out

    def tiled():
        """One tiled UNet call and decode (9 patches of 16 x 16 latents),
        also through every kernel's plain version."""
        def run():
            e = ldm.apply_model(x_T, torch.full((8,), 500, device="cuda"),
                                cond)
            return e, ldm.decode_first_stage(x_T, force_not_quantize=True)

        ldm.split_input_params = {"ks": [16, 16], "stride": [8, 8],
                                  "vqf": image_size(cfg) // lat}
        try:
            out = run()
            counted = dict(A.LAUNCHES)
            with plain_path({}):
                plain = run()
            A.LAUNCHES.clear()
            A.LAUNCHES.update(counted)
        finally:
            ldm.split_input_params = None
        info["tiled_rel_err"] = [_compare(o, q)[1] for o, q in zip(out, plain)]
        return out

    from dsml_thesis_tpu_torch.ops import attention as A

    return info, [
        ("plms", d4.num_steps + 1, 0, lat, lambda: plms.plms_sample(
            d4, eps, shape, x_T=x_T)),
        ("dpm_singlestep_o3_6", 6, 0, lat,
         lambda: dpm_solver.dpm_solver_sample_suite(
             ldm.schedule, eps, shape, steps=6, order=3, method="singlestep",
             x_T=x_T)),
        ("dpm_adaptive_o2", None, 0, lat, adaptive),
        ("ddim_invert_reverse", 2 * d3.num_steps, 0, lat,
         lambda: ddim.ddim_reverse_from(d3, eps, ddim.ddim_invert(d3, eps, x0))),
        ("ddim_sample_masked", d3.num_steps, 0, lat, lambda: ddim.ddim_sample(
            d3, ldm.schedule, eps, shape, gen, x_T=x_T, mask=mask, x0=x0)),
        ("tiled_apply_model_and_decode", 1, 1, 16, tiled),
        ("ddpm_t20", 20, 0, lat, lambda: gaussian.ddpm_p_sample_loop(
            t20, eps, shape, gen, x_T=x_T)),
    ]


def phase_samplers(cfg, ldm, smi):
    """Every sampler of the sampler layer on the card: against itself on the
    CPU on closed-form models (``SAMPLER_REL_TOL`` of each output's maximum,
    the adaptive solver's iterations and convergence equal), then through
    the model's fp32 UNet at batch 8 and full width, a few steps each (the
    DDPM chain on a schedule cut to T = 20; one tiled UNet call and decode,
    9 patches of 16 x 16 latents), each checked for shape, finiteness and
    its launch counts."""
    from dsml_thesis_tpu_torch.ops import attention as A

    results, ok = [], True
    for name, fn in _closed_form_samplers():
        t0 = time.monotonic()
        got, want = fn(torch.device("cuda")), fn(torch.device("cpu"))
        info = None
        if isinstance(got, tuple):
            (got, info), (want, info_cpu) = got, want
            ok &= info == info_cpu
        err, rel = _compare(got.float().cpu(), want.float())
        ok &= rel <= SAMPLER_REL_TOL and bool(torch.isfinite(got).all())
        results.append({"sampler": name, "shape": list(got.shape),
                        "max_abs_err": err, "rel_err": rel, "info": info,
                        "seconds": round(time.monotonic() - t0, 3)})
    emit({"phase": "samplers", "part": "card_vs_cpu",
          "rel_tol": SAMPLER_REL_TOL, "results": results})
    if not ok:
        fail(f"samplers: the card disagrees with the CPU: {results}")

    results = []
    info, cases = _unet_samplers(cfg, ldm)
    with torch.no_grad():
        for name, calls, decodes, latent, fn in cases:
            A.reset_launches()
            t0 = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            launched = dict(A.LAUNCHES)
            if calls is None:   # order 2: two UNet calls an iteration
                calls = 2 * info["adaptive"]["iterations"]
            expect = expected_launches(ldm, {}, unet_calls=calls, encodes=0,
                                       decodes=decodes, latent=latent)
            outs = out if isinstance(out, tuple) else (out,)
            lat = [8, ldm.image_size, ldm.image_size, ldm.channels]
            want_shapes = [lat] + decodes * [[8, image_size(cfg),
                                              image_size(cfg), 3]]
            checks = {
                "shape": [list(o.shape) for o in outs] == want_shapes,
                "finite": all(bool(torch.isfinite(o).all()) for o in outs),
                "launches": launched == expect,
            }
            if decodes:   # the tiled calls against the plain path
                checks["plain_path"] = all(
                    e <= 5e-2 for e in info["tiled_rel_err"])
            results.append({"sampler": name, "unet_calls": calls,
                            "checks": checks, "launches": launched,
                            "launches_expected": expect,
                            "seconds": round(secs, 3)})
            ok &= all(checks.values())
    emit({"phase": "samplers", "part": "unet", "card": smi, "batch": 8,
          "adaptive": info.get("adaptive"),
          "tiled_rel_err_vs_plain": info.get("tiled_rel_err"),
          "results": results})
    if not ok:
        fail(f"samplers: a sampler through the UNet failed: {results}")


# ------------------------------------------------ talking-face video eval

# the video-eval phase: the streaming script's run (clips, speakers a batch,
# frames a clip, DDIM steps), and its name in the kernels line
VIDEO_RUN = "video-eval"
VIDEO_CLIPS, VIDEO_BATCH, VIDEO_FRAMES, VIDEO_STEPS = 4, 2, 4, 10
# PSNR / SSIM on the card against the CPU: the same fp32 operations (SSIM's
# Gaussian filter a cuDNN convolution without TF32), sums in another order
METRIC_REL_TOL = 1e-5
# The FID InceptionV3's features on the card (cuDNN without TF32) against
# the CPU: fp32 convolutions through 48 layers, each summing up to 2,048 x 9
# products in another order; a wrong weight or pool moves them by their own
# scale
INCEPTION_REL_TOL = 1e-4


def random_inception_state_dict(inception, seed):
    """A pt_inception-layout state_dict of random weights from ``seed``
    whose features depend on the image, as a trained network's do: He
    normal convolutions, each BatchNorm's running statistics those of its
    convolution's output over random images (then its scale and shift moved
    off 1 and 0)."""
    torch.manual_seed(seed)
    model = inception.FIDInceptionV3()
    g = torch.Generator().manual_seed(seed)
    blocks = [m for m in model.modules()
              if isinstance(m, inception.BasicConv2d)]

    def calibrate(bn):
        def hook(module, args, out):
            bn.running_mean.copy_(out.mean(dim=(0, 2, 3)))
            bn.running_var.copy_(out.var(dim=(0, 2, 3)))
        return hook

    with torch.no_grad():
        for m in blocks:
            torch.nn.init.kaiming_normal_(m.conv.weight, generator=g,
                                          nonlinearity="relu")
        hooks = [m.conv.register_forward_hook(calibrate(m.bn))
                 for m in blocks]
        model(torch.rand(4, 299, 299, 3, generator=g) * 2 - 1)
        for h in hooks:
            h.remove()
        for m in blocks:
            m.bn.weight.add_(0.2 * torch.randn(m.bn.weight.shape,
                                               generator=g))
            m.bn.bias.add_(0.1 * torch.randn(m.bn.bias.shape, generator=g))
    return model.state_dict()


def phase_video_eval(smi, cfg, ldm, tmp, seed=0):
    """The talking-face generate-and-score path on mead-128-ldm-f4 at full
    width: ``scripts/streaming_pipeline_torch.py``'s ``main()`` on
    ``VIDEO_CLIPS`` synthetic clips (``VIDEO_BATCH`` a batch, two batches,
    ``VIDEO_FRAMES`` frames, DDIM-``VIDEO_STEPS``, guidance 2.0) with the
    weights of ``ldm`` (its first stage written as a ``--ckpt`` file, the
    rest rebuilt from the same seed), its launches against
    ``expected_launches``, batch 0's written clips against a direct
    ``make_video_pipeline`` call on the same inputs and generator (equal
    bits), the wall and device-busy ms of that batch; then
    ``progressive_sampling_torch.sample_clip`` on one clip and
    ``sample_mead_frame_torch.sample_frame`` on one frame; then the metrics
    on the generated frames: PSNR / SSIM and the FID InceptionV3's features
    (a random pt_inception-layout state_dict) on the card against the CPU,
    the features' deviation at TF32, FID / KID / PRC / IS between the two
    batches, and the edit-distance library built on this machine against
    the pure-Python distances. Returns the streaming run's launches."""
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.metrics import (fid, inception, lipread,
                                               native, psnr, ssim,
                                               to_unit_range)
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.server import batch_seed

    B, F, S, w, guidance = VIDEO_BATCH, VIDEO_FRAMES, VIDEO_STEPS, 8, 2.0
    size = image_size(cfg)
    adim = cfg["model"]["params"]["cond_stage_config_2"]["params"][
        "subspace_dim"]
    stream = _script("streaming_pipeline_torch")
    checks, out = {}, {}

    # the first stage as a --ckpt file: the script rebuilds the UNet and the
    # cond stages from the seed, as build_ldm built them, and loads this
    ckpt = os.path.join(tmp, "first_stage.pt")
    torch.save({k: v.cpu() for k, v in ldm.state_dict().items()
                if k.startswith("first_stage.")}, ckpt)
    outdir = os.path.join(tmp, "stream")
    n_batches = VIDEO_CLIPS // B
    with flags():
        A.reset_launches()
        t0 = time.monotonic()
        summary = stream.main([
            "--config", cfg["path"], "--ckpt", ckpt, "--synthetic",
            str(VIDEO_CLIPS), "--batch", str(B), "--frames", str(F),
            "--steps", str(S), "--size", str(size), "--audio-window", str(w),
            "--scale", str(guidance), "--seed", str(seed),
            "--outdir", outdir])
        torch.cuda.synchronize()
        main_wall = time.monotonic() - t0
        launched = dict(A.LAUNCHES)
    expect = expected_launches(ldm, {}, unet_calls=n_batches * F * S,
                               encodes=2 * n_batches, decodes=n_batches * F)
    checks["stream_launches"] = launched == expect
    checks["stream_frames"] = summary["frames"] == VIDEO_CLIPS * F
    written = sorted(os.listdir(outdir))
    vids = [np.load(os.path.join(outdir, n)) for n in written]
    checks["stream_shapes"] = (len(vids) == VIDEO_CLIPS and all(
        v.shape == (F, size, size, 3) and v.dtype == np.float32
        for v in vids))
    checks["stream_finite"] = all(bool(np.isfinite(v).all())
                                  and float(np.abs(v).max()) <= 1.0
                                  for v in vids)

    # batch 0 again, outside the script: the same inputs and generator
    ds = stream._SyntheticClips(VIDEO_CLIPS, size, F, w, adim)
    masked, feats, ids, labels, names, _ = stream.prepare(ds, range(B), F, w)
    pipeline = make_video_pipeline(
        ldm, make_ddim_schedule(ldm.schedule, S, eta=0.0), w,
        guidance_scale=guidance)
    to = lambda a: torch.from_numpy(a).to("cuda")

    def batch0():
        gen = torch.Generator(device="cuda").manual_seed(batch_seed(seed, 0))
        return pipeline(to(masked), to(feats), to(ids), to(labels), gen)

    with flags():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        direct = batch0()
        torch.cuda.synchronize()
        batch_wall = time.monotonic() - t0
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = batch0()
            torch.cuda.synchronize()
        busy = _device_us(prof) / 1e3
    direct = direct.float().cpu().numpy()
    checks["batch0_equal_bits"] = all(
        np.array_equal(np.load(os.path.join(outdir, f"{n}.npy")), direct[i])
        for i, n in enumerate(names))
    checks["batch0_traced_equal_bits"] = bool(np.array_equal(
        traced.float().cpu().numpy(), direct))
    out["stream"] = {
        "clips": VIDEO_CLIPS, "batch": B, "frames": F, "ddim_steps": S,
        "guidance": guidance, "main_wall_seconds": round(main_wall, 3),
        "seconds": round(summary["seconds"], 3),
        "cumulative_frames_per_s": round(summary["cumulative_frames_per_s"],
                                         4),
        "steady_frames_per_s": summary["steady_frames_per_s"],
        "lines": summary["lines"], "launches": launched,
        "launches_expected": expect,
        "batch_wall_ms": round(1e3 * batch_wall, 1),
        "batch_busy_ms": round(busy, 1),
        "batch_idle_share": round(1 - busy / (1e3 * batch_wall), 3)}

    # one clip through progressive_sampling_torch, one frame through
    # sample_mead_frame_torch
    clip_mod = _script("progressive_sampling_torch")
    frame_mod = _script("sample_mead_frame_torch")
    example = stream._SyntheticClips(1, size, F, w, adim)[0]
    with flags():
        A.reset_launches()
        t0 = time.monotonic()
        clip = clip_mod.sample_clip(
            pipeline, example, F, w,
            torch.Generator(device="cuda").manual_seed(batch_seed(seed, 0)))
        clip_s = time.monotonic() - t0
        clip_launched = dict(A.LAUNCHES)
        A.reset_launches()
        t0 = time.monotonic()
        frame = frame_mod.sample_frame(
            ldm, example["masked_image"][0], example["identity"],
            example["audio"], 2, example["class_label"], w,
            ldm.image_size, S, guidance,
            torch.Generator(device="cuda").manual_seed(seed))
        frame_s = time.monotonic() - t0
        frame_launched = dict(A.LAUNCHES)
    clip_expect = expected_launches(ldm, {}, unet_calls=F * S, encodes=2,
                                    decodes=F)
    # a frame: the masked and identity encodes of its conditioning, again
    # for the null branch's (its channel-concat streams are the same)
    frame_expect = expected_launches(ldm, {}, unet_calls=S, encodes=4,
                                     decodes=1)
    checks["clip"] = (clip.shape == (F, size, size, 3)
                      and bool(np.isfinite(clip).all())
                      and float(np.abs(clip).max()) <= 1.0)
    checks["clip_launches"] = clip_launched == clip_expect
    checks["frame"] = (frame.shape == (size, size, 3)
                       and bool(np.isfinite(frame).all())
                       and float(np.abs(frame).max()) <= 1.0)
    checks["frame_launches"] = frame_launched == frame_expect
    out["clip"] = {"shape": list(clip.shape), "seconds": round(clip_s, 3),
                   "launches": clip_launched,
                   "launches_expected": clip_expect}
    out["frame"] = {"shape": list(frame.shape), "seconds": round(frame_s, 3),
                    "launches": frame_launched,
                    "launches_expected": frame_expect}

    # the metrics on the generated frames: batch 0's clips against batch 1's
    gen_a = np.concatenate(vids[:B])
    gen_b = np.concatenate(vids[B:2 * B])
    scores = {}
    for where in ("cuda", "cpu"):
        a = to_unit_range(torch.from_numpy(gen_a).to(where))
        b = to_unit_range(torch.from_numpy(gen_b).to(where))
        scores[where] = (psnr(a, b).cpu(), ssim(a, b).cpu())
    errs = {m: _compare(scores["cuda"][i], scores["cpu"][i])[1]
            for i, m in enumerate(("psnr", "ssim"))}
    checks["psnr_ssim_match_cpu"] = all(e <= METRIC_REL_TOL
                                        for e in errs.values())
    out["psnr_ssim"] = {
        "frames": len(gen_a), "rel_err_vs_cpu": errs,
        "psnr_mean": float(scores["cuda"][0].mean()),
        "ssim_mean": float(scores["cuda"][1].mean())}

    sd = random_inception_state_dict(inception, seed)
    cpu_model = inception.convert_fid_inception(sd)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    card_fn = inception.make_feature_fn(card_model)
    cpu_fn = inception.make_feature_fn(cpu_model)
    feats = {}
    for tag, imgs in (("a", gen_a), ("b", gen_b)):
        feats[tag] = [t.cpu() for t in card_fn(imgs)]
    want = cpu_fn(gen_a)
    inc_errs = {part: _compare(feats["a"][i], want[i])[1]
                for i, part in enumerate(("pool", "logits"))}
    with cudnn_tf32():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.no_grad():
                tf32 = card_model(inception.preprocess(
                    torch.from_numpy(gen_a).to("cuda")))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    tf32_errs = {part: _compare(tf32[i].cpu(), want[i])[1]
                 for i, part in enumerate(("pool", "logits"))}
    x = torch.from_numpy(gen_a).to("cuda")
    inc_ms = time_ms(lambda: card_fn(x), 3, 1)
    checks["inception_matches_cpu"] = all(e <= INCEPTION_REL_TOL
                                          for e in inc_errs.values())
    # features that tell the frames apart (a random network whose signal
    # died would give every image the same features and FID nothing)
    spread = {tag: float(f[0].std(dim=0).mean() / f[0].abs().max())
              for tag, f in feats.items()}
    checks["inception_features_vary"] = min(spread.values()) > 1e-4
    pa, pb = feats["a"][0].double().numpy(), feats["b"][0].double().numpy()
    logits = feats["b"][1].double().numpy()
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    dist = {"fid": fid.fid_from_features(pa, pb),
            "kid": fid.kid_from_features(pa, pb),
            "prc": fid.precision_recall(pa, pb),
            "is": fid.inception_score(e / e.sum(axis=1, keepdims=True))}
    checks["fid_kid_prc_is_finite"] = bool(np.isfinite(
        [dist["fid"], *dist["kid"], *dist["prc"], *dist["is"]]).all())
    out["inception"] = {
        "images": [len(gen_a), len(gen_b)], "resized_to": 299,
        "rel_err_vs_cpu_tf32_off": inc_errs, "rel_tol": INCEPTION_REL_TOL,
        "rel_err_vs_cpu_tf32_on": tf32_errs, "pool_spread": spread,
        "feature_ms_a_batch": round(inc_ms, 3), **dist}
    del card_model, cpu_model

    # the edit-distance library, built on this machine into _build/
    t0 = time.monotonic()
    lib = native.load()
    build_s = time.monotonic() - t0
    rng = np.random.default_rng(seed)
    refs = [list(rng.integers(0, 6, rng.integers(0, 40))) for _ in range(64)]
    hyps = [list(rng.integers(0, 6, rng.integers(0, 40))) for _ in range(64)]
    dists = native.edit_distance_batch(refs, hyps)
    checks["edit_distance_native"] = (
        lib is not None and dists is not None
        and [int(d) for d in dists]
        == [lipread.edit_distance(r, h) for r, h in zip(refs, hyps)])
    out["edit_distance"] = {"library": os.path.relpath(
        native.library_path(), HERE), "build_seconds": round(build_s, 3),
        "pairs": len(refs)}
    shutil.rmtree(outdir, ignore_errors=True)
    os.remove(ckpt)
    emit({"phase": "video-eval", "run": VIDEO_RUN, "card": smi,
          "config": os.path.relpath(cfg["path"], HERE),
          "scripts": ["scripts/streaming_pipeline_torch.py",
                      "scripts/progressive_sampling_torch.py",
                      "scripts/sample_mead_frame_torch.py"],
          "checks": checks, **out})
    if not all(checks.values()):
        fail(f"video-eval: checks failed: {checks}")
    return launched


def image_size(cfg):
    """The frame size of a latent-diffusion config: its first stage's."""
    return cfg["model"]["params"]["first_stage_config"]["params"][
        "ddconfig"]["resolution"]


def synthetic_spec(cfg):
    """SyntheticDataset's fields at a config's real shapes: the talking-face
    model's five, or the AffectNet model's image and class label."""
    size = image_size(cfg)
    frame = [[size, size, 3], "float32"]
    if "cond_stage_config_2" not in cfg["model"]["params"]:
        return {"image": frame, "class_label": [[], "int32"]}
    c2 = cfg["model"]["params"]["cond_stage_config_2"]["params"]
    return {"image": frame, "masked_image": frame, "identity": frame,
            "class_label": [[], "int32"],
            "audio": [[c2["seq_len"], c2["subspace_dim"]], "float32"]}


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
    a frozen first-stage encode of the image and of each channel-concat
    stream that goes through the first stage (three for the talking-face
    model, one for the AffectNet one), and every UNet self-attention once
    forward and once backward through the packed kernels (or the split-head
    ones under DSML_ATTN_PACKED=0). The GroupNorm kernel runs forward only:
    its backward differentiates the plain version, as in the JAX package."""
    short, long = count_attentions(ldm.unet, ldm.image_size)
    encodes = 1 + sum(s.route == "concat_first_stage" for s in ldm.cond_specs)
    step = expected_launches(ldm, env, unet_calls=1, encodes=encodes,
                             decodes=0)
    # training mode has no fused branch: the packed kernels take every
    # self-attention (or, under DSML_ATTN_PACKED=0, the split-head forward
    # that expected_launches counts), and the matching backward kernel runs
    # once for each (the UNet alone: the first stage is frozen)
    step.update({"flash_attention_fproj": 0, "flash_attention_qout": 0})
    bwd = backward_kernel(env)
    if bwd == "flash_attention_bwd_packed":
        step["flash_attention_packed"] = short + long
    step[bwd] = short + long
    if bwd == "flash_attention_bwd" and env.get("DSML_FLASH_STREAMING",
                                                "auto") == "auto":
        # what the auto dispatch streams
        auto = count_auto_streams(ldm.unet, ldm.image_size)
        step[bwd] -= auto
        step["flash_attention_streaming_bwd"] = auto
    evals = expected_launches(ldm, env, unet_calls=1, encodes=encodes,
                              decodes=0)
    return {k: steps * step[k] + 2 * eval_batches * evals[k] for k in step}, step


def backward_kernel(env):
    """The attention backward kernel a UNet training step runs under a flag
    set."""
    if env.get("DSML_ATTN_PACKED", "1") == "1":
        return "flash_attention_bwd_packed"
    if env.get("DSML_FLASH_STREAMING", "auto") == "1":
        return "flash_attention_streaming_bwd"
    return "flash_attention_bwd"


def count_head_widths(unet):
    """{head width: self-attentions} of one UNet call, from its blocks."""
    from dsml_thesis_tpu_torch.models.unet import SpatialTransformer

    widths = {}
    for m in unet.modules():
        if isinstance(m, SpatialTransformer):
            d = m.block_0.attn1.dim_head
            widths[d] = widths.get(d, 0) + m.depth
    return widths


@contextlib.contextmanager
def backward_head_widths():
    """Counts, inside the block, the calls of the three attention backward
    wrappers by head width ({kernel: {width: calls}}); the wrappers run
    unchanged (the autograd Functions look them up at each backward)."""
    from unittest import mock

    from dsml_thesis_tpu_torch.ops import attention as A

    seen = {}

    def spy(name, width):
        wrapped = getattr(A, name)

        def call(*args):
            per, d = seen.setdefault(name, {}), width(*args)
            per[d] = per.get(d, 0) + 1
            return wrapped(*args)
        return mock.patch.object(A, name, call)

    with spy("flash_attention_bwd_packed",
             lambda q, *rest: q.shape[-1] // rest[5]), \
            spy("flash_attention_bwd", lambda q, *_: q.shape[-1]), \
            spy("flash_attention_streaming_bwd", lambda q, *_: q.shape[-1]):
        yield seen


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


def _script(name):
    """scripts/<name>.py as a module (its main() is the entry point a run
    drives)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _train_torch():
    """scripts/train_torch.py as a module."""
    return _script("train_torch")


# Checkpoints of a train phase's runs (2.8 GB each at the LDM's widths): the
# first run writes `last` and checks it, and its monitored (top-k) one too
# only where it is resumed (`train`, `ae-vq`); save_top_k=0 is Lightning's
# spelling of "no monitored checkpoint". The twin run, whose checks are its
# losses and gradients, writes none (`no_checkpoint_files`). One write of
# every four is left; the finetunes (`affectnet-edit`, the tune) write
# `last` alone.
NO_TOP_K = "lightning.modelcheckpoint.params.save_top_k=0"


@contextlib.contextmanager
def no_checkpoint_files():
    """Trainers write no checkpoint file inside the block."""
    from dsml_thesis_tpu_torch.training.trainer import Trainer
    from dsml_thesis_tpu_torch.training.vqgan_trainer import VQGANTrainer

    saved = Trainer.save_checkpoint, VQGANTrainer.save_checkpoint
    Trainer.save_checkpoint = VQGANTrainer.save_checkpoint = \
        lambda self, name: None
    try:
        yield
    finally:
        Trainer.save_checkpoint, VQGANTrainer.save_checkpoint = saved


# the train runs whose first run logs images once, at its last step,
# through the config's own image logger (batch_frequency set to the run's
# steps; max_images 8 as shipped; DDIM-20); the twin run logs none
IMAGE_LOG_RUNS = ("train-mead128", "train-affectnet")
IMAGE_LOG_DDIM_STEPS = 20
# the train run whose `last` checkpoint the tune phase warm-starts from
WARM_START_RUN = "train-mead128"


def warm_start_file(tmp):
    """Where phase_train keeps WARM_START_RUN's last/state.pt until the tune
    phase has read it."""
    return os.path.join(tmp, f"{WARM_START_RUN}-last-state.pt")


@contextlib.contextmanager
def timed_calls(cls, method):
    """Seconds of every call of ``cls.method`` inside the block, the card
    synchronized around each (a list the block reads after)."""
    from unittest import mock

    real, seconds = getattr(cls, method), []

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = real(self, *args, **kw)
        torch.cuda.synchronize()
        seconds.append(round(time.monotonic() - t0, 3))
        return out

    with mock.patch.object(cls, method, timed):
        yield seconds


def image_log_plan(ldm, ddim_steps=IMAGE_LOG_DDIM_STEPS):
    """(UNet calls, first-stage encodes, decodes, denoise-row length,
    diffusion-row length, rows) of one Trainer.log_images call, from the
    model and the trainer's own rules: the encode of the images and of each
    channel-concat stream through the first stage; a DDIM chain for the
    samples, one from the same start for the denoise row and, for a VQ first
    stage, one for the quantized samples; decodes of the reconstruction,
    the samples, the denoise row, each timestep of the diffusion row and the
    quantized samples."""
    from dsml_thesis_tpu_torch.diffusion import make_ddim_schedule
    from dsml_thesis_tpu_torch.models.autoencoder import VQModel
    from dsml_thesis_tpu_torch.training.trainer import diffusion_row_t

    vq = isinstance(ldm.first_stage, VQModel)
    S = make_ddim_schedule(ldm.schedule, ddim_steps).num_steps
    every = max(1, S // 4)
    denoise = len({i for i in range(S) if (S - 1 - i) % every == 0}
                  | {0, S - 1})
    diffusion = len(diffusion_row_t(ldm.schedule.num_timesteps))
    encodes = 1 + sum(s.route == "concat_first_stage" for s in ldm.cond_specs)
    rows = ["inputs", "reconstruction", "samples", "denoise_row",
            "diffusion_row"] + (["samples_x0_quantized"] if vq else [])
    return ((3 if vq else 2) * S, encodes, 3 + diffusion + vq, denoise,
            diffusion, rows)


def expected_image_log_launches(ldm, env):
    """Launches of every kernel in one Trainer.log_images call (eval-mode
    routes, no gradient)."""
    unet_calls, encodes, decodes, *_ = image_log_plan(ldm)
    return expected_launches(ldm, env, unet_calls=unet_calls,
                             encodes=encodes, decodes=decodes)


def check_image_log(logdir, step, ldm, n, size, spec):
    """The image log a run wrote at ``step``: every row of image_log_plan as
    images/<row>_step<step>.npy of its shape ([n, size, size, 3]; the
    denoise and diffusion rows their lengths), finite and within [-1, 1],
    and the conditioning grids of the batch's image streams, finite, of
    shape [n, size, size, 3]. Returns (ok, {file: shape})."""
    *_, denoise, diffusion, rows = image_log_plan(ldm)
    lead = {"denoise_row": denoise, "diffusion_row": diffusion}
    want = {r: (lead.get(r, n), size, size, 3) for r in rows}
    want.update({f"conditioning_{k}": (n, size, size, 3)
                 for k in ("shape_image", "masked_image", "identity")
                 if k in spec})
    ok, shapes = True, {}
    for row, shape in want.items():
        path = os.path.join(logdir, "images", f"{row}_step{step:08d}.npy")
        if not os.path.exists(path):
            ok, shapes[row] = False, None
            continue
        a = np.load(path)
        shapes[row] = list(a.shape)
        ok &= bool(a.shape == shape and np.isfinite(a).all()
                   and (row.startswith("conditioning_")
                        or (a.min() >= -1.0 and a.max() <= 1.0)))
    return ok, shapes


def phase_train(name, config, env, steps, smi, tmp, resume=False):
    """One train run through scripts/train_torch.py's main() at the YAML's
    own batch size. Returns the launch counts of the run (steps + one
    validation batch, and one image log in IMAGE_LOG_RUNS)."""
    from dsml_thesis_tpu_torch.config import load_config
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.training.trainer import Trainer

    train_torch = _train_torch()
    cfg = load_config([config])
    batch = cfg["data"]["params"]["batch_size"]
    spec = synthetic_spec(cfg)
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"spec": spec, "length": 64}}
    val = {"target": node["target"],
           "params": {"spec": spec, "length": batch, "seed": 1000}}
    # key=value overrides replace the YAML's MEAD dataset nodes whole (JSON is
    # YAML's flow form)
    data = [f"data.params.train={json.dumps(node)}",
            f"data.params.validation={json.dumps(val)}"]
    # the image logger runs as the YAML ships it (every 5,000 steps: never in
    # a run this short), but in IMAGE_LOG_RUNS' first run once, at its last
    # step
    log_images = name in IMAGE_LOG_RUNS
    image_log = (["lightning.callbacks.image_logger.params.batch_frequency="
                  f"{steps}"] if log_images else [])

    def run(tag, n_steps, top_k, extra=()):
        argv = ["--base", config, "-t", "--max-steps", str(n_steps),
                "--logdir", os.path.join(tmp, tag), "--name", name,
                "--seed", "0", "--no-test", "--log-every", "1", *data,
                *extra, *([] if top_k else [NO_TOP_K])]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer = train_torch.main(argv)
        torch.cuda.synchronize()
        return trainer, time.monotonic() - t0

    # an fp32 UNet (mead-128-ldm-f4) runs cuDNN's fp32 convolutions, whose
    # default weight-gradient algorithms sum in no fixed order, as in
    # first-stage training: two runs from one seed part after the first
    # update unless cuDNN is held to its deterministic algorithms
    fp32 = cfg["model"]["params"]["unet_config"]["params"].get(
        "dtype") in (None, "float32")
    with flags(**env), (deterministic_cudnn() if fp32
                        else contextlib.nullcontext()):
        A.reset_launches()   # counts below are of this run alone
        with backward_head_widths() as bwd_widths, \
                timed_calls(Trainer, "log_images") as log_seconds:
            trainer, wall = run(f"{name}-a", steps, top_k=resume,
                                extra=image_log)
        launches = dict(A.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        state = trainer._state
        bwd_widths_expected = {backward_kernel(env): {
            d: steps * n
            for d, n in count_head_widths(trainer.ldm.unet).items()}}
        losses, vals = _train_losses(trainer.logdir)
        moved = sum(not torch.equal(p, e)
                    for p, e in zip(state.params, state.ema_params))
        # warm steps, timed on the trained model: CUDA events around whole steps
        xb = trainer._to_device(next(iter(trainer.train_data)))
        step_ms = time_ms(lambda: trainer._train_step(state, xb, 0), 4, 1)
        ckpt = os.path.join(trainer.logdir, "checkpoints", "last", "state.pt")
        ckpt_bytes = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
        if log_images:
            images_ok, image_shapes = check_image_log(
                trainer.logdir, steps, trainer.ldm, trainer.log_max_images,
                image_size(cfg), spec)
            image_expect = expected_image_log_launches(trainer.ldm, env)
        resumed_step = None
        if resume:
            again = train_torch.main(
                ["--resume", trainer.logdir, "-t", "--max-steps",
                 str(steps + 1), "--no-test", "--log-every", "1"])
            resumed_step = again._state.step
            resumed_losses, _ = _train_losses(trainer.logdir)
            del again
        # the run leaves `last` (2.8 GB; `train` a top-k checkpoint beside
        # it): cleared as soon as it has been read, so that the script's peak
        # use of the temporary directory is one run's; the tune phase's warm
        # start keeps WARM_START_RUN's until it has read it
        if name == WARM_START_RUN and ckpt_bytes:
            os.replace(ckpt, warm_start_file(tmp))
        shutil.rmtree(os.path.join(tmp, f"{name}-a"))
        del trainer, state, xb
        torch.cuda.empty_cache()
        with no_checkpoint_files():
            twin, _ = run(f"{name}-b", steps, top_k=False)
        twin_losses, _ = _train_losses(twin.logdir)
        shutil.rmtree(os.path.join(tmp, f"{name}-b"))
        grads_ok, grads = _grad_check(twin, env)
        expect, per_step = expected_train_launches(twin.ldm, env, steps, 1)
        if log_images:
            expect = {k: v + image_expect[k] for k, v in expect.items()}
        del twin
        torch.cuda.empty_cache()

    checks = {
        "steps": len(losses) == steps,
        "finite": all(np.isfinite(losses)) and len(vals) == 1
        and all(np.isfinite(v) for v in vals[0].values()
                if isinstance(v, float)),
        "val_raw_and_ema": bool(vals) and "val_loss" in vals[0]
        and "val_loss_ema" in vals[0],
        "val_memory_logged": bool(vals) and vals[0].get(
            "cuda_0_peak_mib", 0) > 0,
        "parameters_moved": moved > 0,
        "launches": launches == expect,
        "backward_head_widths": bwd_widths == bwd_widths_expected,
        **({"images_logged": images_ok} if log_images else {}),
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
          "batch": batch, "cudnn_deterministic": fp32,
          "optimizer_steps": steps, "checks": checks,
          "losses": losses, "val": vals[0] if vals else None,
          "tensors_moved": moved, "launches": launches,
          "launches_expected": expect, "launches_per_step": per_step,
          "image_log": ({"launches": image_expect, "shapes": image_shapes,
                         "seconds": log_seconds} if log_images else None),
          "backward_launches_by_head_width": bwd_widths,
          "warm_step_ms": step_ms, "img_per_s": batch * 1e3 / step_ms,
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
           "quantize.embedding.weight",
           # a norm and the conv it folds into under DSML_GN_EPILOGUE
           "encoder.down_0_block_1.norm1.weight",
           "encoder.down_0_block_1.conv1.weight"),
    "AutoencoderKL": ("encoder.mid_attn_1.q.weight", "encoder.mid_attn_1.k.weight",
           "decoder.mid_attn_1.v.weight", "encoder.conv_in.weight",
           "decoder.conv_out.weight", "decoder.up_0_block_0.norm2.weight",
           "decoder.up_0_block_0.conv2.weight"),
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
    ``eval_batches`` validation batches under a flag set, from the model's
    own blocks. A step and a validation batch run the autoencoder forward
    once (one encode, one decode): every AttnBlock through the split-head
    forward kernel, every GroupNorm through the whole-row kernel under
    ``DSML_PALLAS_GN=1`` or the statistics kernel under ``stats``, and the
    convs ``count_fused_convs`` counts through the conv + statistics kernel
    under ``DSML_GN_EPILOGUE``. A step's backward launches the attention
    backward kernel once an AttnBlock (the adaptive weight's two gradients
    stop at the decoder's last conv) and nothing else: the GroupNorm kernel
    modes and the conv + statistics op differentiate their plain versions,
    as in the JAX package. Returns (the run's counts, one step's)."""
    n = count_attn_blocks(model)
    streaming = env.get("DSML_FLASH_STREAMING", "auto") == "1"
    fwd, bwd = (("flash_attention_streaming", "flash_attention_streaming_bwd")
                if streaming else ("flash_attention", "flash_attention_bwd"))
    gn_mode = env.get("DSML_PALLAS_GN", "0")
    epilogue = env.get("DSML_GN_EPILOGUE", "0")
    nets = (model.encoder, model.decoder)
    norms = sum(count_norms(net) for net in nets)
    from dsml_thesis_tpu_torch.ops.attention import LAUNCHES

    forward = dict.fromkeys(LAUNCHES, 0)
    forward.update({
        fwd: n,
        "group_norm_silu": norms if gn_mode == "1" else 0,
        "gn_channel_stats": norms if gn_mode == "stats" else 0,
        "conv_stats": sum(count_fused_convs(net, epilogue) for net in nets),
    })
    step = dict(forward, **{bwd: n})
    runs = {k: steps * step[k] + eval_batches * forward[k] for k in step}
    return runs, {k: v for k, v in step.items() if v}


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

    def run(tag, n_steps, top_k):
        argv = ["--base", config, "-t", "--max-steps", str(n_steps),
                "--logdir", os.path.join(tmp, tag), "--name", name,
                "--seed", "0", "--log-every", "1", *overrides,
                *([] if top_k else [NO_TOP_K])]
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
        trainer, wall = run(f"{name}-a", steps, top_k=resume)
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
        with no_checkpoint_files():
            twin, _ = run(f"{name}-b", steps, top_k=False)
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


# ------------------------------------------------------------------ AffectNet

def phase_affectnet(name, ldm, smi, n=8, steps=50, scale=3.0,
                    classes=(0, 1)):
    """AffectNet serving through ``reenactment.sample_class`` (the library
    call of scripts/sample_affectnet_torch.py) on affectnet-128-ldm-vq-f4
    at full width, random weights: first one guided UNet call (a batch of
    ``n`` doubled to 2n by the guidance) and one decode of ``n`` latents
    (unquantized) through the kernels against the same calls through the
    plain versions (5e-2 of the output's maximum, as ``phase_model``), then
    a class batch of ``n`` images for each class (DDIM-``steps``, guidance
    ``scale`` against the null embedding, decoded), launch counts from the
    model's own blocks, the first class again from its seed for equal bits,
    traced: its busy device time beside a class batch's wall time. Returns
    the launch counts of the class batches."""
    from torch.profiler import ProfilerActivity, profile

    from dsml_thesis_tpu_torch.diffusion import make_ddim_schedule
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.reenactment import sample_class

    gen = torch.Generator(device="cuda").manual_seed(1)
    lat, ch = ldm.image_size, ldm.channels
    x = torch.randn(n, lat, lat, ch, generator=gen, device="cuda")
    z = torch.randn(n, lat, lat, ch, generator=gen, device="cuda")
    t = torch.full((n,), 500, device="cuda")
    batch = {"class_label": torch.arange(n, device="cuda") % 8}

    def model_call():
        with torch.no_grad():
            eps = ldm.make_eps_fn(ldm.encode_conditioning(batch),
                                  ldm.null_conditioning(batch, batch_size=n),
                                  scale)(x, t)
            img = ldm.decode_first_stage(z, force_not_quantize=True)
        torch.cuda.synchronize()
        return eps.float(), img.float()

    def class_batch(c):
        g = torch.Generator(device="cuda").manual_seed(c)
        out = sample_class(ldm, c, n, steps=steps, scale=scale, generator=g)
        torch.cuda.synchronize()
        return out

    env = {}
    with flags(**env):
        A.reset_launches()
        eps_k, img_k = model_call()
        model_launches = dict(A.LAUNCHES)
    with plain_path(env):
        A.reset_launches()
        eps_p, img_p = model_call()
        plain_launches = dict(A.LAUNCHES)
    model = {"rel_tol": 5e-2, "launches": model_launches,
             "launches_expected": expected_launches(ldm, env, unet_calls=1,
                                                    encodes=0, decodes=1)}
    for part, k, p in (("unet", eps_k, eps_p), ("decode", img_k, img_p)):
        err, rel = _compare(k, p)
        model[part] = {"shape": list(k.shape), "max_abs_err": err,
                       "rel_err": rel}

    results, secs = {}, []
    with flags(**env):
        A.reset_launches()   # counts below are of the class batches alone
        for c in classes:
            t0 = time.monotonic()
            results[c] = class_batch(c).float().cpu().numpy()
            secs.append(time.monotonic() - t0)
        launches = dict(A.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = class_batch(classes[0]).float().cpu().numpy()
        busy_ms = _device_us(prof) / 1e3
    chain = make_ddim_schedule(ldm.schedule, steps).num_steps
    expect = expected_launches(ldm, env, unet_calls=len(classes) * chain,
                               encodes=0, decodes=len(classes))
    size = lat * 2 ** (len(ldm.first_stage.decoder.ch_mult) - 1)
    imgs = list(results.values())
    checks = {
        "model_agrees": all(model[k]["rel_err"] <= 5e-2
                            for k in ("unet", "decode")),
        "model_launches": model_launches == model["launches_expected"]
        and not any(plain_launches.values()),
        "shape": all(r.shape == (n, size, size, 3) for r in imgs),
        "finite": all(bool(np.isfinite(r).all()) for r in imgs),
        "range": all(float(np.abs(r).max()) <= 1.0 for r in imgs),
        "varied": all(float(r.std()) > 1e-3 for r in imgs),
        "launches": launches == expect,
        "reproducible": bool(np.array_equal(again, results[classes[0]])),
        "classes_differ": not np.array_equal(imgs[0], imgs[-1]),
    }
    wall_ms = 1e3 * secs[-1]
    emit({"phase": "serve", "run": name,
          "config": os.path.relpath(CONFIG_AFFECTNET, HERE), "card": smi,
          "classes": list(classes), "samples_per_class": n, "sampler": "ddim",
          "unet_calls_per_class": chain, "guidance": scale, "model": model,
          "checks": checks, "launches": launches,
          "launches_expected": expect,
          "seconds_per_class": [round(v, 3) for v in secs],
          "class_busy_ms": busy_ms, "class_wall_ms": wall_ms,
          "idle_share": 1.0 - busy_ms / wall_ms,
          "images_per_s": n / secs[-1]})
    if not all(checks.values()):
        fail(f"serve {name}: checks failed: {checks}")
    return launches


# a synthetic BPE merge table (the real one ships with the clip package)
BPE_MERGES = (
    "t h", "th e</w>", "f a", "fa c", "fac e</w>", "h a", "ha p", "hap p",
    "happ y</w>", "p h", "ph o", "pho t", "phot o</w>", "o f</w>", "s a",
    "sa d</w>", "a n", "an g", "ang r", "angr y</w>",
)


def write_guidance_files(tmp):
    """The finetune's guidance checkpoints from seed 0, in the layouts the
    config's keys read: a full-width CLIP ViT-B/16 in the OpenAI layout
    (``clip_ckpt``), an IR-SE50 in the reference Backbone's (``id_ckpt``)
    and a BPE merge table (``clip_bpe``). The real files are not in the
    repository; random weights keep all three losses live."""
    from dsml_thesis_tpu_torch.models import clip as C
    from dsml_thesis_tpu_torch.models.insight_face import (
        IRSE, reference_state_dict)

    torch.manual_seed(0)
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("clip_ckpt", "clip_vit_b16.pt"), ("id_ckpt", "model_ir_se50.pth"),
        ("clip_bpe", "bpe_merges.txt"))}
    torch.save(C.openai_state_dict(C.CLIP(C.CLIPConfig())), paths["clip_ckpt"])
    torch.save(reference_state_dict(IRSE()), paths["id_ckpt"])
    with open(paths["clip_bpe"], "w") as f:
        f.write("#version: 0.2\n" + "\n".join(BPE_MERGES) + "\n")
    return paths


# parameters whose gradients through the finetune's chain and decode the
# kernel path and the plain path are held to (level 0: N = 1024, row 1)
EDIT_GRAD_PROBES = (
    "unet.conv_in.weight",
    "unet.down_0_0_attn.block_0.attn1.to_q.weight",
    "unet.down_0_0_attn.block_0.attn1.to_out.weight",
    "unet.down_1_0_attn.block_0.attn1.to_q.weight",
    "unet.up_0_2_attn.block_0.attn1.to_out.weight",
    "unet.out_norm.weight",
)


def expected_edit_launches(ldm, chain, steps, eval_batches, image_logs):
    """Launches of a DiffusionCLIP finetune run, from the model's own
    blocks: a step runs the ``chain`` UNet calls of the training schedule
    and one decode under autograd (every self-attention through row 1's
    autograd ``Function``, each decoder attention block through row 2 with
    its log-sum-exp and once through row 7 in the backward); a validation
    batch runs that twice without gradients (raw and EMA weights), an image
    log once. Also returns the row-1 launches that go through the
    ``Function``."""
    def calls(n):
        return expected_launches(ldm, {}, unet_calls=n * chain, encodes=0,
                                 decodes=n)

    out = calls(steps + 2 * eval_batches + image_logs)
    out["flash_attention_bwd"] = steps * count_attn_blocks(
        ldm.first_stage.decoder)
    return out, calls(steps)["flash_attention_fproj"]


@contextlib.contextmanager
def autograd_fproj_calls():
    """Counts, inside the block, the row-1 calls that go through its
    autograd ``Function`` (the composed backward) rather than the
    no-gradient launch."""
    from unittest import mock

    from dsml_thesis_tpu_torch.ops import attention as A

    seen = {"calls": 0}
    real = A._KernelForward

    class Spy:
        @staticmethod
        def apply(launch, *args):
            seen["calls"] += launch is A._fproj_launch
            return real.apply(launch, *args)

    with mock.patch.object(A, "_KernelForward", Spy):
        yield seen


def _cache_nodes(d, n):
    """LatentTrain / LatentTest nodes over the cache in ``d``."""
    def node(split, prefix, n_samples):
        return {"target": f"ldm.data.latents.Latent{split}", "params": {
            f"{prefix}_precomputed_latents_path": os.path.join(d,
                                                               "latents.npy"),
            f"{prefix}_origin_path": os.path.join(d, "origin.npy"),
            f"{prefix}_files_path": os.path.join(d, "files.npy"),
            "n_samples": n_samples, "size": 128}}
    return node("Train", "training", None), node("Test", "test", n)


def phase_affectnet_edit(name, smi, tmp, n_images=8, steps=40, strength=0.5,
                         finetune_steps=2):
    """The editing stack of the AffectNet model at full width on the card:

    1. ``reenactment.compute_latent_cache`` (scripts/compute_latents_torch.py's
       call) of ``n_images`` synthetic images under their labels: VQ encode,
       DDIM inversion over the first ``strength`` of the chain in ``steps``
       steps, the reconstruction decoded; written as a cache.
    2. ``finetune_steps`` steps of the DiffusionCLIP finetune
       (affectnet-128-clip-ldm-vq-f4.yaml) through scripts/train_torch.py's
       ``main()`` on that cache via ``LatentTrain`` (batch 4), the l2, id and
       CLIP-direction losses live from guidance files written here, one
       validation batch and one image log; launch counts (row 1 under
       autograd through its ``Function``, row 2 with its log-sum-exp, row 7
       at [4, 1, 1024, 512]), the peak memory, a warm step's time; the first
       step's loss and a few gradients on the kernel path against the plain
       path (a fresh trainer from the same seed: the first step's weights).
    3. ``reenactment.manipulate`` (scripts/latent_manipulation_torch.py's
       call) on the finetuned model: inversion under the source class and
       the reverse chain under the target, decoded.
    Returns the phase's launch counts."""
    from dsml_thesis_tpu_torch.config import build_model, load_config
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.reenactment import (compute_latent_cache,
                                                   inversion_schedule,
                                                   manipulate)
    from dsml_thesis_tpu_torch.training.finetune_trainer import \
        FinetuneTrainer

    cfg = load_config([CONFIG_AFFECTNET])
    torch.manual_seed(0)
    ldm = build_model(cfg["model"])
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    ldm = ldm.to("cuda").eval()
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (n_images, 128, 128, 3)).astype(np.float32)
    labels = np.arange(n_images) % 8
    chain = inversion_schedule(ldm, steps, strength).num_steps
    with flags():
        A.reset_launches()
        t0 = time.monotonic()
        cache = compute_latent_cache(ldm, images, labels, steps=steps,
                                     strength=strength, reconstruct=True,
                                     batch_size=n_images)
        cache_s = time.monotonic() - t0
        cache_launches = dict(A.LAUNCHES)
    cache_expect = expected_launches(ldm, {}, unet_calls=2 * chain,
                                     encodes=1, decodes=1)
    d = os.path.join(tmp, "affectnet-cache")
    os.makedirs(d, exist_ok=True)
    for key in ("origin", "latents", "recon"):
        np.save(os.path.join(d, f"{key}.npy"), cache[key])
    np.save(os.path.join(d, "files.npy"),
            np.array([f"{l}_synthetic{i}.png" for i, l in enumerate(labels)]))
    del ldm
    torch.cuda.empty_cache()

    guidance = write_guidance_files(tmp)
    train_node, val_node = _cache_nodes(d, 4)
    argv = ["--base", CONFIG_AFFECTNET_CLIP, "-t", "--max-steps",
            str(finetune_steps), "--logdir", os.path.join(tmp, "edit"),
            "--name", name, "--seed", "0", "--no-test", "--log-every", "1",
            f"data.params.train={json.dumps(train_node)}",
            f"data.params.validation={json.dumps(val_node)}",
            "data.params.num_workers=2",
            "lightning.callbacks.image_logger.params.batch_frequency="
            f"{finetune_steps}",
            "lightning.callbacks.image_logger.params.max_images=4",
            *(f"model.params.{k}={v}" for k, v in guidance.items()),
            NO_TOP_K]
    with flags(), deterministic_cudnn():
        A.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with autograd_fproj_calls() as through_function:
            trainer = _train_torch().main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(A.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        ft, state = trainer.finetune, trainer._state
        train_ddim = ft.train_ddim.num_steps
        expect, expect_function = expected_edit_launches(
            trainer.ldm, train_ddim, finetune_steps, 1, 1)
        losses, vals = _train_losses(trainer.logdir)
        with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
            first = next(json.loads(ln) for ln in f
                         if json.loads(ln)["split"] == "train")
        live = {k: first.get(f"train/loss_{k}", 0.0)
                for k in ("l2", "id", "clip")}
        moved = sum(not torch.equal(p, e)
                    for p, e in zip(state.params, state.ema_params))
        saved_proj = torch.load(guidance["clip_ckpt"])["visual.proj"]
        towers_kept = (
            torch.equal(ft.clip_image_embed.visual.proj.cpu(), saved_proj)
            and not any(p.requires_grad
                        for tower in (ft.clip_image_embed, ft.arcface_embed)
                        for p in tower.parameters())
            and all(n.startswith("unet.") for n in state.names))
        image_log = os.path.join(trainer.logdir, "images",
                                 f"edited_step{finetune_steps:08d}.npy")
        logged = np.load(image_log) if os.path.exists(image_log) else None
        xb = trainer._to_device(next(iter(trainer.train_data)))
        # one more step, warm: the run's own steps built and chose everything
        step_ms = time_ms(lambda: trainer._train_step(state, xb, 0), 1, 0)

        fresh = FinetuneTrainer(trainer.config, os.path.join(tmp, "edit-b"),
                                seed=0, device=torch.device("cuda"))
        batch = fresh._to_device(next(iter(fresh.train_data)))
        probes = dict(fresh.ldm.named_parameters())
        fresh.ldm.configure_trainable()

        def run():
            fresh.ldm.zero_grad(set_to_none=True)
            loss, _ = fresh.finetune.training_loss(batch)
            loss.backward()
            torch.cuda.synchronize()
            grads = {n: probes[n].grad.detach().float().clone()
                     for n in EDIT_GRAD_PROBES}
            fresh.ldm.zero_grad(set_to_none=True)
            return float(loss.detach()), grads

        grads_ok, grads = _kernel_vs_plain(run, {})
        fresh.close()
        del fresh, probes, batch

        ldm = trainer.ldm.eval()
        with torch.no_grad():
            z0 = ldm.encode_first_stage(
                torch.from_numpy(images[:4]).to("cuda"))
        A.reset_launches()
        edited, _ = manipulate(ldm, inversion_schedule(ldm, steps, strength),
                               trg_label=1, src_label=0, z0=z0)
        torch.cuda.synchronize()
        manip_launches = dict(A.LAUNCHES)
        manip_expect = expected_launches(ldm, {}, unet_calls=2 * chain,
                                         encodes=0, decodes=1)
        edited = edited.float().cpu().numpy()
        trainer.close()
        del trainer, state, ft, ldm, xb
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "edit"), ignore_errors=True)
    shutil.rmtree(os.path.join(tmp, "edit-b"), ignore_errors=True)

    checks = {
        "cache_shapes": cache["latents"].shape == (n_images, 32, 32, 3)
        and cache["origin"].shape == cache["recon"].shape == images.shape,
        "cache_finite": all(bool(np.isfinite(v).all())
                            for v in cache.values()),
        "cache_launches": cache_launches == cache_expect,
        "steps": len(losses) == finetune_steps,
        "finite": all(np.isfinite(losses)) and len(vals) == 1,
        "losses_live": all(v > 0 for v in live.values()),
        "parameters_moved": moved > 0,
        "towers_and_first_stage_kept": towers_kept,
        "launches": launches == expect,
        "row1_through_autograd_function":
            through_function["calls"] == expect_function,
        "image_log": logged is not None and logged.shape == (4, 128, 128, 3),
        "kernel_path_agrees_with_plain_path": grads_ok,
        "manipulation": edited.shape == (4, 128, 128, 3)
        and bool(np.isfinite(edited).all())
        and float(np.abs(edited).max()) <= 1.0,
        "manipulation_launches": manip_launches == manip_expect,
    }
    emit({"phase": "edit", "run": name,
          "config": os.path.relpath(CONFIG_AFFECTNET_CLIP, HERE),
          "card": smi, "checks": checks,
          "cache": {"images": n_images, "steps": chain, "strength": strength,
                    "seconds": round(cache_s, 3), "launches": cache_launches,
                    "launches_expected": cache_expect},
          "finetune": {"batch": 4, "chain_steps": train_ddim,
                       "optimizer_steps": finetune_steps, "losses": losses,
                       "first_step_terms": live,
                       "val": vals[0] if vals else None,
                       "tensors_moved": moved, "launches": launches,
                       "launches_expected": expect,
                       "row1_through_function": through_function["calls"],
                       "row1_through_function_expected": expect_function,
                       "warm_step_ms": step_ms,
                       "peak_memory_bytes": peak,
                       "run_wall_seconds": round(wall, 3),
                       "gradients": grads},
          "manipulation": {"launches": manip_launches,
                           "launches_expected": manip_expect}})
    if not all(checks.values()):
        fail(f"edit {name}: checks failed: {checks}")
    return {k: cache_launches[k] + launches[k] + manip_launches[k]
            for k in launches}


# --------------------------------------------------------- talking-face audio

# The audio features on the card held to the same model on the CPU, fp32: with
# TF32 off in cuDNN and cuBLAS the two differ by the order of fp32 sums only
# (a 24-layer encoder keeps that some tens of roundings of the largest row);
# cuDNN's default TF32 rounds the conv extractor's operands to 10-bit
# mantissas (2^-11 relative each), which the encoder carries to the output at
# well under 2e-2 of its maximum, while a wrong weight, index or resample
# moves it by the order of the maximum itself.
AUDIO_REL_TOL = 1e-4
AUDIO_TF32_REL_TOL = 2e-2
# the clips of the audio-features phase: (name, seconds, video frames)
AUDIO_CLIPS = (("001", 3.0, 90), ("002", 3.2, 96))


def write_audio_tree(root, rate=48000):
    """The MEAD layout of ``AUDIO_CLIPS``: synthetic 16-bit wavs at ``rate``
    (a few tones and noise) and frame directories of empty ``*.jpg`` names,
    which the features script only counts. Returns the tuples pickle."""
    import pickle
    import wave

    rng = np.random.default_rng(0)
    subj, emo, lvl = "M003", "neutral", "level_1"
    for clip, seconds, frames in AUDIO_CLIPS:
        t = np.arange(int(rate * seconds)) / rate
        sig = (0.4 * np.sin(2 * np.pi * 180 * t)
               + 0.3 * np.sin(2 * np.pi * 1250 * t) * np.sin(2 * np.pi * 3 * t)
               + 0.05 * rng.standard_normal(len(t)))
        pcm = (sig / np.abs(sig).max() * 32000).astype(np.int16)
        wav_dir = os.path.join(root, subj, "audio", emo, lvl)
        os.makedirs(wav_dir, exist_ok=True)
        with wave.open(os.path.join(wav_dir, f"{clip}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        frame_dir = os.path.join(root, subj, "video", "front", emo, lvl, clip)
        os.makedirs(frame_dir, exist_ok=True)
        for k in range(frames):
            open(os.path.join(frame_dir, f"{k:03d}.jpg"), "w").close()
    path = os.path.join(root, "tuples.pkl")
    with open(path, "wb") as f:
        pickle.dump({(subj, emo, lvl, c) for c, _, _ in AUDIO_CLIPS}, f)
    return path


def phase_audio_features(smi, tmp, seed=0):
    """scripts/mead_audio_features_torch.py's ``main()`` on the card at full
    width, random weights from ``seed``: ``base`` (wav2vec2-base: 7 x 512
    convs, 12 layers of 768; hidden states, the CNN features resampled to
    the frame count before the encoder) and ``bundle`` (``LARGE_960H``: 24
    layers of 1024, CTC logits of 32 resampled after the model), over 48 kHz
    clips of about 3 s (``AUDIO_CLIPS``). Each clip's pickle against the
    same model on the CPU in fp32 (``AUDIO_REL_TOL`` of the maximum, TF32
    off as ``main()`` of this script sets it); then at cuDNN's default TF32
    (``AUDIO_TF32_REL_TOL``); a warm clip's ms at both. No kernel of the
    port runs here (the attention is plain ``einsum``, as in the JAX
    package): the counts stay 0."""
    import pickle

    from dsml_thesis_tpu_torch.ops import attention as A

    mod = _script("mead_audio_features_torch")
    root = os.path.join(tmp, "mead-audio")
    tuples = write_audio_tree(root)
    subj, emo, lvl = "M003", "neutral", "level_1"
    runs, checks = {}, {}
    for variant in ("base", "bundle"):
        out = os.path.join(tmp, f"features-{variant}")
        A.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mod.main(["--tuples", tuples, "--audio-root", root, "--frames-root",
                  root, "--outdir", out, "--variant", variant, "--seed",
                  str(seed)])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launched = {k: v for k, v in A.LAUNCHES.items() if v}
        cpu_model, do_norm = mod.build_model(variant, None, seed)
        card_model = copy.deepcopy(cpu_model).to("cuda")
        bundle = variant == "bundle"
        width = 32 if bundle else 768
        errs, errs_tf32, shapes, ms, ms_tf32 = {}, {}, {}, {}, {}
        for clip, _, frames in AUDIO_CLIPS:
            name = f"{subj}_{emo}_{lvl}_{clip}"
            with open(os.path.join(out, f"{name}.pkl"), "rb") as f:
                feats = pickle.load(f)
            shapes[name] = [list(feats.shape), str(feats.dtype)]
            wav = mod.normalize_audio(mod.load_wav_16k(os.path.join(
                root, subj, "audio", emo, lvl, f"{clip}.wav")), do_norm)
            ref = mod.featurize(cpu_model, wav, frames, bundle, "cpu")
            errs[name] = _compare(torch.from_numpy(feats),
                                  torch.from_numpy(ref))[1]
            fn = lambda: mod.featurize(card_model, wav, frames, bundle, "cuda")
            ms[name] = time_ms(fn, 3, 1)
            with cudnn_tf32():
                errs_tf32[name] = _compare(torch.from_numpy(fn()),
                                           torch.from_numpy(ref))[1]
                ms_tf32[name] = time_ms(fn, 3, 1)
            checks[f"{variant}_{clip}_shape"] = (
                feats.shape == (frames, width) and feats.dtype == np.float32
                and bool(np.isfinite(feats).all()))
        checks[f"{variant}_matches_cpu"] = all(
            e <= AUDIO_REL_TOL for e in errs.values())
        checks[f"{variant}_tf32_matches_cpu"] = all(
            e <= AUDIO_TF32_REL_TOL for e in errs_tf32.values())
        checks[f"{variant}_no_port_kernel"] = not launched
        runs[variant] = {
            "layers": card_model.cfg.num_layers,
            "hidden": card_model.cfg.hidden_size,
            "conv_dim": list(card_model.cfg.conv_dim),
            "ctc_vocab": card_model.cfg.ctc_vocab, "shapes": shapes,
            "rel_err_tf32_off": errs, "rel_err_cudnn_tf32": errs_tf32,
            "clip_ms_tf32_off": ms, "clip_ms_cudnn_tf32": ms_tf32,
            "main_wall_seconds": round(wall, 3), "launches": launched}
        del cpu_model, card_model
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "audio", "run": "audio-features", "card": smi,
          "script": "scripts/mead_audio_features_torch.py",
          "clips": [{"clip": c, "seconds": s, "frames": n, "rate": 48000}
                    for c, s, n in AUDIO_CLIPS],
          "rel_tol": AUDIO_REL_TOL, "tf32_rel_tol": AUDIO_TF32_REL_TOL,
          "checks": checks, "variants": runs})
    if not all(checks.values()):
        fail(f"audio features: checks failed: {checks}")


# ------------------------------------------------------- lip-reading finetune

# parameters whose gradients through the tune's chain, the prediction's
# decode and the lipreader the kernel path and the plain path are held to
TUNE_GRAD_PROBES = EDIT_GRAD_PROBES + (
    "cond.class_label.embedding.weight",
    "cond.audio.att_conv_0.weight",
)


def expected_tune_launches(ldm, chain, steps, eval_batches):
    """Launches of a lip-reading finetune run, from the model's own blocks:
    a step encodes the image and the two channel-concat streams through the
    frozen first stage, runs the ``chain`` UNet calls of the eta = 1.0 DDIM
    chain under autograd (every self-attention through row 1's autograd
    ``Function``), decodes the prediction with gradient (each decoder
    attention block through row 2 with its log-sum-exp, once through row 7
    in the backward) and the target without; a validation batch runs that
    twice without gradients (raw and EMA weights). Also returns the row-1
    launches that go through the ``Function``."""
    encodes = 1 + sum(s.route == "concat_first_stage" for s in ldm.cond_specs)

    def calls(n):
        return expected_launches(ldm, {}, unet_calls=n * chain,
                                 encodes=n * encodes, decodes=2 * n)

    out = calls(steps + 2 * eval_batches)
    out["flash_attention_bwd"] = steps * count_attn_blocks(
        ldm.first_stage.decoder)
    return out, calls(steps)["flash_attention_fproj"]


def write_lipreader_file(tmp, seed=0):
    """A random LRS3-layout ``model.pth`` (the espnet E2E model's
    ``encoder.frontend.`` keys) from ``seed``: the real file is not in the
    repository."""
    from dsml_thesis_tpu_torch.models.lipreader import (LipreaderFrontend,
                                                        reference_state_dict)

    torch.manual_seed(seed)
    path = os.path.join(tmp, "lrs3_model.pth")
    torch.save(reference_state_dict(LipreaderFrontend()), path)
    return path


def phase_lipread_tune(name, smi, tmp, steps=2):
    """The lip-reading finetune (``mead-128-ldm-f4-tune.yaml``) at full
    width on the card through scripts/train_torch.py's ``main()``: its own
    batch of 8 and 8-step eta = 1.0 chain, ``steps`` steps and one
    validation batch, with a random LRS3 lipreader written here
    (``lipread_ckpt``). The data are a synthetic node with the config's
    shapes plus ``landmarks`` [68, 2]: the card's machine has no Pillow to
    decode MEAD's JPEG frames, so the MEAD reader itself is held on the CPU
    (tests/test_torch_port_mead_data.py). The run warm-starts from the
    train phase's WARM_START_RUN checkpoint (``model.params.ckpt_path``),
    its audio stage at that model's ``seq_len`` (17: the tune YAML's 9 would
    not take a mead-128-ldm-f4 audio stage, Linear(17, 17)), and deletes the
    file once read. Checks: the model, its EMA and step 0 as saved before
    the first step (``warm_started``), the lr term present and
    finite, launch counts (row 1 under autograd through its ``Function``,
    rows 2 and 7 at [8, 1, 1024, 512]), the lipreader bit for bit as built
    and the first stage as loaded, parameters moved, the first step's loss
    and probe
    gradients kernel path against plain path on a fresh trainer (its
    codebook spread, so that the lr term is live); the peak memory and a
    warm step's ms. Returns the run's launch counts."""
    from unittest import mock

    from dsml_thesis_tpu_torch.config import load_config
    from dsml_thesis_tpu_torch.models.lipreader import \
        load_lipreader_checkpoint
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.training.finetune_trainer import \
        FinetuneTrainer
    from dsml_thesis_tpu_torch.training.trainer import Trainer

    warm = warm_start_file(tmp)
    if not os.path.exists(warm):
        fail(f"tune {name}: no {WARM_START_RUN} checkpoint to warm-start "
             "from (the train phase writes it)")
    seq_len = load_config([CONFIG_128])["model"]["params"][
        "cond_stage_config_2"]["params"]["seq_len"]
    warm_args = [f"model.params.ckpt_path={warm}",
                 f"model.params.cond_stage_config_2.params.seq_len={seq_len}"]
    cfg = load_config([CONFIG_TUNE], overrides=warm_args)
    bs = cfg["data"]["params"]["batch_size"]
    spec = dict(synthetic_spec(cfg), landmarks=[[68, 2], "float32"])
    node = {"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
            "params": {"spec": spec, "length": bs * steps}}
    val = {"target": node["target"],
           "params": {"spec": spec, "length": bs, "seed": 1000}}
    lipread = write_lipreader_file(tmp)
    argv = ["--base", CONFIG_TUNE, "-t", "--max-steps", str(steps),
            "--logdir", os.path.join(tmp, "tune"), "--name", name,
            "--seed", "0", "--no-test", "--log-every", "1",
            f"data.params.train={json.dumps(node)}",
            f"data.params.validation={json.dumps(val)}",
            "data.params.num_workers=2",
            f"model.params.lipread_ckpt={lipread}", *warm_args, NO_TOP_K]
    # the saved tensors, mapped (the optimizer's moments are never read)
    warm_sd = torch.load(warm, map_location="cpu", mmap=True,
                         weights_only=True)
    warm_checks = {}
    init_state = Trainer.init_state

    def init_and_compare(self):
        """The run's state, held to the saved one before its first step."""
        state = init_state(self)
        sd = self.ldm.state_dict()
        warm_checks.update(
            model=sd.keys() == warm_sd["model"].keys() and all(
                torch.equal(v.cpu(), warm_sd["model"][k])
                for k, v in sd.items()),
            ema=set(state.names) == set(warm_sd["ema"]) and all(
                torch.equal(e.cpu(), warm_sd["ema"][n])
                for n, e in zip(state.names, state.ema_params)),
            ema_differs_from_raw=any(
                not torch.equal(warm_sd["ema"][n], warm_sd["model"][n])
                for n in state.names),
            step_0=state.step == 0)
        return state

    with flags():
        A.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with autograd_fproj_calls() as through_function, \
                mock.patch.object(Trainer, "init_state", init_and_compare), \
                timed_calls(Trainer, "_warm_start") as warm_seconds:
            trainer = _train_torch().main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(A.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        ft, state = trainer.finetune, trainer._state
        chain = ft.ddim.num_steps
        expect, expect_function = expected_tune_launches(trainer.ldm, chain,
                                                         steps, 1)
        with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        train = [r for r in recs if r["split"] == "train"]
        vals = [r for r in recs if r["split"] == "val"]
        moved = sum(not torch.equal(p, e)
                    for p, e in zip(state.params, state.ema_params))
        reader = ft.lipreader.tower.state_dict()
        saved = load_lipreader_checkpoint(lipread).state_dict()
        reader_kept = (all(torch.equal(reader[k].cpu(), v)
                           for k, v in saved.items())
                       and not any(p.requires_grad
                                   for p in ft.lipreader.parameters()))
        first_stage_kept = all(
            torch.equal(v.cpu(), warm_sd["model"][f"first_stage.{k}"])
            for k, v in trainer.ldm.first_stage.state_dict().items())
        del saved, warm_sd
        os.remove(warm)   # read: the tune's fresh trainer below starts cold
        trained_groups = sorted({n.split(".")[0] for n in state.names})
        config = copy.deepcopy(trainer.config)
        del config["model"]["params"]["ckpt_path"]
        xb = trainer._to_device(next(iter(trainer.train_data)))
        # one more step, warm: the run's own steps built and chose everything
        step_ms = time_ms(lambda: trainer._train_step(state, xb, 0), 1, 0)
        trainer.close()
        del trainer, state, ft, xb
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(tmp, "tune"), ignore_errors=True)

        fresh = FinetuneTrainer(config, os.path.join(tmp, "tune-b"), seed=0,
                                device=torch.device("cuda"))
        batch = fresh._to_device(next(iter(fresh.train_data)))
        probes = dict(fresh.ldm.named_parameters())
        fresh.ldm.configure_trainable()
        # the codebook at its init holds every code at the origin, so every
        # latent decodes to about one image and the lipreader sees equal
        # mouths (the run's lr term reads ~1e-4); a spread codebook, as
        # build_ldm's, makes the lr term and its gradient live for the check
        torch.manual_seed(0)
        torch.nn.init.normal_(fresh.ldm.first_stage.quantize.embedding.weight)
        gen = torch.Generator(device="cuda")
        lr_terms = []

        def run():
            gen.manual_seed(7)
            fresh.ldm.zero_grad(set_to_none=True)
            loss, aux = fresh.finetune.training_loss(batch, gen)
            lr_terms.append(float(aux["lr_loss"].detach()))
            loss.backward()
            torch.cuda.synchronize()
            grads = {n: probes[n].grad.detach().float().clone()
                     for n in TUNE_GRAD_PROBES}
            fresh.ldm.zero_grad(set_to_none=True)
            return float(loss.detach()), grads

        grads_ok, grads = _kernel_vs_plain(run, {})
        fresh.close()
        del fresh, probes, batch
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "tune-b"), ignore_errors=True)

    def finite(recs, key):
        return bool(recs) and all(key in r and np.isfinite(r[key])
                                  for r in recs)

    checks = {
        "steps": len(train) == steps,
        "finite": finite(train, "train/loss") and len(vals) == 1,
        "lr_loss_present": finite(train, "train/lr_loss")
        and finite(vals, "val/lr_loss") and finite(vals, "val/l2_loss"),
        "parameters_moved": moved > 0,
        "warm_started": bool(warm_checks) and all(warm_checks.values()),
        "trains_unet_and_cond_stages": trained_groups == ["cond", "unet"],
        "lipreader_kept": reader_kept,
        "first_stage_kept": first_stage_kept,
        "launches": launches == expect,
        "row1_through_autograd_function":
            through_function["calls"] == expect_function,
        "kernel_path_agrees_with_plain_path": grads_ok,
        "lr_term_live_in_the_check": min(lr_terms) > 1e-3,
    }
    emit({"phase": "tune", "run": name,
          "config": os.path.relpath(CONFIG_TUNE, HERE), "card": smi,
          "checks": checks, "warm_start": warm_checks,
          "warm_start_seconds": warm_seconds, "batch": bs,
          "chain_steps": chain, "audio_seq_len": seq_len,
          "optimizer_steps": steps,
          "losses": [r["train/loss"] for r in train],
          "lr_losses": [r.get("train/lr_loss") for r in train],
          "val": vals[0] if vals else None, "tensors_moved": moved,
          "launches": launches, "launches_expected": expect,
          "row1_through_function": through_function["calls"],
          "row1_through_function_expected": expect_function,
          "warm_step_ms": step_ms, "peak_memory_bytes": peak,
          "run_wall_seconds": round(wall, 3), "gradients": grads,
          "check_lr_loss_kernels_plain": lr_terms})
    if not all(checks.values()):
        fail(f"tune {name}: checks failed: {checks}")
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


# the fp32 D = 32 instantiations (mead-128-ldm-f4's UNet): kernel -> the run
# that is their path; each is a sub-row of the "kernels" line
F32_NARROW = {
    "flash_attention_fproj": "mead128",
    "flash_attention": "mead128-split",
    "flash_attention_packed": "train-mead128",
    "flash_attention_bwd": "train-mead128-split",
    "flash_attention_bwd_packed": "train-mead128",
    "flash_attention_streaming": "train-mead128-streaming",
    "flash_attention_streaming_bwd": "train-mead128-streaming",
}
# the fp32 D = 512 instantiations (the first stage's attention block in
# first-stage training): kernel -> the run that is their path; a sub-row each
F32_WIDE = {
    "flash_attention": "ae-vq",
    "flash_attention_bwd": "ae-vq",
    "flash_attention_streaming": "ae-vq-streaming",
    "flash_attention_streaming_bwd": "ae-vq-streaming",
}
# the fp32 D = 512 backward at the DiffusionCLIP finetune's batch of 4 (its
# decoder, under autograd): kernel -> the run that is its path; a sub-row
F32_EDIT = {
    "flash_attention_bwd": "affectnet-edit",
}
# the fp32 D = 512 backward at the lip-reading finetune's batch of 8 (its
# prediction's decode, under autograd): kernel -> the run that is its path
F32_TUNE = {
    "flash_attention_bwd": "train-mead128-tune",
}
# the fp32 cases at mead-128-ldm-f4's UNet shapes (``_mead128``): kernel ->
# the run that is their path; a sub-row each
F32_UNET = {
    "group_norm_silu": "mead128-gn",
    "gn_channel_stats": "mead128-stats",
    "conv_stats": "mead128-epilogue",
}


def _is_f32_narrow(case):
    return case.get("dtype") == "float32" and case.get("head_dim") == 32


def _mead128(case):
    """Marks a case at mead-128-ldm-f4's fp32 UNet shapes."""
    return dict(case, config="mead-128-ldm-f4")


def _affectnet_clip(case):
    """Marks a case at the shapes of the DiffusionCLIP finetune's step."""
    return dict(case, config="affectnet-128-clip-ldm-vq-f4")


def _lipread_tune(case):
    """Marks a case at the shapes of the lip-reading finetune's step."""
    return dict(case, config="mead-128-ldm-f4-tune")


def kernels_line(cases, launches_by_run):
    """A row for each kernel (its first timed case, its launches in the run
    that is its path), a sub-row for each fp32 D = 32 and D = 512
    instantiation and one for each of GroupNorm and conv + statistics at the
    fp32 UNet's shapes (their cases alone, their launches in their own
    run)."""
    rows = []
    subrows = [(name, run, "float32, head width 32", _is_f32_narrow)
               for name, run in F32_NARROW.items()]
    subrows += [(name, run, "float32, head width 512",
                 lambda c: c.get("dtype") == "float32"
                 and c.get("head_dim") == 512 and "config" not in c)
                for name, run in F32_WIDE.items()]
    subrows += [(name, run,
                 "float32, head width 512, DiffusionCLIP finetune decode",
                 lambda c: c.get("config") == "affectnet-128-clip-ldm-vq-f4")
                for name, run in F32_EDIT.items()]
    subrows += [(name, run,
                 "float32, head width 512, lip-reading finetune decode",
                 lambda c: c.get("config") == "mead-128-ldm-f4-tune")
                for name, run in F32_TUNE.items()]
    subrows += [(name, run, "float32, mead-128-ldm-f4 UNet shapes",
                 lambda c: c.get("config") == "mead-128-ldm-f4")
                for name, run in F32_UNET.items()]
    for name, run, variant, pick in [(n, r, None, None)
                                     for n, (_, _, r) in KERNELS.items()
                                     ] + subrows:
        source, replaces, _ = KERNELS[name]
        mine = [c for c in cases[name] if variant is None or pick(c)]
        timed = [c for c in mine if "ms" in c]
        first = timed[0]
        launches = launches_by_run[run][name]
        if launches < 1:
            fail(f"kernel {name} was launched no time in run {run}")
        row = {
            "name": name, "route": "cuda",
            "source": f"dsml_thesis_tpu_torch/csrc/{source}",
            "replaces": f"dsml_thesis_tpu/ops/{replaces}",
            "launches": launches, "launches_in_run": run,
            "launches_by_run": {r: l.get(name, 0)
                                for r, l in launches_by_run.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "shape": first["shape"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "other_shapes": timed[1:],
        }
        if variant is not None:
            row["variant"] = variant
        rows.append(row)
    return {"kernels": rows}


# serve runs and model checks: (name, config, flags, requests)
RUNS = (
    ("fullattn", CONFIG_FULLATTN, {}, 16),
    ("fullattn-dh64", CONFIG_DH64, {}, 8),
    ("fullattn-dh64-split", CONFIG_DH64, {"DSML_ATTN_PACKED": "0"}, 8),
    ("fullattn-flags", CONFIG_FULLATTN,
     {"DSML_ATTN_FPROJ_PARTIAL": "1", "DSML_PALLAS_GN": "1"}, 8),
    ("headline-stats", CONFIG, {"DSML_PALLAS_GN": "stats"}, 8),
    ("headline", CONFIG, {}, 8),
    ("headline-streaming", CONFIG, {"DSML_FLASH_STREAMING": "1"}, 8),
    ("headline-epilogue-res", CONFIG, {"DSML_GN_EPILOGUE": "res"}, 8),
    ("headline-epilogue", CONFIG, {"DSML_GN_EPILOGUE": "1"}, 8),
    ("mead128", CONFIG_128, {}, 8),
    ("mead128-split", CONFIG_128, {"DSML_ATTN_PACKED": "0"}, 8),
    ("mead128-streaming", CONFIG_128,
     {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}, 8),
    ("mead128-gn", CONFIG_128, {"DSML_PALLAS_GN": "1"}, 8),
    ("mead128-epilogue", CONFIG_128, {"DSML_GN_EPILOGUE": "1"}, 8),
    ("mead128-stats", CONFIG_128, {"DSML_PALLAS_GN": "stats"}, 8),
)
# DDIM steps of each run of RUNS: each config's run without a flag serves
# the config's DDIM-50; a flag run exists to drive a kernel route, which every
# UNet call of a batch takes alike, so DDIM-10 (20 UNet calls a batch, not
# 100) drives it as well, the checks unchanged, for a fifth of the time
SERVE_DDIM_STEPS = {name: 10 if env else 50 for name, _, env, _ in RUNS}
# serve runs of the DPM-Solver++ serving mode (every run of RUNS serves
# DDIM): (name, config, flags, requests, (UNet evaluations a frame,
# order)); mead128-dpm10 runs all three update orders at full width
DPM_RUNS = (
    ("headline-dpm20", CONFIG, {}, 8, (20, 2)),
    ("mead128-dpm10", CONFIG_128, {}, 8, (10, 3)),
)
# the DPM run whose served batch is also held kernel path against plain path
DPM_LATENT_RUN = "mead128-dpm10"
# train runs: (name, config, flags, optimizer steps)
TRAIN_RUNS = (
    ("train", CONFIG, {}, 6),
    ("train-fullattn", CONFIG_FULLATTN, {}, 2),
    ("train-split", CONFIG, {"DSML_ATTN_PACKED": "0"}, 2),
    ("train-gn", CONFIG, {"DSML_PALLAS_GN": "1"}, 2),
    ("train-streaming", CONFIG,
     {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}, 2),
    ("train-epilogue", CONFIG, {"DSML_GN_EPILOGUE": "res"}, 2),
    ("train-fullattn-dh64", CONFIG_DH64, {}, 2),
    ("train-dh64-split", CONFIG_DH64, {"DSML_ATTN_PACKED": "0"}, 2),
    ("train-dh64-streaming", CONFIG_DH64,
     {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}, 2),
    ("train-mead128", CONFIG_128, {}, 2),
    ("train-mead128-split", CONFIG_128, {"DSML_ATTN_PACKED": "0"}, 2),
    ("train-mead128-streaming", CONFIG_128,
     {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}, 2),
    ("train-mead128-epilogue", CONFIG_128, {"DSML_GN_EPILOGUE": "res"}, 2),
    ("train-affectnet", CONFIG_AFFECTNET, {}, 2),
)
# the AffectNet serve run and the editing phase (names in the kernels line)
AFFECTNET_RUN, EDIT_RUN = "affectnet", "affectnet-edit"
# the lip-reading finetune's run (a name in the kernels line)
TUNE_RUN = "train-mead128-tune"
# first-stage train runs: (name, config, flags, optimizer steps)
AE_RUNS = (
    ("ae-vq", CONFIG_VQ, {}, 4),
    ("ae-vq-streaming", CONFIG_VQ, {"DSML_FLASH_STREAMING": "1"}, 2),
    ("ae-kl", CONFIG_KL, {}, 2),
    ("ae-vq-gn", CONFIG_VQ, {"DSML_PALLAS_GN": "1"}, 2),
    ("ae-kl-stats", CONFIG_KL, {"DSML_PALLAS_GN": "stats"}, 2),
    ("ae-vq-epilogue", CONFIG_VQ, {"DSML_GN_EPILOGUE": "1"}, 2),
    ("ae-kl-epilogue-res", CONFIG_KL, {"DSML_GN_EPILOGUE": "res"}, 2),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,model,serve,samplers,video,"
                            "train,audio,tune")
    ap.add_argument("--frames", type=int, default=2,
                    help="frames a clip in the serve phase")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if "tune" in phases and "train" not in phases:
        print(f"chip_smoke: --phases: the tune phase warm-starts from the "
              f"train phase's {WARM_START_RUN} checkpoint: add train",
              file=sys.stderr)
        sys.exit(2)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on the "
              "card and has no CPU mode", file=sys.stderr)
        sys.exit(2)
    # nothing is printed before the program itself is known to be here
    for config in (CONFIG, CONFIG_FULLATTN, CONFIG_DH64, CONFIG_128, CONFIG_VQ,
                   CONFIG_KL, CONFIG_AFFECTNET, CONFIG_AFFECTNET_CLIP,
                   CONFIG_TUNE):
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
    if {"model", "serve", "samplers", "video"} & set(phases):
        models = {}

        def model(config):
            if config not in models:
                cfg, ldm = build_ldm(config)
                models[config] = (dict(cfg, path=config), ldm)
            return models[config]

        for name, config, env, n_requests in RUNS:
            if not {"model", "serve"} & set(phases):
                break
            cfg, ldm = model(config)
            if "model" in phases:
                phase_model(name, ldm, env)
            if "serve" in phases:
                launches[name] = phase_serve(
                    name, cfg, ldm, env, n_requests, args.frames, smi,
                    ddim_steps=SERVE_DDIM_STEPS[name])
        for name, config, env, n_requests, dpm in DPM_RUNS:
            if not {"serve", "samplers"} & set(phases):
                break
            cfg, ldm = model(config)
            if "serve" in phases:
                launches[name] = phase_serve(name, cfg, ldm, env, n_requests,
                                             args.frames, smi, dpm=dpm)
            if "samplers" in phases and name == DPM_LATENT_RUN:
                phase_dpm_latents(name, cfg, ldm, env, args.frames, dpm)
        if "samplers" in phases:
            phase_samplers(*model(CONFIG_128), smi)
        if "video" in phases:
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_video_") as tmp:
                launches[VIDEO_RUN] = phase_video_eval(
                    smi, *model(CONFIG_128), tmp)
        if "serve" in phases:
            launches[AFFECTNET_RUN] = phase_affectnet(
                AFFECTNET_RUN, model(CONFIG_AFFECTNET)[1], smi)
        models.clear()   # free the card for the train runs
        ldm = None
        torch.cuda.empty_cache()
    if {"train", "audio", "tune"} & set(phases):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            if "train" in phases:
                for name, config, env, steps in TRAIN_RUNS:
                    launches[name] = phase_train(name, config, env, steps,
                                                 smi, tmp,
                                                 resume=(name == "train"))
                lpips_files = write_lpips_files(tmp)
                for name, config, env, steps in AE_RUNS:
                    launches[name] = phase_ae_train(
                        name, config, env, steps, smi, tmp, lpips_files,
                        resume=(name == "ae-vq"))
                launches[EDIT_RUN] = phase_affectnet_edit(EDIT_RUN, smi, tmp)
            if "audio" in phases:
                phase_audio_features(smi, tmp)
            if "tune" in phases:
                launches[TUNE_RUN] = phase_lipread_tune(TUNE_RUN, smi, tmp)
    runs = [r[0] for r in RUNS + DPM_RUNS + TRAIN_RUNS + AE_RUNS]
    if cases is None or "samplers" not in phases or "audio" not in phases \
            or not all(r in launches for r in runs + [AFFECTNET_RUN, EDIT_RUN,
                                                      TUNE_RUN, VIDEO_RUN]):
        return
    emit(kernels_line(cases, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
