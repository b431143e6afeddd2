"""Measurements of the port on the GPU, beyond what chip_smoke.py checks.

    python -m dsml_thesis_tpu_torch.tools.measure --gate --profile --train \
        [--config configs/latent-diffusion/mead-256-ldm-f4-fullattn.yaml]

--gate     the routes of one CrossAttention module's self-attention, in
           turns, CUDA events, median of the rounds: the fused-projection op
           against linears + packed kernel + linear at the UNet's two short
           shapes and batch 1, 2, 8, 16; and at N = 4096 (batch 8 and 16)
           the three routes fused-projection op, linears + packed kernel,
           linears + q/out-fused kernel; and the two split-head kernels
           (DSML_FLASH_STREAMING=0 / 1) at the first stage's [8, 1, 4096, 512]
--profile  one warm batch of a model config (default mead-256-ldm-f4; batch
           8 at the config's frame size, DDIM-50, guidance 2.0, random
           weights; --sampler dpm --sampler-steps N --sampler-order K serves
           DPM-Solver++ multistep instead, N UNet calls a frame) under the
           DSML_* flags
           of the environment: phase times from CUDA events, then one UNet
           call and one frame under torch.profiler: kernels launched a call,
           device time by kernel family and the device's idle share (traced,
           and estimated against the same frame's untraced wall time)
--train    training steps of a model config on synthetic batches at the real
           shapes (the YAML's batch size and frame size: batch 8 at 256 px
           for mead-256-*, 32 at 128 px for mead-128-ldm-f4; audio [17, 768];
           fp32 parameters, the config's compute type) under the DSML_* flags
           of the environment, through the
           port's own train step: ms a warm step by CUDA events and img/s,
           the step's parts (frozen encodes, forward, backward, AdamW + EMA)
           by events, peak memory, kernel launches a step, then one step
           under torch.profiler: kernels launched, device time by kernel
           family and the device's idle share
--split    the launches of the Hopper-redesigned kernels, each call under
           torch.profiler: device ms of each kernel name a call for the
           fused-projection op (projection GEMM, attention + output
           projection) at [16, 1024, 320] x 10, [8, 1024, 320] x 10,
           [16, 256, 640] x 20, the packed backward (delta, dk / dv grid,
           dq grid) at [8, 1024, 10 x 32], [8, 256, 20 x 32],
           [8, 4096, 5 x 32], the q/out-fused op at [8, 4096, 160] and
           [16, 4096, 160] x 5, the streaming forward (the split
           kernel, and the combine kernel where the K / V stream is cut)
           at [8, 10, 1024, 32], [8, 20, 256, 32] and [1, 2, 100, 5000, 32],
           the packed forward at [16, 4096, 5 x 32], [8, 4096, 5 x 32],
           [8, 4096, 2 x 80] and [8, 1024, 10 x 32], the streaming
           backward (lse, delta, dk / dv grid, dq grid) at [8, 10, 1024, 32],
           [8, 20, 256, 32] and [8, 2, 4096, 80], the packed backward at
           [8, 4096, 2 x 80], the streaming forward at [8, 2, 4096, 80], and
           the split-head forward (the packed forward's grid on one head)
           and backward (the packed backward's grids on one head) at
           [8, 10, 1024, 32], [8, 20, 256, 32] and [8, 2, 4096, 80], and
           the fp32 packed forward (images, attention) and backward
           (images with delta, dk / dv grid, dq grid) at [32, 1024, 5 x 32],
           and the fp32 split-head and streaming forwards (images,
           attention) and backwards (images with delta, the streaming
           one's log-sum-exp grid, dk / dv grid, dq grid) at
           [32, 5, 1024, 32]
--ae CFG   first-stage training steps of an autoencoder config
           (configs/autoencoder/vqgan-f4.yaml or kl-f4.yaml: fp32, batch 16,
           128 px, random weights and LPIPS from seed 0, disc_start 0 so
           that the GAN term and its adaptive weight run) under the DSML_*
           flags of the environment, through the port's own fused step: ms a
           warm step by CUDA events over 10 steps and img/s, kernel launches
           a step, peak memory, then one step under torch.profiler: kernels
           launched, device-busy ms, device time by kernel family and the
           device's idle share
--affectnet  one warm class batch of affectnet-128-ldm-vq-f4 (8 images,
           DDIM-50, guidance 3.0 as a batch of 16, random weights cast for
           sampling, through reenactment.sample_class) by CUDA events, then
           one batch untraced and one under torch.profiler: kernels
           launched, device time by family and the idle share
--finetune one warm step of the DiffusionCLIP finetune
           (affectnet-128-clip-ldm-vq-f4: batch 4, the 6-step chain and the
           decode under autograd, random full-width CLIP ViT-B/16 and
           IR-SE50 towers and a random direction table handed in) through
           the port's train step: ms a warm step by CUDA events, the
           forward and the backward by events, peak memory, launches a step,
           then one step under torch.profiler as --train's
--lipread  one warm step of the lip-reading finetune
           (mead-128-ldm-f4-tune: batch 8, the 8-step eta = 1.0 chain and
           the prediction's decode under autograd, a random LRS3 lipreader
           on 88 px mouths) through the port's train step: ms a warm step
           by CUDA events, the forward and the backward by events, peak
           memory, launches a step, then one step under torch.profiler as
           --train's (wall, busy, idle share, kernels, device time by
           family)

Prints one JSON line per measurement, each with the card's name and power
limit. Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from .. import cli
from ..config import build_model, load_config
from ..diffusion import make_ddim_schedule, make_video_pipeline
from ..flags import KERNEL_FLAGS
from ..models.unet import CrossAttention
from ..ops import attention as A
from ..utils_io import cast_sampling_params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "latent-diffusion",
                      "mead-256-ldm-f4.yaml")
PARTIAL = "DSML_ATTN_FPROJ_PARTIAL"
CONFIG_AFFECTNET = os.path.join(ROOT, "configs", "latent-diffusion",
                                "affectnet-128-ldm-vq-f4.yaml")
CONFIG_AFFECTNET_CLIP = os.path.join(ROOT, "configs", "latent-diffusion",
                                     "affectnet-128-clip-ldm-vq-f4.yaml")
CONFIG_TUNE = os.path.join(ROOT, "configs", "latent-diffusion",
                           "mead-128-ldm-f4-tune.yaml")


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


def _in_turns(routes: dict, rounds: int = 5, iters: int = 20) -> dict:
    """Median and range of each route's ms a call, the routes timed in turns
    (a, b, c, c, b, a a round) after a warm-up."""
    for fn in routes.values():
        event_ms(fn, 5)
    times = {name: [] for name in routes}
    order = list(routes) + list(routes)[::-1]
    for _ in range(rounds):
        for name in order:
            times[name].append(event_ms(routes[name], iters))
    out = {}
    for name, t in times.items():
        out[f"{name}_ms"] = statistics.median(t)
        out[f"{name}_ms_range"] = [min(t), max(t)]
    return out


def gate(smi: str):
    """Routes of the same CrossAttention module's self-attention. The route
    is chosen as the serving path chooses it, by the module's own rule and
    flags; here the rule's constant and the flag are set around each call."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def routed(attn, x, max_tokens, partial):
        def call():
            saved = A.FPROJ_MAX_TOKENS, os.environ.get(PARTIAL)
            A.FPROJ_MAX_TOKENS, os.environ[PARTIAL] = max_tokens, partial
            try:
                return attn(x)
            finally:
                A.FPROJ_MAX_TOKENS = saved[0]
                if saved[1] is None:
                    del os.environ[PARTIAL]
                else:
                    os.environ[PARTIAL] = saved[1]
        return call

    for n, c, heads, batches in ((1024, 320, 10, (1, 2, 8, 16)),
                                 (256, 640, 20, (1, 2, 8, 16)),
                                 (4096, 160, 5, (8, 16))):
        attn = CrossAttention(c, None, heads, c // heads, dtype=torch.bfloat16)
        attn = cast_sampling_params(attn).cuda().eval()
        for b in batches:
            x = torch.randn(b, n, c, generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            routes = {"fused": routed(attn, x, n, "0"),
                      "packed": routed(attn, x, 0, "0")}
            if n > 1024:
                routes["qout"] = routed(attn, x, 0, "1")
            with torch.no_grad():
                A.reset_launches()
                outs = {name: fn().float() for name, fn in routes.items()}
                launched = dict(A.LAUNCHES)
                res = _in_turns(routes)
            print(json.dumps({
                "measure": "gate", "card": smi, "shape": [b, n, c, heads],
                **res, "launches_of_one_call_each": launched,
                "max_abs_diff_from_fused": {
                    name: (o - outs["fused"]).abs().max().item()
                    for name, o in outs.items() if name != "fused"}}),
                flush=True)

    # the split-head dispatch's two kernels on the first stage's attention
    q, k, v = (torch.randn(8, 1, 4096, 512, generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    routes = {"resident": lambda: A.flash_attention(q, k, v),
              "streaming": lambda: A.flash_attention_streaming(q, k, v)}
    with torch.no_grad():
        A.reset_launches()
        outs = {name: fn().float() for name, fn in routes.items()}
        launched = dict(A.LAUNCHES)
        res = _in_turns(routes)
    print(json.dumps({
        "measure": "gate", "card": smi, "shape": list(q.shape), **res,
        "launches_of_one_call_each": launched,
        "max_abs_diff_from_resident":
            (outs["streaming"] - outs["resident"]).abs().max().item()}),
        flush=True)


_FAMILIES = (
    # row 5's fp32 D = 32 log-sum-exp grid past the N = 64 level
    # (hopper_narrow_f32.cuh on split heads)
    ("streaming_bwd_lse_f32_kernel",
     "attention backward: streaming log-sum-exp"),
    # the fp32 D = 32 split-head and streaming forwards of rows 2 and 4 past
    # the N = 64 level (hopper_narrow_f32.cuh on split heads)
    ("split_images_f32_kernel",
     "attention: flash_attention (fp32 D = 32: images)"),
    ("split_attention_f32_kernel", "attention: flash_attention (fp32 D = 32)"),
    ("streaming_images_f32_kernel",
     "attention: streaming (fp32 D = 32: images)"),
    ("streaming_attention_f32_kernel", "attention: streaming (fp32 D = 32)"),
    # the fp32 D = 32 packed rows 3 and 8 (hopper_narrow_f32.cuh's images
    # and TF32 wgmma grids, or attention_f32_narrow.cuh's at N <= 64), and
    # the backward grids of rows 7 and 5 (packed_, split_, streaming_bwd_*)
    ("packed_images_f32_kernel", "attention: packed (fp32 D = 32: images)"),
    ("bwd_images_f32_kernel",
     "attention backward: fp32 D = 32 images + delta"),
    ("packed_attention_f32", "attention: packed (fp32 D = 32)"),
    ("bwd_dkdv_f32_kernel", "attention backward: dk / dv grid"),
    ("bwd_dq_f32_kernel", "attention backward: dq grid"),
    # the other fp32 D = 32 kernels (flash_attention_fproj.cu's TF32 wgmma
    # pair, attention_f32_narrow.cuh)
    ("fproj_qkv_tf32_kernel", "attention: fproj (fp32 D = 32: projections)"),
    ("fproj_attend_tf32_kernel",
     "attention: fproj (fp32 D = 32: attention + to_out)"),
    ("flash_fwd_f32_narrow_kernel", "attention: flash_attention (fp32 D = 32)"),
    ("streaming_fwd_f32_narrow_kernel", "attention: streaming (fp32 D = 32)"),
    ("streaming_lse_f32_narrow_kernel",
     "attention backward: streaming log-sum-exp"),
    ("dkdv_f32_narrow_kernel", "attention backward: dk / dv grid"),
    ("dq_f32_narrow_kernel", "attention backward: dq grid"),
    ("delta_f32_narrow_kernel", "attention backward: delta"),
    ("flash_fwd_f32_kernel", "attention: flash_attention (fp32)"),
    ("streaming_fwd_f32_kernel", "attention: streaming (fp32)"),
    ("streaming_lse_f32_kernel", "attention backward: streaming log-sum-exp"),
    ("bwd_delta_f32_kernel", "attention backward: delta"),
    # the fp32 D = 512 backwards (hopper_wide_f32_bwd.cuh)
    ("bwd_wide_f32_images_kernel", "attention backward: fp32 D = 512 images"),
    ("bwd_wide_f32_scores_kernel", "attention backward: fp32 D = 512 scores"),
    ("bwd_wide_f32_grads_kernel",
     "attention backward: fp32 D = 512 gradient GEMMs"),
    ("fproj_attention_kernel", "attention: fproj (attention + to_out)"),
    ("qkv_proj_kernel", "attention: fproj (q, k, v projection)"),
    ("flash_attention_kernel", "attention: flash_attention"),
    ("streaming_wide_kernel", "attention: streaming"),
    ("streaming_wgmma_kernel", "attention: streaming"),
    ("streaming_combine_kernel", "attention: streaming"),
    ("streaming_lse_kernel", "attention backward: streaming log-sum-exp"),
    ("hbwd::dkdv_kernel", "attention backward: dk / dv grid"),
    ("hbwd::dq_kernel", "attention backward: dq grid"),
    ("conv_stats_kernel", "conv + statistics kernel"),
    ("conv_stats_finish_kernel", "conv + statistics kernel"),
    ("packed_attention_kernel", "attention: packed"),
    ("bwd_delta_kernel", "attention backward: delta"),
    ("multi_tensor", "optimizer / EMA (foreach)"),
    ("qout_attention_kernel", "attention: qout (q proj + attention + to_out)"),
    ("gn_stats_cluster_kernel", "GroupNorm kernels: statistics"),
    ("gn_partial_kernel", "GroupNorm kernels: statistics"),
    ("gn_finish_kernel", "GroupNorm kernels: statistics"),
    ("gn_apply_kernel", "GroupNorm kernels: apply"),
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


def _by_family(kernels: dict, field: int) -> dict:
    """Device ms (field 0) or launches (field 1) of a profile's kernels,
    summed by family."""
    fams = {}
    for name, rec in kernels.items():
        fams[_family(name)] = fams.get(_family(name), 0) + rec[field]
    return fams


_ANNOTATION = re.compile(r"^[\w.]+#[\w.]+$")


def is_annotation(name: str) -> bool:
    """Whether a device record of a torch.profiler trace is an annotation
    that PyTorch mirrors onto the device track (``ProfilerStep#1``,
    ``Optimizer.step#AdamW.step``: it spans kernels, so summing it counts
    them twice) rather than a kernel. A kernel's own name may hold '#'
    (``void at::native::...{lambda()#3}...``) and is a kernel. The one rule
    of every device-time sum of the port's tools and of ``chip_smoke.py``."""
    return bool(_ANNOTATION.match(name))


def _device_kernels(prof) -> dict:
    """name -> (device ms, launches) of every kernel a profile recorded
    (annotations left out: ``is_annotation``)."""
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if (dev_us > 0 and ev.device_type.name == "CUDA"
                and not is_annotation(ev.key)):
            out[ev.key] = (dev_us / 1e3, ev.count)
    return out


def split(smi: str, calls: int = 10):
    """Device ms of each kernel a call of rows 1-8 launches, from ``calls``
    warm calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape, s=1.0, dtype=torch.bfloat16: (
        torch.randn(*shape, generator=gen, device="cuda") * s).to(dtype)

    def fproj(b, n, c, heads):
        h = rnd(b, n, c)
        wq, wk, wv = (rnd(c, c, s=c ** -0.5) for _ in range(3))
        wo, bo = rnd(c, c, s=c ** -0.5), rnd(c, s=0.1)
        return lambda: A.flash_attention_fproj(h, wq, wk, wv, wo, bo, heads)

    def packed_bwd(b, n, heads, d, dtype=torch.bfloat16):
        q, k, v, do = (rnd(b, n, heads * d, dtype=dtype) for _ in range(4))
        scale = d ** -0.5
        out, lse = A._launch_packed_forward(q, k, v, heads, scale, True)
        return lambda: A.flash_attention_bwd_packed(q, k, v, out, lse, do,
                                                    heads, scale)

    def qout(b, n, c, heads):
        h, k, v = rnd(b, n, c), rnd(b, n, c), rnd(b, n, c)
        wq, wo = rnd(c, c, s=c ** -0.5), rnd(c, c, s=c ** -0.5)
        bo = rnd(c, s=0.1)
        return lambda: A.flash_attention_qout(h, k, v, wq, wo, bo, heads)

    def streaming(b, h, nq, nk, d, dtype=torch.bfloat16):
        q, k, v = (rnd(b, h, n, d, dtype=dtype) for n in (nq, nk, nk))
        return lambda: A.flash_attention_streaming(q, k, v)

    def packed(b, n, heads, d, dtype=torch.bfloat16):
        q, k, v = (rnd(b, n, heads * d, dtype=dtype) for _ in range(3))
        return lambda: A.flash_attention_packed(q, k, v, heads)

    def streaming_bwd(b, h, n, d, dtype=torch.bfloat16):
        q, k, v, do = (rnd(b, h, n, d, dtype=dtype) for _ in range(4))
        out = A.flash_attention_streaming(q, k, v)
        return lambda: A.flash_attention_streaming_bwd(q, k, v, out, do)

    def flash(b, h, n, d, dtype=torch.bfloat16):
        q, k, v = (rnd(b, h, n, d, dtype=dtype) for _ in range(3))
        return lambda: A.flash_attention(q, k, v)

    def flash_bwd(b, h, n, d, dtype=torch.bfloat16):
        q, k, v, do = (rnd(b, h, n, d, dtype=dtype) for _ in range(4))
        scale = d ** -0.5
        out, lse = A._launch_flash_forward(q, k, v, scale, True)
        return lambda: A.flash_attention_bwd(q, k, v, out, lse, do, scale)

    cases = [("flash_attention_packed", [16, 4096, 5, 32],
              packed(16, 4096, 5, 32)),
             ("flash_attention_packed", [8, 4096, 5, 32],
              packed(8, 4096, 5, 32)),
             ("flash_attention_packed", [8, 1024, 10, 32],
              packed(8, 1024, 10, 32)),
             ("flash_attention_streaming_bwd", [8, 10, 1024, 1024, 32],
              streaming_bwd(8, 10, 1024, 32)),
             ("flash_attention_streaming_bwd", [8, 20, 256, 256, 32],
              streaming_bwd(8, 20, 256, 32)),
             ("flash_attention_qout", [8, 4096, 160, 5],
              qout(8, 4096, 160, 5)),
             ("flash_attention_qout", [16, 4096, 160, 5],
              qout(16, 4096, 160, 5)),
             ("flash_attention_streaming", [8, 10, 1024, 1024, 32],
              streaming(8, 10, 1024, 1024, 32)),
             ("flash_attention_streaming", [8, 20, 256, 256, 32],
              streaming(8, 20, 256, 256, 32)),
             ("flash_attention_streaming", [1, 2, 100, 5000, 32],
              streaming(1, 2, 100, 5000, 32)),
             ("flash_attention_fproj", [16, 1024, 320, 10],
              fproj(16, 1024, 320, 10)),
             ("flash_attention_fproj", [8, 1024, 320, 10],
              fproj(8, 1024, 320, 10)),
             ("flash_attention_fproj", [16, 256, 640, 20],
              fproj(16, 256, 640, 20)),
             ("flash_attention_bwd_packed", [8, 1024, 10, 32],
              packed_bwd(8, 1024, 10, 32)),
             ("flash_attention_bwd_packed", [8, 256, 20, 32],
              packed_bwd(8, 256, 20, 32)),
             ("flash_attention_bwd_packed", [8, 4096, 5, 32],
              packed_bwd(8, 4096, 5, 32)),
             # the -fullattn-dh64 level-0 heads, 2 of 80
             ("flash_attention_packed", [8, 4096, 2, 80],
              packed(8, 4096, 2, 80)),
             ("flash_attention_bwd_packed", [8, 4096, 2, 80],
              packed_bwd(8, 4096, 2, 80)),
             ("flash_attention_streaming", [8, 2, 4096, 4096, 80],
              streaming(8, 2, 4096, 4096, 80)),
             ("flash_attention_streaming_bwd", [8, 2, 4096, 4096, 80],
              streaming_bwd(8, 2, 4096, 80)),
             # the split-head route (DSML_ATTN_PACKED=0)
             ("flash_attention", [8, 10, 1024, 1024, 32],
              flash(8, 10, 1024, 32)),
             ("flash_attention", [8, 20, 256, 256, 32], flash(8, 20, 256, 32)),
             ("flash_attention", [8, 2, 4096, 4096, 80],
              flash(8, 2, 4096, 80)),
             ("flash_attention_bwd", [8, 10, 1024, 1024, 32],
              flash_bwd(8, 10, 1024, 32)),
             ("flash_attention_bwd", [8, 20, 256, 256, 32],
              flash_bwd(8, 20, 256, 32)),
             ("flash_attention_bwd", [8, 2, 4096, 4096, 80],
              flash_bwd(8, 2, 4096, 80)),
             # fp32 at D = 32: a train-mead128 step's level 0
             ("flash_attention_packed", [32, 1024, 5, 32, "float32"],
              packed(32, 1024, 5, 32, torch.float32)),
             ("flash_attention_bwd_packed", [32, 1024, 5, 32, "float32"],
              packed_bwd(32, 1024, 5, 32, torch.float32)),
             # ... and of a train-mead128-split / -streaming step
             ("flash_attention", [32, 5, 1024, 1024, 32, "float32"],
              flash(32, 5, 1024, 32, torch.float32)),
             ("flash_attention_streaming", [32, 5, 1024, 1024, 32, "float32"],
              streaming(32, 5, 1024, 1024, 32, torch.float32)),
             ("flash_attention_bwd", [32, 5, 1024, 1024, 32, "float32"],
              flash_bwd(32, 5, 1024, 32, torch.float32)),
             ("flash_attention_streaming_bwd",
              [32, 5, 1024, 1024, 32, "float32"],
              streaming_bwd(32, 5, 1024, 32, torch.float32))]
    with torch.no_grad():
        for name, shape, fn in cases:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            kernels = _device_kernels(prof)
            print(json.dumps({
                "measure": "split", "card": smi, "op": name, "shape": shape,
                "calls": calls,
                "ms_a_call": {k: ms / calls for k, (ms, _) in kernels.items()},
                "launches": {k: n for k, (_, n) in kernels.items()}}),
                flush=True)


def _frame_size(cfg) -> int:
    """The frame size of a latent-diffusion config: its first stage's."""
    return cfg["model"]["params"]["first_stage_config"]["params"][
        "ddconfig"]["resolution"]


def profile(smi: str, frames: int, config: str, sampler: str = "ddim",
            sampler_steps: int = 20, sampler_order: int = 2):
    from torch.profiler import ProfilerActivity

    device = torch.device("cuda")
    batch, window = 8, 8
    chain = {"sampler": sampler}
    if sampler == "dpm":
        chain.update(sampler_steps=sampler_steps, sampler_order=sampler_order)
    steps = 50 if sampler == "ddim" else sampler_steps   # UNet calls a frame
    env = {k: os.environ[k] for k in KERNEL_FLAGS if k in os.environ}
    run = {"card": smi, "config": os.path.relpath(config, ROOT), "flags": env,
           "batch": batch, **chain}
    cfg = load_config([config])
    size = _frame_size(cfg)
    torch.manual_seed(0)
    ldm = build_model(cfg["model"])
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    ldm = cast_sampling_params(ldm).to(device).eval()
    ddim = make_ddim_schedule(ldm.schedule, 50, eta=0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    adim = cfg["model"]["params"]["cond_stage_config_2"]["params"]["subspace_dim"]

    def inputs(f):
        return (r(batch, f, size, size, 3).clamp(-1, 1),
                r(batch, f + window, adim), r(batch, size, size, 3).clamp(-1, 1),
                torch.arange(batch, device=device) % 8)

    pipe = make_video_pipeline(ldm, ddim, window, guidance_scale=2.0, **chain)
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
                                  decode=False, **chain)
        chain_ms = event_ms(lambda: lat(mf, au, idn, lab, gen), 1) - enc_ms
        lat, ch = ldm.image_size, ldm.channels
        z = r(batch, lat, lat, ch)
        dec_ms = event_ms(lambda: ldm.decode_first_stage(z), 3)
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        total_ms = event_ms(lambda: pipe(mf, au, idn, lab, gen), 1)
        wall = time.monotonic() - t0
    print(json.dumps({
        "measure": "phases", **run, "frames": frames,
        "unet_calls_per_frame": steps, "batch_ms": total_ms,
        "encode_ms": enc_ms, "chain_ms": chain_ms,
        "unet_call_ms": chain_ms / (frames * steps),
        "decode_ms_per_frame": dec_ms, "launches": dict(A.LAUNCHES),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_seconds_all": wall}), flush=True)

    # one guidance-pair UNet call under the profiler: kernels launched
    x_t = r(batch, lat, lat, ch)
    cond = {"crossattn": r(2 * batch, 1, ldm.unet.context_dim),
            "concat": r(batch, lat, lat, ldm.unet.conv_in.in_channels - ch)}
    t = torch.full((batch,), 500, device=device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        ldm.apply_model(x_t, t, cond, cfg_pairs=True)
        torch.cuda.synchronize()
    call = _device_kernels(prof)
    print(json.dumps({
        "measure": "unet_call", **run,
        "kernels_launched": sum(n for _, n in call.values()),
        "device_busy_ms": sum(ms for ms, _ in call.values()),
        "launched_by_family": _by_family(call, 1)}), flush=True)

    # one frame under the profiler: device time by kernel family, idle share.
    # Tracing slows the host, so the same frame is also timed untraced: the
    # traced device-busy time over the untraced wall time estimates the idle
    # share a user sees.
    t0 = time.monotonic()
    pipe(*inputs(1), gen)
    torch.cuda.synchronize()
    wall_untraced_ms = 1e3 * (time.monotonic() - t0)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        pipe(*inputs(1), gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    kernels = _device_kernels(prof)
    fams = _by_family(kernels, 0)
    busy_ms = sum(fams.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({
        "measure": "profile", **run, "frames": 1,
        "kernels_launched": sum(n for _, n in kernels.values()),
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


def train(smi: str, config: str, steps: int = 10):
    from ..training.ema import ema_update
    from ..training.train_state import (create_train_state, make_optimizer,
                                        make_train_step)

    device = torch.device("cuda")
    env = {k: os.environ[k] for k in KERNEL_FLAGS if k in os.environ}
    cfg = load_config([config])
    batch_size, size = cfg["data"]["params"]["batch_size"], _frame_size(cfg)
    run = {"card": smi, "config": os.path.relpath(config, ROOT), "flags": env,
           "batch": batch_size, "size": size,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.manual_seed(0)
    ldm = build_model(cfg["model"]).to(device)
    base_lr = batch_size * cfg["model"].get("base_learning_rate", 1e-6)
    state = create_train_state(ldm, make_optimizer(ldm, base_lr), base_lr)
    step = make_train_step(ldm)
    gen = torch.Generator(device=device).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    c2 = cfg["model"]["params"]["cond_stage_config_2"]["params"]
    batch = {"image": r(batch_size, size, size, 3),
             "masked_image": r(batch_size, size, size, 3),
             "identity": r(batch_size, size, size, 3),
             "class_label": torch.arange(batch_size, device=device) % 8,
             "audio": r(batch_size, c2["seq_len"], c2["subspace_dim"])}

    for _ in range(3):   # warm-up: kernel build, cuDNN algorithm choice
        step(state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t0 = time.monotonic()
    step_ms = event_ms(lambda: step(state, batch, 0), steps)
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    launches = {k: v / steps for k, v in A.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()

    # the parts of a step, each between its own events (the sum is a little
    # more than a step: each part ends in a synchronize)
    ldm.train()
    enc_ms = event_ms(lambda: [ldm.encode_first_stage(batch[k]) for k in
                               ("image", "masked_image", "identity")], 3)
    holder = {}

    def forward():
        gen.manual_seed(1)
        holder["loss"] = ldm.training_loss(batch, gen)[0]

    fwd_ms = event_ms(forward, 1)
    bwd_ms = event_ms(lambda: holder["loss"].backward(), 1)

    def update():
        state.optimizer.step()
        ema_update(state.ema_params, state.params, state.step)

    opt_ms = event_ms(update, 1)
    state.optimizer.zero_grad(set_to_none=True)
    print(json.dumps({
        "measure": "train_step", **run, "steps_timed": steps,
        "step_ms": step_ms, "img_per_s": 1e3 * batch_size / step_ms,
        "host_ms_per_step": wall_ms, "encodes_ms": enc_ms,
        "forward_ms_with_encodes": fwd_ms, "backward_ms": bwd_ms,
        "adamw_ema_ms": opt_ms, "launches_per_step": launches,
        "peak_memory_gb": peak / 2 ** 30,
        "trainable_parameters": sum(p.numel() for p in state.params)}),
        flush=True)

    _profile_step(lambda: step(state, batch, 0), "train_profile", run)


def _profile_step(step, measure: str, run: dict):
    """One step untraced, then one under torch.profiler: kernels launched,
    device-busy ms, device time by family and the idle share (the traced
    busy time over the untraced wall time)."""
    from torch.profiler import ProfilerActivity

    t0 = time.monotonic()
    step()
    torch.cuda.synchronize()
    wall_untraced_ms = 1e3 * (time.monotonic() - t0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_traced_ms = 1e3 * (time.monotonic() - t0)
    kernels = _device_kernels(prof)
    fams = _by_family(kernels, 0)
    busy_ms = sum(fams.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({
        "measure": measure, **run,
        "kernels_launched": sum(n for _, n in kernels.values()),
        "launched_by_family": _by_family(kernels, 1),
        "wall_ms_traced": wall_traced_ms, "wall_ms_untraced": wall_untraced_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_untraced_estimate":
            (1 - busy_ms / wall_untraced_ms) if busy_ms else None,
        "family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "family_share": {k: v / busy_ms for k, v in sorted(
            fams.items(), key=lambda kv: -kv[1])} if busy_ms else None,
        "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                        for k, v in top]}), flush=True)


def affectnet(smi: str, n: int = 8, steps: int = 50, scale: float = 3.0):
    from ..reenactment import sample_class

    device = torch.device("cuda")
    cfg = load_config([CONFIG_AFFECTNET])
    run = {"card": smi, "config": os.path.relpath(CONFIG_AFFECTNET, ROOT),
           "samples": n, "steps": steps, "guidance": scale,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.manual_seed(0)
    ldm = build_model(cfg["model"])
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    ldm = cast_sampling_params(ldm).to(device).eval()
    gen = torch.Generator(device=device)

    def batch():
        gen.manual_seed(0)
        sample_class(ldm, 1, n, steps=steps, scale=scale, generator=gen)

    batch()   # warm-up: kernel build
    A.reset_launches()
    ms = event_ms(batch, 2)
    print(json.dumps({"measure": "affectnet_class_batch", **run,
                      "class_batch_ms": ms,
                      "launches_per_batch": {k: v / 2 for k, v in
                                             A.LAUNCHES.items() if v}}),
          flush=True)
    with torch.no_grad():
        _profile_step(batch, "affectnet_class_profile", run)


def finetune(smi: str, steps: int = 5):
    from ..config import build_finetune
    from ..models import clip as C
    from ..models.insight_face import IRSE, make_id_embed
    from ..training.train_state import (create_train_state, make_optimizer,
                                        make_train_step)

    device = torch.device("cuda")
    cfg = load_config([CONFIG_AFFECTNET_CLIP])
    bs = cfg["data"]["params"]["batch_size"]
    run = {"card": smi, "config": os.path.relpath(CONFIG_AFFECTNET_CLIP, ROOT),
           "batch": bs, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.manual_seed(0)
    ldm = build_model(cfg["model"])
    ft = build_finetune(
        cfg["model"], ldm=ldm,
        clip_image_embed=C.make_clip_image_embed(C.CLIPConfig()),
        arcface_embed=make_id_embed(IRSE()),
        text_direction=torch.randn(8, C.CLIPConfig().embed_dim),
        direction_by_source=True).to(device)
    base_lr = bs * cfg["model"].get("base_learning_rate", 1e-6)
    state = create_train_state(ldm, make_optimizer(ldm, base_lr), base_lr)
    step = make_train_step(ft)
    gen = torch.Generator(device=device).manual_seed(0)
    lat = ldm.image_size
    batch = {"latent": torch.randn(bs, lat, lat, 3, generator=gen,
                                   device=device),
             "original": torch.rand(bs, 128, 128, 3, generator=gen,
                                    device=device) * 2 - 1,
             "class_label": torch.arange(bs, device=device) % 8}

    for _ in range(2):   # warm-up: kernel build, cuDNN algorithm choice
        step(state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    step_ms = event_ms(lambda: step(state, batch, 0), steps)
    launches = {k: v / steps for k, v in A.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    holder = {}

    def forward():
        holder["loss"] = ft.training_loss(batch)[0]

    fwd_ms = event_ms(forward, 1)
    bwd_ms = event_ms(lambda: holder["loss"].backward(), 1)
    with torch.no_grad():
        chain_ms = event_ms(lambda: ft.edit(batch["latent"],
                                            ft.targets(batch, bs)), 1)
    state.optimizer.zero_grad(set_to_none=True)
    print(json.dumps({
        "measure": "finetune_step", **run, "steps_timed": steps,
        "chain_steps": ft.train_ddim.num_steps, "step_ms": step_ms,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "chain_ms_without_gradient": chain_ms, "launches_per_step": launches,
        "peak_memory_gb": peak / 2 ** 30,
        "trainable_parameters": sum(p.numel() for p in state.params)}),
        flush=True)
    _profile_step(lambda: step(state, batch, 0), "finetune_profile", run)


def lipread(smi: str, steps: int = 5):
    from ..config import build_finetune
    from ..models.lipreader import LipreaderFrontend, make_lipreader_apply
    from ..training.train_state import (create_train_state, make_optimizer,
                                        make_train_step)

    device = torch.device("cuda")
    cfg = load_config([CONFIG_TUNE])
    bs = cfg["data"]["params"]["batch_size"]
    run = {"card": smi, "config": os.path.relpath(CONFIG_TUNE, ROOT),
           "batch": bs, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.manual_seed(0)
    ldm = build_model(cfg["model"])
    # a spread codebook (the init holds every code at the origin): decoded
    # frames, and so the lipreader's mouths, differ between latents
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    ft = build_finetune(cfg["model"], ldm=ldm, lipreader_fn=(
        make_lipreader_apply(LipreaderFrontend()))).to(device)
    base_lr = bs * cfg["model"].get("base_learning_rate", 1e-6)
    state = create_train_state(ldm, make_optimizer(ldm, base_lr), base_lr)
    step = make_train_step(ft)
    gen = torch.Generator(device=device).manual_seed(0)
    c2 = cfg["model"]["params"]["cond_stage_config_2"]["params"]
    frame = lambda: torch.rand(bs, 128, 128, 3, generator=gen,
                               device=device) * 2 - 1
    # landmarks around a face's mouth (centroid near (64, 90)) on 128 px
    landmarks = torch.tensor([64.0, 90.0], device=device) + 6 * torch.randn(
        bs, 68, 2, generator=gen, device=device)
    batch = {"image": frame(), "masked_image": frame(), "identity": frame(),
             "class_label": torch.arange(bs, device=device) % 8,
             "audio": torch.randn(bs, c2["seq_len"], c2["subspace_dim"],
                                  generator=gen, device=device),
             "landmarks": landmarks}

    for _ in range(2):   # warm-up: kernel build, cuDNN algorithm choice
        step(state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    step_ms = event_ms(lambda: step(state, batch, 0), steps)
    launches = {k: v / steps for k, v in A.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    holder = {}

    def forward():
        holder["loss"] = ft.training_loss(batch, gen)[0]

    fwd_ms = event_ms(forward, 1)
    bwd_ms = event_ms(lambda: holder["loss"].backward(), 1)
    state.optimizer.zero_grad(set_to_none=True)
    print(json.dumps({
        "measure": "lipread_step", **run, "steps_timed": steps,
        "chain_steps": ft.ddim.num_steps, "step_ms": step_ms,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms,
        "launches_per_step": launches, "peak_memory_gb": peak / 2 ** 30,
        "trainable_parameters": sum(p.numel() for p in state.params)}),
        flush=True)
    _profile_step(lambda: step(state, batch, 0), "lipread_profile", run)


def ae(smi: str, config: str, steps: int = 10):
    from ..training.vqgan import create_first_stage_state
    from ..training.vqgan_trainer import TRAINERS

    device = torch.device("cuda")
    env = {k: os.environ[k] for k in KERNEL_FLAGS if k in os.environ}
    cfg = load_config([config])
    trainer = TRAINERS[cfg["model"]["target"]]
    cfg["model"]["params"]["lossconfig"]["params"]["disc_start"] = 0
    batch_size = 16
    size = cfg["model"]["params"]["ddconfig"]["resolution"]
    run = {"card": smi, "config": os.path.relpath(config, ROOT), "flags": env,
           "batch": batch_size, "dtype": "float32",
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.manual_seed(0)
    model, loss = trainer._build(cfg["model"])
    model, loss = model.to(device), loss.to(device)
    lr = batch_size * cfg["model"].get("base_learning_rate", 4.5e-6)
    state = create_first_stage_state(model, loss, lr)
    step = trainer._make_train_step(model, loss)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(batch_size, size, size, 3, generator=gen,
                    device=device).clamp(-1, 1)

    for _ in range(3):   # warm-up: kernel build, cuDNN algorithm choice
        step(state, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t0 = time.monotonic()
    step_ms = event_ms(lambda: step(state, x), steps)
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    print(json.dumps({
        "measure": "ae_step", **run, "steps_timed": steps,
        "step_ms": step_ms, "img_per_s": 1e3 * batch_size / step_ms,
        "host_ms_per_step": wall_ms,
        "launches_per_step": {k: v / steps for k, v in A.LAUNCHES.items()
                              if v},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "trainable_parameters": sum(p.numel() for p in state.ae_params),
        "discriminator_parameters": sum(p.numel()
                                        for p in state.disc_params)}),
        flush=True)

    _profile_step(lambda: step(state, x), "ae_profile", run)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--config", default=CONFIG,
                    help="model config YAML of --profile and --train")
    ap.add_argument("--ae", default=None, metavar="CONFIG",
                    help="first-stage config YAML to time training steps of")
    ap.add_argument("--affectnet", action="store_true",
                    help="one AffectNet class batch, timed and profiled")
    ap.add_argument("--finetune", action="store_true",
                    help="DiffusionCLIP finetune steps, timed and profiled")
    ap.add_argument("--lipread", action="store_true",
                    help="lip-reading finetune steps, timed and profiled")
    cli.add_sampler_args(ap, note="the chain --profile times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = card()
    if args.gate:
        gate(smi)
    if args.split:
        split(smi)
    if args.profile:
        profile(smi, args.frames, args.config, args.sampler,
                args.sampler_steps, args.sampler_order)
    if args.train:
        train(smi, args.config)
    if args.ae:
        ae(smi, args.ae)
    if args.affectnet:
        affectnet(smi)
    if args.finetune:
        finetune(smi)
    if args.lipread:
        lipread(smi)


if __name__ == "__main__":
    main()
