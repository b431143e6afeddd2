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
           8, DDIM-50, guidance 2.0, random weights) under the DSML_* flags
           of the environment: phase times from CUDA events, then one UNet
           call and one frame under torch.profiler: kernels launched a call,
           device time by kernel family and the device's idle share (traced,
           and estimated against the same frame's untraced wall time)
--train    training steps of a model config on synthetic batches at the real
           shapes (batch 8, 256 px, audio [17, 768]; fp32 parameters, bf16
           compute) under the DSML_* flags of the environment, through the
           port's own train step: ms a warm step by CUDA events and img/s,
           the step's parts (frozen encodes, forward, backward, AdamW + EMA)
           by events, peak memory, kernel launches a step, then one step
           under torch.profiler: kernels launched, device time by kernel
           family and the device's idle share
--ae CFG   first-stage training steps of an autoencoder config
           (configs/autoencoder/vqgan-f4.yaml or kl-f4.yaml: fp32, batch 16,
           128 px, random weights and LPIPS from seed 0, disc_start 0 so
           that the GAN term and its adaptive weight run) under the DSML_*
           flags of the environment, through the port's own fused step: ms a
           warm step by CUDA events over 10 steps and img/s, kernel launches
           a step, peak memory, then one step under torch.profiler: kernels
           launched, device-busy ms, device time by kernel family and the
           device's idle share

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
    ("flash_fwd_f32_kernel", "attention: flash_attention (fp32)"),
    ("streaming_fwd_f32_kernel", "attention: streaming (fp32)"),
    ("streaming_lse_f32_kernel", "attention backward: streaming log-sum-exp"),
    ("bwd_dkdv_f32_kernel", "attention backward: dk / dv grid"),
    ("bwd_dq_f32_kernel", "attention backward: dq grid"),
    ("bwd_delta_f32_kernel", "attention backward: delta"),
    ("fproj_attention_kernel", "attention: fproj (attention + to_out)"),
    ("qkv_proj_kernel", "attention: fproj (q, k, v projection)"),
    ("flash_attention_kernel", "attention: flash_attention"),
    ("streaming_fwd_kernel", "attention: streaming"),
    ("streaming_combine_kernel", "attention: streaming"),
    ("streaming_lse_kernel", "attention backward: streaming log-sum-exp"),
    ("streaming_dkdv_kernel", "attention backward: dk / dv grid"),
    ("streaming_dq_kernel", "attention backward: dq grid"),
    ("conv_stats_kernel", "conv + statistics kernel"),
    ("conv_stats_finish_kernel", "conv + statistics kernel"),
    ("packed_attention_kernel", "attention: packed"),
    ("bwd_dkdv_kernel", "attention backward: dk / dv grid"),
    ("bwd_dq_kernel", "attention backward: dq grid"),
    ("bwd_delta_kernel", "attention backward: delta"),
    ("multi_tensor", "optimizer / EMA (foreach)"),
    ("qout_attention_kernel", "attention: qout (q proj + attention + to_out)"),
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


def _device_kernels(prof) -> dict:
    """name -> (device ms, launches) of every kernel a profile recorded.
    Annotations that PyTorch mirrors onto the device track
    (``Optimizer.step#AdamW.step``) span their kernels and are left out."""
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if (dev_us > 0 and ev.device_type.name == "CUDA"
                and not _ANNOTATION.match(ev.key)):
            out[ev.key] = (dev_us / 1e3, ev.count)
    return out


def profile(smi: str, frames: int, config: str):
    from torch.profiler import ProfilerActivity

    device = torch.device("cuda")
    batch, steps, size, window = 8, 50, 256, 8
    env = {k: os.environ[k] for k in KERNEL_FLAGS if k in os.environ}
    run = {"card": smi, "config": os.path.relpath(config, ROOT), "flags": env,
           "batch": batch}
    cfg = load_config([config])
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
        "measure": "phases", **run, "frames": frames,
        "ddim_steps": steps, "batch_ms": total_ms,
        "encode_ms": enc_ms, "ddim_chain_ms": chain_ms,
        "unet_call_ms": chain_ms / (frames * steps),
        "decode_ms_per_frame": dec_ms, "launches": dict(A.LAUNCHES),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_seconds_all": wall}), flush=True)

    # one guidance-pair UNet call under the profiler: kernels launched
    x_t = r(batch, 64, 64, 3)
    cond = {"crossattn": r(2 * batch, 1, ldm.unet.context_dim),
            "concat": r(batch, 64, 64, 6)}
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
    batch_size, size = 8, 256
    env = {k: os.environ[k] for k in KERNEL_FLAGS if k in os.environ}
    run = {"card": smi, "config": os.path.relpath(config, ROOT), "flags": env,
           "batch": batch_size}
    cfg = load_config([config])
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
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--config", default=CONFIG,
                    help="model config YAML of --profile and --train")
    ap.add_argument("--ae", default=None, metavar="CONFIG",
                    help="first-stage config YAML to time training steps of")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = card()
    if args.gate:
        gate(smi)
    if args.profile:
        profile(smi, args.frames, args.config)
    if args.train:
        train(smi, args.config)
    if args.ae:
        ae(smi, args.ae)


if __name__ == "__main__":
    main()
