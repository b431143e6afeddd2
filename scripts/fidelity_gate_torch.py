#!/usr/bin/env python3
"""Fidelity gate of the PyTorch port's flagship sampling path (the port's
``scripts/fidelity_gate.py``).

The progressive video sampler runs twice on identical weights, inputs and
noise:

  A) reference numerics: fp32 parameters and compute, every kernel replaced
     by its plain version (``dsml_thesis_tpu_torch/tools/plain.py``; the
     JAX gate's ``DSML_FLASH_ATTN=0``, a flag the port refuses);
  B) flagship numerics: the UNet and first stage computing in bf16 on
     parameters cast by ``cast_sampling_params``, through the kernels;

and it prints one JSON line with PSNR(B vs A) over the decoded frames under
the JAX gate's keys. ``--isolate-flash`` adds a run C (fp32, the kernels)
and the PSNR of C vs A and of B vs C; ``--ab-env KEY=VALUE`` sets a flag for
run B only; ``--csim`` adds the identity-embedding cosine between B's and
A's frames through an ``iresnet18`` (``--csim-weights``, a reference
checkpoint, or random weights from the seed). ``--ckpt`` takes the weights
as every port entry point does (``utils_io.load_params``: a reference
Lightning checkpoint, a ``scripts/train_torch.py`` checkpoint or a
state_dict); without it the weights are random from ``--seed``. A VQ
codebook still in its initial range (U(-1/K, 1/K): any latent decodes to
one image) is drawn unit normal from the seed, as a trained codebook spans
the latents. The JSON also holds each run's seconds and kernel launches.

    python3 scripts/fidelity_gate_torch.py [--config path.yaml] [--ckpt W]
        [--res 256 --steps 50 --frames 4 --batch 2] [--isolate-flash]
        [--ab-env DSML_GELU_EXACT=1] [--csim] [--tiny] [--cpu]

It runs on the card; without one it fails unless ``--cpu`` is given
(``--tiny``: a tiny MEAD model at 16 px, 2 frames, 4 steps, batch 1, for
the CPU).
"""
import argparse
import contextlib
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch
import yaml

from dsml_thesis_tpu_torch import cli

# the tiny MEAD model of the tests (a copy: the port reads nothing of the
# JAX package's tests)
TINY_MEAD_CFG = """
model:
  target: ldm.models.diffusion.ddpm2cond.LatentDiffusion
  params:
    linear_start: 0.0015
    linear_end: 0.0205
    timesteps: 100
    image_size: 8
    channels: 3
    first_stage_key: image
    cond_stage_key_1: class_label
    cond_stage_key_2: audio
    cond_stage_trainable: true
    conditioning_key: crossattn
    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        image_size: 8
        in_channels: 9
        out_channels: 3
        model_channels: 32
        attention_resolutions: [2]
        num_res_blocks: 1
        channel_mult: [1, 2]
        num_head_channels: 16
        use_spatial_transformer: true
        transformer_depth: 1
        context_dim: 48
    first_stage_config:
      target: ldm.models.autoencoder.VQModelInterface
      params:
        embed_dim: 3
        n_embed: 64
        ddconfig:
          double_z: false
          z_channels: 3
          resolution: 16
          in_channels: 3
          out_ch: 3
          ch: 32
          ch_mult: [1, 2]
          num_res_blocks: 1
          attn_resolutions: [8]
          dropout: 0.0
        lossconfig: {target: torch.nn.Identity}
    cond_stage_config_1:
      target: ldm.modules.encoders.modules.ClassEmbedder
      params: {embed_dim: 16, n_classes: 8, key: class_label, p_uncond: 0.2}
    cond_stage_config_2:
      target: ldm.modules.encoders.modules.Conv1DTemporalAttention
      params: {seq_len: 5, subspace_dim: 32, subspace2hidden: false}
"""


@contextlib.contextmanager
def env_set(key, value):
    """``key`` set to ``value`` inside the block (unset for None)."""
    saved = os.environ.pop(key, None) if key else None
    if key and value is not None:
        os.environ[key] = value
    try:
        yield
    finally:
        if key:
            os.environ.pop(key, None)
            if saved is not None:
                os.environ[key] = saved


def build(cfg, dtype, args, device, weights=None):
    """The config's model computing in ``dtype``, its weights random from
    ``args.seed`` (or ``--ckpt``'s), or ``weights`` where given."""
    from dsml_thesis_tpu_torch.config import build_model
    from dsml_thesis_tpu_torch.models.autoencoder import VQModel
    from dsml_thesis_tpu_torch.utils_io import load_params

    c = copy.deepcopy(cfg)
    p = c["model"]["params"]
    p["unet_config"]["params"]["dtype"] = dtype
    if "dtype" in p.get("first_stage_config", {}).get("params", {}):
        p["first_stage_config"]["params"]["dtype"] = dtype
    torch.manual_seed(args.seed)
    ldm = build_model(c["model"])
    note = None
    if weights is not None:
        ldm.load_state_dict(weights)
    else:
        if args.ckpt:
            ldm.load_state_dict(load_params(args.ckpt, ldm, c["model"]))
        fs = ldm.first_stage
        if isinstance(fs, VQModel):
            book = fs.quantize.embedding.weight.data
            if float(book.abs().max()) <= 1.0 / book.shape[0]:
                g = torch.Generator().manual_seed(args.seed)
                with torch.no_grad():
                    book.copy_(torch.randn(book.shape, generator=g))
                note = "drawn unit normal (still at its initial range)"
    return ldm.to(device).eval(), note


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt", default=None, help=cli.CKPT_HELP)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--guidance", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--isolate-flash", action="store_true")
    ap.add_argument("--ab-env", default=None, metavar="KEY=VALUE",
                    help="a flag set for the flagship (B) run only, e.g. "
                         "DSML_GELU_EXACT=1 or DSML_GN_EPILOGUE=res")
    ap.add_argument("--csim", action="store_true",
                    help="also the identity cosine of the two runs' frames "
                         "through an iresnet18")
    ap.add_argument("--csim-weights", default=None,
                    help="a reference iresnet18 checkpoint for --csim; "
                         "without it random weights from --seed")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny model at 16 px (for the CPU)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.config import load_config
    from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                                 make_video_pipeline)
    from dsml_thesis_tpu_torch.metrics import (cosine_similarity, psnr,
                                               to_unit_range)
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.tools.plain import plain_path
    from dsml_thesis_tpu_torch.utils_io import cast_sampling_params

    if args.tiny:
        cfg = yaml.safe_load(TINY_MEAD_CFG)
        args.res, args.batch, args.frames, args.steps = 16, 1, 2, 4
    else:
        path = (args.config
                or f"configs/latent-diffusion/mead-{args.res}-ldm-f4.yaml")
        cfg = load_config([path])

    ldm32, note = build(cfg, "float32", args, device)
    if args.tiny:
        ldm16 = ldm32
    else:
        ldm16, _ = build(cfg, "bfloat16", args, device,
                         weights=ldm32.state_dict())
        cast_sampling_params(ldm16)

    c2p = cfg["model"]["params"].get("cond_stage_config_2", {}).get(
        "params", {"seq_len": 5, "subspace_dim": 32})
    w = (c2p["seq_len"] - 1) // 2
    B, F, S, R = args.batch, args.frames, args.steps, args.res
    g = torch.Generator().manual_seed(args.seed + 1)
    masked = torch.randn(B, F, R, R, 3, generator=g) * 0.5
    audio = torch.randn(B, F, c2p["subspace_dim"], generator=g)
    ident = torch.randn(B, R, R, 3, generator=g) * 0.5
    labels = torch.zeros(B, dtype=torch.long)
    lat = ldm32.image_size
    x_T = torch.randn(B, F, lat, lat, ldm32.channels, generator=g)
    masked, audio, ident, labels, x_T = (
        t.to(device) for t in (masked, audio, ident, labels, x_T))
    ddim = make_ddim_schedule(ldm32.schedule, S, eta=0.0)

    ab_key = ab_val = None
    if args.ab_env:
        ab_key, _, ab_val = args.ab_env.partition("=")
    seconds, launches = {}, {}

    def run(name, ldm, kernels, ab=False):
        pipe = make_video_pipeline(ldm, ddim, w, guidance_scale=args.guidance)
        route = contextlib.nullcontext() if kernels else plain_path({})
        with env_set(ab_key, ab_val if ab else None), route:
            A.reset_launches()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.monotonic()
            out = pipe(masked, audio, ident, labels, x_T=x_T)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds[name] = round(time.monotonic() - t0, 3)
            launches[name] = {k: v for k, v in A.LAUNCHES.items() if v}
        print(f"# {name}: kernels={kernels} "
              f"dtype={ldm.unet.dtype} {seconds[name]} s", file=sys.stderr)
        return out.float()

    ref = run("reference", ldm32, kernels=False)
    flag = run("flagship", ldm16, kernels=True, ab=True)
    p_flag = float(psnr(to_unit_range(flag), to_unit_range(ref)).mean())
    result = {"metric": "psnr_bf16flash_vs_fp32_db", "value": round(p_flag, 2),
              "steps": S, "frames": F, "res": R}
    if args.ab_env:
        result["ab_env"] = args.ab_env
    if args.isolate_flash:
        mid = run("flash_only", ldm32, kernels=True)
        result["psnr_flash_only_db"] = round(float(psnr(
            to_unit_range(mid), to_unit_range(ref)).mean()), 2)
        result["psnr_bf16_given_flash_db"] = round(float(psnr(
            to_unit_range(flag), to_unit_range(mid)).mean()), 2)
    if args.csim:
        from dsml_thesis_tpu_torch.convert import torch_load
        from dsml_thesis_tpu_torch.models.arcface import (_BLOCKS,
                                                          convert_iresnet,
                                                          iresnet)
        from dsml_thesis_tpu_torch.models.insight_face import make_embed_fn

        torch.manual_seed(args.seed)
        tower = iresnet("iresnet18")
        if args.csim_weights:
            sd = torch_load(args.csim_weights)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            tower.load_state_dict(convert_iresnet(sd, _BLOCKS["iresnet18"]))
        embed_fn = make_embed_fn(tower, device)

        def embed(frames):
            # [0, 1] frames to 112 px by antialiased bilinear resampling
            # (jax.image.resize's "bilinear" on a downsample), then [-1, 1]
            x = to_unit_range(frames).reshape((-1,) + frames.shape[-3:])
            x = torch.nn.functional.interpolate(
                x.permute(0, 3, 1, 2), size=(112, 112), mode="bilinear",
                align_corners=False, antialias=True).permute(0, 2, 3, 1)
            return embed_fn(x * 2.0 - 1.0)

        cs = cosine_similarity(embed(flag), embed(ref))
        result["csim_flag_vs_ref"] = round(float(cs.mean()), 4)
        result["csim_delta"] = round(float(1.0 - cs.mean()), 4)
        result["csim_backbone"] = (args.csim_weights
                                   or "random-init iresnet18")
    result["ckpt"] = args.ckpt or "random-init"
    if note:
        result["codebook"] = note
    result["seconds"] = seconds
    result["launches"] = launches
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
