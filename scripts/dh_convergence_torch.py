#!/usr/bin/env python3
"""Controlled head-width convergence pair of the PyTorch port (the port's
``scripts/dh_convergence.py``): the same training recipe at head widths
(``num_head_channels``) 32 and 64 on identical synthetic data and seeds,
both loss curves recorded. Head width changes no parameter shape (the
projections stay [C, C]; only the attention's reshape into C / dh heads
moves), so the pair shows whether the wider heads train as the narrow ones
do.

    python3 scripts/dh_convergence_torch.py [--steps 300 --res 64 --batch 8]
        [--widths 32 64] [--dtype float32|bfloat16] [--cpu] [--out curves.json]

The model is the MEAD 4-cond family scaled to ``--res`` px (``model_cfg``:
128 channels, attention at ds 2, an f4 VQ first stage), trained by the
port's ``make_optimizer`` / ``create_train_state`` / ``make_train_step`` /
``make_eval_step`` from the reference's initialisation (the last conv of
every ResBlock, the attention blocks' ``proj_out`` and the output conv zero,
as the JAX package's ``init_params`` gives them; the rest PyTorch's default
under ``--seed``). Batches: 16 drawn by ``numpy.random.RandomState(0)`` (the
masked frame is the target with its lower half zeroed, so the concat
conditioning carries signal), validation by ``RandomState(99)``, the same
arrays as the JAX script's. One JSON line a width, then a summary. It runs
on the card; without one it fails unless ``--cpu`` is given. The model
computes in fp32, as the JAX script's does; on the card that needs fp32
attention kernels at head width 64, which the port does not instantiate,
so there ``--dtype bfloat16`` runs it (the headline configs' compute type).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli


def model_cfg(dh: int, res: int):
    """MEAD-family 4-cond LDM scaled to ``res`` px (f4 latent), attention at
    ds = 2 (channels 2 * mc, divisible by 64), head width ``dh``."""
    mc = 128
    return {
        "target": "ldm.models.diffusion.ddpm2cond.LatentDiffusion",
        "params": {
            "linear_start": 0.0015, "linear_end": 0.0205, "timesteps": 1000,
            "image_size": res // 4, "channels": 3,
            "first_stage_key": "image",
            "cond_stage_key_1": "class_label", "cond_stage_key_2": "audio",
            "cond_stage_trainable": True, "conditioning_key": "crossattn",
            "scale_factor": 1.0,
            "scheduler_config": {
                "target": "ldm.lr_scheduler.LambdaLinearScheduler",
                "params": {"warm_up_steps": [50], "cycle_lengths": [10000000],
                           "f_start": [1e-6], "f_max": [1.0], "f_min": [1.0]},
            },
            "unet_config": {
                "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
                "params": {
                    "image_size": res // 4, "in_channels": 9,
                    "out_channels": 3, "model_channels": mc,
                    "attention_resolutions": [2], "num_res_blocks": 1,
                    "channel_mult": [1, 2], "num_head_channels": dh,
                    "use_spatial_transformer": True, "transformer_depth": 1,
                    "context_dim": 80,
                },
            },
            "first_stage_config": {
                "target": "ldm.models.autoencoder.VQModelInterface",
                "params": {
                    "embed_dim": 3, "n_embed": 512,
                    "ddconfig": {
                        "double_z": False, "z_channels": 3, "resolution": res,
                        "in_channels": 3, "out_ch": 3, "ch": 32,
                        "ch_mult": [1, 2, 2], "num_res_blocks": 1,
                        "attn_resolutions": [], "dropout": 0.0,
                    },
                    "lossconfig": {"target": "torch.nn.Identity"},
                },
            },
            "cond_stage_config_1": {
                "target": "ldm.modules.encoders.modules.ClassEmbedder",
                "params": {"embed_dim": 16, "n_classes": 8,
                           "key": "class_label"},
            },
            "cond_stage_config_2": {
                "target": "ldm.modules.encoders.modules.Conv1DTemporalAttention",
                "params": {"seq_len": 5, "subspace_dim": 64,
                           "subspace2hidden": False},
            },
        },
    }


def make_batch(rs: np.random.RandomState, batch: int, res: int, c2p: dict):
    """One batch of numpy arrays, drawn in the JAX script's order."""
    img = rs.rand(batch, res, res, 3).astype(np.float32) * 2 - 1
    masked = img.copy()
    masked[:, res // 2:] = 0.0
    return {
        "image": img,
        "masked_image": masked,
        "identity": rs.rand(batch, res, res, 3).astype(np.float32) * 2 - 1,
        "class_label": rs.randint(0, 8, (batch,)),
        "audio": rs.randn(batch, c2p["seq_len"], c2p["subspace_dim"])
        .astype(np.float32),
    }


def make_batches(cfg: dict, batch: int, res: int):
    """(16 training batches from RandomState(0), the validation batch from
    RandomState(99)): the same stream for every width."""
    c2p = cfg["params"]["cond_stage_config_2"]["params"]
    rs = np.random.RandomState(0)
    return ([make_batch(rs, batch, res, c2p) for _ in range(16)],
            make_batch(np.random.RandomState(99), batch, res, c2p))


def zero_block_outputs(unet) -> None:
    """The reference's ``zero_module`` initialisation: the last conv of every
    ResBlock, every SpatialTransformer's ``proj_out`` and the output conv."""
    from dsml_thesis_tpu_torch.models.unet import ResBlock, SpatialTransformer

    convs = [unet.conv_out]
    for m in unet.modules():
        if isinstance(m, ResBlock):
            convs.append(m.out_conv)
        elif isinstance(m, SpatialTransformer):
            convs.append(m.proj_out)
    with torch.no_grad():
        for c in convs:
            c.weight.zero_()
            c.bias.zero_()


def run_width(dh, args, device):
    from dsml_thesis_tpu_torch.config import build_model
    from dsml_thesis_tpu_torch.training.train_state import (
        create_train_state, make_eval_step, make_optimizer, make_train_step)

    cfg = model_cfg(dh, args.res)
    if args.dtype != "float32":
        for stage in ("unet_config", "first_stage_config"):
            cfg["params"][stage]["params"]["dtype"] = args.dtype
    torch.manual_seed(args.seed)
    ldm = build_model(cfg)
    zero_block_outputs(ldm.unet)
    ldm = ldm.to(device)
    batches, val_batch = make_batches(cfg, args.batch, args.res)
    on = lambda b: {k: torch.from_numpy(np.asarray(v)).to(device)
                    for k, v in b.items()}
    batches, val_batch = [on(b) for b in batches], on(val_batch)
    n_params = sum(p.numel() for p in ldm.parameters()) / 1e6
    opt = make_optimizer(ldm, args.lr)
    state = create_train_state(ldm, opt, args.lr,
                               scheduler_config=cfg["params"][
                                   "scheduler_config"])
    train_step, eval_step = make_train_step(ldm), make_eval_step(ldm)

    losses, vals = [], []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    for i in range(args.steps):
        ldm.train()
        m = train_step(state, batches[i % len(batches)], seed=1)
        losses.append(float(m.get("train/loss", m.get("train/loss_simple"))))
        if i % args.val_every == 0 or i == args.steps - 1:
            ev = eval_step(state, val_batch, seed=2)
            vals.append((i, float(ev["val_loss"]), float(ev["val_loss_ema"])))
            print(f"dh{dh} step {i}: train {losses[-1]:.4f} "
                  f"val {vals[-1][1]:.4f} val_ema {vals[-1][2]:.4f}",
                  file=sys.stderr, flush=True)
    sync()
    dt = time.time() - t0

    k = max(1, args.steps // 10)
    return {
        "dh": dh, "params_M": round(n_params, 2), "steps": args.steps,
        "lr": args.lr, "batch": args.batch, "res": args.res,
        "dtype": args.dtype,
        "loss_first10": round(float(np.mean(losses[:k])), 4),
        "loss_last10pct": round(float(np.mean(losses[-k:])), 4),
        "val": [(i, round(v, 4), round(e, 4)) for i, v, e in vals],
        "train_s": round(dt, 1),
        "losses_every5": [round(float(x), 4) for x in losses[::5]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--widths", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-every", type=int, default=50)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the UNet's and the first stage's compute type "
                         "(parameters stay fp32). The port's attention "
                         "kernels have no fp32 instantiation at head width "
                         "64 (this model's first-stage mid attention, and "
                         "the UNet at --widths 64): on the card float32 "
                         "raises there, bfloat16 runs")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = cli.device_of(args.cpu)

    recs = [run_width(dh, args, device) for dh in args.widths]
    for r in recs:
        print(json.dumps(r))
    if len(recs) >= 2:
        a, b = recs[0], recs[1]
        print(f"# dh{a['dh']}: {a['loss_first10']} -> {a['loss_last10pct']}"
              f" | dh{b['dh']}: {b['loss_first10']} -> {b['loss_last10pct']}")
        # how far the two curves part: attention starts at zero (proj_out),
        # so the widths only part once training has moved proj_out; a
        # separation near zero on a long run would mean the head width never
        # mattered and the run shows nothing
        d = np.abs(np.asarray(a["losses_every5"])
                   - np.asarray(b["losses_every5"]))
        print(f"# curve separation: max {d.max():.4f} "
              f"(late-half max {d[len(d)//2:].max():.4f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    main()
