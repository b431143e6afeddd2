#!/usr/bin/env python3
"""Training CLI of the PyTorch / CUDA port (the port's ``main.py -t``).

    python3 scripts/train_torch.py --base configs/latent-diffusion/<cfg>.yaml \
        -t [--logdir logs] [--seed 123] [--max-steps N] [--epochs N] \
        [--resume <logdir | logdir/checkpoints/<name>>] [--scale_lr true] \
        [--no-test] [--cpu] [nested.key=value ...]

Builds the port's ``Trainer`` from the merged config, trains (``-t``),
validates with raw and EMA weights, writes ``metrics.jsonl`` and a ``last``
checkpoint under the run's logdir, and evaluates the test split if the
config has one. A first-stage config (``configs/autoencoder/*.yaml``: a
``VQModel`` or ``AutoencoderKL`` target) goes to ``VQGANTrainer`` /
``KLAETrainer`` instead (validation, top-k on ``val/rec_loss``, ``last``; no
test split). It runs on the card; without one it fails unless ``--cpu`` is
given. The shipped model configs name the MEAD dataset, which the port
does not read yet: override ``data`` with a synthetic node, e.g.

    data.params.train='{target: dsml_thesis_tpu_torch.data.SyntheticDataset,
      params: {length: 64, spec: {image: [[256, 256, 3], float32],
      masked_image: [[256, 256, 3], float32], identity: [[256, 256, 3],
      float32], class_label: [[], int32], audio: [[17, 768], float32]}}}'

(and the same for ``data.params.validation``). The first-stage configs name
AffectNet, likewise not read: a node with ``spec: {image: [[128, 128, 3],
float32]}``; their ``perceptual_weight: 1.0`` needs the LPIPS files,
``model.params.lossconfig.params.vgg_ckpt=<torchvision vgg16 features
state_dict>`` and ``model.params.lossconfig.params.lpips_lin_ckpt=<taming
lin heads>``.
"""
from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-b", "--base", nargs="*", default=[],
                   help="config yaml(s), merged left to right")
    p.add_argument("-t", "--train", action="store_true", default=False)
    p.add_argument("-r", "--resume", type=str, default="",
                   help="resume from a run logdir or a checkpoint directory "
                        "inside it")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-s", "--seed", type=int, default=123)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--max-steps", "--max_steps", type=int, default=None)
    p.add_argument("--scale_lr", type=str, default="true")
    p.add_argument("--no-test", action="store_true", default=False)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (the default is the card, and no "
                        "card is an error)")
    return p


def main(argv=None):
    """Runs the CLI; returns the Trainer (for callers that drive it from
    Python)."""
    import torch
    import yaml

    from dsml_thesis_tpu_torch.config import load_config
    from dsml_thesis_tpu_torch.training.trainer import Trainer
    from dsml_thesis_tpu_torch.training.vqgan_trainer import TRAINERS

    opt, unknown = get_parser().parse_known_args(argv)
    if opt.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise SystemExit("train_torch: no CUDA device (pass --cpu to train "
                         "on the CPU)")

    if opt.resume:
        if not os.path.isdir(opt.resume):
            raise ValueError("--resume expects a run logdir or a checkpoint "
                             "directory inside it")
        path = opt.resume.rstrip("/")
        if os.path.basename(os.path.dirname(path)) == "checkpoints":
            resume_ckpt = os.path.basename(path)
            logdir = os.path.dirname(os.path.dirname(path))
        else:
            logdir, resume_ckpt = path, "last"
        saved = sorted(glob.glob(os.path.join(logdir, "configs/*.yaml")))
        if not saved and not opt.base:
            raise ValueError(f"no saved configs under {logdir}/configs")
        opt.base = saved + opt.base
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        cfg_name = opt.name or (os.path.splitext(
            os.path.basename(opt.base[0]))[0] if opt.base else "run")
        logdir = os.path.join(opt.logdir, f"{now}_{cfg_name}")
        resume_ckpt = None

    config = load_config(opt.base, overrides=unknown)
    config["scale_lr"] = opt.scale_lr.lower() in ("true", "1", "yes")
    os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
    with open(os.path.join(logdir, "configs", "project.yaml"), "w") as f:
        yaml.safe_dump(config, f)

    target = config["model"]["target"]
    first_stage = target in TRAINERS
    if first_stage:
        trainer = TRAINERS[target](config, logdir, seed=opt.seed,
                                   max_steps=opt.max_steps, device=device)
    elif "autoencoder" in target or "tune" in target.rsplit(".", 2)[-2]:
        raise NotImplementedError(
            f"model target {target}: the finetune trainer is not ported")
    else:
        trainer = Trainer(config, logdir, seed=opt.seed,
                          max_steps=opt.max_steps, device=device)
    print(f"logdir: {logdir}; device: {device}; lr: {trainer.lr:.3e}")

    try:
        if opt.train:
            if resume_ckpt is not None:
                trainer.restore_checkpoint(resume_ckpt)
            state = trainer.fit(epochs=opt.epochs or None,
                                log_every=opt.log_every)
            print("training done; final step:", state.step)
            if not (opt.no_test or first_stage):
                test_metrics = trainer.test()
                if test_metrics:
                    print("test:", {k: round(v, 5)
                                    for k, v in test_metrics.items()})
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
