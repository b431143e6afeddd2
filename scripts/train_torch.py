#!/usr/bin/env python3
"""Training CLI of the PyTorch / CUDA port (the port's ``main.py -t``).

    python3 scripts/train_torch.py --base configs/latent-diffusion/<cfg>.yaml \
        -t [--logdir logs] [--seed 123] [--max-steps N] [--epochs N] \
        [--resume <logdir | logdir/checkpoints/<name>>] [--scale_lr true] \
        [--no-test] [--profile-at-step K] [--cpu] [nested.key=value ...]

Builds the port's ``Trainer`` from the merged config, trains (``-t``),
validates with raw and EMA weights, writes ``metrics.jsonl`` and a ``last``
checkpoint under the run's logdir, and evaluates the test split if the
config has one. A first-stage config (``configs/autoencoder/*.yaml``: a
``VQModel`` or ``AutoencoderKL`` target) goes to ``VQGANTrainer`` /
``KLAETrainer`` instead (validation, top-k on ``val/rec_loss``, ``last``; no
test split). It runs on the card; without one it fails unless ``--cpu`` is
given. The shipped MEAD configs read the MEAD clips (``MEADBase3`` /
``MEADBase5``) through ``data.params.train.params.tuples_path=<tuples.pkl>``,
``data_root=<root>`` and ``audio_dir=<features of
scripts/mead_audio_features_torch.py>`` (and the same under
``data.params.validation``), or take a synthetic node, e.g.

    data.params.train='{target: dsml_thesis_tpu_torch.data.SyntheticDataset,
      params: {length: 64, spec: {image: [[256, 256, 3], float32],
      masked_image: [[256, 256, 3], float32], identity: [[256, 256, 3],
      float32], class_label: [[], int32], audio: [[17, 768], float32]}}}'

The lip-reading finetune (``mead-128-ldm-f4-tune.yaml``, target
``ddpm2condtune``) goes to ``FinetuneTrainer``; its data carry
``landmarks`` (``MEADBase5``, or a synthetic node whose spec adds
``landmarks: [[68, 2], float32]``) and its frozen lipreader comes from
``model.params.lipread_ckpt=<LRS3 model.pth>`` (without it the loss is the
L2 term alone). The AffectNet LDM config
(``affectnet-128-ldm-vq-f4.yaml``) reads its image lists through
``data.params.train.params.training_images_list_file=<list>`` (one path a
line, ``<label>_*.jpg``) and ``...validation.params.test_images_list_file``,
or takes a synthetic node with ``spec: {image: [[128, 128, 3], float32],
class_label: [[], int32]}``. The image logger of the LDM configs
(``lightning.callbacks.image_logger.params``: ``batch_frequency`` 5,000,
``max_images`` 8 as shipped) writes the EMA weights' inputs,
reconstructions, DDIM-20 samples, denoise and diffusion rows (and, for a VQ
first stage, the quantized samples) as ``images/<row>_step<N>.npy`` every
``batch_frequency`` steps.

The DiffusionCLIP finetune
(``affectnet-128-clip-ldm-vq-f4.yaml``, target ``LatentDiffusionCLIP``) goes
to ``FinetuneTrainer``: its data are latent caches of
``scripts/compute_latents_torch.py``
(``data.params.train.params.training_precomputed_latents_path=.../latents.npy``,
``training_origin_path=.../origin.npy``, ``training_files_path=.../files.npy``,
and the ``test_*`` keys of the validation node) and its guidance towers come
from ``model.params.clip_ckpt=<CLIP checkpoint>``,
``model.params.clip_bpe=<BPE merge table>`` and
``model.params.id_ckpt=<IR-SE50 state_dict>``. The first-stage configs name
AffectNet, likewise not read: a node with ``spec: {image: [[128, 128, 3],
float32]}``; their ``perceptual_weight: 1.0`` needs the LPIPS files,
``model.params.lossconfig.params.vgg_ckpt=<torchvision vgg16 features
state_dict>`` and ``model.params.lossconfig.params.lpips_lin_ckpt=<taming
lin heads>``.

Warm start: ``model.params.ckpt_path=<file>`` starts the model (raw weights,
and the EMA from its shadows) from a reference Lightning ``.ckpt``, a
checkpoint of this script (``<logdir>/checkpoints/last/state.pt``) or a
state_dict of the port's model, at step 0 with a fresh optimizer; the
lip-reading tune starts so from a trained ``mead-128-ldm-f4`` run.
``model.params.first_stage_config.params.ckpt_path=<file>`` loads a
pretrained VQGAN (a taming ``.ckpt``, an LDM checkpoint's
``first_stage_model.*`` or a ``VQGANTrainer`` ``state.pt``).
``--profile-at-step K`` writes a ``torch.profiler`` Chrome trace of five
steps from step K to ``<logdir>/profile/``.
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
    p.add_argument("--profile-at-step", type=int, default=None,
                   help="trace five steps from this one with torch.profiler "
                        "(a Chrome trace under <logdir>/profile/)")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (the default is the card, and no "
                        "card is an error)")
    return p


def main(argv=None):
    """Runs the CLI; returns the Trainer (for callers that drive it from
    Python)."""
    import torch
    import yaml

    from dsml_thesis_tpu_torch.config import is_finetune_target, load_config
    from dsml_thesis_tpu_torch.training.finetune_trainer import FinetuneTrainer
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
    elif is_finetune_target(target):
        trainer = FinetuneTrainer(config, logdir, seed=opt.seed,
                                  max_steps=opt.max_steps, device=device)
    elif "autoencoder" in target:
        raise NotImplementedError(f"model target {target} is not ported")
    else:
        trainer = Trainer(config, logdir, seed=opt.seed,
                          max_steps=opt.max_steps, device=device)
    print(f"logdir: {logdir}; device: {device}; lr: {trainer.lr:.3e}")

    try:
        if opt.train:
            if resume_ckpt is not None:
                trainer.restore_checkpoint(resume_ckpt)
            fit_kw = ({} if opt.profile_at_step is None
                      else {"profile_at_step": opt.profile_at_step})
            state = trainer.fit(epochs=opt.epochs or None,
                                log_every=opt.log_every, **fit_kw)
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
