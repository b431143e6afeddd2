"""Trainer of the guidance finetunes: DiffusionCLIP emotion editing and the
talking-face lip-reading finetune.

Counterpart of ``dsml_thesis_tpu/training/finetune_trainer.py``: the port's
``Trainer`` with the loss module swapped for the finetune wrapper that
``config.build_finetune`` builds over the trainer's LDM. Gradients run
through the differentiable reverse DDIM chain into the UNet (and the
trainable cond stages); the optimizer and the EMA take the LDM's trainable
parameters only, so the first stage and the guidance towers or the
lipreader (held by the wrapper) stay as they were loaded. Validation logs
the wrapper's terms (``val/l2_loss``, ``val/lr_loss`` of the lip-reading
finetune). The warm start (``model.params.ckpt_path``, a first-stage
``ckpt_path``) is the base trainer's: it loads the LDM, and the lipreader,
the guidance towers and the other extras stay as built. ``log_images``
saves the EMA weights' edited grids of the DiffusionCLIP finetune as
``.npy`` under ``images/``
(``lightning.callbacks.image_logger.params.batch_frequency`` sets the
interval); for a wrapper without ``edit`` it does nothing.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import build_finetune
from .trainer import Trainer


class FinetuneTrainer(Trainer):
    """``encoder_fns``: guidance towers handed in (``clip_image_embed``,
    ``arcface_embed``, ``lipreader_fn``) in place of those the config's
    checkpoint paths (``clip_ckpt``, ``clip_bpe``, ``id_ckpt``,
    ``lipread_ckpt``) would build."""

    def __init__(self, config: Dict, logdir: str, seed: int = 123,
                 max_steps: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 encoder_fns: Optional[Dict] = None):
        super().__init__(config, logdir, seed=seed, max_steps=max_steps,
                         device=device)
        self.finetune = build_finetune(self.model_cfg, ldm=self.ldm,
                                       device=self.device,
                                       **(encoder_fns or {})).to(self.device)
        self.loss_module = self.finetune

    @torch.no_grad()
    def log_images(self, batch: Dict, step: int, n: int = 4) -> None:
        """The first ``n`` examples edited by the EMA weights, clamped to
        [-1, 1], as ``images/edited_step<step>.npy``; nothing for a
        wrapper without ``edit`` (the lip-reading finetune)."""
        if not hasattr(self.finetune, "edit") or "latent" not in batch:
            return
        nb = self._to_device(batch)
        x_lat = nb["latent"][:n]
        target = self.finetune.targets(nb, x_lat.shape[0])
        with self._state.ema_scope():
            z = self.finetune.edit(x_lat, target)
            edit = torch.clamp(self.ldm.decode_first_stage(z), -1.0, 1.0)
        outdir = os.path.join(self.logdir, "images")
        os.makedirs(outdir, exist_ok=True)
        np.save(os.path.join(outdir, f"edited_step{step:08d}.npy"),
                edit.float().cpu().numpy())
