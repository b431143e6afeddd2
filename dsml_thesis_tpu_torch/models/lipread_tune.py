"""Lip-reading finetune of the talking-face LDM.

Counterpart of ``dsml_thesis_tpu/models/lipread_tune.py`` (the reference's
``ddpm2condtune``): in place of the eps-MSE, the loss

  1. encodes the target frame through the frozen first stage;
  2. noises it at t ~ U{0..T-1} on the original schedule (``q_sample``);
  3. runs the whole ``decode_steps``-step reverse DDIM chain at eta = 1.0
     under the full conditioning, differentiably, the model in its
     evaluation form (the UNet's eval-mode routing, as the JAX
     ``make_eps_fn`` runs ``apply_model(deterministic=True)``);
  4. decodes prediction (with gradient) and target (without) through the
     frozen first stage, clamped to [-1, 1];
  5. cuts a ``mouth_crop`` gray patch around each mouth's landmark centroid
     (``cut_mouth``), center-crops it to ``mouth_center_crop``, normalizes
     it and resizes it bilinearly to ``mouth_size``;
  6. takes the frozen lipreader's frame features of both and minimizes
     ``1 - cos`` (weighted by ``lr_loss_weight`` from step
     ``start_lr_loss`` on, ``adopt_weight``) plus the L2 of the latents.

Without a lipreader the loss is the L2 term alone, as in the JAX package.
The lipreader (``models/lipreader.py``'s features, or any callable) is held
here, outside the LDM whose trainable parameters the optimizer and the EMA
take, frozen and in eval mode. Random draws come from a ``torch.Generator``
(another stream than ``jax.random`` gives from the same seed); each can be
handed in: ``t``, ``noise`` (the ``q_sample`` noise), ``drop`` (the label
drop) and ``noise_seq`` (the chain's per-step noise, row i at step i).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.ddim import ddim_reverse_from
from ..diffusion.gaussian import q_sample
from ..diffusion.schedules import make_ddim_schedule
from ..losses.discriminator import adopt_weight
from .ldm import LatentDiffusion

MOUTH_IDX_START, MOUTH_IDX_STOP = 48, 68   # the 68-landmark mouth range
GRAY = (0.2989, 0.587, 0.114)


def cut_mouth(images: torch.Tensor, landmarks: torch.Tensor, crop: int = 96,
              grayscale: bool = True) -> torch.Tensor:
    """A (crop x crop) patch of each image centred on its mouth landmarks.

    images [B, H, W, C] in [-1, 1], landmarks [B, 68, 2] pixel coordinates
    (x, y). The centroid of landmarks 48-68 is rounded (half to even, as
    ``jnp.round``) and clamped to [crop // 2, size - crop // 2]; the patch's
    corner is kept inside the image, as ``lax.dynamic_slice`` keeps it. A
    differentiable gather per sample."""
    b, h, w, _ = images.shape
    centers = landmarks[:, MOUTH_IDX_START:MOUTH_IDX_STOP, :].mean(dim=1)
    half = crop // 2
    cx = torch.clamp(torch.round(centers[:, 0]), half, w - half).long()
    cy = torch.clamp(torch.round(centers[:, 1]), half, h - half).long()
    if grayscale:
        rgb = torch.tensor(GRAY, dtype=images.dtype, device=images.device)
        images = (images * rgb).sum(dim=-1, keepdim=True)
    x0 = torch.clamp(cx - half, 0, w - crop)
    y0 = torch.clamp(cy - half, 0, h - crop)
    ar = torch.arange(crop, device=images.device)
    rows = (y0[:, None] + ar)[:, :, None]            # [B, crop, 1]
    cols = (x0[:, None] + ar)[:, None, :]            # [B, 1, crop]
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images[bi, rows, cols]


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, h, w, C] -> [B, size, size, C], half-pixel bilinear without
    antialiasing: ``jax.image.resize(..., "bilinear")`` for an upsample."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                         mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1)


class LipreadFinetune(nn.Module):
    """The lip-reading finetune loss over the talking-face
    ``LatentDiffusion``. ``lipreader``: frozen frame features, mouths
    [B, mouth_size, mouth_size, 1] (gray, normalized) -> [B, D]."""

    def __init__(self, ldm: LatentDiffusion,
                 lipreader: Optional[Callable] = None,
                 decode_steps: int = 8, lr_loss_weight: float = 1.0,
                 start_lr_loss: int = 0, mouth_crop: int = 72,
                 mouth_center_crop: int = 64, mouth_size: int = 88,
                 mouth_mean: float = 0.421, mouth_std: float = 0.165):
        super().__init__()
        self.ldm = ldm
        self.lipreader = lipreader
        if isinstance(lipreader, nn.Module):
            lipreader.requires_grad_(False)
        self.decode_steps = decode_steps
        self.lr_loss_weight, self.start_lr_loss = lr_loss_weight, start_lr_loss
        self.mouth_crop, self.mouth_center_crop = mouth_crop, mouth_center_crop
        self.mouth_size = mouth_size
        # applied to the [-1, 1] gray crop as it is (the reference's
        # Normalize(0, 1) ahead of it is the identity)
        self.mouth_mean, self.mouth_std = mouth_mean, mouth_std
        self.ddim = make_ddim_schedule(ldm.schedule, decode_steps, eta=1.0)

    def train(self, mode: bool = True) -> "LipreadFinetune":
        """The lipreader stays in eval mode whatever the mode."""
        super().train(mode)
        if isinstance(self.lipreader, nn.Module):
            self.lipreader.eval()
        return self

    def prep_mouths(self, images: torch.Tensor,
                    landmarks: torch.Tensor) -> torch.Tensor:
        """Decoded frames -> the lipreader's input: the gray mouth crop,
        center-cropped, normalized, resized to ``mouth_size``."""
        m = cut_mouth(images, landmarks, crop=self.mouth_crop)
        cc = self.mouth_center_crop
        off = (self.mouth_crop - cc) // 2
        m = m[:, off:off + cc, off:off + cc, :]
        m = (m - self.mouth_mean) / self.mouth_std
        return resize_bilinear(m, self.mouth_size)

    def training_loss(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      global_step: int = 0, training: bool = True,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      drop: Optional[torch.Tensor] = None,
                      noise_seq: Optional[torch.Tensor] = None):
        """Returns (loss, aux) with ``l2_loss``, ``lr_loss`` (with a
        lipreader) and ``loss``. ``training=False`` is the validation form:
        no label drop. The draws come from ``generator`` unless handed
        in."""
        ldm = self.ldm.eval()
        z0 = ldm.encode_first_stage(batch[ldm.first_stage_key])
        cond = ldm.encode_conditioning(batch, training=training,
                                       generator=generator, drop=drop)
        if t is None:
            t = torch.randint(0, ldm.schedule.num_timesteps, (z0.shape[0],),
                              generator=generator, device=z0.device)
        if noise is None:
            noise = torch.randn(z0.shape, generator=generator,
                                device=z0.device, dtype=z0.dtype)
        if noise_seq is None:
            noise_seq = torch.randn((self.ddim.num_steps,) + tuple(z0.shape),
                                    generator=generator, device=z0.device,
                                    dtype=torch.float32)
        z_rec = ddim_reverse_from(self.ddim, ldm.make_eps_fn(cond),
                                  q_sample(ldm.schedule, z0, t, noise),
                                  noise_seq=noise_seq)
        loss = torch.mean((z_rec - z0) ** 2)
        aux = {"l2_loss": loss}
        if self.lipreader is not None:
            if "landmarks" not in batch:
                raise KeyError(
                    "lipread finetune needs batch['landmarks'] (MEADBase5 / "
                    "include_landmarks=True); refusing to train with the L2 "
                    "term only")
            lm = batch["landmarks"][..., :2]
            x_pred = torch.clamp(ldm.decode_first_stage(z_rec), -1.0, 1.0)
            f_pred = self.lipreader(self.prep_mouths(x_pred, lm))
            with torch.no_grad():
                x_gt = torch.clamp(ldm.decode_first_stage(z0), -1.0, 1.0)
                f_gt = self.lipreader(self.prep_mouths(x_gt, lm))
            cos = (f_pred * f_gt).sum(dim=-1) / (
                torch.linalg.vector_norm(f_pred, dim=-1)
                * torch.linalg.vector_norm(f_gt, dim=-1) + 1e-8)
            aux["lr_loss"] = 1.0 - cos.mean()
            w = adopt_weight(self.lr_loss_weight, global_step,
                             self.start_lr_loss)
            loss = loss + w * aux["lr_loss"]
        aux["loss"] = loss
        return loss, aux
