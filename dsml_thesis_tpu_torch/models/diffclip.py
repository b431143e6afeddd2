"""DiffusionCLIP-style finetune of the AffectNet LDM (emotion editing by
gradient steering).

Counterpart of ``dsml_thesis_tpu/models/diffclip.py``: from cached
DDIM-inverted latents (``scripts/compute_latents_torch.py``), run the short
reverse DDIM chain of the training schedule (``train_steps`` steps over the
first ``strength`` of the diffusion) under the TARGET emotion, decode it
through the frozen first stage, and minimize

    l2_weight * L2(edit, src) + id_weight * ID(src, edit)
      + clip_weight * -log((2 - d_dir) / 2)

Autograd runs through the whole chain and the decoder into the UNet. As in
the JAX package the chain runs the model in its evaluation form (the UNet's
eval-mode routing, no label drop; JAX ``make_eps_fn`` ->
``apply_model(deterministic=True)``) and the decode is not clamped. Only the
UNet trains: the conditioning stage of the shipped config is not trainable,
the first stage is frozen, and the guidance towers (``clip_image_embed``,
``arcface_embed``: modules of ``models/clip.py`` / ``models/insight_face.py``
or any callables) are held here, outside the LDM whose trainable parameters
the optimizer and the EMA take, frozen and in eval mode.

Not ported: the emotion-classifier loss (``cls_weight > 0``), whose
EfficientNet tower is not.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..diffusion.ddim import ddim_reverse_from
from ..diffusion.schedules import DDIMSchedule, make_ddim_schedule
from ..losses.guidance import (clip_directional_loss,
                               diffusionclip_direction_loss, id_loss, l2_loss)
from .ldm import LatentDiffusion


class DiffusionCLIPFinetune(nn.Module):
    """The finetune loss over a base ``LatentDiffusion``.

    ``text_direction``: the precomputed unit CLIP text direction, [D] or a
    per-class table [n_classes, D] indexed by the SOURCE class
    (``direction_by_source``, the reference's semantics) or by the target
    class; a batch's ``text_direction`` entry overrides it.
    ``edit_attr_label``: every example is edited toward this class; None
    takes the batch's ``class_label`` as the target."""

    def __init__(self, ldm: LatentDiffusion, train_steps: int = 6,
                 strength: float = 0.5, l2_weight: float = 1.0,
                 id_weight: float = 1.0, clip_weight: float = 1.0,
                 cls_weight: float = 0.0,
                 clip_image_embed: Optional[Callable] = None,
                 arcface_embed: Optional[Callable] = None,
                 classifier_logits: Optional[Callable] = None,
                 edit_attr_label: Optional[int] = None,
                 text_direction: Optional[torch.Tensor] = None,
                 direction_by_source: bool = False):
        super().__init__()
        if cls_weight > 0 or classifier_logits is not None:
            raise NotImplementedError(
                "cls_loss_w > 0 / cls_ckpt: the emotion classifier "
                "(EfficientNet) is not ported")
        self.ldm = ldm
        self.train_steps, self.strength = train_steps, strength
        self.l2_weight, self.id_weight = l2_weight, id_weight
        self.clip_weight = clip_weight
        self.clip_image_embed = clip_image_embed
        self.arcface_embed = arcface_embed
        for tower in (clip_image_embed, arcface_embed):
            if isinstance(tower, nn.Module):
                tower.requires_grad_(False)
        self.edit_attr_label = edit_attr_label
        self.direction_by_source = direction_by_source
        self.register_buffer(
            "text_direction", None if text_direction is None
            else torch.as_tensor(text_direction, dtype=torch.float32))
        self.train_ddim = make_ddim_schedule(ldm.schedule, train_steps,
                                             eta=0.0, strength=strength)

    def train(self, mode: bool = True) -> "DiffusionCLIPFinetune":
        """The guidance towers stay in eval mode whatever the mode."""
        super().train(mode)
        for tower in (self.clip_image_embed, self.arcface_embed):
            if isinstance(tower, nn.Module):
                tower.eval()
        return self

    def targets(self, batch: Dict[str, torch.Tensor],
                n: int) -> torch.Tensor:
        """The target class of each of the first ``n`` examples."""
        if self.edit_attr_label is not None:
            return torch.full((n,), self.edit_attr_label, dtype=torch.long,
                              device=batch["latent"].device)
        return batch["class_label"][:n]

    def edit(self, x_lat: torch.Tensor, target_labels: torch.Tensor,
             ddim: Optional[DDIMSchedule] = None) -> torch.Tensor:
        """The reverse chain from inverted latents under the target labels,
        the model in its evaluation form; differentiable."""
        self.ldm.eval()
        cond = self.ldm.encode_conditioning({"class_label": target_labels})
        eps_fn = self.ldm.make_eps_fn(cond)
        return ddim_reverse_from(ddim or self.train_ddim, eps_fn, x_lat)

    def training_loss(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None):
        """batch: ``latent`` (inverted latents), ``original`` (source images
        in [-1, 1]), ``class_label`` (source class). Returns (loss, aux).
        Nothing is drawn: ``generator`` is accepted for the trainer's step
        and unused."""
        x_lat, src = batch["latent"], batch["original"]
        target = self.targets(batch, x_lat.shape[0])
        edit = self.ldm.decode_first_stage(self.edit(x_lat, target))

        loss = torch.zeros((), device=x_lat.device)
        aux: Dict[str, torch.Tensor] = {}
        if self.l2_weight > 0:
            aux["loss_l2"] = l2_loss(edit, src)
            loss = loss + self.l2_weight * aux["loss_l2"]
        if self.id_weight > 0 and self.arcface_embed is not None:
            aux["loss_id"] = id_loss(self.arcface_embed, src, edit)
            loss = loss + self.id_weight * aux["loss_id"]
        if self.clip_weight > 0 and self.clip_image_embed is not None:
            tdir = batch.get("text_direction")
            if tdir is None:
                tdir = self.text_direction
                if tdir is None:
                    raise ValueError(
                        "clip_loss_w > 0 needs a CLIP text direction: supply "
                        "batch['text_direction'], set text_direction, or add "
                        "clip_bpe (the BPE merge table) next to clip_ckpt in "
                        "the config")
                if tdir.dim() == 2:   # a per-class table: a row an example
                    key = (batch["class_label"] if self.direction_by_source
                           else target)
                    tdir = tdir[key.long()]
            d = clip_directional_loss(self.clip_image_embed, src, edit, tdir)
            aux["loss_clip"] = torch.mean(diffusionclip_direction_loss(d))
            loss = loss + self.clip_weight * aux["loss_clip"]
        aux["loss"] = loss
        return loss, aux
