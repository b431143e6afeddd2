"""Guidance losses of the DiffusionCLIP emotion-editing finetune.

Counterpart of ``dsml_thesis_tpu/losses/guidance.py``:
  - the CLIP directional loss (StyleGAN-NADA): 1 - cos(dI, dT), with dI the
    image embeddings' difference (edit minus source) and dT the precomputed
    text direction; the finetune maps it through -log((2 - d) / 2);
  - the identity loss: 1 - cos of the face-identity embeddings of source and
    edit;
  - the classifier loss: cross-entropy toward the target emotion;
  - the l2 loss between edit and source;
  - the emotion prompts: ``LABEL2EMOTION`` (the source-side text of each
    AffectNet class) and ``EMOTION_PROMPTS`` (per-target pairs).

Each loss takes its encoder as a callable (a module of ``models/clip.py`` or
``models/insight_face.py``, or any function of an image batch), so that the
math runs with stand-ins and with real weights alike.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

LABEL2EMOTION = {
    0: "face", 1: "happy face", 2: "sad face", 3: "surprised face",
    4: "scared face", 5: "disgusted face", 6: "angry face", 7: "face",
}

EMOTION_PROMPTS = {
    0: ("face", "neutral face"),
    1: ("face", "happy face"),
    2: ("face", "sad face"),
    3: ("face", "surprised face"),
    4: ("face", "scared face"),
    5: ("face", "disgusted face"),
    6: ("face", "angry face"),
    7: ("face", "face"),
}

Embed = Callable[[torch.Tensor], torch.Tensor]


def _norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def clip_directional_loss(image_embed_fn: Embed, src_images: torch.Tensor,
                          edited_images: torch.Tensor,
                          text_direction: torch.Tensor) -> torch.Tensor:
    """1 - cos(image direction, text direction), averaged over the batch;
    ``text_direction`` [D] or [B, D]."""
    e_src = image_embed_fn(src_images)
    e_edit = image_embed_fn(edited_images)
    img_dir = _norm(e_edit - e_src)
    txt_dir = _norm(text_direction)
    return torch.mean(1.0 - torch.sum(img_dir * txt_dir, dim=-1))


def diffusionclip_direction_loss(d: torch.Tensor) -> torch.Tensor:
    """-log((2 - d) / 2) of the directional distance."""
    return -torch.log(torch.clamp((2.0 - d) / 2.0, 1e-6, 1.0))


def id_loss(embed_fn: Embed, src_images: torch.Tensor,
            edited_images: torch.Tensor) -> torch.Tensor:
    """1 - cos(identity(src), identity(edit)), averaged over the batch."""
    a = _norm(embed_fn(src_images))
    b = _norm(embed_fn(edited_images))
    return torch.mean(1.0 - torch.sum(a * b, dim=-1))


def cls_loss(logits_fn: Embed, edited_images: torch.Tensor,
             target_labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy toward the target emotion under a frozen classifier."""
    logp = F.log_softmax(logits_fn(edited_images), dim=-1)
    return -torch.mean(torch.gather(logp, -1,
                                    target_labels.long()[:, None]))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)
