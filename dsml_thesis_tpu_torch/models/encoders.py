"""Conditioning-stage encoders of the talking-face model.

Counterpart of ``dsml_thesis_tpu/models/encoders.py`` for the streams the
ported models use: the class label (with the null embedding of
classifier-free guidance in each of the reference's three layouts) and the
audio window pooled to one token. Both
compute in the promotion of input and parameter types, like the JAX modules
(an fp32 input through bf16-cast weights stays fp32). In training the
class embedder drops the whole batch's labels to the null token with
probability ``p_uncond`` (one Bernoulli draw a call, from a
``torch.Generator`` or handed in as ``drop``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import Linear


class ClassEmbedder(nn.Module):
    """Class label -> one cross-attention token, with the null embedding that
    classifier-free guidance uses as the unconditional token. ``null_mode``
    selects the reference's variant:

      - ``extra_row`` (the talking-face ``ClassEmbedder``): row
        ``n_classes`` of an (n_classes + 1)-row ``embedding`` table;
      - ``separate`` (``ClassEmbedder3``): an ``embedding`` of n_classes rows
        and a 1-row ``uncond_embedding``; with ``freeze_null``
        (``ClassEmbedder2``) that row is detached and listed by
        ``frozen_paths()``, so that the optimizer never sees it;
      - ``none`` (face reenactment's plain ``ClassEmbedder``): no null
        embedding and no label drop.
    """

    def __init__(self, embed_dim: int, n_classes: int, p_uncond: float = 0.0,
                 key: str = "class_label", null_mode: str = "extra_row",
                 freeze_null: bool = False):
        super().__init__()
        if freeze_null and null_mode != "separate":
            raise ValueError("freeze_null=True requires null_mode='separate' "
                             f"(got null_mode={null_mode!r})")
        if null_mode not in ("extra_row", "separate", "none"):
            raise ValueError(f"unknown null_mode {null_mode!r}")
        if null_mode == "none" and p_uncond != 0.0:
            raise ValueError("null_mode='none' cannot drop labels")
        self.n_classes, self.key = n_classes, key
        self.p_uncond = p_uncond
        self.null_mode, self.freeze_null = null_mode, freeze_null
        extra = 1 if null_mode == "extra_row" else 0
        self.embedding = nn.Embedding(n_classes + extra, embed_dim)
        if null_mode == "separate":
            self.uncond_embedding = nn.Embedding(1, embed_dim)

    def frozen_paths(self):
        """Sub-trees the optimizer skips (``LatentDiffusion.frozen_subpaths``
        collects them): the pinned null row, which decoupled weight decay
        would otherwise shrink though it gets no gradient."""
        return ("uncond_embedding",) if self.freeze_null else ()

    def forward(self, labels: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """labels: int [B] -> tokens [B, 1, embed_dim]. With ``training`` and
        ``p_uncond > 0`` one uniform draw (from ``generator``, on its device)
        decides whether the whole batch takes the null token; ``drop`` (a
        bool scalar) fixes that decision instead of drawing it."""
        c = self.embedding(labels.long())[:, None, :]
        if training and self.p_uncond > 0:
            if drop is None:
                where = generator.device if generator is not None \
                    else labels.device
                drop = torch.rand((), generator=generator,
                                  device=where) < self.p_uncond
            drop = torch.as_tensor(drop, device=c.device)
            c = torch.where(drop, self.null_token(labels.shape[0]), c)
        return c

    def null_token(self, batch_size: int) -> torch.Tensor:
        """Unconditional token for classifier-free guidance, [B, 1, D]."""
        if self.null_mode == "extra_row":
            row = self.embedding.weight[self.n_classes]
        elif self.null_mode == "separate":
            row = self.uncond_embedding.weight[0]
            if self.freeze_null:
                row = row.detach()
        else:
            raise ValueError(
                "this ClassEmbedder has no null embedding (null_mode='none', "
                "the plain variant): guidance needs ClassEmbedder3 or the "
                "talking-face variant")
        return row[None, None, :].expand(batch_size, 1, -1)


class Conv1DTemporalAttention(nn.Module):
    """Attention-pool a (2w+1)-frame audio-feature window into one token.

    A 5-layer Conv1d pyramid 768->192->64->16->4->1 (LeakyReLU 0.02) scores
    the frames, a Linear + softmax over the window gives the weights, the
    token is the weighted sum. x [B, seq_len, D] -> [B, 1, D].
    """

    def __init__(self, seq_len: int, subspace_dim: int = 768,
                 subspace2hidden: bool = False):
        super().__init__()
        if subspace2hidden:
            raise NotImplementedError("subspace2hidden is not ported: no "
                                      "talking-face config sets it")
        self.seq_len = seq_len
        cin = subspace_dim
        for i, ch in enumerate((192, 64, 16, 4, 1)):
            self.add_module(f"att_conv_{i}", nn.Conv1d(cin, ch, 3, padding=1))
            cin = ch
        self.att_dense = Linear(seq_len, seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = x.transpose(1, 2)  # [B, D, L] for Conv1d
        for i in range(5):
            conv = getattr(self, f"att_conv_{i}")
            dt = torch.promote_types(h.dtype, conv.weight.dtype)
            h = F.conv1d(h.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                         padding=1)
            h = F.leaky_relu(h, negative_slope=0.02)
        attn = torch.softmax(self.att_dense(h.reshape(b, self.seq_len)), dim=1)
        return (x * attn[:, :, None]).sum(dim=1)[:, None, :]
