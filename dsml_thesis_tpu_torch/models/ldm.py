"""LatentDiffusion of the port: one engine for every conditioning layout.

Counterpart of ``dsml_thesis_tpu/models/ldm.py`` for sampling. A list of
``CondSpec`` says, for every conditioning stream, which batch key feeds
which encoder and whether the result joins the cross-attention context
(feature- or token-concatenated) or is channel-concatenated onto the UNet
input (optionally after the frozen first stage). Unlike the JAX class, whose
methods take a parameter tree, this is an ``nn.Module`` that owns its
parameters: ``unet``, ``first_stage`` and ``cond.<key>``.

Not ported yet: training loss, KL first stages, and the split-input patch
tiling (``split_input_params`` raises ``NotImplementedError``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..diffusion.schedules import DiffusionSchedule

ROUTES = ("crossattn_feature", "crossattn_token", "concat_first_stage",
          "concat_raw")


@dataclasses.dataclass(frozen=True)
class CondSpec:
    """One conditioning stream: batch key, encoder (None = pass-through),
    route (one of ``ROUTES``) and whether training updates the encoder."""

    key: str
    module: Optional[nn.Module]
    route: str = "crossattn_feature"
    trainable: bool = True


class LatentDiffusion(nn.Module):
    def __init__(self, unet: nn.Module, first_stage: Optional[nn.Module],
                 cond_specs: Sequence[CondSpec], schedule: DiffusionSchedule,
                 scale_factor: float = 1.0, parameterization: str = "eps",
                 first_stage_key: str = "image", image_size: int = 32,
                 channels: int = 3, split_input_params: Optional[Dict] = None):
        super().__init__()
        for spec in cond_specs:
            if spec.route not in ROUTES:
                raise ValueError(spec.route)
        self.unet = unet
        self.first_stage = first_stage
        self.cond_specs = tuple(cond_specs)
        self.cond = nn.ModuleDict({s.key: s.module for s in cond_specs
                                   if s.module is not None})
        self.schedule = schedule
        self.scale_factor = scale_factor
        self.parameterization = parameterization
        self.first_stage_key = first_stage_key
        self.image_size, self.channels = image_size, channels
        self.split_input_params = split_input_params

    def _no_tiling(self):
        if self.split_input_params is not None:
            raise NotImplementedError(
                "split_input_params (patch tiling) is not ported yet")

    # ---------- first stage (frozen) ----------

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B,H,W,3] -> scaled latents [B,h,w,c]."""
        self._no_tiling()
        if self.first_stage is None:
            return x * self.scale_factor
        return self.first_stage.encode(x) * self.scale_factor

    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """Scaled latents -> images; the VQ first stage quantizes first."""
        self._no_tiling()
        z = z / self.scale_factor
        if self.first_stage is None:
            return z
        return self.first_stage.decode(z,
                                       force_not_quantize=force_not_quantize)

    # ---------- conditioning ----------

    def encode_crossattn_tokens(self, batch: Dict[str, torch.Tensor],
                                null: bool = False) -> torch.Tensor:
        """Context tokens [B, L, D] of the cross-attention streams: the
        feature-concatenated streams joined along the feature axis, then the
        token-concatenated ones along the token axis. Concat streams are
        skipped: the progressive video sampler supplies the masked / identity
        latents itself. ``null=True`` gives the unconditional branch of the
        guidance (each encoder's null token where it has one)."""
        feat, tok = [], []
        for spec in self.cond_specs:
            if not spec.route.startswith("crossattn"):
                continue
            v = batch[spec.key]
            if spec.module is not None:
                if null and hasattr(spec.module, "null_token"):
                    v = spec.module.null_token(v.shape[0])
                else:
                    v = spec.module(v)
            (feat if spec.route == "crossattn_feature" else tok).append(v)
        ctx = None
        if feat:
            dt = feat[0].dtype
            for f in feat[1:]:
                dt = torch.promote_types(dt, f.dtype)
            ctx = torch.cat([f.to(dt) for f in feat], dim=-1)
        if tok:
            t = torch.cat(tok, dim=1)
            ctx = t if ctx is None else torch.cat([ctx, t], dim=1)
        return ctx

    # ---------- model application ----------

    def apply_model(self, x_t: torch.Tensor, t: torch.Tensor,
                    cond: Dict[str, Optional[torch.Tensor]],
                    cfg_pairs: bool = False) -> torch.Tensor:
        """Channel-concat the concat streams, cross-attend to the context.
        With ``cfg_pairs`` x_t / t / concat arrive at B and the context is
        the [uncond; cond] pair at 2B (see ``UNetModel.forward``)."""
        self._no_tiling()
        x_in = x_t
        if cond.get("concat") is not None:
            cc = cond["concat"]
            dt = torch.promote_types(x_t.dtype, cc.dtype)
            x_in = torch.cat([x_t.to(dt), cc.to(dt)], dim=-1)
        return self.unet(x_in, t, cond.get("crossattn"), cfg_pairs=cfg_pairs)
