"""LatentDiffusion of the port: one engine for every conditioning layout.

Counterpart of ``dsml_thesis_tpu/models/ldm.py`` for sampling and for the
diffusion training loss. A list of
``CondSpec`` says, for every conditioning stream, which batch key feeds
which encoder and whether the result joins the cross-attention context
(feature- or token-concatenated) or is channel-concatenated onto the UNet
input (optionally after the frozen first stage). Unlike the JAX class, whose
methods take a parameter tree, this is an ``nn.Module`` that owns its
parameters: ``unet``, ``first_stage`` and ``cond.<key>``.

Training: ``training_loss(batch, generator)`` is the JAX class's
``training_loss(params, batch, rng)``. The first stage is always frozen (eval
mode, ``torch.no_grad()``); ``trainable_filter`` / ``frozen_subpaths`` say
which groups and sub-trees the optimizer gets, and ``configure_trainable``
sets ``requires_grad`` to match. Random draws come from a ``torch.Generator``
(another stream than ``jax.random`` gives from the same seed), and each can
be handed in (``t=``, ``noise=``, ``drop=``) as ``x_T`` can for sampling.

Sampling: ``null_conditioning`` and ``make_eps_fn`` compose the guided
model closure of the samplers, as the JAX class's methods of those names do;
``sample_ddim`` runs a DDIM chain under them (the trainer's image logger).

``split_input_params`` runs the UNet (and, with ``patch_distributed_vq``,
the first-stage encode and decode) over overlapping patches blended by
``diffusion/tiling.py``. Not ported yet: KL first stages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..diffusion import tiling
from ..diffusion.ddim import cfg_eps_fn, ddim_sample
from ..diffusion.gaussian import p_losses, q_sample
from ..diffusion.schedules import DiffusionSchedule, make_ddim_schedule

from .encoders import ClassEmbedder

ROUTES = ("crossattn_feature", "crossattn_token", "concat_first_stage",
          "concat_raw")
_LABEL_DROPPERS = (ClassEmbedder,)   # encoders whose forward takes training=


@dataclasses.dataclass(frozen=True)
class CondSpec:
    """One conditioning stream: batch key, encoder (None = pass-through),
    route (one of ``ROUTES``) and whether training updates the encoder."""

    key: str
    module: Optional[nn.Module]
    route: str = "crossattn_feature"
    trainable: bool = True


class LatentDiffusion(nn.Module):
    # training_loss honours batch["_sample_weights"] (ragged-tail validation)
    supports_sample_weights = True

    def __init__(self, unet: nn.Module, first_stage: Optional[nn.Module],
                 cond_specs: Sequence[CondSpec], schedule: DiffusionSchedule,
                 scale_factor: float = 1.0, parameterization: str = "eps",
                 first_stage_key: str = "image", image_size: int = 32,
                 channels: int = 3, split_input_params: Optional[Dict] = None,
                 loss_type: str = "l2", l_simple_weight: float = 1.0,
                 original_elbo_weight: float = 0.0,
                 monitor: str = "val_loss_ema"):
        super().__init__()
        self.loss_type, self.monitor = loss_type, monitor
        self.l_simple_weight = l_simple_weight
        self.original_elbo_weight = original_elbo_weight
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

    def _split_params(self) -> Optional[Dict]:
        """split_input_params when the patch-distributed first stage is on."""
        sp = self.split_input_params
        if sp and sp.get("patch_distributed_vq", True):
            return sp
        return None

    # ---------- which parameters train ----------

    def param_groups(self) -> Dict[str, nn.Module]:
        """Top-level parameter groups under the JAX tree's names: ``unet``,
        ``first_stage`` and ``cond/<key>``."""
        groups = {"unet": self.unet}
        if self.first_stage is not None:
            groups["first_stage"] = self.first_stage
        groups.update({f"cond/{k}": m for k, m in self.cond.items()})
        return groups

    def trainable_filter(self) -> Dict[str, bool]:
        """Which groups receive gradients: the UNet and the trainable cond
        stages; the first stage is always frozen."""
        by_key = {s.key: s for s in self.cond_specs}
        return {name: name == "unet" or (name.startswith("cond/")
                                         and by_key[name[5:]].trainable)
                for name in self.param_groups()}

    def frozen_subpaths(self) -> Dict[str, Sequence[str]]:
        """Sub-trees inside otherwise-trainable groups that the optimizer
        must skip ('/'-joined paths by group): what a cond stage declares
        through ``frozen_paths()``. Decoupled weight decay must not erode
        them even though they get no gradient."""
        out: Dict[str, Sequence[str]] = {}
        for spec in self.cond_specs:
            if (spec.module is not None and spec.trainable
                    and hasattr(spec.module, "frozen_paths")):
                paths = tuple(spec.module.frozen_paths())
                if paths:
                    out[f"cond/{spec.key}"] = paths
        return out

    def named_trainable_parameters(self):
        """(group, name inside the group, parameter) of every parameter the
        optimizer updates and the EMA shadows, in module order."""
        trainable, frozen = self.trainable_filter(), self.frozen_subpaths()
        for group, module in self.param_groups().items():
            if not trainable[group]:
                continue
            skip = tuple(p.replace("/", ".") for p in frozen.get(group, ()))
            for name, param in module.named_parameters():
                if not any(name == f or name.startswith(f + ".") for f in skip):
                    yield group, name, param

    def configure_trainable(self) -> "LatentDiffusion":
        """Set ``requires_grad`` on every parameter to what the optimizer
        will update, and nothing else."""
        for p in self.parameters():
            p.requires_grad_(False)
        for _, _, p in self.named_trainable_parameters():
            p.requires_grad_(True)
        return self

    def train(self, mode: bool = True) -> "LatentDiffusion":
        """The frozen first stage stays in eval mode whatever the mode."""
        super().train(mode)
        if self.first_stage is not None:
            self.first_stage.eval()
        return self

    # ---------- first stage (frozen) ----------

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B,H,W,3] -> scaled latents [B,h,w,c]; with
        ``split_input_params`` overlapping pixel patches are encoded and
        their latents blended (df = vqf)."""
        if self.first_stage is None:
            return x * self.scale_factor
        sp = self._split_params()
        if sp is not None:
            z = tiling.tiled_apply(lambda v, L: self.first_stage.encode(v), x,
                                   sp, df=int(sp["vqf"]))
        else:
            z = self.first_stage.encode(x)
        return z * self.scale_factor

    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """Scaled latents -> images; the VQ first stage quantizes first.
        With ``split_input_params`` overlapping latent patches are decoded
        and their pixels blended (uf = vqf)."""
        z = z / self.scale_factor
        if self.first_stage is None:
            return z
        dec = lambda v: self.first_stage.decode(
            v, force_not_quantize=force_not_quantize)
        sp = self._split_params()
        if sp is not None:
            return tiling.tiled_apply(lambda v, L: dec(v), z, sp,
                                      uf=int(sp["vqf"]))
        return dec(z)

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

    def encode_conditioning(self, batch: Dict[str, torch.Tensor],
                            training: bool = False,
                            generator: Optional[torch.Generator] = None,
                            drop: Optional[torch.Tensor] = None,
                            null: bool = False,
                            batch_size: Optional[int] = None
                            ) -> Dict[str, Optional[torch.Tensor]]:
        """Run every cond stage and route the streams: cross-attention
        context (feature- then token-concatenated) and the channel-concat
        group (``concat_first_stage`` streams through the frozen first
        stage). With ``training`` an encoder that drops labels draws from
        ``generator`` (or takes ``drop``); a non-trainable encoder's output
        is detached. ``null`` gives the unconditional branch of the guidance
        (see ``null_conditioning``)."""
        feat, tok, concat = [], [], []
        for spec in self.cond_specs:
            if (null and spec.route.startswith("crossattn")
                    and spec.module is not None
                    and hasattr(spec.module, "null_token")):
                n = batch_size if batch_size is not None \
                    else batch[spec.key].shape[0]
                v = spec.module.null_token(n)
                (feat if spec.route == "crossattn_feature" else tok).append(v)
                continue
            v = batch[spec.key]
            if spec.module is not None:
                if isinstance(spec.module, _LABEL_DROPPERS):
                    v = spec.module(v, training=training, generator=generator,
                                    drop=drop)
                else:
                    v = spec.module(v)
                if not spec.trainable:
                    v = v.detach()
            if spec.route == "crossattn_feature":
                feat.append(v)
            elif spec.route == "crossattn_token":
                tok.append(v)
            elif spec.route == "concat_first_stage":
                concat.append(self.encode_first_stage(v))
            else:
                concat.append(v)
        ctx = None
        if feat:
            dt = feat[0].dtype
            for f in feat[1:]:
                dt = torch.promote_types(dt, f.dtype)
            ctx = torch.cat([f.to(dt) for f in feat], dim=-1)
        if tok:
            t = torch.cat(tok, dim=1)
            ctx = t if ctx is None else torch.cat([ctx, t], dim=1)
        return {"crossattn": ctx,
                "concat": torch.cat(concat, dim=-1) if concat else None}

    def null_conditioning(self, batch: Dict[str, torch.Tensor],
                          batch_size: int) -> Dict[str, Optional[torch.Tensor]]:
        """The unconditional branch of classifier-free guidance: each
        cross-attention stream from its encoder's null token at
        ``batch_size`` (the batch may hold None there), the concat streams
        as ``encode_conditioning`` routes them."""
        return self.encode_conditioning(batch, null=True,
                                        batch_size=batch_size)

    def make_eps_fn(self, cond: Dict[str, Optional[torch.Tensor]],
                    uncond: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                    scale: float = 1.0):
        """``eps_fn(x, t)`` of the samplers: the model under ``cond``, with
        classifier-free guidance against ``uncond`` at ``scale`` (one
        batch-doubled call; a single conditional call at scale 1 or without
        ``uncond``)."""
        if self.parameterization != "eps":
            raise NotImplementedError(
                "sampling is implemented for parameterization='eps' only, "
                f"got {self.parameterization!r}")
        return cfg_eps_fn(lambda x, t, c: self.apply_model(x, t, c), cond,
                          uncond, scale)

    def sample_ddim(self, cond: Dict[str, Optional[torch.Tensor]], shape,
                    generator: Optional[torch.Generator] = None,
                    steps: int = 50, eta: float = 0.0,
                    uncond: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                    guidance_scale: float = 1.0,
                    x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents [B, h, w, c] of a ``steps``-step DDIM chain under
        ``cond`` (guided against ``uncond`` at ``guidance_scale``); eta > 0
        adds the step noise. ``x_T`` replaces the initial draw from
        ``generator``."""
        ddim = make_ddim_schedule(self.schedule, steps, eta=eta)
        return ddim_sample(ddim, self.schedule,
                           self.make_eps_fn(cond, uncond, guidance_scale),
                           shape, generator, x_T=x_T, eta_noise=eta > 0)

    # ---------- model application ----------

    def apply_model(self, x_t: torch.Tensor, t: torch.Tensor,
                    cond: Dict[str, Optional[torch.Tensor]],
                    cfg_pairs: bool = False) -> torch.Tensor:
        """Channel-concat the concat streams, cross-attend to the context.
        With ``cfg_pairs`` x_t / t / concat arrive at B and the context is
        the [uncond; cond] pair at 2B (see ``UNetModel.forward``).

        With ``split_input_params`` the UNet runs over overlapping patches
        of the channel-concatenated input, the context and t replicated per
        patch, and the eps patches are blended; the guidance-pair dedup is
        refused there."""
        x_in = x_t
        if cond.get("concat") is not None:
            cc = cond["concat"]
            dt = torch.promote_types(x_t.dtype, cc.dtype)
            x_in = torch.cat([x_t.to(dt), cc.to(dt)], dim=-1)
        ctx = cond.get("crossattn")
        if self.split_input_params is None:
            return self.unet(x_in, t, ctx, cfg_pairs=cfg_pairs)
        if cfg_pairs:
            raise NotImplementedError(
                "cfg_pairs dedup not supported with split_input_params")

        def fn(patches, L):
            c_rep = None if ctx is None else ctx.repeat_interleave(L, 0)
            return self.unet(patches, t.repeat_interleave(L, 0), c_rep)

        return tiling.tiled_apply(fn, x_in, self.split_input_params)

    # ---------- training ----------

    def training_loss(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      training: bool = True, t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      drop: Optional[torch.Tensor] = None):
        """The diffusion loss of one batch: frozen first-stage encode of the
        image (a ``latent`` batch is taken as it is: already encoded and
        scaled), conditioning, a uniform timestep and normal noise per
        sample, ``q_sample``, the UNet, ``p_losses``. Returns (loss, aux).

        ``training`` puts the module in that mode first: True is the training
        form (label drop on; the UNet's self-attention takes the
        differentiable packed kernels), False the validation form (t and
        noise stay random, the label drop is off, eval-mode routing). ``t``,
        ``noise`` and ``drop`` replace the draws from ``generator`` (which
        must lie on the batch's device). ``batch["_sample_weights"]`` masks
        rows out of the means."""
        self.train(training)
        x = batch[self.first_stage_key]
        z = x if self.first_stage_key == "latent" else self.encode_first_stage(x)
        cond = self.encode_conditioning(batch, training=training,
                                        generator=generator, drop=drop)
        if t is None:
            t = torch.randint(0, self.schedule.num_timesteps, (z.shape[0],),
                              generator=generator, device=z.device)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=z.device,
                                dtype=z.dtype)
        eps = self.apply_model(q_sample(self.schedule, z, t, noise), t, cond)
        return p_losses(
            self.schedule, eps, z, noise, t,
            parameterization=self.parameterization, loss_type=self.loss_type,
            l_simple_weight=self.l_simple_weight,
            original_elbo_weight=self.original_elbo_weight,
            sample_weights=batch.get("_sample_weights"))
