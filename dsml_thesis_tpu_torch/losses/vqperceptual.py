"""VQGAN training loss: pixel + LPIPS reconstruction, commitment, and the
adaptive-weight PatchGAN term.

Counterpart of ``dsml_thesis_tpu/losses/vqperceptual.py`` (``VQGANLoss``).
The adaptive weight differentiates the reconstruction NLL and the generator
loss with respect to the decoder's last conv weight on the step's own graph
(``adaptive_d_weight``), as the reference does; the JAX package re-decodes a
stop-gradient latent for it, which gives the same value.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .discriminator import (NLayerDiscriminator, adaptive_d_weight,
                            adopt_weight, hinge_d_loss, vanilla_d_loss)
from .lpips import LPIPS


class GANLossBase(nn.Module):
    """The discriminator, the frozen LPIPS and the discriminator's loss,
    shared by the VQ and the KL objectives."""

    def __init__(self, disc_start: int, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0,
                 disc_weight: float = 1.0, perceptual_weight: float = 1.0,
                 disc_ndf: int = 64, disc_loss: str = "hinge"):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r}: hinge or vanilla")
        self.disc_start, self.disc_factor = disc_start, disc_factor
        self.disc_weight, self.perceptual_weight = disc_weight, perceptual_weight
        self.discriminator = NLayerDiscriminator(
            ndf=disc_ndf, n_layers=disc_num_layers, input_nc=disc_in_channels)
        self.lpips = LPIPS() if perceptual_weight > 0 else None
        if self.lpips is not None:
            self.lpips.requires_grad_(False)
        self._d_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss

    def _perceptual(self, rec, inputs, reconstructions):
        if self.lpips is None:
            return rec
        p = self.lpips(inputs, reconstructions)
        return rec + self.perceptual_weight * p.reshape(-1, 1, 1, 1)

    def _d_weight(self, nll, g_loss, last_layer, val: bool,
                  need_gan: bool) -> torch.Tensor:
        """The adaptive weight in training; 0 in validation (the reference's
        weight raises there and is caught as 0). Training without a last
        layer raises while the GAN term is on (``need_gan``): a constant in
        its place would train another objective."""
        if not val and last_layer is not None:
            return adaptive_d_weight(nll, g_loss, last_layer, self.disc_weight)
        if not val and need_gan:
            raise ValueError(
                "generator_loss needs last_layer during training (the "
                "adaptive d_weight is not optional while disc_factor > 0)")
        return torch.zeros((), device=nll.device)

    def discriminator_loss(self, inputs, reconstructions, global_step: int
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The discriminator's loss on detached images."""
        logits_real = self.discriminator(inputs.detach())
        logits_fake = self.discriminator(reconstructions.detach())
        disc_factor = adopt_weight(self.disc_factor, global_step,
                                   self.disc_start)
        d_loss = disc_factor * self._d_loss(logits_real, logits_fake)
        return d_loss, {"disc_loss": d_loss.detach(),
                        "logits_real": logits_real.detach().mean(),
                        "logits_fake": logits_fake.detach().mean()}


class VQGANLoss(GANLossBase):
    def __init__(self, disc_start: int, codebook_weight: float = 1.0,
                 pixel_loss: str = "l1", **kw):
        super().__init__(disc_start, **kw)
        if pixel_loss not in ("l1", "l2"):
            raise ValueError(f"pixel_loss {pixel_loss!r}: l1 or l2")
        self.codebook_weight, self.pixel_loss = codebook_weight, pixel_loss

    def nll_loss(self, inputs, reconstructions) -> torch.Tensor:
        d = inputs - reconstructions
        rec = d.abs() if self.pixel_loss == "l1" else d ** 2
        return self._perceptual(rec, inputs, reconstructions).mean()

    def generator_loss(self, codebook_loss, inputs, reconstructions,
                       global_step: int,
                       last_layer: Optional[torch.Tensor] = None,
                       val: bool = False):
        """-> (loss, log). ``last_layer``: the decoder's last conv weight, on
        the graph of ``reconstructions``."""
        nll = self.nll_loss(inputs, reconstructions)
        g_loss = -self.discriminator(reconstructions).mean()
        d_weight = self._d_weight(nll, g_loss, last_layer, val,
                                  self.disc_factor > 0.0)
        disc_factor = adopt_weight(self.disc_factor, global_step,
                                   self.disc_start)
        quant = codebook_loss.mean()
        loss = nll + d_weight * disc_factor * g_loss \
            + self.codebook_weight * quant
        log = {"total_loss": loss, "quant_loss": quant, "nll_loss": nll,
               "d_weight": d_weight,
               "disc_factor": torch.tensor(float(disc_factor)),
               "g_loss": g_loss}
        return loss, {k: v.detach() for k, v in log.items()}
