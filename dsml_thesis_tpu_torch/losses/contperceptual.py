"""KL-autoencoder training loss: pixel + LPIPS NLL under a log-variance, the
KL term, and the adaptive-weight PatchGAN term.

Counterpart of ``dsml_thesis_tpu/losses/contperceptual.py``
(``KLAutoencoderLoss``): the NLL is sum(rec / exp(logvar) + logvar) / batch
(a config's ``pixelloss_weight`` is not applied, as in the reference);
``logvar`` is a parameter that no optimizer moves unless the trainer's
``train_logvar`` puts it under the autoencoder's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .discriminator import adopt_weight
from .vqperceptual import GANLossBase


class KLAutoencoderLoss(GANLossBase):
    def __init__(self, disc_start: int, logvar_init: float = 0.0,
                 kl_weight: float = 1.0, **kw):
        super().__init__(disc_start, **kw)
        self.kl_weight = kl_weight
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)),
                                   requires_grad=False)

    def _rec_tensor(self, inputs, reconstructions):
        """|x - rec| + w_p * lpips, elementwise."""
        return self._perceptual((inputs - reconstructions).abs(), inputs,
                                reconstructions)

    def _nll_from_rec(self, rec) -> torch.Tensor:
        return torch.sum(rec / torch.exp(self.logvar) + self.logvar) \
            / rec.shape[0]

    def nll_loss(self, inputs, reconstructions) -> torch.Tensor:
        return self._nll_from_rec(self._rec_tensor(inputs, reconstructions))

    def generator_loss(self, kl, inputs, reconstructions, global_step: int,
                       last_layer: Optional[torch.Tensor] = None,
                       val: bool = False):
        """-> (loss, log). ``kl`` is the posterior's per-sample KL [B];
        ``rec_loss`` in the log is the logvar-free mean the configs
        monitor."""
        rec = self._rec_tensor(inputs, reconstructions)
        nll = self._nll_from_rec(rec)
        g_loss = -self.discriminator(reconstructions).mean()
        kl_loss = torch.sum(kl) / kl.shape[0]
        gan_on = self.disc_factor > 0.0
        d_weight = self._d_weight(nll, g_loss,
                                  last_layer if gan_on else None, val, gan_on)
        disc_factor = adopt_weight(self.disc_factor, global_step,
                                   self.disc_start)
        loss = nll + self.kl_weight * kl_loss + d_weight * disc_factor * g_loss
        log = {"total_loss": loss, "logvar": self.logvar.clone(),
               "kl_loss": kl_loss,
               "nll_loss": nll, "rec_loss": rec.mean(), "d_weight": d_weight,
               "disc_factor": torch.tensor(float(disc_factor)),
               "g_loss": g_loss}
        return loss, {k: v.detach() for k, v in log.items()}
