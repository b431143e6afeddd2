"""KL-autoencoder training steps (the same fused shape as the VQGAN's,
``training/vqgan.py``).

Counterpart of ``dsml_thesis_tpu/training/kl_ae.py``: the posterior is
sampled in training and in validation. The JAX package draws its noise from
a key it splits once a step; here a step draws from a generator seeded from
(seed, step), a validation batch from (seed, step, batch index). ``noise``
replaces the draw (the tests hand both frameworks the same numbers). With
``train_logvar`` the loss's log-variance moves under the autoencoder's
optimizer (the trainer puts it there).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..losses.contperceptual import KLAutoencoderLoss
from ..models.autoencoder import AutoencoderKL
from .train_state import fold_seed
from .vqgan import FirstStageState, gan_step


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_kl_ae_train_step(model: AutoencoderKL,
                          loss: KLAutoencoderLoss) -> Callable:
    def step(state: FirstStageState, x: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> Dict:
        gen = (_generator(fold_seed(state.seed, state.step), x.device)
               if noise is None else None)
        rec, posterior = model(x, generator=gen, noise=noise,
                               sample_posterior=True)
        g_total, g_log = loss.generator_loss(
            posterior.kl(), x, rec, state.step,
            last_layer=model.decoder.conv_out.weight)
        return gan_step(state, loss, x, rec, g_total, g_log)

    return step


def make_kl_ae_eval_step(model: AutoencoderKL,
                         loss: KLAutoencoderLoss) -> Callable:
    """Validation: a posterior sample of fresh noise per batch (the batch
    index folded into the seed), generator and discriminator losses, no
    update; ``val/rec_loss`` is the logvar-free mean the config monitors."""

    @torch.no_grad()
    def step(state: FirstStageState, x: torch.Tensor, idx: int,
             noise: Optional[torch.Tensor] = None) -> Dict:
        gen = (_generator(fold_seed(fold_seed(state.seed, state.step), idx),
                          x.device) if noise is None else None)
        rec, posterior = model(x, generator=gen, noise=noise,
                               sample_posterior=True)
        g_total, g_log = loss.generator_loss(posterior.kl(), x, rec,
                                             state.step, val=True)
        d_total, _ = loss.discriminator_loss(x, rec, state.step)
        return {"val/rec_loss": g_log["rec_loss"], "val/aeloss": g_total,
                "val/kl_loss": g_log["kl_loss"], "val/disc_loss": d_total}

    return step
