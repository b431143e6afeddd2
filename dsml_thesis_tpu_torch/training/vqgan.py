"""First-stage training steps: the fused generator + discriminator step of
the VQGAN, its validation step, and the state both share with the KL
autoencoder's (``training/kl_ae.py``).

Counterpart of ``dsml_thesis_tpu/training/vqgan.py``
(``make_vqgan_train_step``, ``make_vqgan_eval_step``). A step, in the JAX
package's order: the generator loss (with the adaptive GAN weight taken on
the step's own graph) and the autoencoder's update, then the
discriminator's loss on the input and the PRE-update reconstruction, both
detached, and the discriminator's update. Two ``torch.optim.Adam(lr,
betas=(0.5, 0.9), eps=1e-8)``, which is optax's ``adam(b1=0.5, b2=0.9)``
term for term. A trainable parameter that gets no gradient steps a zero one
(optax does; ``torch.optim`` would skip it). Metrics come back as 0-dim
tensors (no synchronisation in the step).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import torch

from ..losses.vqperceptual import VQGANLoss
from ..models.autoencoder import VQModel


def make_adam(params: Sequence[torch.nn.Parameter],
              lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


@dataclasses.dataclass
class FirstStageState:
    """What a first-stage step updates: the step counter (it gates the GAN
    term), the parameters of each optimizer and the two optimizers; ``seed``
    seeds the KL autoencoder's posterior draws."""

    step: int
    seed: int
    ae_params: List[torch.nn.Parameter]
    disc_params: List[torch.nn.Parameter]
    ae_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam

    def state_dict(self) -> Dict:
        return {"step": self.step, "ae_opt": self.ae_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.step = int(sd["step"])
        self.ae_opt.load_state_dict(sd["ae_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])


def create_first_stage_state(model: torch.nn.Module, loss: torch.nn.Module,
                             lr: float, seed: int = 0,
                             extra_ae_params: Sequence[torch.nn.Parameter] = ()
                             ) -> FirstStageState:
    """The autoencoder's optimizer over every model parameter (and
    ``extra_ae_params``: the KL loss's log-variance when it is trained), the
    discriminator's over the discriminator's."""
    ae_params = list(model.parameters()) + list(extra_ae_params)
    disc_params = list(loss.discriminator.parameters())
    return FirstStageState(0, seed, ae_params, disc_params,
                           make_adam(ae_params, lr), make_adam(disc_params, lr))


def apply_grads(params: List[torch.nn.Parameter], loss_value: torch.Tensor,
                opt: torch.optim.Optimizer) -> None:
    """Gradients of ``loss_value`` for ``params`` alone (zeros where there is
    none), then one optimizer step."""
    grads = torch.autograd.grad(loss_value, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    for p in params:
        p.grad = None


def gan_step(state: FirstStageState, loss, x: torch.Tensor, rec: torch.Tensor,
             g_total: torch.Tensor, g_log: Dict) -> Dict[str, torch.Tensor]:
    """The part of a step after the generator loss: the autoencoder's update,
    the discriminator's loss on (x, pre-update rec) and its update."""
    apply_grads(state.ae_params, g_total, state.ae_opt)
    d_total, d_log = loss.discriminator_loss(x, rec, state.step)
    apply_grads(state.disc_params, d_total, state.disc_opt)
    state.step += 1
    return {f"train/{k}": v for k, v in {**g_log, **d_log}.items()}


def make_vqgan_train_step(model: VQModel, loss: VQGANLoss) -> Callable:
    def step(state: FirstStageState, x: torch.Tensor) -> Dict:
        rec, qloss, _ = model(x)
        g_total, g_log = loss.generator_loss(
            qloss, x, rec, state.step,
            last_layer=model.decoder.conv_out.weight)
        return gan_step(state, loss, x, rec, g_total, g_log)

    return step


def make_vqgan_eval_step(model: VQModel, loss: VQGANLoss) -> Callable:
    """Generator and discriminator losses of a validation batch, no update;
    ``val/rec_loss`` is the NLL the configs monitor. ``idx`` (the batch's
    index) is unused: the VQ pass draws nothing."""

    @torch.no_grad()
    def step(state: FirstStageState, x: torch.Tensor, idx: int) -> Dict:
        del idx
        rec, qloss, _ = model(x)
        g_total, g_log = loss.generator_loss(qloss, x, rec, state.step,
                                             val=True)
        d_total, _ = loss.discriminator_loss(x, rec, state.step)
        return {"val/rec_loss": g_log["nll_loss"], "val/aeloss": g_total,
                "val/quant_loss": g_log["quant_loss"], "val/disc_loss": d_total}

    return step
