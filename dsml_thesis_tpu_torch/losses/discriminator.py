"""PatchGAN discriminator and the GAN losses of first-stage training.

Counterpart of ``dsml_thesis_tpu/losses/discriminator.py``: GroupNorm in
place of the reference's BatchNorm, as Flax computes it (fp32 statistics,
variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6; plain ops, as XLA's there),
``normal(0, 0.02)`` conv weights, 4 x 4 kernels with padding 1. Inputs and
logits are NHWC.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _groups_for(channels: int, cap: int = 32) -> int:
    """Largest group count <= cap that divides ``channels``."""
    g = min(cap, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """Flax's GroupNorm module on NCHW, in plain ops."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.num_groups, -1)
        mean = xg.mean(-1, keepdim=True)
        var = ((xg * xg).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class NLayerDiscriminator(nn.Module):
    def __init__(self, ndf: int = 64, n_layers: int = 3, input_nc: int = 3):
        super().__init__()
        self.n_layers = n_layers
        conv = lambda cin, cout, stride, bias: nn.Conv2d(
            cin, cout, 4, stride=stride, padding=1, bias=bias)
        self.conv0 = conv(input_nc, ndf, 2, True)
        cin = ndf
        for i in range(1, n_layers + 1):
            cout = ndf * min(2 ** i, 8)
            setattr(self, f"conv{i}", conv(cin, cout, 2 if i < n_layers else 1,
                                           False))
            setattr(self, f"norm{i}",
                    GroupNorm(_groups_for(cout), cout))
            cin = cout
        self.conv_out = conv(cin, 1, 1, True)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> patch logits [B, h, w, 1]."""
        h = F.leaky_relu(self.conv0(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``weight`` from ``threshold`` steps on, ``value`` before."""
    return value if global_step < threshold else weight


def adaptive_d_weight(nll: torch.Tensor, g_loss: torch.Tensor,
                      last_layer: torch.Tensor,
                      disc_weight: float) -> torch.Tensor:
    """||d nll / d last|| / (||d g_loss / d last|| + 1e-4), clamped to
    [0, 1e4], times ``disc_weight``, no gradient: both gradients are taken on
    the step's own graph (which is kept for the step's backward)."""
    nll_g, = torch.autograd.grad(nll, last_layer, retain_graph=True)
    g_g, = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
    d_weight = nll_g.norm() / (g_g.norm() + 1e-4)
    return (d_weight.clamp(0.0, 1e4) * disc_weight).detach()
