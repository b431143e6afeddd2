"""LPIPS perceptual distance (VGG16 features and learned linear heads).

Counterpart of ``dsml_thesis_tpu/losses/lpips.py``: the same five relu taps,
scaling constants, channel normalisation (eps 1e-10) and 1x1 heads.
``load_lpips_weights`` takes the same two files the JAX package's
``convert_lpips_weights`` reads (a torchvision ``vgg16`` ``features``
state_dict and the taming heads ``lin<k>.model.1.weight``), whose layout is
already PyTorch's. The convolutions are cuDNN's: they are plain convolutions
in the JAX package too, with no Pallas kernel behind them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_STAGE_CHANNELS = (64, 128, 256, 512, 512)
_STAGE_CONVS = (2, 2, 3, 3, 3)
# torchvision's vgg16.features indices of each stage's convs
_TV_INDEX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16's conv trunk on NCHW, returning the five relu taps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for s, (n, ch) in enumerate(zip(_STAGE_CONVS, _STAGE_CHANNELS)):
            for i in range(n):
                setattr(self, f"conv{s}_{i}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x):
        taps = []
        for s, n in enumerate(_STAGE_CONVS):
            for i in range(n):
                x = F.relu(getattr(self, f"conv{s}_{i}")(x))
            taps.append(x)
            if s < 4:
                x = F.max_pool2d(x, 2, 2)
        return taps


def _norm_tensor(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """lpips(a, b), a and b in [-1, 1] NHWC -> per-image distance [B]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for s, ch in enumerate(_STAGE_CHANNELS):
            setattr(self, f"lin{s}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None],
                             persistent=False)

    def forward(self, a, b):
        feats = [self.vgg((t.permute(0, 3, 1, 2) - self.shift) / self.scale)
                 for t in (a, b)]
        total = 0.0
        for s, (xa, xb) in enumerate(zip(*feats)):
            diff = (_norm_tensor(xa) - _norm_tensor(xb)) ** 2
            total = total + getattr(self, f"lin{s}")(diff).mean(dim=(1, 2, 3))
        return total


def load_lpips_weights(vgg_sd: Mapping, lin_sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16().features`` state_dict (keys
    ``features.<idx>.weight`` / ``.bias``) and the taming heads (keys
    ``lin<k>.model.1.weight``) -> a state_dict of ``LPIPS`` (fp32)."""
    f32 = lambda v: torch.as_tensor(v).detach().float().cpu()
    out: Dict[str, torch.Tensor] = {}
    for s, idxs in enumerate(_TV_INDEX):
        for i, t in enumerate(idxs):
            out[f"vgg.conv{s}_{i}.weight"] = f32(vgg_sd[f"features.{t}.weight"])
            out[f"vgg.conv{s}_{i}.bias"] = f32(vgg_sd[f"features.{t}.bias"])
    for s in range(len(_STAGE_CHANNELS)):
        out[f"lin{s}.weight"] = f32(lin_sd[f"lin{s}.model.1.weight"])
    return out


def lpips_weight_files(sd: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of ``load_lpips_weights``: an ``LPIPS`` state_dict as the
    two files' state_dicts (torchvision ``vgg16().features``, taming heads),
    e.g. to write weights made from a seed where the real ones are absent."""
    vgg: Dict[str, torch.Tensor] = {}
    for s, idxs in enumerate(_TV_INDEX):
        for i, t in enumerate(idxs):
            vgg[f"features.{t}.weight"] = sd[f"vgg.conv{s}_{i}.weight"]
            vgg[f"features.{t}.bias"] = sd[f"vgg.conv{s}_{i}.bias"]
    lin = {f"lin{s}.model.1.weight": sd[f"lin{s}.weight"]
           for s in range(len(_STAGE_CHANNELS))}
    return vgg, lin
