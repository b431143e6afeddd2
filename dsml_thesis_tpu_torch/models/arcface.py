"""ArcFace iResNet identity backbones (the CSIM metric's towers), and the
eval-mode BatchNorm / PReLU that the IR-SE tower of ``insight_face.py``
shares.

Counterpart of ``dsml_thesis_tpu/models/arcface.py``: the reference's
``backbones/iresnet.py`` (``iresnet18/34/50/100/200``; ``IBasicBlock`` =
BN-Conv-BN-PReLU-Conv-BN with a 1x1-BN downsample where the stride or width
changes; a 512-d embedding). Inference only: call ``.eval()`` (the
BatchNorms then normalize with their running statistics, eps 1e-5) or use
``make_embed_fn``. Sub-modules carry the reference's names (``conv1``,
``layer1.0.bn1``, ``layer1.0.downsample.0``, ``features`` ...), so a
reference state_dict loads with ``load_state_dict``; ``convert_iresnet``
reads exactly the keys the JAX package's converter reads (the tests hold
that) and fills what a checkpoint may lack (``num_batches_tracked``).
Images are NHWC in [-1, 1] at the boundary, NCHW inside.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

_BLOCKS = {
    "iresnet18": (2, 2, 2, 2),
    "iresnet34": (3, 4, 6, 3),
    "iresnet50": (3, 4, 14, 3),
    "iresnet100": (3, 13, 30, 3),
    "iresnet200": (6, 26, 60, 6),
}


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1: (x - mean) / sqrt(var + eps) * weight
    + bias, with the running statistics as the buffers ``mean`` / ``var``
    (the JAX ``_BN``'s names; the IR-SE tower's layout)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.var + self.eps)
        return ((x - self.mean.reshape(shape)) * inv.reshape(shape)
                * self.weight.reshape(shape) + self.bias.reshape(shape))


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1, slopes in ``alpha`` (the JAX name)."""

    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, a * x)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class IBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes, eps=1e-5)
        self.conv1 = _conv3x3(inplanes, planes)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.prelu = nn.PReLU(planes)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn3 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


class IResNet(nn.Module):
    """112 x 112 RGB NHWC in [-1, 1] -> 512-d identity embedding
    (unnormalized, as the reference returns it)."""

    def __init__(self, layers: Sequence[int], num_features: int = 512):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = _conv3x3(3, 64)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.prelu = nn.PReLU(64)
        inplanes = 64
        for i, (n, planes) in enumerate(zip(self.layers, (64, 128, 256, 512))):
            blocks = [IBasicBlock(inplanes, planes, stride=2)]
            blocks += [IBasicBlock(planes, planes) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = planes
        self.bn2 = nn.BatchNorm2d(512, eps=1e-5)
        self.fc = nn.Linear(512 * 7 * 7, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        for i in range(len(self.layers)):
            h = getattr(self, f"layer{i + 1}")(h)
        h = self.bn2(h)
        # dropout is the identity at inference; flatten C-major (NCHW)
        return self.features(self.fc(h.flatten(1)))


def iresnet(name: str, **kw) -> IResNet:
    return IResNet(layers=_BLOCKS[name], **kw)


def bn_keys(name: str) -> List[str]:
    """A torch BatchNorm's weights and statistics under ``name``."""
    return [f"{name}.{k}" for k in ("weight", "bias", "running_mean",
                                    "running_var")]


def iresnet_keys(layers: Sequence[int]) -> List[str]:
    """The reference state_dict keys an IResNet's weights come from: the
    JAX package's ``convert_iresnet`` reads exactly these."""
    keys = ["conv1.weight", *bn_keys("bn1"), "prelu.weight"]
    for li, n in enumerate(layers):
        for bi in range(n):
            t = f"layer{li + 1}.{bi}"
            keys += [*bn_keys(f"{t}.bn1"), *bn_keys(f"{t}.bn2"),
                     *bn_keys(f"{t}.bn3"), f"{t}.conv1.weight",
                     f"{t}.conv2.weight", f"{t}.prelu.weight"]
            if bi == 0:   # every stage opens with a stride of 2
                keys += [f"{t}.downsample.0.weight",
                         *bn_keys(f"{t}.downsample.1")]
    return keys + [*bn_keys("bn2"), "fc.weight", "fc.bias",
                   *bn_keys("features")]


def reference_weights(sd: Dict, keys: Sequence[str]
                      ) -> Dict[str, torch.Tensor]:
    """``keys`` of a reference state_dict as fp32, with each BatchNorm's
    ``num_batches_tracked`` from ``sd`` or 0 where it has none (it plays no
    part at inference)."""
    out = {k: torch.as_tensor(sd[k]).detach().float().cpu().clone()
           for k in keys}
    for k in list(out):
        if k.endswith(".running_mean"):
            t = k[:-len("running_mean")] + "num_batches_tracked"
            out[t] = torch.as_tensor(sd.get(t, 0), dtype=torch.long).clone()
    return out


def convert_iresnet(sd: Dict, layers: Sequence[int]) -> Dict[str, torch.Tensor]:
    """A reference iResNet state_dict -> the state_dict of ``IResNet(layers)``
    (the same names, ``reference_weights`` of ``iresnet_keys``)."""
    return reference_weights(sd, iresnet_keys(layers))
