"""The IR-SE face-identity tower of the DiffusionCLIP identity loss.

Counterpart of the IR-SE part of ``dsml_thesis_tpu/models/insight_face.py``:
the reference's ``model_irse.Backbone`` (mode ``ir_se``, 50 / 100 / 152
layers) into which its identity loss loads ``model_ir_se50.pth``. Inference
only: BatchNorm normalizes with its running statistics (eps 1e-5, the JAX
``_BN``'s), the final BatchNorm1d too. Sub-modules, parameters and buffers
carry the Flax trees' names (``input_conv``, ``input_bn``, ``body_<i>``,
``prelu.alpha``, a BatchNorm's ``mean`` / ``var`` from the ``batch_stats``
collection, ``output_scale`` / ``output_mean`` ...), so
``convert.from_jax_variables`` fills the tower from a JAX variables tree;
``convert_irse`` maps a reference checkpoint onto it. Images are NHWC at the
boundary, NCHW inside.

Not ported: MobileFaceNet, the face ViT and iResNet (the CSIM metric's
towers).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _irse_stages(num_layers: int) -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) of every bottleneck (get_blocks)."""
    units = {50: (3, 4, 14, 3), 100: (3, 13, 30, 3),
             152: (3, 8, 36, 3)}[num_layers]
    blocks: List[Tuple[int, int, int]] = []
    in_ch = 64
    for depth, n in zip((64, 128, 256, 512), units):
        blocks.append((in_ch, depth, 2))
        blocks.extend((depth, depth, 1) for _ in range(n - 1))
        in_ch = depth
    return blocks


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1: (x - mean) / sqrt(var + eps) * weight
    + bias, with the running statistics as the buffers ``mean`` / ``var``."""

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
    """Per-channel PReLU over dim 1, slopes in ``alpha``."""

    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, a * x)


class SEModule(nn.Module):
    """Squeeze-excite: mean -> 1x1 -> ReLU -> 1x1 -> sigmoid gate."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(c // reduction, c, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIR(nn.Module):
    """bottleneck_IR / bottleneck_IR_SE (``se``)."""

    def __init__(self, in_channel: int, depth: int, stride: int, se: bool):
        super().__init__()
        self.stride = stride
        if in_channel != depth:
            self.short_conv = nn.Conv2d(in_channel, depth, 1, stride=stride,
                                        bias=False)
            self.short_bn = BatchNorm(depth)
        self.bn0 = BatchNorm(in_channel)
        self.conv1 = nn.Conv2d(in_channel, depth, 3, padding=1, bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = nn.Conv2d(depth, depth, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm(depth)
        if se:
            self.se = SEModule(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "short_conv"):
            shortcut = self.short_bn(self.short_conv(x))
        else:   # MaxPool2d(1, stride): a strided subsample
            shortcut = x[:, :, ::self.stride, ::self.stride]
        res = self.conv2(self.prelu(self.conv1(self.bn0(x))))
        res = self.bn1(res)
        if hasattr(self, "se"):
            res = self.se(res)
        return res + shortcut


class IRSE(nn.Module):
    """Backbone: 112 px RGB NHWC in [-1, 1] -> unit-norm 512-d embedding.
    ``affine`` is the final BatchNorm1d's (the identity loss's checkpoint has
    it)."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 affine: bool = True):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"unknown mode {mode!r}")
        self.num_layers, self.stages = num_layers, _irse_stages(num_layers)
        self.affine = affine
        self.input_conv = nn.Conv2d(3, 64, 3, padding=1, bias=False)
        self.input_bn = BatchNorm(64)
        self.input_prelu = PReLU(64)
        for i, (in_ch, depth, stride) in enumerate(self.stages):
            self.add_module(f"body_{i}", BottleneckIR(in_ch, depth, stride,
                                                      mode == "ir_se"))
        self.output_bn = BatchNorm(512)
        self.output_fc = nn.Linear(512 * 7 * 7, 512)
        if affine:
            self.output_scale = nn.Parameter(torch.ones(512))
            self.output_bias = nn.Parameter(torch.zeros(512))
        self.register_buffer("output_mean", torch.zeros(512))
        self.register_buffer("output_var", torch.ones(512))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.input_prelu(self.input_bn(self.input_conv(
            x.permute(0, 3, 1, 2))))
        for i in range(len(self.stages)):
            h = getattr(self, f"body_{i}")(h)
        h = self.output_bn(h)
        # dropout is the identity at inference; flatten C-major (NCHW)
        h = self.output_fc(h.reshape(h.shape[0], -1))
        h = (h - self.output_mean) * torch.rsqrt(self.output_var + 1e-5)
        if self.affine:
            h = h * self.output_scale + self.output_bias
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d`` on NHWC images."""
    oh, ow = out_hw if isinstance(out_hw, (tuple, list)) else (out_hw, out_hw)
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (oh, ow)
                                 ).permute(0, 2, 3, 1)


class IdEmbed(nn.Module):
    """The identity loss's feature extractor: [-1, 1] NHWC images of any
    size -> clamp -> adaptive pool to 112 -> IR-SE embedding."""

    def __init__(self, tower: IRSE):
        super().__init__()
        self.tower = tower

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool2d(torch.clamp(images, -1.0, 1.0), (112, 112))
        return self.tower(x)


def make_id_embed(tower: IRSE) -> IdEmbed:
    """``IdEmbed`` around ``tower``, frozen and in eval mode."""
    embed = IdEmbed(tower)
    embed.requires_grad_(False)
    return embed.eval()


def _bn_keys(dst: str, src: str):
    return ((f"{dst}.weight", f"{src}.weight"), (f"{dst}.bias", f"{src}.bias"),
            (f"{dst}.mean", f"{src}.running_mean"),
            (f"{dst}.var", f"{src}.running_var"))


def _irse_key_map(num_layers: int, sd_keys) -> List[Tuple[str, str]]:
    """(port key, reference key) of every tensor of a reference Backbone."""
    pairs = [("input_conv.weight", "input_layer.0.weight"),
             ("input_prelu.alpha", "input_layer.2.weight")]
    pairs += _bn_keys("input_bn", "input_layer.1")
    for i, (in_ch, depth, _) in enumerate(_irse_stages(num_layers)):
        d, s = f"body_{i}", f"body.{i}"
        if in_ch != depth:
            pairs.append((f"{d}.short_conv.weight",
                          f"{s}.shortcut_layer.0.weight"))
            pairs += _bn_keys(f"{d}.short_bn", f"{s}.shortcut_layer.1")
        pairs += _bn_keys(f"{d}.bn0", f"{s}.res_layer.0")
        pairs += [(f"{d}.conv1.weight", f"{s}.res_layer.1.weight"),
                  (f"{d}.prelu.alpha", f"{s}.res_layer.2.weight"),
                  (f"{d}.conv2.weight", f"{s}.res_layer.3.weight")]
        pairs += _bn_keys(f"{d}.bn1", f"{s}.res_layer.4")
        if f"{s}.res_layer.5.fc1.weight" in sd_keys:
            pairs += [(f"{d}.se.fc1.weight", f"{s}.res_layer.5.fc1.weight"),
                      (f"{d}.se.fc2.weight", f"{s}.res_layer.5.fc2.weight")]
    pairs += _bn_keys("output_bn", "output_layer.0")
    pairs += [("output_fc.weight", "output_layer.3.weight"),
              ("output_fc.bias", "output_layer.3.bias"),
              ("output_mean", "output_layer.4.running_mean"),
              ("output_var", "output_layer.4.running_var")]
    if "output_layer.4.weight" in sd_keys:
        pairs += [("output_scale", "output_layer.4.weight"),
                  ("output_bias", "output_layer.4.bias")]
    return pairs


def convert_irse(sd: Dict, num_layers: int = 50) -> Dict[str, torch.Tensor]:
    """A reference ``Backbone`` state_dict -> ``state_dict`` of ``IRSE``.
    The final BatchNorm1d is affine where the checkpoint has
    ``output_layer.4.weight``: build ``IRSE(affine=...)`` to match."""
    return {dst: torch.as_tensor(sd[src]).detach().float().cpu().clone()
            for dst, src in _irse_key_map(num_layers, set(sd))}


def reference_state_dict(tower: IRSE) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_irse``: an ``IRSE``'s weights in the
    reference ``Backbone`` layout (to write a checkpoint file)."""
    own = tower.state_dict()
    present = {f"body.{i}.res_layer.5.fc1.weight"
               for i in range(len(tower.stages))
               if hasattr(getattr(tower, f"body_{i}"), "se")}
    if tower.affine:
        present.add("output_layer.4.weight")
    return {src: own[dst].detach().cpu().clone()
            for dst, src in _irse_key_map(tower.num_layers, present)}
