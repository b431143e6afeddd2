"""The lipreader's visual frontend (Conv3d stem + ResNet-18 trunk) of the
talking-face lip-reading finetune.

Counterpart of ``dsml_thesis_tpu/models/lipreader.py``: the Conv3dResNet
frontend of the LRS3 "Visual Speech Recognition for Multiple Languages"
model, the only part of the lipreader the finetune's loss runs: a Conv3d
(1 -> 64, k (5, 7, 7), s (1, 2, 2)) + BatchNorm + activation + MaxPool3d
((1, 3, 3), s (1, 2, 2)) stem, then a ResNet-18 (BasicBlock [2, 2, 2, 2],
64 -> 512) over every frame as one [B * T] batch and an adaptive average
pool: [B, T, H, W, 1] -> [B, T, 512]. Inference only: BatchNorm normalizes
with its running statistics (``insight_face.BatchNorm``, eps 1e-5, buffers
``mean`` / ``var``). Sub-modules carry the Flax tree's names
(``frontend3d``, ``frontend_bn``, ``layer<l>_<b>.{conv1, bn1, conv2, bn2,
ds_conv, ds_bn}``), so ``convert.from_jax_variables`` fills it from a JAX
variables tree; ``convert_lipreader`` maps the user's LRS3 ``model.pth``
onto it and ``reference_state_dict`` writes one back. Videos are NTHWC at
the boundary, NCDHW / NCHW inside. The convolutions are plain ops (cuDNN on
the card), as the JAX package's are plain XLA ops.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .insight_face import BatchNorm

_RESNET18_LAYERS = (2, 2, 2, 2)
_RESNET18_PLANES = (64, 128, 256, 512)


def _act(relu_type: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if relu_type == "swish":
        return F.silu
    if relu_type == "relu":
        return F.relu
    # 'prelu' exists upstream, but no published checkpoint ships it and the
    # converter has no mapping for its slopes
    raise ValueError(f"unsupported relu_type {relu_type!r} (swish/relu)")


class _BasicBlock(nn.Module):
    """conv3x3-bn-act-conv3x3-bn (+ 1x1-bn downsample), the activation after
    the residual add."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 relu_type: str = "swish"):
        super().__init__()
        self.act = _act(relu_type)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = stride != 1 or inplanes != planes
        if self.downsample:
            self.ds_conv = nn.Conv2d(inplanes, planes, 1, stride, bias=False)
            self.ds_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample:
            x = self.ds_bn(self.ds_conv(x))
        return self.act(h + x)


class LipreaderFrontend(nn.Module):
    """Conv3dResNet visual frontend, [B, T, H, W, 1] -> [B, T, 512]."""

    def __init__(self, relu_type: str = "swish"):
        super().__init__()
        self.act = _act(relu_type)
        self.frontend3d = nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3),
                                    bias=False)
        self.frontend_bn = BatchNorm(64)
        inplanes = 64
        for li, (planes, reps) in enumerate(zip(_RESNET18_PLANES,
                                                _RESNET18_LAYERS)):
            for bi in range(reps):
                stride = 2 if (bi == 0 and li > 0) else 1
                self.add_module(f"layer{li + 1}_{bi}", _BasicBlock(
                    inplanes, planes, stride, relu_type))
                inplanes = planes

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t = video.shape[:2]
        h = self.frontend3d(video.permute(0, 4, 1, 2, 3))   # [B, 64, T, h, w]
        h = self.act(self.frontend_bn(h))
        h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        h = h.transpose(1, 2).reshape((b * t,) + (h.shape[1],) + h.shape[3:])
        for li, reps in enumerate(_RESNET18_LAYERS):
            for bi in range(reps):
                h = getattr(self, f"layer{li + 1}_{bi}")(h)
        return h.mean(dim=(2, 3)).reshape(b, t, -1)


class LipreaderFeatures(nn.Module):
    """The finetune's frame features: mouths [B, H, W, 1] -> [B, 512], each
    frame a sequence of one (the reference's ``.unsqueeze(1)``); frozen, in
    eval mode."""

    def __init__(self, tower: LipreaderFrontend):
        super().__init__()
        self.tower = tower

    def forward(self, mouths: torch.Tensor) -> torch.Tensor:
        return self.tower(mouths[:, None])[:, 0]


# ---------------------------------------------------------------------------
# the LRS3 checkpoint layout (espnet E2E state dict or a bare Conv3dResNet)
# ---------------------------------------------------------------------------

def _bn_pairs(dst: str, src: str):
    return ((f"{dst}.weight", f"{src}.weight"), (f"{dst}.bias", f"{src}.bias"),
            (f"{dst}.mean", f"{src}.running_mean"),
            (f"{dst}.var", f"{src}.running_var"))


def _key_map(prefix: str, downsample):
    """(port key, checkpoint key) of every tensor of the frontend;
    ``downsample(trunk_block)`` says whether a block has the 1x1 branch."""
    pairs = [("frontend3d.weight", f"{prefix}frontend3D.0.weight")]
    pairs += _bn_pairs("frontend_bn", f"{prefix}frontend3D.1")
    for li, reps in enumerate(_RESNET18_LAYERS):
        for bi in range(reps):
            src = f"{prefix}trunk.layer{li + 1}.{bi}"
            dst = f"layer{li + 1}_{bi}"
            pairs += [(f"{dst}.conv1.weight", f"{src}.conv1.weight"),
                      (f"{dst}.conv2.weight", f"{src}.conv2.weight")]
            pairs += _bn_pairs(f"{dst}.bn1", f"{src}.bn1")
            pairs += _bn_pairs(f"{dst}.bn2", f"{src}.bn2")
            if downsample(src):
                pairs.append((f"{dst}.ds_conv.weight",
                              f"{src}.downsample.0.weight"))
                pairs += _bn_pairs(f"{dst}.ds_bn", f"{src}.downsample.1")
    return pairs


def detect_frontend_prefix(sd: Mapping) -> str:
    """Where the visual frontend sits in a checkpoint: the full espnet E2E
    model keys it ``encoder.frontend.``, a bare Conv3dResNet ``''``."""
    for k in sd:
        if k.endswith("frontend3D.0.weight"):
            return k[: -len("frontend3D.0.weight")]
    raise ValueError("no Conv3dResNet frontend (frontend3D.0.weight) found")


def convert_lipreader(sd: Mapping, prefix: Optional[str] = None
                      ) -> Dict[str, torch.Tensor]:
    """An LRS3 state dict (full E2E model or bare frontend) ->
    ``state_dict`` of ``LipreaderFrontend``."""
    if prefix is None:
        prefix = detect_frontend_prefix(sd)
    pairs = _key_map(prefix, lambda src: f"{src}.downsample.0.weight" in sd)
    return {dst: torch.as_tensor(sd[src]).detach().float().cpu().clone()
            for dst, src in pairs}


def reference_state_dict(front: LipreaderFrontend,
                         prefix: str = "encoder.frontend."
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_lipreader``: a frontend's weights in the
    LRS3 layout under ``prefix`` (to write a ``model.pth``)."""
    own = front.state_dict()
    blocks = {f"{prefix}trunk.layer{li + 1}.{bi}"
              for li, reps in enumerate(_RESNET18_LAYERS) for bi in range(reps)
              if getattr(front, f"layer{li + 1}_{bi}").downsample}
    return {src: own[dst].detach().cpu().clone()
            for dst, src in _key_map(prefix, blocks.__contains__)}


def load_lipreader_checkpoint(path: str, relu_type: str = "swish"
                              ) -> LipreaderFrontend:
    """``model.pth`` (a state dict, a module, or a dict holding
    ``model_state_dict``) -> the frontend, frozen and in eval mode."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    front = LipreaderFrontend(relu_type)
    front.load_state_dict(convert_lipreader(sd), strict=True)
    front.requires_grad_(False)
    return front.eval()


def make_lipreader_apply(tower: LipreaderFrontend) -> LipreaderFeatures:
    """The finetune's feature function around ``tower``: mouths
    [B, 88, 88, 1] -> [B, 512], frozen and in eval mode."""
    feats = LipreaderFeatures(tower)
    feats.requires_grad_(False)
    return feats.eval()


def make_lipreader_video_apply(tower: LipreaderFrontend) -> LipreaderFrontend:
    """The temporal form (5-frame receptive field) for sequence-level
    evaluation: video [B, T, H, W, 1] -> [B, T, 512], frozen, eval mode."""
    tower.requires_grad_(False)
    return tower.eval()
