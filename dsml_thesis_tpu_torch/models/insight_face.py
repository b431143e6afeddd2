"""Face-identity towers: the IR-SE tower of the DiffusionCLIP identity loss
and the CSIM metric's MobileFaceNet and face ViT (the iResNets are
``arcface.py``).

Counterpart of ``dsml_thesis_tpu/models/insight_face.py``. Inference only
(BatchNorm with its running statistics, dropout and drop-path off, no token
masking); images are NHWC in [-1, 1] at the boundary, NCHW inside.

* IR-SE: the reference's ``model_irse.Backbone`` (mode ``ir_se``, 50 / 100
  / 152 layers) into which its identity loss loads ``model_ir_se50.pth``.
  Sub-modules, parameters and buffers carry the Flax trees' names
  (``input_conv``, ``input_bn``, ``body_<i>``, ``prelu.alpha``, a
  BatchNorm's ``mean`` / ``var`` from the ``batch_stats`` collection,
  ``output_scale`` / ``output_mean`` ...), so ``convert.from_jax_variables``
  fills the tower from a JAX variables tree; ``convert_irse`` maps a
  reference checkpoint onto it.
* MobileFaceNet (the reference's ``backbones/mobilefacenet.py``, ``mbf`` /
  ``mbf_large``) and the face ViT (``backbones/vit.py``, ``vit_t`` /
  ``vit_s`` / ``vit_b``): sub-modules under the reference's names (torch
  ``BatchNorm2d`` / ``PReLU`` / ``LayerNorm`` in eval mode), so a reference
  state_dict loads with ``load_state_dict``; ``convert_mobilefacenet`` /
  ``convert_face_vit`` read exactly the keys the JAX package's converters
  read and fill what a checkpoint may lack (``num_batches_tracked``, the
  ViT's unused ``mask_token``). The ViT's attention is plain matrix
  products and a softmax in fp32, as in the JAX package (no kernel).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .arcface import BatchNorm, PReLU, bn_keys, reference_weights


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


# ---------------------------------------------------------------------------
# MobileFaceNet (backbones/mobilefacenet.py)
# ---------------------------------------------------------------------------

class ConvBlock(nn.Module):
    """Conv (no bias) - BatchNorm - PReLU; without the PReLU the reference's
    ``LinearBlock``."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 prelu: bool = True):
        super().__init__()
        layers = [nn.Conv2d(in_c, out_c, kernel, stride, padding,
                            groups=groups, bias=False), nn.BatchNorm2d(out_c)]
        if prelu:
            layers.append(nn.PReLU(out_c))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class DepthWise(nn.Module):
    """1x1 expand -> depthwise 3x3 -> 1x1 project (+ the input)."""

    def __init__(self, in_c: int, out_c: int, groups: int, stride: int = 2,
                 residual: bool = False):
        super().__init__()
        self.residual = residual
        self.layers = nn.Sequential(
            ConvBlock(in_c, groups),
            ConvBlock(groups, groups, 3, stride, 1, groups=groups),
            ConvBlock(groups, out_c, prelu=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layers(x)
        return x + h if self.residual else h


class Residual(nn.Module):
    def __init__(self, c: int, num_block: int, groups: int):
        super().__init__()
        self.layers = nn.Sequential(*[DepthWise(c, c, groups, stride=1,
                                                residual=True)
                                      for _ in range(num_block)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class GDC(nn.Module):
    """7x7 depthwise linear block -> flatten -> linear -> BatchNorm1d."""

    def __init__(self, num_features: int):
        super().__init__()
        self.layers = nn.Sequential(
            ConvBlock(512, 512, 7, groups=512, prelu=False), nn.Flatten(),
            nn.Linear(512, num_features, bias=False),
            nn.BatchNorm1d(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class MobileFaceNet(nn.Module):
    """``get_mbf`` (blocks (1, 4, 6, 2), scale 2) / ``get_mbf_large``
    ((2, 8, 12, 4), 4): 112 px RGB NHWC in [-1, 1] -> a ``num_features``-d
    embedding (unnormalized, as the reference returns it)."""

    def __init__(self, num_features: int = 512,
                 blocks: Sequence[int] = (1, 4, 6, 2), scale: int = 2):
        super().__init__()
        self.blocks = tuple(blocks)
        c = 64 * scale
        layers = [ConvBlock(3, c, 3, 2, 1)]
        if blocks[0] == 1:
            layers.append(ConvBlock(c, c, 3, 1, 1, groups=64))
        else:
            layers.append(Residual(c, blocks[0], groups=128))
        for in_c, out_c, down_g, res_g, n in (
                (c, c, 128, 128, blocks[1]), (c, 2 * c, 256, 256, blocks[2]),
                (2 * c, 2 * c, 512, 256, blocks[3])):
            layers += [DepthWise(in_c, out_c, down_g),
                       Residual(out_c, n, groups=res_g)]
        self.layers = nn.ModuleList(layers)
        self.conv_sep = ConvBlock(2 * c, 512)
        self.features = GDC(num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for layer in self.layers:
            h = layer(h)
        return self.features(self.conv_sep(h))


def mobilefacenet_keys(blocks: Sequence[int] = (1, 4, 6, 2)) -> List[str]:
    """The reference state_dict keys a MobileFaceNet's weights come from
    (those the JAX package's ``convert_mobilefacenet`` reads)."""
    def convblock(t, prelu=True):
        return ([f"{t}.layers.0.weight", *bn_keys(f"{t}.layers.1")]
                + ([f"{t}.layers.2.weight"] if prelu else []))

    def depthwise(t):
        return (convblock(f"{t}.layers.0") + convblock(f"{t}.layers.1")
                + convblock(f"{t}.layers.2", prelu=False))

    keys = convblock("layers.0")
    if blocks[0] == 1:
        keys += convblock("layers.1")
    else:
        for i in range(blocks[0]):
            keys += depthwise(f"layers.1.layers.{i}")
    for si, n in enumerate(blocks[1:]):
        li = 2 + 2 * si
        keys += depthwise(f"layers.{li}")
        for i in range(n):
            keys += depthwise(f"layers.{li + 1}.layers.{i}")
    return (keys + convblock("conv_sep")
            + convblock("features.layers.0", prelu=False)
            + ["features.layers.2.weight", *bn_keys("features.layers.3")])


def face_vit_keys(depth: int, qkv_bias: bool = False) -> List[str]:
    """The reference state_dict keys a face ViT's weights come from (those
    the JAX package's ``convert_face_vit`` reads)."""
    keys = ["patch_embed.proj.weight", "patch_embed.proj.bias", "pos_embed",
            "norm.weight", "norm.bias", "feature.0.weight",
            *bn_keys("feature.1"), "feature.2.weight", *bn_keys("feature.3")]
    for i in range(depth):
        t = f"blocks.{i}"
        keys += [f"{t}.norm1.weight", f"{t}.norm1.bias", f"{t}.norm2.weight",
                 f"{t}.norm2.bias", f"{t}.attn.qkv.weight",
                 f"{t}.attn.proj.weight", f"{t}.attn.proj.bias",
                 f"{t}.mlp.fc1.weight", f"{t}.mlp.fc1.bias",
                 f"{t}.mlp.fc2.weight", f"{t}.mlp.fc2.bias"]
        if qkv_bias:
            keys.append(f"{t}.attn.qkv.bias")
    return keys


def convert_mobilefacenet(sd: Dict, blocks: Sequence[int] = (1, 4, 6, 2)
                          ) -> Dict[str, torch.Tensor]:
    """A reference MobileFaceNet state_dict -> the state_dict of
    ``MobileFaceNet(blocks=blocks)`` (the same names)."""
    return reference_weights(sd, mobilefacenet_keys(blocks))


# ---------------------------------------------------------------------------
# face VisionTransformer (backbones/vit.py)
# ---------------------------------------------------------------------------

class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu6(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4).float()
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out.to(x.dtype))


class FaceViTBlock(nn.Module):
    """Pre-LayerNorm attention and ReLU6 MLP, each residual (eval: no
    drop-path)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class FaceViT(nn.Module):
    """The reference's ``VisionTransformer`` at eval: patchify -> blocks ->
    LayerNorm -> the feature head (two bias-free linears, each followed by a
    BatchNorm1d of eps 2e-5). 112 px RGB NHWC in [-1, 1] -> a
    ``num_classes``-d embedding. Factory widths: ``FACE_VIT_FACTORIES``."""

    def __init__(self, img_size: int = 112, patch_size: int = 9,
                 embed_dim: int = 512, depth: int = 12, num_heads: int = 8,
                 num_classes: int = 512, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False):
        super().__init__()
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches, embed_dim))
        self.blocks = nn.ModuleList([
            FaceViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias)
            for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.feature = nn.Sequential(
            nn.Linear(embed_dim * num_patches, embed_dim, bias=False),
            nn.BatchNorm1d(embed_dim, eps=2e-5),
            nn.Linear(embed_dim, num_classes, bias=False),
            nn.BatchNorm1d(num_classes, eps=2e-5))
        # the reference's token masking in training; unused at inference
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(x.permute(0, 3, 1, 2)) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        h = self.norm(h.float())
        return self.feature(h.reshape(h.shape[0], -1))


FACE_VIT_FACTORIES = {
    "vit_t": dict(embed_dim=256, depth=12),
    "vit_s": dict(embed_dim=512, depth=12),
    "vit_b": dict(embed_dim=512, depth=24),
}


def convert_face_vit(sd: Dict, depth: int = 12) -> Dict[str, torch.Tensor]:
    """A reference ``VisionTransformer`` state_dict -> the state_dict of
    ``FaceViT(depth=depth, qkv_bias=...)``: qkv biases where the file has
    them (build the model to match), ``mask_token`` from the file or zeros."""
    qkv_bias = "blocks.0.attn.qkv.bias" in sd
    out = reference_weights(sd, face_vit_keys(depth, qkv_bias))
    d = out["pos_embed"].shape[-1]
    out["mask_token"] = torch.as_tensor(
        sd.get("mask_token", torch.zeros(1, 1, d))).detach().float().clone()
    return out


def make_embed_fn(model: nn.Module, device=None
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A tower as an ``images -> embeddings`` function: frozen, in eval mode,
    on ``device`` (where given), without gradients."""
    model = model.eval().requires_grad_(False)
    if device is not None:
        model = model.to(device)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        return model(images)

    return fn
