"""CLIP ViT image and text towers for the DiffusionCLIP directional loss.

Counterpart of ``dsml_thesis_tpu/models/clip.py`` (the OpenAI CLIP
architecture, ViT-B/16 by default): a pre-LN transformer with QuickGELU and
a fused q/k/v projection, a class token and learned positions on the vision
side, a causal text transformer pooled at the end-of-text token. Sub-modules
and parameters carry the Flax tree's names (``patch_conv``,
``class_embedding``, ``positional_embedding``, ``block_<i>``, ``proj``,
``token_embedding``, ``text_projection``), so ``convert.from_jax_tree``
fills them from a JAX tree; ``convert_clip_openai`` / ``convert_clip_hf`` /
``load_clip_checkpoint`` map the OpenAI and HuggingFace checkpoint layouts
onto them. Images are NHWC at the boundary.

Attention inside the towers is plain ``matmul`` + ``softmax``, as the JAX
module's is plain ``jnp``: no TPU kernel stands behind it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Defaults are ViT-B/16."""

    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    embed_dim: int = 512
    # OpenAI CLIP uses QuickGELU; some HF checkpoints (LAION ViT-H / bigG)
    # plain GELU
    use_quick_gelu: bool = True


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPBlock(nn.Module):
    """Pre-LN residual attention block (OpenAI ResidualAttentionBlock)."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 use_quick_gelu: bool = True):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.use_quick_gelu = use_quick_gelu
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.qkv = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.heads
        qkv = self.qkv(self.ln_1(x)).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # each [B, H, N, hd]
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if self.causal:
            keep = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, float("-inf"))
        h = torch.matmul(torch.softmax(logits, dim=-1), v)
        x = x + self.out_proj(h.transpose(1, 2).reshape(b, n, d))
        h = self.c_fc(self.ln_2(x))
        h = quick_gelu(h) if self.use_quick_gelu else F.gelu(h)
        return x + self.c_proj(h)


class CLIPVisionTower(nn.Module):
    """CLIP-normalized NHWC images at ``image_size`` -> [B, embed_dim]."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_conv = nn.Conv2d(3, c.vision_width, c.patch_size,
                                    stride=c.patch_size, bias=False)
        tokens = (c.image_size // c.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.randn(c.vision_width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(tokens, c.vision_width) * 0.02)
        self.ln_pre = nn.LayerNorm(c.vision_width, eps=1e-5)
        for i in range(c.vision_layers):
            self.add_module(f"block_{i}", CLIPBlock(
                c.vision_width, c.vision_heads,
                use_quick_gelu=c.use_quick_gelu))
        self.ln_post = nn.LayerNorm(c.vision_width, eps=1e-5)
        self.proj = nn.Parameter(torch.randn(c.vision_width, c.embed_dim)
                                 * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = self.patch_conv(x.permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2)              # [B, grid^2, width]
        cls = self.class_embedding.to(h.dtype).expand(b, 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding
        h = self.ln_pre(h)
        for i in range(self.cfg.vision_layers):
            h = getattr(self, f"block_{i}")(h)
        return self.ln_post(h[:, 0]) @ self.proj


class CLIPTextTower(nn.Module):
    """int tokens [B, L] -> [B, embed_dim], pooled at the end-of-text token
    (the largest id: ``argmax`` of the row, padding being 0)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.token_embedding = nn.Parameter(
            torch.randn(c.vocab_size, c.text_width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(c.context_length, c.text_width) * 0.01)
        for i in range(c.text_layers):
            self.add_module(f"block_{i}", CLIPBlock(
                c.text_width, c.text_heads, causal=True,
                use_quick_gelu=c.use_quick_gelu))
        self.ln_final = nn.LayerNorm(c.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.randn(c.text_width, c.embed_dim) * 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        h = self.token_embedding[tokens]
        h = h + self.positional_embedding[:h.shape[1]]
        for i in range(self.cfg.text_layers):
            h = getattr(self, f"block_{i}")(h)
        h = self.ln_final(h)
        eot = tokens.argmax(dim=-1)
        h = h[torch.arange(h.shape[0], device=h.device), eot]
        return h @ self.text_projection


class CLIP(nn.Module):
    """Both towers: ``encode_image`` / ``encode_text``."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.visual = CLIPVisionTower(cfg)
        self.text = CLIPTextTower(cfg)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def forward(self, images, tokens):
        return self.encode_image(images), self.encode_text(tokens)


# --------------------------------------------------------------------------
# preprocessing and the loss-side helpers
# --------------------------------------------------------------------------

def bicubic_resize_torch(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """NHWC bicubic resize: ``F.interpolate(mode="bicubic",
    align_corners=False)`` without antialiasing (the cubic kernel with
    a = -0.75, half-pixel centres, replicated borders), what the reference's
    torchvision resize runs on tensors. Computed in fp64 and rounded once:
    the fp32 kernel forms its taps in fp32 and lands some 2e-6 off the exact
    resize of values in [0, 1] (the JAX package's matrix form, 2e-7).
    Differentiable."""
    y = F.interpolate(x.permute(0, 3, 1, 2).double(), size=(out_h, out_w),
                      mode="bicubic", align_corners=False)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def preprocess_gan_output(images: torch.Tensor,
                          image_size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC images of any square size -> CLIP-normalized NHWC at
    ``image_size``: to [0, 1], bicubic resize, CLIP mean / std."""
    x = (images + 1.0) * 0.5
    if x.shape[1] != image_size or x.shape[2] != image_size:
        x = bicubic_resize_torch(x, image_size, image_size)
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class CLIPImageEmbed(nn.Module):
    """images ([-1, 1] NHWC) -> unit-norm CLIP image embeddings: the
    image-embedding callable of the directional loss."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = CLIPVisionTower(cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.visual(preprocess_gan_output(images, self.cfg.image_size))
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def make_clip_image_embed(cfg: CLIPConfig,
                          visual_state: Optional[Dict] = None
                          ) -> CLIPImageEmbed:
    """A ``CLIPImageEmbed`` with the vision tower's weights (a ``state_dict``
    of ``CLIPVisionTower``) loaded, frozen and in eval mode."""
    embed = CLIPImageEmbed(cfg)
    if visual_state is not None:
        embed.visual.load_state_dict(visual_state, strict=True)
    embed.requires_grad_(False)
    return embed.eval()


@torch.no_grad()
def compute_text_direction(text_tower: CLIPTextTower, src_tokens: torch.Tensor,
                           trg_tokens: torch.Tensor) -> torch.Tensor:
    """Unit-norm mean difference of the per-template text embeddings (target
    minus source); [T, context] tokens each. Identical prompts give an exact
    zero direction (the eps keeps it from 0 / 0)."""
    def embed(tok):
        f = text_tower(tok)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    d = (embed(trg_tokens) - embed(src_tokens)).mean(dim=0)
    return d / (torch.linalg.vector_norm(d) + 1e-8)


# Prompt templates of the text direction (StyleGAN-NADA's ImageNet set).
IMAGENET_TEMPLATES = [
    "a bad photo of a {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.",
    "a photo of a nice {}.", "a photo of a weird {}.",
    "a blurry photo of a {}.", "a cartoon {}.", "art of a {}.",
    "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]


# --------------------------------------------------------------------------
# checkpoint layouts
# --------------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().float().cpu().clone()


def _count_blocks(sd: Dict, prefix: str, suffix: str) -> int:
    return sum(1 for k in sd if k.startswith(prefix) and k.endswith(suffix))


def convert_clip_openai(sd: Dict, vision_heads: Optional[int] = None,
                        text_heads: Optional[int] = None
                        ) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """An OpenAI ``clip`` checkpoint's state_dict -> (config, ``state_dict``
    of ``CLIP``). Heads default to 64-wide ones (ViT-B/16: 12 vision, 8
    text): the state_dict does not record them."""
    vw = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    tw = sd["text_projection"].shape[0]
    cfg = CLIPConfig(
        image_size=grid * patch, patch_size=patch, vision_width=vw,
        vision_layers=sum(1 for k in sd if k.startswith("visual.")
                          and k.endswith(".attn.in_proj_weight")),
        vision_heads=vision_heads or vw // 64,
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
        text_width=tw, text_heads=text_heads or tw // 64,
        text_layers=sum(1 for k in sd if not k.startswith("visual.")
                        and k.endswith(".attn.in_proj_weight")),
        embed_dim=sd["text_projection"].shape[1])
    out: Dict[str, torch.Tensor] = {}

    def block(dst, src):
        for a, b in (("ln_1", "ln_1"), ("ln_2", "ln_2"),
                     ("qkv", "attn.in_proj"), ("out_proj", "attn.out_proj"),
                     ("c_fc", "mlp.c_fc"), ("c_proj", "mlp.c_proj")):
            sep = "_" if b == "attn.in_proj" else "."
            out[f"{dst}.{a}.weight"] = _f32(sd[f"{src}.{b}{sep}weight"])
            out[f"{dst}.{a}.bias"] = _f32(sd[f"{src}.{b}{sep}bias"])

    out["visual.patch_conv.weight"] = _f32(sd["visual.conv1.weight"])
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[f"visual.{name}"] = _f32(sd[f"visual.{name}"])
    for ln in ("ln_pre", "ln_post"):
        for p in ("weight", "bias"):
            out[f"visual.{ln}.{p}"] = _f32(sd[f"visual.{ln}.{p}"])
    for i in range(cfg.vision_layers):
        block(f"visual.block_{i}", f"visual.transformer.resblocks.{i}")
    out["text.token_embedding"] = _f32(sd["token_embedding.weight"])
    out["text.positional_embedding"] = _f32(sd["positional_embedding"])
    out["text.text_projection"] = _f32(sd["text_projection"])
    for p in ("weight", "bias"):
        out[f"text.ln_final.{p}"] = _f32(sd[f"ln_final.{p}"])
    for i in range(cfg.text_layers):
        block(f"text.block_{i}", f"transformer.resblocks.{i}")
    return cfg, out


def convert_clip_hf(sd: Dict, vision_heads: Optional[int] = None,
                    text_heads: Optional[int] = None,
                    use_quick_gelu: bool = True
                    ) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """A HuggingFace ``CLIPModel`` state_dict -> (config, ``state_dict`` of
    ``CLIP``). ``use_quick_gelu=False`` for checkpoints trained with plain
    GELU: the state_dict cannot tell."""
    pe = "vision_model.embeddings."
    vw = sd[pe + "patch_embedding.weight"].shape[0]
    patch = sd[pe + "patch_embedding.weight"].shape[-1]
    grid = int(round((sd[pe + "position_embedding.weight"].shape[0] - 1)
                     ** 0.5))
    tw = sd["text_projection.weight"].shape[1]
    cfg = CLIPConfig(
        image_size=grid * patch, patch_size=patch, vision_width=vw,
        vision_layers=_count_blocks(sd, "vision_model.encoder.layers.",
                                    ".self_attn.q_proj.weight"),
        vision_heads=vision_heads or max(1, vw // 64),
        vocab_size=sd["text_model.embeddings.token_embedding.weight"].shape[0],
        context_length=sd[
            "text_model.embeddings.position_embedding.weight"].shape[0],
        text_width=tw, text_heads=text_heads or max(1, tw // 64),
        text_layers=_count_blocks(sd, "text_model.encoder.layers.",
                                  ".self_attn.q_proj.weight"),
        embed_dim=sd["visual_projection.weight"].shape[0],
        use_quick_gelu=use_quick_gelu)
    out: Dict[str, torch.Tensor] = {}

    def block(dst, src):
        for p in ("weight", "bias"):
            out[f"{dst}.qkv.{p}"] = torch.cat(
                [_f32(sd[f"{src}.self_attn.{x}_proj.{p}"]) for x in "qkv"])
            for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                         ("out_proj", "self_attn.out_proj"),
                         ("c_fc", "mlp.fc1"), ("c_proj", "mlp.fc2")):
                out[f"{dst}.{a}.{p}"] = _f32(sd[f"{src}.{b}.{p}"])

    out["visual.patch_conv.weight"] = _f32(sd[pe + "patch_embedding.weight"])
    out["visual.class_embedding"] = _f32(sd[pe + "class_embedding"])
    out["visual.positional_embedding"] = _f32(
        sd[pe + "position_embedding.weight"])
    out["visual.proj"] = _f32(sd["visual_projection.weight"]).t().contiguous()
    for a, b in (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm")):
        for p in ("weight", "bias"):
            out[f"visual.{a}.{p}"] = _f32(sd[f"vision_model.{b}.{p}"])
    for i in range(cfg.vision_layers):
        block(f"visual.block_{i}", f"vision_model.encoder.layers.{i}")
    out["text.token_embedding"] = _f32(
        sd["text_model.embeddings.token_embedding.weight"])
    out["text.positional_embedding"] = _f32(
        sd["text_model.embeddings.position_embedding.weight"])
    out["text.text_projection"] = _f32(
        sd["text_projection.weight"]).t().contiguous()
    for p in ("weight", "bias"):
        out[f"text.ln_final.{p}"] = _f32(
            sd[f"text_model.final_layer_norm.{p}"])
    for i in range(cfg.text_layers):
        block(f"text.block_{i}", f"text_model.encoder.layers.{i}")
    return cfg, out


def load_clip_checkpoint(path: str, use_quick_gelu: bool = True
                         ) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """An OpenAI- or HF-layout CLIP checkpoint on disk -> (config,
    ``state_dict`` of ``CLIP``). ``use_quick_gelu`` applies to the HF
    layout only (OpenAI-layout checkpoints are QuickGELU)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "visual.conv1.weight" in obj:
        return convert_clip_openai(obj)
    if "vision_model.embeddings.patch_embedding.weight" in obj:
        return convert_clip_hf(obj, use_quick_gelu=use_quick_gelu)
    raise ValueError(f"unrecognized CLIP checkpoint layout in {path}")


def openai_state_dict(model: CLIP) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_clip_openai``: a ``CLIP``'s weights in the
    OpenAI checkpoint layout (to write a checkpoint file of given weights)."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}

    def block(src, dst):
        for a, b in (("ln_1", "ln_1"), ("ln_2", "ln_2"),
                     ("qkv", "attn.in_proj"), ("out_proj", "attn.out_proj"),
                     ("c_fc", "mlp.c_fc"), ("c_proj", "mlp.c_proj")):
            sep = "_" if b == "attn.in_proj" else "."
            for p in ("weight", "bias"):
                out[f"{dst}.{b}{sep}{p}"] = sd[f"{src}.{a}.{p}"]

    out["visual.conv1.weight"] = sd["visual.patch_conv.weight"]
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[f"visual.{name}"] = sd[f"visual.{name}"]
    for ln in ("ln_pre", "ln_post"):
        for p in ("weight", "bias"):
            out[f"visual.{ln}.{p}"] = sd[f"visual.{ln}.{p}"]
    for i in range(model.cfg.vision_layers):
        block(f"visual.block_{i}", f"visual.transformer.resblocks.{i}")
    out["token_embedding.weight"] = sd["text.token_embedding"]
    out["positional_embedding"] = sd["text.positional_embedding"]
    out["text_projection"] = sd["text.text_projection"]
    for p in ("weight", "bias"):
        out[f"ln_final.{p}"] = sd[f"text.ln_final.{p}"]
    for i in range(model.cfg.text_layers):
        block(f"text.block_{i}", f"transformer.resblocks.{i}")
    return out
