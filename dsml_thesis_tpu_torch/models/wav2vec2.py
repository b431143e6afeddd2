"""wav2vec2 (base, post-norm) and the trainable ``AudioEmbedder`` cond stage.

Counterpart of ``dsml_thesis_tpu/models/wav2vec2.py``:
  - the conv feature extractor (layer 0 normed per channel over time, the
    group-norm layout of ``facebook/wav2vec2-base-960h``), the feature
    projection, the grouped positional conv and the post-LN encoder of
    ``transformers``' ``Wav2Vec2Model`` with ``do_stable_layer_norm=False``;
  - the reference's override: the CNN features are resampled
    (``align_corners=True``) from about 49 Hz to the video frame count
    before the projection and the encoder, one row a frame;
  - the CTC ``lm_head`` of the ``Wav2Vec2ForCTC`` bundle models
    (``LARGE_960H``);
  - ``AudioEmbedder``: wav2vec2 features at the frame rate, a (2w + 1)-frame
    window around ``frame_idx`` (replicate-padded at the clip's edges),
    conv attention scores and a softmax, pooled to one token.

Sub-modules carry the Flax trees' names (``feature_extractor.conv_<i>``,
``gn_scale_0``, ``fp_ln``, ``fp_proj``, ``pos_conv``, ``enc_ln``,
``layer_<i>.{q,k,v,out}_proj``, ``ln1``, ``fc1``, ``fc2``, ``ln2``,
``lm_head``; ``audio_encoder``, ``att_conv_<i>``, ``att_fc``), so
``convert.from_jax_params`` carries weights across. ``convert_wav2vec2``
maps a ``transformers`` state dict onto these modules and ``config_from_hf``
reads a snapshot's ``config.json`` as a plain dict: nothing here needs
``transformers``. The attention is plain ``einsum`` and softmax, as in the
JAX package (no kernel stands behind it). Inference numerics only: the
reference's dropout, layer drop and spec augment are not implemented, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Defaults = facebook/wav2vec2-base-960h."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    # CTC character head (the bundle models emit vocabulary logits); None =
    # no head
    ctc_vocab: Optional[int] = None


# facebook/wav2vec2-large-960h (the ASR bundle): base's post-norm layout
# scaled up, with a CTC head of 32 logits
LARGE_960H = Wav2Vec2Config(hidden_size=1024, num_layers=24, num_heads=16,
                            intermediate_size=4096, ctc_vocab=32)


def interp_align_corners(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=True)`` on axis 1 of
    [B, T, D] (the reference's 49 Hz -> frame-rate resampler)."""
    if x.shape[1] == out_len:
        return x
    return F.interpolate(x.transpose(1, 2), size=out_len, mode="linear",
                         align_corners=True).transpose(1, 2)


class FeatureExtractor(nn.Module):
    """The conv feature encoder: raw audio [B, S] -> [B, T, conv_dim[-1]]
    at about 49 Hz. Layer 0 is normed per channel over time (biased
    variance, eps 1e-5, affine); every layer ends in exact GELU."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        cin = 1
        for i, (d, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                          cfg.conv_stride)):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, d, k, stride=s,
                                                   bias=cfg.conv_bias))
            cin = d
        self.n_layers = len(cfg.conv_dim)
        self.gn_scale_0 = nn.Parameter(torch.ones(cfg.conv_dim[0]))
        self.gn_bias_0 = nn.Parameter(torch.zeros(cfg.conv_dim[0]))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        h = audio[:, None, :]
        for i in range(self.n_layers):
            h = getattr(self, f"conv_{i}")(h)
            if i == 0:
                mean = h.mean(dim=2, keepdim=True)
                var = h.var(dim=2, keepdim=True, unbiased=False)
                h = (h - mean) * torch.rsqrt(var + 1e-5)
                h = h * self.gn_scale_0[:, None] + self.gn_bias_0[:, None]
            h = F.gelu(h)
        return h.transpose(1, 2)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (``do_stable_layer_norm=False``)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(d, d))
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = (getattr(self, f"{p}_proj")(x).reshape(b, n, self.heads, hd)
                   for p in "qkv")
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                             * hd ** -0.5, dim=-1)
        h = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, d)
        x = self.ln1(x + self.out_proj(h))
        return self.ln2(x + self.fc2(F.gelu(self.fc1(x))))


class Wav2Vec2(nn.Module):
    """Raw 16 kHz audio [B, S] -> features [B, num_frames, D] (CTC logits
    [B, T, vocab] with a head).

    ``num_frames`` resamples the CNN features to the video frame count
    before the encoder (the reference override); None keeps the native
    length. ``freeze_extractor`` stops gradients at the conv extractor (the
    reference's ``_freeze_parameters``)."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 freeze_extractor: bool = False):
        super().__init__()
        self.cfg = cfg
        self.freeze_extractor = freeze_extractor
        d = cfg.hidden_size
        self.feature_extractor = FeatureExtractor(cfg)
        self.fp_ln = nn.LayerNorm(cfg.conv_dim[-1], eps=1e-5)
        self.fp_proj = nn.Linear(cfg.conv_dim[-1], d)
        k = cfg.num_conv_pos_embeddings
        self.pos_conv = nn.Conv1d(d, d, k, padding=k // 2,
                                  groups=cfg.num_conv_pos_embedding_groups)
        self.enc_ln = nn.LayerNorm(d, eps=1e-5)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))
        if cfg.ctc_vocab is not None:
            self.lm_head = nn.Linear(d, cfg.ctc_vocab)

    def forward(self, audio: torch.Tensor,
                num_frames: Optional[int] = None) -> torch.Tensor:
        h = self.feature_extractor(audio)
        if self.freeze_extractor:
            h = h.detach()
        if num_frames is not None:
            h = interp_align_corners(h, num_frames)
        h = self.fp_proj(self.fp_ln(h))
        # grouped positional conv; an even kernel's SamePad drops the last
        pos = self.pos_conv(h.transpose(1, 2)).transpose(1, 2)
        if self.cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        h = self.enc_ln(h + F.gelu(pos))
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h)
        if self.cfg.ctc_vocab is not None:
            h = self.lm_head(h)
        return h


class AudioEmbedder(nn.Module):
    """The reference's ``AudioEmbedder``: wav2vec2 features at the frame
    rate, a (2 * win_len + 1)-frame window around ``frame_idx`` (clip-edge
    indices clamped: replicate padding), conv attention scores, softmax,
    pooled to one [B, 1, D] token."""

    def __init__(self, win_len: int = 4, subspace_dim: int = 768,
                 cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 freeze_extractor: bool = True):
        super().__init__()
        self.win_len, self.subspace_dim = win_len, subspace_dim
        self.audio_encoder = Wav2Vec2(cfg, freeze_extractor=freeze_extractor)
        cin = cfg.hidden_size
        for i, ch in enumerate((192, 64, 16, 4, 1)):
            self.add_module(f"att_conv_{i}", nn.Conv1d(cin, ch, 3, padding=1))
            cin = ch
        self.att_fc = nn.Linear(2 * win_len + 1, 2 * win_len + 1)

    def window_pool(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, 2w+1, D] window features -> [B, 1, D] pooled token."""
        h = feats.transpose(1, 2)
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"att_conv_{i}")(h),
                             negative_slope=0.02)
        att = torch.softmax(self.att_fc(h[:, 0, :]), dim=1)
        return torch.einsum("bwd,bw->bd", feats, att)[:, None]

    def forward(self, audio: torch.Tensor, num_frames: Optional[int] = None,
                frame_idx: Union[int, torch.Tensor, None] = None,
                training: bool = False) -> torch.Tensor:
        """audio: raw [B, S]; frame_idx: an int or [B] positions. Without
        ``num_frames`` / ``frame_idx`` the audio is the window itself and
        the token is centred on it. ``training`` is accepted for the cond
        stages' calling convention; the forward is deterministic."""
        w = self.win_len
        if num_frames is None:
            num_frames = 2 * w + 1
        if frame_idx is None:
            frame_idx = w
        if isinstance(frame_idx, int) and not 0 <= frame_idx < num_frames:
            raise ValueError(
                f"frame_idx {frame_idx} out of range [0, {num_frames})")
        feats = self.audio_encoder(audio, num_frames=num_frames)
        offsets = torch.arange(-w, w + 1, device=feats.device)
        if isinstance(frame_idx, int):
            idx = torch.clamp(frame_idx + offsets, 0, num_frames - 1)
            window = feats[:, idx]
        else:
            idx = torch.clamp(torch.as_tensor(frame_idx, device=feats.device
                                              ).long()[:, None] + offsets,
                              0, num_frames - 1)
            window = torch.gather(
                feats, 1, idx[:, :, None].expand(-1, -1, feats.shape[-1]))
        return self.window_pool(window)

    @staticmethod
    def frozen_paths():
        """Sub-trees the optimizer and the EMA skip: the conv feature
        extractor, frozen as the reference freezes it."""
        return ("audio_encoder/feature_extractor",)


def config_from_hf(hf: Mapping, ctc: bool = False) -> Wav2Vec2Config:
    """A ``transformers`` ``Wav2Vec2Config`` as a plain dict (a snapshot's
    ``config.json``) -> ``Wav2Vec2Config``; ``ctc`` adds the ForCTC head of
    ``vocab_size`` logits. Only the post-norm, group-norm-extractor layout
    (base / large-960h) is implemented."""
    if hf.get("do_stable_layer_norm", False):
        raise ValueError("only the do_stable_layer_norm=False (base / "
                         "large-960h) layout is implemented")
    if hf.get("feat_extract_norm", "group") != "group":
        raise ValueError("only the feat_extract_norm='group' extractor "
                         "layout is implemented")
    base = Wav2Vec2Config()
    return Wav2Vec2Config(
        ctc_vocab=hf["vocab_size"] if ctc else None,
        conv_dim=tuple(hf.get("conv_dim", base.conv_dim)),
        conv_kernel=tuple(hf.get("conv_kernel", base.conv_kernel)),
        conv_stride=tuple(hf.get("conv_stride", base.conv_stride)),
        conv_bias=hf.get("conv_bias", base.conv_bias),
        hidden_size=hf.get("hidden_size", base.hidden_size),
        num_layers=hf.get("num_hidden_layers", base.num_layers),
        num_heads=hf.get("num_attention_heads", base.num_heads),
        intermediate_size=hf.get("intermediate_size", base.intermediate_size),
        num_conv_pos_embeddings=hf.get("num_conv_pos_embeddings",
                                       base.num_conv_pos_embeddings),
        num_conv_pos_embedding_groups=hf.get(
            "num_conv_pos_embedding_groups",
            base.num_conv_pos_embedding_groups),
    )


def convert_wav2vec2(sd: Mapping, cfg: Wav2Vec2Config = Wav2Vec2Config()
                     ) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``Wav2Vec2Model`` / ``Wav2Vec2ForCTC`` state dict
    -> ``state_dict`` of ``Wav2Vec2(cfg)``. ForCTC keys carry a
    ``wav2vec2.`` prefix beside an unprefixed ``lm_head``. The positional
    conv's weight norm (``weight_g`` / ``weight_v``, or the parametrized
    ``original0`` / ``original1``) is folded: g * v / ||v|| over dims 0, 1."""
    sd = {(k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k): v
          for k, v in sd.items()}
    if "feature_extractor.conv_layers.1.layer_norm.weight" in sd:
        # the 'layer' extractor layout norms every conv layer; its layer 0
        # would load into the group-norm slot shape for shape and the rest
        # would be dropped
        raise ValueError(
            "convert_wav2vec2: the state dict uses the "
            "feat_extract_norm='layer' extractor layout; only 'group' "
            "(base / large-960h) is implemented")

    def t(key):
        return torch.as_tensor(sd[key]).detach().float().cpu().clone()

    out: Dict[str, torch.Tensor] = {}

    def take(dst, src, names=("weight", "bias")):
        for n in names:
            out[f"{dst}.{n}"] = t(f"{src}.{n}")

    for i in range(len(cfg.conv_dim)):
        take(f"feature_extractor.conv_{i}",
             f"feature_extractor.conv_layers.{i}.conv",
             ("weight", "bias") if cfg.conv_bias else ("weight",))
    gn = "feature_extractor.conv_layers.0.layer_norm"
    out["feature_extractor.gn_scale_0"] = t(f"{gn}.weight")
    out["feature_extractor.gn_bias_0"] = t(f"{gn}.bias")
    take("fp_ln", "feature_projection.layer_norm")
    take("fp_proj", "feature_projection.projection")
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in sd:
        g, v = t(f"{base}.weight_g"), t(f"{base}.weight_v")
    else:
        g = t(f"{base}.parametrizations.weight.original0")
        v = t(f"{base}.parametrizations.weight.original1")
    norm = torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True))
    out["pos_conv.weight"] = g * v / torch.clamp(norm, min=1e-12)
    out["pos_conv.bias"] = t(f"{base}.bias")
    take("enc_ln", "encoder.layer_norm")
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"layer_{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            take(f"{dst}.{p}", f"{src}.attention.{p}")
        take(f"{dst}.ln1", f"{src}.layer_norm")
        take(f"{dst}.fc1", f"{src}.feed_forward.intermediate_dense")
        take(f"{dst}.fc2", f"{src}.feed_forward.output_dense")
        take(f"{dst}.ln2", f"{src}.final_layer_norm")
    if cfg.ctc_vocab is not None:
        take("lm_head", "lm_head")
    return out
