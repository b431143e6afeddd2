"""First stage of the port: Encoder / Decoder, the VQModel (VQGAN) and the
AutoencoderKL wrappers with their training surface.

Counterpart of ``dsml_thesis_tpu/models/autoencoder.py`` (same sub-module
names, NHWC at the public boundary, NCHW ``channels_last`` inside).
GroupNorm eps is 1e-6 here (1e-5 in the UNet). The single-head attention
block (one head as wide as the channels, 512 in the shipped configs) runs
through ``ops.attention.multi_head_attention`` (the resident or the streaming
kernel, ``DSML_FLASH_STREAMING``). Under ``DSML_GN_EPILOGUE`` the GroupNorm
statistics ride the convs as in the UNet: a block returns ``(out, stats)``
and takes ``in_stats``; ``emit_stats`` says whether a norm will read the
statistics (before a resampler none does). As the latent-diffusion first
stage, ``encode`` skips quantization and ``decode`` quantizes first.
``VQModel.forward`` returns (reconstruction, commitment loss, codes) and
``AutoencoderKL.forward`` (reconstruction, ``DiagonalGaussian`` posterior),
as the JAX modules do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from .quantize import VectorQuantizer
from .unet import (Conv2d, GroupNormSiLU, _no_dropout, fused_conv,
                   gn_epilogue_mode, head_conv, resolve_dtype, stem_conv,
                   upsample_nearest)


class ResnetBlock(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        _no_dropout(dropout)
        out_ch = out_channels or channels
        self.norm1 = GroupNormSiLU(channels, eps=1e-6)
        self.conv1 = Conv2d(channels, out_ch, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNormSiLU(out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        if channels != out_ch:
            self.nin_shortcut = Conv2d(channels, out_ch, 1, dtype=dtype)

    def forward(self, x, in_stats=None, emit_stats: bool = False):
        if not gn_epilogue_mode():
            h = self.conv2(self.norm2(self.conv1(self.norm1(x, in_stats))))
            if hasattr(self, "nin_shortcut"):
                x = self.nin_shortcut(x)
            return x + h, None
        # conv1 with norm1 folded in where statistics came, norm2's
        # statistics out; conv2 with norm2 folded in and the residual added
        fold_in = in_stats is not None
        h, mid_stats = fused_conv(self.conv1, x if fold_in else self.norm1(x),
                                  in_stats=in_stats, norm=self.norm1)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        out, stats = fused_conv(self.conv2, h, skip=x, in_stats=mid_stats,
                                norm=self.norm2)
        return out, (stats if emit_stats else None)


class AttnBlock(nn.Module):
    """Single-head full self-attention over the spatial tokens. Same
    ``(out, stats)`` / ``in_stats`` / ``emit_stats`` convention as
    ``ResnetBlock``; under ``DSML_GN_EPILOGUE=1`` the norm folds into one
    [C, 3C] 1x1 product for q, k and v, and ``proj_out`` + residual leave the
    statistics of the result."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.norm = GroupNormSiLU(channels, eps=1e-6, silu=False)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x, in_stats=None, emit_stats: bool = False):
        b, c, hh, ww = x.shape
        epi = gn_epilogue_mode(full=True)
        if epi and in_stats is not None:
            # the normalized tensor is never written: one product for q, k, v
            # (the three 1x1 weights concatenated along the outputs)
            qkv, _ = fused_conv((self.q, self.k, self.v), x,
                                in_stats=in_stats, norm=self.norm)
            q, k, v = (t.permute(0, 2, 3, 1).reshape(b, 1, hh * ww, c
                                                     ).contiguous()
                       for t in qkv.split(c, dim=1))
        else:
            h = self.norm(x, in_stats)
            # [B, C, H, W] channels_last -> [B, 1, H*W, C]: a view, then packed
            tokens = lambda t: t.permute(0, 2, 3, 1).reshape(
                b, 1, hh * ww, c).contiguous()
            q, k, v = tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h))
        out = multi_head_attention(q, k, v, scale=c ** -0.5)
        out = out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        if epi and emit_stats:
            return fused_conv(self.proj_out, out, skip=x)
        return x + self.proj_out(out), None


class DownsampleAE(nn.Module):
    """Strided conv after the asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpsampleAE(nn.Module):
    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(upsample_nearest(x))


def _mid(net, h, st):
    h, st = net.mid_block_1(h, st, True)
    h, st = net.mid_attn_1(h, st, True)
    return net.mid_block_2(h, st, True)


class Encoder(nn.Module):
    """ddconfig-driven conv encoder. forward(x [B,H,W,C]) -> [B,h,w,z]."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 z_channels: int, double_z: bool = True, dropout: float = 0.0,
                 in_channels: int = 3, out_ch: int = 3, tanh_out: bool = False,
                 dtype=None):
        super().__init__()
        del out_ch, tanh_out  # decoder keys of the shared ddconfig
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.attn_levels = []
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, dtype=dtype)
        curr_res, block_in = resolution, ch
        for i_level, mult in enumerate(self.ch_mult):
            attn_here = curr_res in attn_resolutions
            self.attn_levels.append(attn_here)
            for i_block in range(num_res_blocks):
                self.add_module(
                    f"down_{i_level}_block_{i_block}",
                    ResnetBlock(block_in, ch * mult, dropout, dtype))
                block_in = ch * mult
                if attn_here:
                    self.add_module(f"down_{i_level}_attn_{i_block}",
                                    AttnBlock(block_in, dtype))
            if i_level != len(self.ch_mult) - 1:
                self.add_module(f"down_{i_level}_downsample",
                                DownsampleAE(block_in, dtype))
                curr_res //= 2
        self.mid_block_1 = ResnetBlock(block_in, None, dropout, dtype)
        self.mid_attn_1 = AttnBlock(block_in, dtype)
        self.mid_block_2 = ResnetBlock(block_in, None, dropout, dtype)
        self.norm_out = GroupNormSiLU(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in,
                               2 * z_channels if double_z else z_channels, 3,
                               padding=1, dtype=dtype)

    def forward(self, x):
        # ``st``: the channel statistics of h from the fused conv that
        # produced it, for the next norm; None after a resampler
        h, st = stem_conv(self.conv_in, x.permute(0, 3, 1, 2))
        last_level = len(self.ch_mult) - 1
        for i_level in range(len(self.ch_mult)):
            attn_here = self.attn_levels[i_level]
            for i_block in range(self.num_res_blocks):
                # a downsample (no norm) follows a level's last block
                at_resample = (i_block == self.num_res_blocks - 1
                               and i_level != last_level)
                h, st = getattr(self, f"down_{i_level}_block_{i_block}")(
                    h, st, attn_here or not at_resample)
                if attn_here:
                    h, st = getattr(self, f"down_{i_level}_attn_{i_block}")(
                        h, st, not at_resample)
            if i_level != last_level:
                h, st = getattr(self, f"down_{i_level}_downsample")(h), None
        h, st = _mid(self, h, st)
        h = head_conv(self.norm_out, self.conv_out, h, st)
        return h.permute(0, 2, 3, 1)


class Decoder(nn.Module):
    """ddconfig-driven conv decoder. forward(z [B,h,w,z]) -> [B,H,W,out_ch]."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 z_channels: int, out_ch: int = 3, dropout: float = 0.0,
                 in_channels: int = 3, double_z: bool = False,
                 tanh_out: bool = False, dtype=None):
        super().__init__()
        del in_channels, double_z  # encoder keys of the shared ddconfig
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.tanh_out = tanh_out
        num_res = len(self.ch_mult)
        block_in = ch * self.ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1, dtype=dtype)
        self.mid_block_1 = ResnetBlock(block_in, None, dropout, dtype)
        self.mid_attn_1 = AttnBlock(block_in, dtype)
        self.mid_block_2 = ResnetBlock(block_in, None, dropout, dtype)
        self.attn_levels = [False] * num_res
        for i_level in reversed(range(num_res)):
            attn_here = curr_res in attn_resolutions
            self.attn_levels[i_level] = attn_here
            for i_block in range(num_res_blocks + 1):
                self.add_module(
                    f"up_{i_level}_block_{i_block}",
                    ResnetBlock(block_in, ch * self.ch_mult[i_level], dropout,
                                dtype))
                block_in = ch * self.ch_mult[i_level]
                if attn_here:
                    self.add_module(f"up_{i_level}_attn_{i_block}",
                                    AttnBlock(block_in, dtype))
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample",
                                UpsampleAE(block_in, dtype))
                curr_res *= 2
        self.norm_out = GroupNormSiLU(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, z):
        h, st = stem_conv(self.conv_in, z.permute(0, 3, 1, 2))
        h, st = _mid(self, h, st)
        for i_level in reversed(range(len(self.ch_mult))):
            attn_here = self.attn_levels[i_level]
            for i_block in range(self.num_res_blocks + 1):
                # an upsample (no norm) follows a level's last block
                at_resample = i_block == self.num_res_blocks and i_level != 0
                h, st = getattr(self, f"up_{i_level}_block_{i_block}")(
                    h, st, attn_here or not at_resample)
                if attn_here:
                    h, st = getattr(self, f"up_{i_level}_attn_{i_block}")(
                        h, st, not at_resample)
            if i_level != 0:
                h, st = getattr(self, f"up_{i_level}_upsample")(h), None
        h = head_conv(self.norm_out, self.conv_out, h, st)
        if self.tanh_out:
            h = torch.tanh(h)
        return h.permute(0, 2, 3, 1)


class VQModel(nn.Module):
    """VQGAN: encoder -> pre-quant conv -> VQ -> post-quant conv -> decoder."""

    def __init__(self, ddconfig: dict, n_embed: int, embed_dim: int,
                 beta: float = 0.25, dtype=None):
        super().__init__()
        dd = dict(ddconfig)
        dd.pop("dtype", None)
        dtype = resolve_dtype(dtype)
        self.dtype = dtype
        self.encoder = Encoder(dtype=dtype, **dd)
        self.decoder = Decoder(dtype=dtype, **dd)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=beta)
        z_out = (2 if dd.get("double_z", True) else 1) * dd["z_channels"]
        self.quant_conv = Conv2d(z_out, embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, dd["z_channels"], 1,
                                      dtype=dtype)

    @staticmethod
    def _conv_nhwc(conv, x):
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def encode(self, x):
        """Un-quantized latent (what the diffusion runs on), [B,h,w,embed]."""
        return self._conv_nhwc(self.quant_conv, self.encoder(x))

    def encode_quantized(self, x):
        return self.quantize(self.encode(x))

    def decode(self, z, force_not_quantize: bool = False):
        if not force_not_quantize:
            z, _, _ = self.quantize(z)
        return self.decoder(self._conv_nhwc(self.post_quant_conv, z))

    def forward(self, x):
        """x [B, H, W, C] -> (reconstruction, commitment loss, codes)."""
        quant, qloss, idx = self.encode_quantized(x)
        return self.decode(quant, force_not_quantize=True), qloss, idx


@dataclasses.dataclass
class DiagonalGaussian:
    """Posterior of the KL autoencoder, NHWC like the latents."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_params(cls, params: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = params.chunk(2, dim=-1)
        return cls(mean, logvar.clamp(-30.0, 20.0))

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise: ``noise`` as given, or a standard normal
        draw from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(0.5 * self.logvar) * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(posterior || N(0, 1)) per sample, [B]."""
        return 0.5 * torch.sum(
            self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
            dim=tuple(range(1, self.mean.dim())))


class AutoencoderKL(nn.Module):
    """KL-regularised autoencoder: encoder -> [mean | logvar] -> sample ->
    post-quant conv -> decoder."""

    def __init__(self, ddconfig: dict, embed_dim: int, dtype=None):
        super().__init__()
        dd = dict(ddconfig)
        dd.pop("dtype", None)
        if not dd.get("double_z", True):
            raise ValueError("AutoencoderKL needs double_z: true (the encoder "
                             "emits mean and log-variance)")
        dtype = resolve_dtype(dtype)
        self.dtype = dtype
        self.encoder = Encoder(dtype=dtype, **dd)
        self.decoder = Decoder(dtype=dtype, **dd)
        self.quant_conv = Conv2d(2 * dd["z_channels"], 2 * embed_dim, 1,
                                 dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, dd["z_channels"], 1,
                                      dtype=dtype)

    def encode(self, x) -> DiagonalGaussian:
        return DiagonalGaussian.from_params(
            VQModel._conv_nhwc(self.quant_conv, self.encoder(x)))

    def decode(self, z):
        return self.decoder(VQModel._conv_nhwc(self.post_quant_conv, z))

    def forward(self, x, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                sample_posterior: Optional[bool] = None):
        """x [B, H, W, C] -> (reconstruction, posterior). The posterior is
        sampled (from ``noise``, or drawn from ``generator``) when either is
        given, else its mode is decoded, unless ``sample_posterior`` says."""
        posterior = self.encode(x)
        if sample_posterior is None:
            sample_posterior = generator is not None or noise is not None
        z = (posterior.sample(generator, noise) if sample_posterior
             else posterior.mode())
        return self.decode(z), posterior
