"""Denoising UNet of the port (PyTorch modules, channel-last at the boundary).

Counterpart of ``dsml_thesis_tpu/models/unet.py``: same architecture, same
sub-module names (so a JAX parameter tree maps onto ``state_dict`` keys by
path, see ``convert.py``), same numerics contract:
  - parameters are fp32 (or cast once for sampling); every Conv / Linear
    computes in the module's ``dtype`` (bf16 in the shipped configs);
  - GroupNorm and LayerNorm take their statistics in fp32;
  - the GEGLU gate is the tanh GELU (PyTorch's ``F.gelu`` default is erf).

``UNetModel.forward(x[B,H,W,C], t[B], context[B,L,D]) -> eps[B,H,W,out]``.
Inside, tensors are NCHW in ``channels_last`` memory, which is the same
bytes as the NHWC boundary, so the permutes are views.

Eval-mode self-attention over up to 1024 tokens goes through the
projection-fused attention op (``ops.attention.flash_attention_fproj``),
longer sequences through the packed kernel (or the q/out-fused one under
``DSML_ATTN_FPROJ_PARTIAL=1``); single-token cross-attention is the exact
broadcast of the JAX package. Under ``DSML_GN_EPILOGUE`` the GroupNorm
statistics ride the convs (``ops.conv_gn.conv_stats``): a block returns its
output together with the output's channel sums, and the next norm reads
those instead of reducing the tensor again. Ported is what the talking-face
configs use: the spatial-transformer UNet with conv resampling. Dropout,
``use_scale_shift_norm``, ``resblock_updown``, class labels and the
transformer-less attention block raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..flags import env_flag, env_mode, refuse_unported
from ..ops.attention import (flash_attention_fproj, fproj_kernel_takes,
                             fproj_one_q_block, fused_qout_self_attention,
                             multi_head_attention,
                             packed_multi_head_attention)
from ..ops.conv_gn import conv_stats, group_norm_silu_apply
from ..ops.groupnorm import group_norm_silu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           None: torch.float32}


def resolve_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[dtype]


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, [cos | sin] ordering like guided-diffusion."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


# --------------------------------------------------------------------------
# layers that compute in a stated type whatever type their parameters have
# --------------------------------------------------------------------------

def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                   w: torch.Tensor) -> torch.dtype:
    """``dtype`` when the layer states one, else the promotion of input and
    parameter types (an fp32 input through bf16-cast weights stays fp32)."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """NCHW conv computing in ``dtype``."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class GroupNormSiLU(nn.Module):
    """GroupNorm (fp32 statistics) optionally followed by SiLU, on NCHW."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = True):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, stats=None):
        """``stats``: the (sum, sum of squares) per channel of x, [B, C] fp32
        each, from the epilogue of the conv that produced x; the norm is
        then applied from them and x is not reduced again."""
        # channels_last NCHW is NHWC in memory: the permute is a view and
        # contiguous() copies nothing
        kw = dict(num_groups=self.num_groups, eps=self.eps, silu=self.silu)
        xl = x.permute(0, 2, 3, 1).contiguous()
        if stats is not None:
            y = group_norm_silu_apply(xl, stats[0], stats[1], self.weight,
                                      self.bias, **kw)
        else:
            y = group_norm_silu(xl, self.weight, self.bias, **kw)
        return y.permute(0, 3, 1, 2)


def gn_epilogue_mode(full: bool = False) -> bool:
    """Whether ``DSML_GN_EPILOGUE`` fuses GroupNorm statistics into the convs
    at a site: ``res`` at the 3x3 convs of the ResBlocks / ResnetBlocks
    only, ``1`` also at the sites that ask with ``full=True`` (stem convs,
    the 1x1 projections around attention, the final norm + conv)."""
    mode = env_mode("DSML_GN_EPILOGUE", "0", ("0", "1", "res"))
    return mode == "1" or (mode == "res" and not full)


def fused_conv(conv, x, bias=None, skip=None, in_stats=None,
               norm: Optional[GroupNormSiLU] = None):
    """A stride-1 ``Conv2d`` through ``conv_stats``, on NCHW ``channels_last``
    tensors: -> (y, (ch_sum, ch_sq)). ``conv`` may be several convs of one
    input, run as one with their outputs side by side. ``bias`` replaces the
    conv's own with a per-batch one [B, Cout] fp32; with ``in_stats`` the
    input is normalized by ``norm`` from those statistics inside the op. The
    weight is brought to the op's [K, K, Cin, Cout] layout here, one copy a
    call."""
    convs = conv if isinstance(conv, (tuple, list)) else (conv,)
    dt = _compute_dtype(convs[0].compute_dtype, x, convs[0].weight)
    nhwc = lambda t: t.to(dt).permute(0, 2, 3, 1)
    one = len(convs) == 1   # nothing to concatenate, nothing to copy
    weight = convs[0].weight if one else torch.cat([m.weight for m in convs])
    if bias is None:
        bias = convs[0].bias if one else torch.cat([m.bias for m in convs])
        bias = bias.float().expand(x.shape[0], -1)
    gn = {} if in_stats is None else dict(
        in_stats=in_stats, gamma=norm.weight, beta=norm.bias,
        num_groups=norm.num_groups, eps=norm.eps, silu_in=norm.silu)
    y, ch_sum, ch_sq = conv_stats(
        nhwc(x), weight.to(dt).permute(2, 3, 1, 0), bias,
        skip=None if skip is None else nhwc(skip), **gn)
    return y.permute(0, 3, 1, 2), (ch_sum, ch_sq)


def stem_conv(conv_in, x):
    """A net's first conv and, under ``DSML_GN_EPILOGUE=1``, its output's
    statistics."""
    if gn_epilogue_mode(full=True):
        return fused_conv(conv_in, x)
    return conv_in(x), None


def head_conv(norm_out, conv_out, h, st):
    """A net's last ``conv_out(norm_out(h))``; under ``DSML_GN_EPILOGUE=1``
    the norm folds into the conv where statistics came (they are not used
    past it)."""
    if gn_epilogue_mode(full=True) and st is not None:
        return fused_conv(conv_out, h, in_stats=st, norm=norm_out)[0]
    return conv_out(norm_out(h, st))


def concat_stats(a, b):
    """Channel statistics of a channel concat: the concat of the statistics;
    None if either side has none."""
    if a is None or b is None:
        return None
    return torch.cat([a[0], b[0]], dim=-1), torch.cat([a[1], b[1]], dim=-1)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed, and returned, in fp32 (eps 1e-5)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


def upsample_nearest(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _no_dropout(dropout: float):
    if dropout:
        raise NotImplementedError(
            "dropout is not ported (no shipped config sets it): set dropout "
            "to 0")


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

class ResBlock(nn.Module):
    """Residual block with the timestep embedding added after the first
    conv. Returns ``(out, stats)``: under ``DSML_GN_EPILOGUE`` ``stats`` is
    the channel (sum, sum of squares) of ``out`` for the next norm, else
    None; ``in_stats`` takes the same pair for this block's ``in_norm``."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        _no_dropout(dropout)
        self.in_norm = GroupNormSiLU(channels)
        self.in_conv = Conv2d(channels, out_channels, 3, padding=1, dtype=dtype)
        self.emb_proj = Linear(emb_channels, out_channels, dtype=dtype)
        self.out_norm = GroupNormSiLU(out_channels)
        self.out_conv = Conv2d(out_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        if channels != out_channels:
            self.skip = Conv2d(channels, out_channels, 1, dtype=dtype)

    def forward(self, x, emb, in_stats=None):
        emb_out = self.emb_proj(F.silu(emb))
        if not gn_epilogue_mode():
            h = self.in_conv(self.in_norm(x, in_stats))
            h = self.out_conv(self.out_norm(h + emb_out[:, :, None, None]))
            if hasattr(self, "skip"):
                x = self.skip(x)
            return x + h, None
        # in_conv: in_norm folded in where the producer left statistics, the
        # timestep vector as a per-batch bias, out_norm's statistics out
        fold_in = in_stats is not None
        h, mid_stats = fused_conv(
            self.in_conv, x if fold_in else self.in_norm(x),
            bias=self.in_conv.bias.float() + emb_out.float(),
            in_stats=in_stats, norm=self.in_norm)
        # out_conv: out_norm folded in, the residual added, and the
        # statistics of the result out for the next block's norm
        if hasattr(self, "skip"):
            x = self.skip(x)
        return fused_conv(self.out_conv, h, skip=x, in_stats=mid_stats,
                          norm=self.out_norm)


class CrossAttention(nn.Module):
    """Multi-head attention on [B, N, C] tokens; self-attention when
    ``context`` is None. The branches, in the JAX module's order:

    * one context token: the softmax over one key is 1, so the block is
      ``to_out(to_v(context))`` broadcast over the queries (exact);
    * eval-mode self-attention over a sequence one q-block covers
      (``fproj_one_q_block``: N up to 1024), at widths the fused op takes:
      one call of ``flash_attention_fproj`` (projections, attention and
      ``to_out``). ``DSML_ATTN_FUSED_PROJ=0`` turns it off;
    * else eval-mode self-attention with ``DSML_ATTN_FPROJ_PARTIAL=1``:
      ``to_k`` / ``to_v`` as linears, then ``fused_qout_self_attention`` (q
      projection, attention and ``to_out`` in one kernel);
    * else the three projections, ``packed_multi_head_attention`` on the
      packed [B, N, H*D] layout and ``to_out``: longer self-attention,
      cross-attention over several tokens, training mode;
    * ``DSML_ATTN_PACKED=0`` (it also turns the two fused branches off):
      the projections, a head split, ``multi_head_attention`` (the
      resident or the streaming kernel, ``DSML_FLASH_STREAMING``) and a merge.

    The JAX package gates the fused branches further on TPU facts (backend,
    VMEM fit, N >= 256, mesh size, batch >= 8); none is a property of the
    function, so none is kept here.
    """

    def __init__(self, query_dim: int, context_dim: Optional[int], heads: int,
                 dim_head: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        _no_dropout(dropout)
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        kv_dim = query_dim if context_dim is None else context_dim
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(kv_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(kv_dim, inner, bias=False, dtype=dtype)
        self.to_out = Linear(inner, query_dim, dtype=dtype)

    def forward(self, x, context=None):
        dt = self.dtype or x.dtype
        scale = self.dim_head ** -0.5
        if context is not None and context.shape[1] == 1:
            refuse_unported("DSML_XATTN_1TOK")
            out = self.to_out(self.to_v(context))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        x = x.to(dt)  # once: the LayerNorm before hands over fp32
        packed = env_flag("DSML_ATTN_PACKED", True)
        if context is None and not self.training and packed:
            cast = lambda p: p.to(dt)
            h = x.contiguous()
            if (env_flag("DSML_ATTN_FUSED_PROJ", True)
                    and fproj_one_q_block(x.shape[1])
                    and (not x.is_cuda or fproj_kernel_takes(
                        x.shape[-1], self.dim_head, dt))):
                return flash_attention_fproj(
                    h, cast(self.to_q.weight), cast(self.to_k.weight),
                    cast(self.to_v.weight), cast(self.to_out.weight),
                    cast(self.to_out.bias), self.heads, scale=scale)
            if env_flag("DSML_ATTN_FPROJ_PARTIAL", False):
                return fused_qout_self_attention(
                    h, self.to_k(h), self.to_v(h), self.to_q.weight,
                    self.to_out.weight, self.to_out.bias, self.heads,
                    scale=scale)
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        if packed:
            return self.to_out(packed_multi_head_attention(
                q, k, v, self.heads, scale=scale))
        b, n, _ = x.shape
        split = lambda t: t.reshape(b, t.shape[1], self.heads,
                                    self.dim_head).permute(0, 2, 1, 3
                                                           ).contiguous()
        out = multi_head_attention(split(q), split(k), split(v), scale=scale)
        return self.to_out(out.permute(0, 2, 1, 3).reshape(b, n, -1))


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP, mult 4. The gate is the tanh GELU, the JAX package's
    default; DSML_GELU_EXACT=1 selects the erf form there and here."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype=None):
        super().__init__()
        _no_dropout(dropout)
        self.proj_in = Linear(dim, dim * mult * 2, dtype=dtype)
        self.proj_out = Linear(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        a, gate = self.proj_in(x).chunk(2, dim=-1)
        form = "none" if env_flag("DSML_GELU_EXACT", False) else "tanh"
        return self.proj_out(a * F.gelu(gate, approximate=form))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: Optional[int], heads: int,
                 dim_head: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (LayerNorm32(dim) for _ in range(3))
        self.attn1 = CrossAttention(dim, None, heads, dim_head, dropout, dtype)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dropout,
                                    dtype)
        self.ff = GEGLUFeedForward(dim, dropout=dropout, dtype=dtype)

    def forward(self, x, context=None, tile_pairs: bool = False):
        x = self.attn1(self.norm1(x)) + x
        if tile_pairs:
            # guidance-pair dedup through the first self-attention: both
            # halves are identical until attn2 first reads the context
            x = torch.cat([x, x], dim=0)
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Feature map -> tokens -> transformer blocks -> feature map, residual.
    Returns ``(out, stats)`` and takes ``in_stats`` as ``ResBlock`` does;
    under ``DSML_GN_EPILOGUE=1`` ``norm`` folds into the 1x1 ``proj_in`` and
    ``proj_out`` + residual leave the statistics of the result."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, dropout: float = 0.0,
                 dtype=None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNormSiLU(channels, eps=1e-6, silu=False)
        self.proj_in = Conv2d(channels, inner, 1, dtype=dtype)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                inner, context_dim, heads, dim_head, dropout, dtype))
        self.proj_out = Conv2d(inner, channels, 1, dtype=dtype)

    def forward(self, x, context=None, tile_pairs: bool = False,
                in_stats=None):
        b, c, h, w = x.shape
        x_in = x
        epi = gn_epilogue_mode(full=True)
        if epi and in_stats is not None:
            x, _ = fused_conv(self.proj_in, x, in_stats=in_stats,
                              norm=self.norm)
        else:
            x = self.proj_in(self.norm(x, in_stats))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, -1)
        for d in range(self.depth):
            x = getattr(self, f"block_{d}")(x, context, tile_pairs and d == 0)
        if tile_pairs:
            b = 2 * b
            x_in = torch.cat([x_in, x_in], dim=0)
        x = x.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        if epi:
            return fused_conv(self.proj_out, x, skip=x_in)
        return self.proj_out(x) + x_in, None


class Upsample(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True, dtype=None):
        super().__init__()
        if use_conv:
            self.conv = Conv2d(channels, out_channels or channels, 3,
                               padding=1, dtype=dtype)

    def forward(self, x):
        x = upsample_nearest(x)
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True, dtype=None):
        super().__init__()
        if use_conv:
            self.conv = Conv2d(channels, out_channels or channels, 3, stride=2,
                               padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x) if hasattr(self, "conv") else F.avg_pool2d(x, 2)


class UNetModel(nn.Module):
    """The denoiser. forward(x[B,H,W,C], t[B], context[B,L,D]) -> [B,H,W,out]."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int],
                 dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_heads: int = -1,
                 num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 use_spatial_transformer: bool = True,
                 transformer_depth: int = 1, context_dim: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 use_checkpoint: bool = False, dtype=None,
                 image_size: Optional[int] = None, legacy: bool = True):
        super().__init__()
        for name, on in (("use_scale_shift_norm", use_scale_shift_norm),
                         ("resblock_updown", resblock_updown),
                         ("use_spatial_transformer=False",
                          not use_spatial_transformer)):
            if on:
                raise NotImplementedError(
                    f"{name} is not ported: no talking-face config sets it")
        if context_dim is None:
            raise ValueError("the spatial transformer needs context_dim")
        if num_heads == -1 and num_head_channels == -1:
            raise ValueError("set one of num_heads / num_head_channels")
        if num_classes is not None:
            raise NotImplementedError("class-conditional UNet is not ported")
        # use_checkpoint (rematerialisation) changes memory, not numbers: not
        # ported, so every activation is kept for the backward
        del use_checkpoint, image_size
        dtype = resolve_dtype(dtype)
        self.dtype = dtype
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.context_dim = context_dim
        self.num_heads, self.num_head_channels = num_heads, num_head_channels
        self.legacy = legacy
        emb_dim = model_channels * 4

        def res(cin, cout):
            return ResBlock(cin, emb_dim, cout, dropout, dtype)

        def attn(ch):
            heads, dim_head = self._heads(ch)
            return SpatialTransformer(ch, heads, dim_head, transformer_depth,
                                      context_dim, dropout, dtype)

        self.time_embed_0 = Linear(model_channels, emb_dim, dtype=dtype)
        self.time_embed_2 = Linear(emb_dim, emb_dim, dtype=dtype)
        self.conv_in = Conv2d(in_channels, model_channels, 3, padding=1,
                              dtype=dtype)
        ch, ds = model_channels, 1
        skip_chs: List[int] = [ch]
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}_res",
                                res(ch, mult * model_channels))
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn", attn(ch))
                skip_chs.append(ch)
            if level != len(self.channel_mult) - 1:
                self.add_module(f"down_{level}_ds",
                                Downsample(ch, ch, conv_resample, dtype))
                skip_chs.append(ch)
                ds *= 2
        self.mid_res1 = res(ch, ch)
        self.mid_attn = attn(ch)
        self.mid_res2 = res(ch, ch)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}_res",
                                res(ch + skip_chs.pop(), model_channels * mult))
                ch = model_channels * mult
                if ds in self.attention_resolutions:
                    self.add_module(f"up_{level}_{i}_attn", attn(ch))
                if level and i == num_res_blocks:
                    self.add_module(f"up_{level}_us",
                                    Upsample(ch, ch, conv_resample, dtype))
                    ds //= 2
        self.out_norm = GroupNormSiLU(ch)
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1, dtype=dtype)

    def _heads(self, ch: int) -> Tuple[int, int]:
        """(num_heads, dim_head) for a channel width (the upstream legacy
        head-width rule)."""
        heads = (self.num_heads if self.num_head_channels == -1
                 else ch // self.num_head_channels)
        if self.legacy or self.num_head_channels == -1:
            return heads, ch // heads
        return heads, self.num_head_channels

    def forward(self, x, timesteps, context=None, cfg_pairs: bool = False):
        """With ``cfg_pairs`` x / timesteps arrive at B while context is the
        [uncond; cond] pair at 2B: everything before the first
        cross-attention is computed once and tiled to 2B there (exact, since
        both halves share x_t, t and the concat channels); the result is 2B."""
        if context is None or context.shape[-1] != self.context_dim:
            raise ValueError(
                f"context must be [B, L, {self.context_dim}], got "
                f"{None if context is None else tuple(context.shape)}")
        if context.shape[0] != (2 if cfg_pairs else 1) * x.shape[0]:
            raise ValueError(
                "context batch must equal x's batch, or twice it (the "
                "[uncond; cond] pair) with cfg_pairs")
        in_dtype = x.dtype
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        context = context.to(self.dtype)

        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_2(F.silu(self.time_embed_0(t_emb.to(self.dtype))))

        # ``st`` rides beside ``h``: the channel (sum, sum of squares) of h
        # from the fused conv that produced it, or None (the next norm then
        # reduces h itself); a resampler ends the thread
        def attn(name, h, st, tile_pairs=False):
            return getattr(self, name)(h, context, tile_pairs, st)

        tile = lambda a: torch.cat([a, a], dim=0)

        def diverge_rest(emb, hs):
            """The time embedding and every stored skip, with its statistics,
            tiled to the pair batch."""
            return tile(emb), [
                (tile(e), None if s is None else (tile(s[0]), tile(s[1])))
                for e, s in hs]

        diverged = not cfg_pairs
        h, st = stem_conv(self.conv_in, x)
        hs = [(h, st)]
        ds = 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h, st = getattr(self, f"down_{level}_{i}_res")(h, emb, st)
                if ds in self.attention_resolutions:
                    first_pair = not diverged
                    h, st = attn(f"down_{level}_{i}_attn", h, st, first_pair)
                    if first_pair:
                        emb, hs = diverge_rest(emb, hs)
                        diverged = True
                hs.append((h, st))
            if level != len(self.channel_mult) - 1:
                h, st = getattr(self, f"down_{level}_ds")(h), None
                hs.append((h, st))
                ds *= 2

        h, st = self.mid_res1(h, emb, st)
        first_pair = not diverged  # no attention in the input blocks
        h, st = attn("mid_attn", h, st, first_pair)
        if first_pair:
            emb, hs = diverge_rest(emb, hs)
            diverged = True
        h, st = self.mid_res2(h, emb, st)

        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h_skip, st_skip = hs.pop()
                st = concat_stats(st, st_skip)
                h = torch.cat([h, h_skip], dim=1)
                h, st = getattr(self, f"up_{level}_{i}_res")(h, emb, st)
                if ds in self.attention_resolutions:
                    h, st = attn(f"up_{level}_{i}_attn", h, st)
                if level and i == self.num_res_blocks:
                    h, st = getattr(self, f"up_{level}_us")(h), None
                    ds //= 2

        h = head_conv(self.out_norm, self.conv_out, h, st)
        return h.permute(0, 2, 3, 1).to(in_dtype)
