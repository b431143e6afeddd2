"""Split-input fold/unfold tiling.

Counterpart of ``dsml_thesis_tpu/diffusion/tiling.py``: the config-gated
``split_input_params`` path runs the UNet and the first-stage codecs over
overlapping spatial patches, blends the per-patch outputs with a
border-distance weighting and divides out the accumulated overlap
(``fold(w * o) / fold(w)``).

Patch geometry is known from the shapes, so ``unfold`` is a stack of
slices and ``fold`` a sum into slices; the weighting and the overlap
divisor are numpy constants, moved to the device once per geometry and
device. The L patches ride the batch axis (batch-major), so the model runs
once over B * L patches. Layout is NHWC; the patch order is torch
``nn.Unfold``'s (row-major, ``l = iy * Lx + ix``), which the tie-breaker
weighting depends on.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

# Upstream CompVis defaults for the weighting knobs; any key present in the
# config overrides.
DEFAULT_PARAMS = {
    "patch_distributed_vq": True,
    "tie_braker": False,
    "clip_max_weight": 0.5,
    "clip_min_weight": 0.01,
    "clip_max_tie_weight": 0.5,
    "clip_min_tie_weight": 0.01,
}


def _delta_border(h: int, w: int) -> np.ndarray:
    """Normalized distance to the nearest image border: 0 at the border,
    0.5 at the center, shape [h, w]."""
    y = np.arange(h, dtype=np.float64)[:, None] / max(h - 1, 1)
    x = np.arange(w, dtype=np.float64)[None, :] / max(w - 1, 1)
    dist_lu = np.minimum(np.broadcast_to(y, (h, w)), np.broadcast_to(x, (h, w)))
    dist_rd = np.minimum(np.broadcast_to(1 - y, (h, w)),
                         np.broadcast_to(1 - x, (h, w)))
    return np.minimum(dist_lu, dist_rd)


def patch_grid(hw: Tuple[int, int], ks: Tuple[int, int],
               stride: Tuple[int, int]) -> Tuple[int, int]:
    """Number of patches per axis, torch Unfold semantics (no padding)."""
    return ((hw[0] - ks[0]) // stride[0] + 1,
            (hw[1] - ks[1]) // stride[1] + 1)


def clamp_kernel(hw: Tuple[int, int], ks: Tuple[int, int],
                 stride: Tuple[int, int]):
    """The reference's kernel / stride clamp for inputs smaller than a
    patch."""
    ks = (min(ks[0], hw[0]), min(ks[1], hw[1]))
    stride = (min(stride[0], hw[0]), min(stride[1], hw[1]))
    return ks, stride


def tile_weighting(ks: Tuple[int, int], Ly: int, Lx: int,
                   params: Dict) -> np.ndarray:
    """Per-patch blend weights [L, ks0, ks1, 1]: clipped border distance of
    the patch, optionally tie-broken by the border distance of the patch's
    position in the L-grid."""
    p = {**DEFAULT_PARAMS, **params}
    w = np.clip(_delta_border(*ks), p["clip_min_weight"], p["clip_max_weight"])
    w = np.broadcast_to(w[None], (Ly * Lx, ks[0], ks[1])).copy()
    if p["tie_braker"]:
        lw = np.clip(_delta_border(Ly, Lx),
                     p["clip_min_tie_weight"], p["clip_max_tie_weight"])
        w *= lw.reshape(Ly * Lx, 1, 1)
    return w[..., None].astype(np.float32)


def unfold(x: torch.Tensor, ks: Tuple[int, int],
           stride: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, L, ks0, ks1, C], torch-Unfold patch order."""
    Ly, Lx = patch_grid(tuple(x.shape[1:3]), ks, stride)
    return torch.stack([
        x[:, iy * stride[0]:iy * stride[0] + ks[0],
          ix * stride[1]:ix * stride[1] + ks[1], :]
        for iy in range(Ly) for ix in range(Lx)], dim=1)


def fold(patches: torch.Tensor, out_hw: Tuple[int, int],
         stride: Tuple[int, int]) -> torch.Tensor:
    """[B, L, ks0, ks1, C] -> [B, H, W, C], overlaps summed (torch
    nn.Fold)."""
    b, L, kh, kw, c = patches.shape
    Ly, Lx = patch_grid(out_hw, (kh, kw), stride)
    assert Ly * Lx == L, (Ly, Lx, L)
    out = patches.new_zeros((b, out_hw[0], out_hw[1], c))
    for iy in range(Ly):
        for ix in range(Lx):
            y0, x0 = iy * stride[0], ix * stride[1]
            out[:, y0:y0 + kh, x0:x0 + kw, :] += patches[:, iy * Lx + ix]
    return out


def overlap_normalization(out_hw: Tuple[int, int], ks: Tuple[int, int],
                          stride: Tuple[int, int],
                          params: Dict) -> np.ndarray:
    """fold(weighting): the [H, W, 1] divisor of the blended canvas."""
    Ly, Lx = patch_grid(out_hw, ks, stride)
    w = tile_weighting(ks, Ly, Lx, params)
    out = np.zeros((out_hw[0], out_hw[1], 1), np.float32)
    for iy in range(Ly):
        for ix in range(Lx):
            y0, x0 = iy * stride[0], ix * stride[1]
            out[y0:y0 + ks[0], x0:x0 + ks[1], :] += w[iy * Lx + ix]
    return out


@functools.lru_cache(maxsize=64)
def _blend_constants(hw_out, ks_out, stride_out, Ly, Lx, params_items,
                     device, dtype):
    """The weighting and the overlap divisor on the device, once per
    geometry (a host-to-device copy waits for the stream)."""
    params = dict(params_items)
    w = torch.from_numpy(tile_weighting(ks_out, Ly, Lx, params))
    norm = torch.from_numpy(
        overlap_normalization(hw_out, ks_out, stride_out, params))
    return w.to(device=device, dtype=dtype), norm.to(device=device, dtype=dtype)


def _hashable(params: Dict):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in params.items()))


def tiled_apply(fn: Callable[[torch.Tensor, int], torch.Tensor],
                x: torch.Tensor, params: Dict, uf: int = 1,
                df: int = 1) -> torch.Tensor:
    """Run ``fn`` over overlapping patches of x and blend them.

    fn(z, L) maps z [B*L, kh, kw, C] -> [B*L, kh*uf//df, kw*uf//df, C'] (uf:
    decoder upsample, df: encoder downsample). Patches are batch-major, so
    per-sample side inputs (t, context) replicate with
    ``repeat_interleave(L, dim=0)``; the L patches run in one batched call.
    """
    assert uf == 1 or df == 1, "reference supports uf>1 xor df>1"
    b = x.shape[0]
    hw = tuple(x.shape[1:3])
    ks, stride = clamp_kernel(hw, tuple(params["ks"]), tuple(params["stride"]))
    Ly, Lx = patch_grid(hw, ks, stride)
    L = Ly * Lx

    z = unfold(x, ks, stride)                      # [B, L, kh, kw, C]
    o = fn(z.reshape((b * L,) + z.shape[2:]), L)   # [B*L, kh', kw', C']
    ks_out = (ks[0] * uf // df, ks[1] * uf // df)
    stride_out = (stride[0] * uf // df, stride[1] * uf // df)
    hw_out = (hw[0] * uf // df, hw[1] * uf // df)
    assert tuple(o.shape[1:3]) == ks_out, (o.shape, ks_out)

    w, norm = _blend_constants(hw_out, ks_out, stride_out, Ly, Lx,
                               _hashable(params), o.device, o.dtype)
    o = o.reshape((b, L) + o.shape[1:]) * w[None]
    return fold(o, hw_out, stride_out) / norm[None]
