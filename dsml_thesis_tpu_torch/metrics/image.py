"""Image quality metrics: PSNR, SSIM, cosine similarity.

Counterpart of ``dsml_thesis_tpu/metrics/image.py``. Images are NHWC; the
reference's metric scripts map generated and ground-truth frames from
[-1, 1] to [0, 1] (``to_unit_range``) and score them with
``data_range=1``. SSIM is Wang et al.'s with skimage's algorithm: an 11 x 11
Gaussian window at sigma 1.5 (k1 0.01, k2 0.03), population covariance,
the mean over the pixels whose window lies inside the image (a 5-pixel
crop), and piq's average pre-pooling of images larger than 383 px.

On the card the filter is a cuDNN convolution, which may multiply in TF32;
``ssim`` runs inside ``full_fp32`` so that its answer is the CPU's fp32 one.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32():
    """cuBLAS and cuDNN without TF32 inside the block (fp32 products, as on
    the CPU); the caller's settings are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0)


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR of NHWC batches."""
    mse = ((a - b) ** 2).mean(dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' 2-D filter of NCHW images."""
    c = x.shape[1]
    return F.conv2d(x, kernel.expand(c, 1, *kernel.shape), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03,
         downsample: bool = True) -> torch.Tensor:
    """Per-image SSIM of NHWC batches (11 x 11 Gaussian, sigma 1.5), in the
    inputs' type. ``downsample`` average-pools by
    f = max(1, round(min(H, W) / 256)) first, as piq does (a no-op at 128
    and 256 px)."""
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    if downsample:
        f = max(1, round(min(a.shape[2], a.shape[3]) / 256))
        if f > 1:
            a, b = F.avg_pool2d(a, f), F.avg_pool2d(b, f)
    kernel = torch.as_tensor(_gaussian_kernel(), dtype=a.dtype,
                             device=a.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    with full_fp32():
        mu_a = _filter2d(a, kernel)
        mu_b = _filter2d(b, kernel)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sigma_aa = _filter2d(a * a, kernel) - mu_aa
        sigma_bb = _filter2d(b * b, kernel) - mu_bb
        sigma_ab = _filter2d(a * b, kernel) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      axis: int = -1) -> torch.Tensor:
    """Cosine similarity along ``axis``; a zero vector gives 0, as
    ``F.cosine_similarity``'s clamp gives it."""
    an = a / a.norm(dim=axis, keepdim=True).clamp_min(1e-8)
    bn = b / b.norm(dim=axis, keepdim=True).clamp_min(1e-8)
    return (an * bn).sum(dim=axis)
