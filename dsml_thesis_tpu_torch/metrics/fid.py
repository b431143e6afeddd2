"""FID / IS / KID / PRC math over a pluggable feature extractor.

Counterpart of ``dsml_thesis_tpu/metrics/fid.py`` (the reference scores
sample directories with torch-fidelity's FID, ISC, KID and PRC). The math is
numpy, in float64 where the features are; the features come from an
extractor passed in: the FID InceptionV3 of ``metrics/inception.py`` fed by
the user's ``pt_inception`` checkpoint, or any other embedding.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (Heusel et al. 2017)."""
    diff = mu1 - mu2
    offset = np.eye(sigma1.shape[0]) * eps
    # trace of sqrtm(s1 s2): use sqrtm(s1^(1/2) s2 s1^(1/2)) for symmetry
    s1_half = _sqrtm_psd(sigma1 + offset)
    inner = _sqrtm_psd(s1_half @ (sigma2 + offset) @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(inner))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu1, s1 = activation_statistics(feats_a)
    mu2, s2 = activation_statistics(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


def inception_score(probs: np.ndarray, splits: int = 10,
                    shuffle_seed: Optional[int] = 2020) -> Tuple[float, float]:
    """IS from class probabilities [N, C].

    Features are shuffled before splitting (torch-fidelity does the same
    with rng_seed=2020) — sample dirs usually sort by class/subject, which
    would skew each split's marginal p(y)."""
    if shuffle_seed is not None:
        probs = probs[np.random.RandomState(shuffle_seed).permutation(len(probs))]
    scores = []
    n = len(probs)
    for k in range(splits):
        part = probs[k * n // splits:(k + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-10) - np.log(py + 1e-10))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def kid_from_features(
    feats_a: np.ndarray, feats_b: np.ndarray, n_subsets: int = 100,
    subset_size: Optional[int] = None, seed: int = 0,
) -> Tuple[float, float]:
    """KID: polynomial-kernel (d=3) MMD^2, averaged over random subsets."""
    rng = np.random.RandomState(seed)
    m = subset_size or min(1000, len(feats_a), len(feats_b))
    d = feats_a.shape[1]

    def poly(x, y):
        return (x @ y.T / d + 1.0) ** 3

    vals = []
    for _ in range(n_subsets):
        x = feats_a[rng.choice(len(feats_a), m, replace=False)]
        y = feats_b[rng.choice(len(feats_b), m, replace=False)]
        kxx = poly(x, x)
        kyy = poly(y, y)
        kxy = poly(x, y)
        np.fill_diagonal(kxx, 0)
        np.fill_diagonal(kyy, 0)
        mmd = kxx.sum() / (m * (m - 1)) + kyy.sum() / (m * (m - 1)) - 2 * kxy.mean()
        vals.append(mmd)
    return float(np.mean(vals)), float(np.std(vals))


def precision_recall(
    real_feats: np.ndarray, fake_feats: np.ndarray, k: int = 3,
) -> Tuple[float, float]:
    """Improved precision & recall (Kynkaanniemi et al. 2019), the PRC metric
    torch-fidelity reports (reference metrics.sh:7-14, --prc): a sample is
    covered if it falls inside any k-NN-radius ball of the other set.
    precision = coverage of fake by real manifold; recall = of real by fake.
    """
    real_feats = np.asarray(real_feats, np.float32)
    fake_feats = np.asarray(fake_feats, np.float32)

    def pairwise(a, b):
        aa = (a * a).sum(1)[:, None]
        bb = (b * b).sum(1)[None, :]
        return np.sqrt(np.clip(aa + bb - 2 * (a @ b.T), 0, None))

    # row-blocked: full NxN matrices OOM at FID-scale dirs (~25k images
    # per side -> ~5GB; torch-fidelity batches the same way)
    block = 4096

    def knn_radius(x):
        if len(x) <= k:
            raise ValueError(
                f"precision/recall with k={k} needs more than {k} samples "
                f"per side (got {len(x)})")
        out = np.empty(len(x), np.float32)
        for s in range(0, len(x), block):
            d = pairwise(x[s:s + block], x)
            # k-th nearest excluding self (self-distance 0 is column 0)
            out[s:s + block] = np.sort(d, axis=1)[:, k]
        return out

    def coverage(a, radius_b, b):
        hit = np.empty(len(a), bool)
        for s in range(0, len(a), block):
            d = pairwise(a[s:s + block], b)
            hit[s:s + block] = (d <= radius_b[None, :]).any(axis=1)
        return float(hit.mean())

    precision = coverage(fake_feats, knn_radius(real_feats), real_feats)
    recall = coverage(real_feats, knn_radius(fake_feats), fake_feats)
    return precision, recall


def compute_features(
    image_dir_or_array, extractor: Callable[[np.ndarray], np.ndarray],
    batch: int = 32, size: Optional[int] = None,
) -> np.ndarray:
    """Run an extractor over a dir of images / an [N,H,W,3] array in [-1,1]."""
    import glob
    import os

    if isinstance(image_dir_or_array, np.ndarray):
        arrs = image_dir_or_array
    else:
        from PIL import Image

        exts = ("jpg", "jpeg", "png", "JPG", "JPEG", "PNG")
        paths = sorted(
            p for e in exts
            for p in glob.glob(os.path.join(image_dir_or_array, f"*.{e}"))
        )
        if not paths:
            raise ValueError(
                f"no images (*.{'/'.join(exts)}) in {image_dir_or_array}")

        def load(p):
            # torch-fidelity/pytorch-fid parity: BILINEAR squash to
            # size x size (no bicubic shortest-side resize + center crop —
            # interpolation/crop choices measurably shift FID)
            img = Image.open(p).convert("RGB")
            if size is not None and img.size != (size, size):
                img = img.resize((size, size), Image.BILINEAR)
            return np.asarray(img, np.float32) / 127.5 - 1.0

        arrs = np.stack([load(p) for p in paths])
    # no padded tail: a batch of another size needs no second compile here
    out = [np.asarray(extractor(arrs[s:s + batch]))
           for s in range(0, len(arrs), batch)]
    return np.concatenate(out)
