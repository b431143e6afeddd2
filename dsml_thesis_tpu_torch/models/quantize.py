"""Vector quantization for the VQGAN first stage (inference form).

Counterpart of ``dsml_thesis_tpu/models/quantize.py``: the nearest-codebook
search is one [BHW, D] x [D, K] product plus an argmin, in fp32. The
commitment loss belongs to first-stage training and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


def _nearest_code(flat: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """argmin_k ||flat_i - e_k||^2 through the expanded square, in fp32."""
    flat, e = flat.float(), e.float()
    d = ((flat ** 2).sum(dim=1, keepdim=True) - 2.0 * flat @ e.t()
         + (e ** 2).sum(dim=1)[None, :])
    return torch.argmin(d, dim=1)


class VectorQuantizer(nn.Module):
    """Codebook lookup: z [B, H, W, e_dim] -> (z_q, indices [B, H, W])."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        zf = z.float()
        idx = _nearest_code(zf.reshape(-1, self.e_dim), self.embedding.weight)
        z_q = self.embedding.weight[idx].reshape(zf.shape).float()
        z_q = zf + (z_q - zf)  # the straight-through form, values only
        return z_q.to(z.dtype), idx.reshape(zf.shape[:-1])

    def get_codebook_entry(self, indices: torch.Tensor, shape=None):
        z_q = self.embedding.weight[indices.reshape(-1)]
        return z_q if shape is None else z_q.reshape(shape)
