"""Vector quantization for the VQGAN first stage.

Counterpart of ``dsml_thesis_tpu/models/quantize.py`` (``VectorQuantizer``):
the nearest-codebook search is one [BHW, D] x [D, K] product plus an argmin,
in fp32; the commitment loss and the straight-through gradient are those of
first-stage training.
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
    """Codebook lookup: z [B, H, W, e_dim] -> (z_q, loss, indices [B, H, W]).

    ``legacy=True`` (the reference's default) weighs the loss as
    ||sg(z_q) - z||^2 + beta ||z_q - sg(z)||^2, ``legacy=False`` the other
    way round; z_q passes the gradient straight through to z."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25,
                 legacy: bool = True):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.legacy = n_e, e_dim, beta, legacy
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)

    def forward(self, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        zf = z.float()
        e = self.embedding.weight
        with torch.no_grad():
            idx = _nearest_code(zf.reshape(-1, self.e_dim), e)
        z_q = e[idx].reshape(zf.shape).float()
        to_z = torch.mean((z_q.detach() - zf) ** 2)
        to_code = torch.mean((z_q - zf.detach()) ** 2)
        loss = (to_z + self.beta * to_code if self.legacy
                else self.beta * to_z + to_code)
        z_q = zf + (z_q - zf).detach()  # straight-through
        return z_q.to(z.dtype), loss, idx.reshape(zf.shape[:-1])

    def get_codebook_entry(self, indices: torch.Tensor, shape=None):
        z_q = self.embedding.weight[indices.reshape(-1)]
        return z_q if shape is None else z_q.reshape(shape)
