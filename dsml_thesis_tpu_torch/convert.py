"""Weight bridge from the JAX package to the port.

``from_jax_params(params)`` turns the JAX ``LatentDiffusion`` parameter tree
(nested dicts of numpy arrays: ``unet``, ``first_stage``, ``cond/<key>``)
into a ``state_dict`` for ``models.ldm.LatentDiffusion``;
``from_jax_tree(tree)`` does the same for one module's tree. The port's
sub-modules carry the JAX modules' names, so a key is the tree path joined
by dots; only the leaves change:

  kernel  [I, O]            -> weight [O, I]            (Linear)
  kernel  [k, I, O]         -> weight [O, I, k]         (Conv1d)
  kernel  [kh, kw, I, O]    -> weight [O, I, kh, kw]    (Conv2d)
  scale                     -> weight                   (Group / LayerNorm)
  embedding                 -> <embedding module>.weight
  bias                      -> bias
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _leaf(path: str, name: str, value) -> tuple:
    a = np.array(value, dtype=np.float32)  # a copy: never a view of the source
    if name == "kernel":
        return f"{path}.weight", np.ascontiguousarray(
            np.transpose(a, _KERNEL_AXES[a.ndim]))
    if name == "scale":
        return f"{path}.weight", a
    if name == "embedding":
        # a bare table (the quantizer's codebook) lives in an nn.Embedding
        # called `embedding`; an Embed sub-module is already named by its path
        owner = path if path.endswith("embedding") else f"{path}.embedding"
        return f"{owner}.weight", a
    return f"{path}.{name}", a


def from_jax_tree(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One JAX module's parameter tree -> ``state_dict`` of its port module
    (keys under ``prefix``), fp32."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(from_jax_tree(value, f"{prefix}.{name}" if prefix
                                     else name))
        else:
            key, arr = _leaf(prefix, name, value)
            out[key] = torch.from_numpy(arr)
    return out


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LatentDiffusion parameter tree -> port ``state_dict`` (fp32)."""
    out: Dict[str, torch.Tensor] = {}
    for group, tree in params.items():
        out.update(from_jax_tree(tree, group.replace("/", ".")))
    return out
