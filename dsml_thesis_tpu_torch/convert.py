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

``to_jax_tree(module, tensors)`` and ``to_jax_params(ldm, tensors)`` are the
inverses: a module's ``state_dict`` (or any tensors under the same keys:
gradients, EMA shadows, updated parameters) back into the numpy tree of the
JAX layout, so that both sides can be compared leaf by leaf.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _leaf(path: str, name: str, value) -> tuple:
    a = np.array(value, dtype=np.float32)  # a copy: never a view of the source
    if name == "kernel":
        return _join(path, "weight"), np.ascontiguousarray(
            np.transpose(a, _KERNEL_AXES[a.ndim]))
    if name == "scale":
        return _join(path, "weight"), a
    if name == "embedding":
        # a bare table (the quantizer's codebook) lives in an nn.Embedding
        # called `embedding`; an Embed sub-module is already named by its path
        owner = path if path.endswith("embedding") else _join(path, "embedding")
        return _join(owner, "weight"), a
    return _join(path, name), a


def from_jax_tree(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One JAX module's parameter tree -> ``state_dict`` of its port module
    (keys under ``prefix``), fp32."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(from_jax_tree(value, _join(prefix, name)))
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


_INVERSE_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def to_jax_tree(module: nn.Module,
                tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The inverse of ``from_jax_tree``: ``tensors`` (default: the module's
    own parameters), keyed like ``module.state_dict()``, as the nested numpy
    tree of the JAX module. Keys missing from ``tensors`` are left out. The
    leaf kind follows the owning sub-module: Linear / Conv weights become
    ``kernel`` (axes moved back), an ``nn.Embedding`` table ``embedding``
    (bare under a vector quantizer, inside its ``Embed`` sub-tree elsewhere),
    any other ``weight`` a norm's ``scale``."""
    from .models.quantize import VectorQuantizer

    if tensors is None:
        tensors = dict(module.named_parameters())
    tree: Dict = {}
    for path, sub in module.named_modules():
        for name, _ in sub.named_parameters(recurse=False):
            key = f"{path}.{name}" if path else name
            if key not in tensors:
                continue
            a = tensors[key].detach().float().cpu().numpy()
            parts = path.split(".") if path else []
            if name == "weight" and isinstance(
                    sub, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                leaf = "kernel"
                a = np.ascontiguousarray(
                    np.transpose(a, _INVERSE_KERNEL_AXES[a.ndim]))
            elif name == "weight" and isinstance(sub, nn.Embedding):
                leaf = "embedding"
                owner = module.get_submodule(".".join(parts[:-1]))
                if isinstance(owner, VectorQuantizer):
                    parts = parts[:-1]   # the codebook is a bare table there
            elif name == "weight":
                leaf = "scale"
            else:
                leaf = name
            node = tree
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = a
    return tree


def to_jax_params(ldm: nn.Module,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The inverse of ``from_jax_params``: the LatentDiffusion's tensors as
    the JAX parameter tree (groups ``unet``, ``first_stage``, ``cond/<key>``).
    ``tensors`` is keyed like ``ldm.state_dict()``; groups with no tensor in
    it are left out."""
    out: Dict = {}
    for group, module in ldm.param_groups().items():
        prefix = group.replace("/", ".") + "."
        sub = None if tensors is None else {
            k[len(prefix):]: v for k, v in tensors.items()
            if k.startswith(prefix)}
        tree = to_jax_tree(module, sub)
        if tree:
            out[group] = tree
    return out
