"""Parameter utilities of the port: the sampling cast, and the weight layer
that every ``--ckpt`` and warm start reads through.

Counterpart of ``dsml_thesis_tpu/utils_io.py``: ``surgical_load`` (the
reference's ``init_from_ckpt(ignore_keys, only_model)`` on a ``state_dict``)
and ``load_params``, which resolves a checkpoint of any source into a
``state_dict`` of the port's ``LatentDiffusion``:

  - a reference PyTorch Lightning ``.ckpt`` / ``.pt`` (the thesis's published
    weights), converted by ``convert.py``, LitEma's shadows preferred;
  - a checkpoint of the port's trainers (``checkpoints/<name>/state.pt`` or
    its directory: ``model`` and the EMA shadows ``ema``);
  - a bare ``state_dict`` of the port's model (``torch.save`` of
    ``ldm.state_dict()``, or of ``convert.from_jax_params`` of a JAX tree).

A JAX package's Orbax directory is refused with the route across: the port
never imports orbax.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from . import convert

CHECKPOINT_FILE = "state.pt"
ORBAX_ROUTE = (
    "a JAX package (Orbax) checkpoint directory cannot be read by the port, "
    "which never imports orbax: restore it with the JAX package, then save "
    "torch.save(dsml_thesis_tpu_torch.convert.from_jax_params("
    "jax.tree.map(numpy.asarray, params)), 'weights.pt') and pass that file")


def cast_sampling_params(module: nn.Module,
                         dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every fp32 parameter and buffer of ``module`` to ``dtype`` (bf16),
    in place, for sampling: it halves the weight bytes read per model call.
    The layers compute in their own stated type and the norms take their
    statistics in fp32 whatever the parameters' type, so this only rounds
    the weights once. Training state stays fp32: sampling paths only."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.dtype == torch.float32:
            t.data = t.data.to(dtype)
    return module


def _matches(key: str, prefixes: Sequence[str]) -> bool:
    # a prefix may be spelled with the JAX tree's '/' or the state_dict's '.'
    return any(key.startswith(p.replace("/", ".")) for p in prefixes)


def surgical_load(template: Mapping[str, torch.Tensor],
                  loaded: Mapping[str, torch.Tensor],
                  ignore_keys: Sequence[str] = (),
                  only: Optional[Sequence[str]] = ()) -> Dict[str, torch.Tensor]:
    """Merge ``loaded`` into ``template`` (both ``state_dict``s): a key under
    an ``ignore_keys`` prefix keeps the template's value; with ``only``, only
    keys under those prefixes are taken from ``loaded``. Keys missing from
    ``loaded`` keep the template's value and keys missing from ``template``
    are dropped, as ``load_state_dict(strict=False)`` would."""
    out = {}
    for k, v in template.items():
        take = (k in loaded and not _matches(k, ignore_keys)
                and (not only or _matches(k, only)))
        out[k] = loaded[k] if take else v
    return out


def _tensors(obj: Mapping, ldm: nn.Module, model_cfg: Dict,
             use_ema: bool) -> Dict[str, torch.Tensor]:
    """The tensors a loaded checkpoint holds for ``ldm``, keyed like its
    ``state_dict`` (only the groups the file has)."""
    if "model" in obj and "ema" in obj:           # the port's trainers
        sd = dict(obj["model"])
        if use_ema:
            sd.update(obj["ema"])
        return sd
    if "state_dict" in obj or any(k.startswith("model.diffusion_model.")
                                  for k in obj):   # a reference checkpoint
        return convert.load_reference_ldm_checkpoint_from_sd(
            convert.reference_state_dict(obj, use_ema), ldm, model_cfg)
    return dict(obj)                               # a bare state_dict


def _overlay(path: str, got: Mapping[str, torch.Tensor],
             ldm: nn.Module) -> Dict[str, torch.Tensor]:
    """``ldm``'s ``state_dict`` with every group ``got`` holds replaced by
    ``got``'s tensors; such a group must match ``ldm``'s keys and shapes."""
    own = ldm.state_dict()
    groups = [g.replace("/", ".") + "." for g in ldm.param_groups()]
    stray = [k for k in got if not any(k.startswith(g) for g in groups)]
    if stray:
        raise KeyError(f"{path}: tensors outside the model's groups: "
                       f"{sorted(stray)[:5]}")
    out = dict(own)
    for g in groups:
        have = {k for k in got if k.startswith(g)}
        if not have:
            continue
        want = {k for k in own if k.startswith(g)}
        if have != want:
            raise KeyError(
                f"{path}: group {g[:-1]!r} does not match the model: missing "
                f"{sorted(want - have)[:5]}, unexpected "
                f"{sorted(have - want)[:5]}")
        for k in have:
            if got[k].shape != own[k].shape:
                raise ValueError(f"{path}: {k} has shape "
                                 f"{tuple(got[k].shape)}, the model "
                                 f"{tuple(own[k].shape)}")
            out[k] = got[k]
    return out


def _read(path: str) -> Mapping:
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint does not exist: {path!r}")
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
            raise ValueError(f"{path}: no {CHECKPOINT_FILE} of the port's "
                             f"trainers; {ORBAX_ROUTE}")
        path = os.path.join(path, CHECKPOINT_FILE)
    return convert.torch_load(path)


def load_params(path: str, ldm: nn.Module, model_cfg: Dict,
                use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A checkpoint of any source as a whole ``state_dict`` of ``ldm``
    (``ldm.load_state_dict(..., strict=True)`` takes it). Group by group
    (``unet``, ``first_stage``, ``cond.<key>``): a group the file lacks (the
    first stage of a UNet-only checkpoint) keeps ``ldm``'s own weights; a
    group it has must match ``ldm``'s keys exactly. ``use_ema`` prefers the
    EMA shadows where the file has them."""
    return _overlay(path, _tensors(_read(path), ldm, model_cfg, use_ema), ldm)


def load_raw_and_ema(path: str, ldm: nn.Module, model_cfg: Dict):
    """``load_params`` with ``use_ema`` False and True from one read of the
    file (a warm start wants both): a file without EMA shadows gives the raw
    weights to both."""
    obj = _read(path)
    return tuple(_overlay(path, _tensors(obj, ldm, model_cfg, ema), ldm)
                 for ema in (False, True))
