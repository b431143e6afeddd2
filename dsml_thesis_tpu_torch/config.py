"""Config-YAML surface of the port: the same files under ``configs/`` that
drive the JAX package build the PyTorch model.

Own copies of ``load_config`` / ``_deep_merge`` (plain YAML, no framework)
and a ``build_model`` for the talking-face (MEAD) model configs: the
two-conditioning ``LatentDiffusion`` target with a VQ first stage, a
``ClassEmbedder`` and a ``Conv1DTemporalAttention``; and ``instantiate_from_config`` for the
dataset targets the port's trainer drives (``SyntheticDataset``, under the
JAX package's target names too, so one ``data`` node serves both trainers).
``scheduler_config``, ``base_learning_rate`` and ``data`` are read by the
trainer as the JAX trainer reads them. Other targets raise
``NotImplementedError`` until their modules are ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import yaml

from .data import SyntheticDataset
from .diffusion import make_schedule
from .models.autoencoder import VQModel
from .models.encoders import ClassEmbedder, Conv1DTemporalAttention
from .models.ldm import CondSpec, LatentDiffusion
from .models.unet import UNetModel


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def load_config(paths: Sequence[str], overrides: Sequence[str] = ()) -> Dict:
    """Merge YAML files left to right, then apply ``a.b.c=value`` dotlist
    overrides."""
    cfg: Dict = {}
    for p in paths:
        with open(p) as f:
            cfg = _deep_merge(cfg, yaml.safe_load(f) or {})
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "=" not in ov or key.lstrip().startswith("-"):
            raise ValueError(
                f"unrecognized argument {ov!r}: config overrides must be "
                "dotted key=value pairs (e.g. model.params.image_size=32)")
        node = cfg
        parts = key.strip().split(".")
        for i, part in enumerate(parts[:-1]):
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f"override {key!r}: '{'.'.join(parts[:i + 1])}' is "
                    f"{type(node).__name__} ({node!r}), cannot descend into it")
        node[parts[-1]] = _parse_value(val)
    return cfg


def _build_unet(params: Dict) -> UNetModel:
    kw = dict(params)
    kw.pop("n_embed", None)
    kw.pop("use_fp16", None)
    return UNetModel(**kw)


def _build_vq(params: Dict) -> VQModel:
    return VQModel(ddconfig=dict(params["ddconfig"]),
                   n_embed=params["n_embed"], embed_dim=params["embed_dim"],
                   dtype=params.get("dtype"))


_BUILDERS = {
    "ldm.modules.diffusionmodules.openaimodel.UNetModel": _build_unet,
    "ldm.models.autoencoder.VQModelInterface": _build_vq,
    "ldm.models.autoencoder.VQModel": _build_vq,
    "ldm.modules.encoders.modules.ClassEmbedder":
        lambda p: ClassEmbedder(**p),
    "ldm.modules.encoders.modules.Conv1DTemporalAttention":
        lambda p: Conv1DTemporalAttention(**p),
    "dsml_thesis_tpu_torch.data.SyntheticDataset":
        lambda p: SyntheticDataset(**p),
    "dsml_thesis_tpu.data.SyntheticDataset": lambda p: SyntheticDataset(**p),
    "dsml_thesis_tpu.data.datasets.SyntheticDataset":
        lambda p: SyntheticDataset(**p),
}

_LDM_TARGETS_2COND = {
    "ldm.models.diffusion.ddpm2cond.LatentDiffusion",
    "ldm.models.diffusion.ddpm2condtune.LatentDiffusion",
}


def instantiate_from_config(node: Dict) -> Any:
    target = node["target"]
    if target not in _BUILDERS:
        raise NotImplementedError(f"config target {target} is not ported")
    return _BUILDERS[target](dict(node.get("params", {})))


def build_model(model_cfg: Dict) -> LatentDiffusion:
    """Build the LatentDiffusion of a talking-face model config node
    (``cfg["model"]``), parameters at their PyTorch default inits in fp32."""
    target = model_cfg["target"]
    if target not in _LDM_TARGETS_2COND:
        raise NotImplementedError(f"model target {target} is not ported")
    p = dict(model_cfg.get("params", {}))
    if p.get("parameterization", "eps") != "eps":
        raise NotImplementedError("sampling is implemented for "
                                  "parameterization='eps' only")
    schedule = make_schedule(
        beta_schedule=p.get("beta_schedule", "linear"),
        timesteps=p.get("timesteps", 1000),
        linear_start=p.get("linear_start", 1e-4),
        linear_end=p.get("linear_end", 2e-2),
        cosine_s=p.get("cosine_s", 8e-3),
        v_posterior=p.get("v_posterior", 0.0),
    )
    trainable = p.get("cond_stage_trainable", False)
    cond_specs: List[CondSpec] = [
        CondSpec(p.get("cond_stage_key_1", "class_label"),
                 instantiate_from_config(p["cond_stage_config_1"]),
                 "crossattn_feature", trainable),
        CondSpec(p.get("cond_stage_key_2", "audio"),
                 instantiate_from_config(p["cond_stage_config_2"]),
                 "crossattn_feature", trainable),
    ]
    # the masked-motion and identity latents are channel-concatenated onto
    # the UNet input; detected by the UNet taking more channels than a latent
    if p["unet_config"]["params"]["in_channels"] > p.get("channels", 3):
        for key in p.get("concat_keys", ("masked_image", "identity")):
            cond_specs.append(CondSpec(key, None, "concat_first_stage", False))
    return LatentDiffusion(
        unet=instantiate_from_config(p["unet_config"]),
        first_stage=instantiate_from_config(p["first_stage_config"]),
        cond_specs=cond_specs,
        schedule=schedule,
        scale_factor=p.get("scale_factor", 1.0),
        first_stage_key=p.get("first_stage_key", "image"),
        image_size=p.get("image_size", 32),
        channels=p.get("channels", 3),
        split_input_params=p.get("split_input_params"),
        loss_type=p.get("loss_type", "l2"),
        l_simple_weight=p.get("l_simple_weight", 1.0),
        original_elbo_weight=p.get("original_elbo_weight", 0.0),
        monitor=p.get("monitor", "val_loss_ema"),
    )
