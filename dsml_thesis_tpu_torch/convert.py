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
  kernel  [kt, kh, kw, I, O] -> weight [O, I, kt, kh, kw] (Conv3d)
  scale                     -> weight                   (Group / Layer /
                                                         BatchNorm)
  embedding                 -> <embedding module>.weight
  bias                      -> bias
  any other leaf            -> the tensor of that name, as it is: the free
                               tensors of the CLIP towers (class_embedding,
                               positional_embedding, proj, token_embedding,
                               text_projection), a PReLU's alpha, IR-SE's
                               output_scale / output_bias

``from_jax_variables(variables)`` also reads the ``batch_stats`` collection
of a module with BatchNorm (IR-SE): a BatchNorm's ``mean`` / ``var`` (and
IR-SE's ``output_mean`` / ``output_var``) land in the buffers of those names.

``to_jax_tree(module, tensors)`` and ``to_jax_params(ldm, tensors)`` are the
inverses: a module's ``state_dict`` (or any tensors under the same keys:
gradients, EMA shadows, updated parameters) back into the numpy tree of the
JAX layout, so that both sides can be compared leaf by leaf.

The reference's PyTorch Lightning checkpoints (the thesis's published
weights) come in through the counterpart of ``dsml_thesis_tpu/convert.py``:
each converter reads the reference's module names (``model.diffusion_model.*``
for the UNet, ``first_stage_model.*`` for the VQGAN, ``cond_stage_model*.*``
for the cond stages, ``model_ema.*`` for LitEma's shadows), builds the JAX
layout's tree from them and hands it to ``from_jax_tree`` /
``from_jax_params``, so that one layout rule serves both sources. Two
branches that no shipped config reaches raise ``NotImplementedError``: the
plain-QKV ``AttentionBlock`` UNet (``use_spatial_transformer: false``) and the
``LandmarkEncoder`` cond stage, neither of which the port has.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


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


def from_jax_variables(variables: Mapping,
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX variables tree ``{"params": ..., "batch_stats": ...}`` ->
    ``state_dict`` of its port module, parameters and running statistics
    (buffers under the statistics' own names) together."""
    out = from_jax_tree(variables["params"], prefix)
    stats = from_jax_tree(variables.get("batch_stats", {}), prefix)
    clash = set(out) & set(stats)
    if clash:
        raise ValueError(f"parameters and statistics share names: {clash}")
    out.update(stats)
    return out


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LatentDiffusion parameter tree -> port ``state_dict`` (fp32)."""
    out: Dict[str, torch.Tensor] = {}
    for group, tree in params.items():
        out.update(from_jax_tree(tree, group.replace("/", ".")))
    return out


_INVERSE_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0),
                        5: (2, 3, 4, 1, 0)}


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
                    sub, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
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


# --------------------------------------------------------------------------
# the reference's Lightning checkpoints
# --------------------------------------------------------------------------
# Name maps of the reference module trees: UNetModel
# (face_reenactment/ldm/modules/diffusionmodules/openaimodel.py:413-700,
# input_blocks / middle_block / output_blocks), the VQGAN Encoder / Decoder
# (ldm/modules/diffusionmodules/model.py:368-556) and the VQModel wrapper
# (ldm/models/autoencoder.py:14-60). torch Linear (O, I), Conv2d
# (O, I, kh, kw) and Conv1d (O, I, k) go to the JAX layout's (I, O),
# (kh, kw, I, O) and (k, I, O); a norm's weight / bias to scale / bias.

def _t_linear(w):  # (O, I) -> (I, O)
    return np.ascontiguousarray(np.transpose(w, (1, 0)))


def _t_conv2d(w):  # (O, I, kh, kw) -> (kh, kw, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _t_conv1d(w):  # (O, I, k) -> (k, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _to_np(sd: Mapping, key: str) -> np.ndarray:
    v = sd[key]
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    return np.array(v, dtype=np.float32)   # a copy: never a view of the source


class _Tree:
    """The JAX layout's tree as nested dicts, filled by '/'-joined paths."""

    def __init__(self):
        self.tree: Dict = {}

    def put(self, path: str, value: np.ndarray):
        node = self.tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value


def _conv(p: _Tree, sd, tname: str, fname: str, kind: str = "conv2d"):
    tr = {"conv2d": _t_conv2d, "conv1d": _t_conv1d, "linear": _t_linear}[kind]
    p.put(f"{fname}/kernel", tr(_to_np(sd, f"{tname}.weight")))
    if f"{tname}.bias" in sd:
        p.put(f"{fname}/bias", _to_np(sd, f"{tname}.bias"))


def _norm(p: _Tree, sd, tname: str, fname: str):
    p.put(f"{fname}/scale", _to_np(sd, f"{tname}.weight"))
    p.put(f"{fname}/bias", _to_np(sd, f"{tname}.bias"))


def _resblock(p: _Tree, sd, t: str, f: str):
    _norm(p, sd, f"{t}.in_layers.0", f"{f}/in_norm")
    _conv(p, sd, f"{t}.in_layers.2", f"{f}/in_conv")
    _conv(p, sd, f"{t}.emb_layers.1", f"{f}/emb_proj", "linear")
    _norm(p, sd, f"{t}.out_layers.0", f"{f}/out_norm")
    _conv(p, sd, f"{t}.out_layers.3", f"{f}/out_conv")
    if f"{t}.skip_connection.weight" in sd:
        _conv(p, sd, f"{t}.skip_connection", f"{f}/skip")


def _spatial_transformer(p: _Tree, sd, t: str, f: str, depth: int = 1):
    _norm(p, sd, f"{t}.norm", f"{f}/norm")
    _conv(p, sd, f"{t}.proj_in", f"{f}/proj_in")
    for d in range(depth):
        tb, fb = f"{t}.transformer_blocks.{d}", f"{f}/block_{d}"
        for a in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _conv(p, sd, f"{tb}.{a}.{proj}", f"{fb}/{a}/{proj}", "linear")
            _conv(p, sd, f"{tb}.{a}.to_out.0", f"{fb}/{a}/to_out", "linear")
        for i in (1, 2, 3):
            _norm(p, sd, f"{tb}.norm{i}", f"{fb}/norm{i}")
        _conv(p, sd, f"{tb}.ff.net.0.proj", f"{fb}/ff/proj_in", "linear")
        _conv(p, sd, f"{tb}.ff.net.2", f"{fb}/ff/proj_out", "linear")
    _conv(p, sd, f"{t}.proj_out", f"{f}/proj_out")


def unet_tree(sd: Mapping, num_res_blocks: int, channel_mult: Sequence[int],
              attention_resolutions: Sequence[int], transformer_depth: int = 1,
              prefix: str = "", use_spatial_transformer: bool = True) -> Dict:
    """A reference UNetModel ``state_dict`` (keys under ``prefix``) -> the
    JAX layout's UNet tree. The plain-QKV ``AttentionBlock`` layout
    (``use_spatial_transformer=False``) raises: the port's UNet has no such
    branch."""
    if not use_spatial_transformer:
        raise NotImplementedError(
            "use_spatial_transformer=False: the plain-QKV AttentionBlock UNet "
            "is not ported (no shipped config uses it)")
    p = _Tree()
    g = lambda k: prefix + k
    attn = lambda t, f: _spatial_transformer(p, sd, t, f, transformer_depth)
    _conv(p, sd, g("time_embed.0"), "time_embed_0", "linear")
    _conv(p, sd, g("time_embed.2"), "time_embed_2", "linear")
    if g("label_emb.weight") in sd:
        p.put("label_emb/embedding", _to_np(sd, g("label_emb.weight")))
    _conv(p, sd, g("input_blocks.0.0"), "conv_in")
    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _resblock(p, sd, g(f"input_blocks.{idx}.0"),
                      f"down_{level}_{i}_res")
            if ds in attention_resolutions:
                attn(g(f"input_blocks.{idx}.1"), f"down_{level}_{i}_attn")
            idx += 1
        if level != len(channel_mult) - 1:
            _conv(p, sd, g(f"input_blocks.{idx}.0.op"), f"down_{level}_ds/conv")
            idx += 1
            ds *= 2
    _resblock(p, sd, g("middle_block.0"), "mid_res1")
    attn(g("middle_block.1"), "mid_attn")
    _resblock(p, sd, g("middle_block.2"), "mid_res2")
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _resblock(p, sd, g(f"output_blocks.{idx}.0"), f"up_{level}_{i}_res")
            j = 1
            if ds in attention_resolutions:
                attn(g(f"output_blocks.{idx}.{j}"), f"up_{level}_{i}_attn")
                j += 1
            if level and i == num_res_blocks:
                _conv(p, sd, g(f"output_blocks.{idx}.{j}.conv"),
                      f"up_{level}_us/conv")
                ds //= 2
            idx += 1
    _norm(p, sd, g("out.0"), "out_norm")
    _conv(p, sd, g("out.2"), "conv_out")
    return p.tree


def convert_unet(sd: Mapping, num_res_blocks: int, channel_mult: Sequence[int],
                 attention_resolutions: Sequence[int],
                 transformer_depth: int = 1, prefix: str = "",
                 use_spatial_transformer: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """A reference UNetModel ``state_dict`` -> ``state_dict`` of the port's
    ``UNetModel``."""
    return from_jax_tree(unet_tree(
        sd, num_res_blocks, channel_mult, attention_resolutions,
        transformer_depth, prefix, use_spatial_transformer))


def _ae_resblock(p: _Tree, sd, t: str, f: str):
    _norm(p, sd, f"{t}.norm1", f"{f}/norm1")
    _conv(p, sd, f"{t}.conv1", f"{f}/conv1")
    _norm(p, sd, f"{t}.norm2", f"{f}/norm2")
    _conv(p, sd, f"{t}.conv2", f"{f}/conv2")
    if f"{t}.nin_shortcut.weight" in sd:
        _conv(p, sd, f"{t}.nin_shortcut", f"{f}/nin_shortcut")
    if f"{t}.conv_shortcut.weight" in sd:
        # use_conv_shortcut=True stores a 3x3 conv (model.py:108); the
        # ResnetBlock has a 1x1 nin_shortcut only
        raise NotImplementedError(
            f"{t}.conv_shortcut: 3x3 conv shortcuts (use_conv_shortcut=True) "
            "are not ported")


def _ae_attn(p: _Tree, sd, t: str, f: str):
    _norm(p, sd, f"{t}.norm", f"{f}/norm")
    for name in ("q", "k", "v", "proj_out"):
        _conv(p, sd, f"{t}.{name}", f"{f}/{name}")


def _encoder_tree(sd, ch_mult, num_res_blocks, attn_resolutions, resolution,
                  prefix) -> Dict:
    p = _Tree()
    g = lambda k: prefix + k
    _conv(p, sd, g("conv_in"), "conv_in")
    res = resolution
    for lvl in range(len(ch_mult)):
        for b in range(num_res_blocks):
            _ae_resblock(p, sd, g(f"down.{lvl}.block.{b}"),
                         f"down_{lvl}_block_{b}")
            if res in attn_resolutions:
                _ae_attn(p, sd, g(f"down.{lvl}.attn.{b}"),
                         f"down_{lvl}_attn_{b}")
        if lvl != len(ch_mult) - 1:
            _conv(p, sd, g(f"down.{lvl}.downsample.conv"),
                  f"down_{lvl}_downsample/conv")
            res //= 2
    _ae_resblock(p, sd, g("mid.block_1"), "mid_block_1")
    _ae_attn(p, sd, g("mid.attn_1"), "mid_attn_1")
    _ae_resblock(p, sd, g("mid.block_2"), "mid_block_2")
    _norm(p, sd, g("norm_out"), "norm_out")
    _conv(p, sd, g("conv_out"), "conv_out")
    return p.tree


def _decoder_tree(sd, ch_mult, num_res_blocks, attn_resolutions, resolution,
                  prefix) -> Dict:
    p = _Tree()
    g = lambda k: prefix + k
    _conv(p, sd, g("conv_in"), "conv_in")
    _ae_resblock(p, sd, g("mid.block_1"), "mid_block_1")
    _ae_attn(p, sd, g("mid.attn_1"), "mid_attn_1")
    _ae_resblock(p, sd, g("mid.block_2"), "mid_block_2")
    res = resolution // 2 ** (len(ch_mult) - 1)
    for lvl in reversed(range(len(ch_mult))):
        for b in range(num_res_blocks + 1):
            _ae_resblock(p, sd, g(f"up.{lvl}.block.{b}"),
                         f"up_{lvl}_block_{b}")
            if res in attn_resolutions:
                _ae_attn(p, sd, g(f"up.{lvl}.attn.{b}"), f"up_{lvl}_attn_{b}")
        if lvl != 0:
            _conv(p, sd, g(f"up.{lvl}.upsample.conv"),
                  f"up_{lvl}_upsample/conv")
            res *= 2
    _norm(p, sd, g("norm_out"), "norm_out")
    _conv(p, sd, g("conv_out"), "conv_out")
    return p.tree


def vqmodel_tree(sd: Mapping, ddconfig: dict, prefix: str = "") -> Dict:
    """A reference (taming) VQModel ``state_dict`` -> the JAX layout's
    VQModel tree."""
    args = (sd, ddconfig["ch_mult"], ddconfig["num_res_blocks"],
            ddconfig["attn_resolutions"], ddconfig["resolution"])
    p = _Tree()
    _conv(p, sd, prefix + "quant_conv", "quant_conv")
    _conv(p, sd, prefix + "post_quant_conv", "post_quant_conv")
    p.put("quantize/embedding", _to_np(sd, prefix + "quantize.embedding.weight"))
    return {"encoder": _encoder_tree(*args, prefix=prefix + "encoder."),
            "decoder": _decoder_tree(*args, prefix=prefix + "decoder."),
            **p.tree}


def convert_vqmodel(sd: Mapping, ddconfig: dict, prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """A reference VQModel ``state_dict`` -> ``state_dict`` of the port's
    ``VQModel``."""
    return from_jax_tree(vqmodel_tree(sd, ddconfig, prefix))


def torch_load(path: str) -> Mapping:
    """``torch.load`` of a checkpoint on the CPU: tensors only where the file
    allows it; a reference Lightning ``.ckpt`` pickles extras
    (``hyper_parameters``, ``callbacks``) that only ``weights_only=False``
    reads, as the reference's own loader does."""
    import pickle

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_first_stage_checkpoint(ckpt_path: str, ddconfig: dict
                                ) -> Dict[str, torch.Tensor]:
    """A pretrained first stage (``first_stage_config.params.ckpt_path``)
    -> ``state_dict`` of the port's ``VQModel``. Takes a bare taming VQModel
    layout, an LDM checkpoint's ``first_stage_model.*`` keys, and the port's
    own first-stage trainer checkpoint (``VQGANTrainer``'s ``state.pt`` or
    its directory: ``model`` holds the ``VQModel``'s ``state_dict``)."""
    import os

    if os.path.isdir(ckpt_path):
        ckpt_path = os.path.join(ckpt_path, "state.pt")
    ckpt = torch_load(ckpt_path)
    if "model" in ckpt and isinstance(ckpt["model"], Mapping):
        return {k: v.float() for k, v in ckpt["model"].items()}
    sd = dict(ckpt.get("state_dict", ckpt))
    prefix = ("first_stage_model."
              if any(k.startswith("first_stage_model.") for k in sd) else "")
    return convert_vqmodel(sd, ddconfig, prefix=prefix)


def class_embedder_tree(sd: Mapping, prefix: str = "",
                        null_mode: str = "extra_row") -> Dict:
    tree: Dict = {"embedding": {
        "embedding": _to_np(sd, prefix + "embedding.weight")}}
    if null_mode == "separate":
        tree["uncond_embedding"] = {
            "embedding": _to_np(sd, prefix + "uncond_embedding.weight")}
    return tree


def convert_class_embedder(sd: Mapping, prefix: str = "",
                           null_mode: str = "extra_row"
                           ) -> Dict[str, torch.Tensor]:
    """A reference ClassEmbedder (``extra_row``: one table with the null
    row; ``separate``: ``embedding`` and ``uncond_embedding``) ->
    ``state_dict`` of the port's ``ClassEmbedder``."""
    return from_jax_tree(class_embedder_tree(sd, prefix, null_mode))


def conv1d_temporal_attention_tree(sd: Mapping, prefix: str = "") -> Dict:
    p = _Tree()
    for i in range(5):
        _conv(p, sd, f"{prefix}attentionConvNet.{2 * i}", f"att_conv_{i}",
              "conv1d")
    _conv(p, sd, f"{prefix}attentionNet.0", "att_dense", "linear")
    return p.tree


def convert_conv1d_temporal_attention(sd: Mapping, prefix: str = ""
                                      ) -> Dict[str, torch.Tensor]:
    """The reference's audio ``Conv1DTemporalAttention`` -> ``state_dict``
    of the port's module."""
    return from_jax_tree(conv1d_temporal_attention_tree(sd, prefix))


def reference_state_dict(ckpt: Mapping, use_ema: bool = False) -> Dict:
    """The flat ``state_dict`` of a loaded reference checkpoint. With
    ``use_ema`` LitEma's shadows (``model_ema.<name without dots>``) take the
    place of the UNet's ``model.diffusion_model.*`` weights they shadow; a
    file without shadows keeps its raw weights. The flattening could in
    principle map two names to one, but LitEma's ``register_buffer`` refuses
    such a pair when it trains, so a trained checkpoint has none."""
    sd = dict(ckpt.get("state_dict", ckpt))
    if use_ema:
        ema = {}
        for k in sd:
            if k.startswith("model.diffusion_model."):
                flat = "model_ema." + k[len("model."):].replace(".", "")
                if flat in sd:
                    ema[k] = sd[flat]
        sd.update(ema)
    return sd


def load_ema_or_raw(ckpt_path: str, ldm: nn.Module, model_cfg: Dict,
                    use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference Lightning checkpoint -> ``state_dict`` of the port's
    ``LatentDiffusion`` (the groups the file holds), the UNet's EMA weights
    preferred (``use_ema``)."""
    return load_reference_ldm_checkpoint_from_sd(
        reference_state_dict(torch_load(ckpt_path), use_ema), ldm, model_cfg)


def load_reference_ldm_checkpoint(ckpt_path: str, ldm: nn.Module,
                                  model_cfg: Dict) -> Dict[str, torch.Tensor]:
    """A reference Lightning checkpoint's raw weights -> ``state_dict`` of
    the port's ``LatentDiffusion``."""
    return load_ema_or_raw(ckpt_path, ldm, model_cfg, use_ema=False)


def reference_ldm_tree(sd: Mapping, ldm: nn.Module, model_cfg: Dict) -> Dict:
    """A reference LDM ``state_dict`` -> the JAX layout's parameter tree
    (groups ``unet``, ``first_stage`` where the file has
    ``first_stage_model.*``, ``cond/<key>``). The cond stages follow the
    order of ``ldm.cond_specs``: ``cond_stage_model.`` for a model with one,
    ``cond_stage_model_<i>.`` (from 1) for several."""
    from .models.encoders import ClassEmbedder, Conv1DTemporalAttention

    p = dict(model_cfg.get("params", {}))
    up = p["unet_config"]["params"]
    tree: Dict = {"unet": unet_tree(
        sd, num_res_blocks=up["num_res_blocks"],
        channel_mult=tuple(up["channel_mult"]),
        attention_resolutions=tuple(up["attention_resolutions"]),
        transformer_depth=up.get("transformer_depth", 1),
        prefix="model.diffusion_model.",
        use_spatial_transformer=up.get("use_spatial_transformer", True))}
    if any(k.startswith("first_stage_model.") for k in sd):
        tree["first_stage"] = vqmodel_tree(
            sd, p["first_stage_config"]["params"]["ddconfig"],
            prefix="first_stage_model.")
    specs = [s for s in ldm.cond_specs if s.module is not None]
    for i, spec in enumerate(specs):
        prefix = ("cond_stage_model." if len(specs) == 1
                  else f"cond_stage_model_{i + 1}.")
        if isinstance(spec.module, ClassEmbedder):
            sub = class_embedder_tree(sd, prefix, spec.module.null_mode)
        elif isinstance(spec.module, Conv1DTemporalAttention):
            sub = conv1d_temporal_attention_tree(sd, prefix)
        else:
            raise NotImplementedError(
                f"cond stage {type(spec.module).__name__}: no converter (the "
                "LandmarkEncoder is not ported)")
        tree[f"cond/{spec.key}"] = sub
    return tree


def load_reference_ldm_checkpoint_from_sd(sd: Mapping, ldm: nn.Module,
                                          model_cfg: Dict
                                          ) -> Dict[str, torch.Tensor]:
    """A reference LDM ``state_dict`` -> ``state_dict`` of the port's
    ``LatentDiffusion``, through ``from_jax_params``."""
    return from_jax_params(reference_ldm_tree(sd, ldm, model_cfg))
