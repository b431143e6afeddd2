"""Config-YAML surface of the port: the same files under ``configs/`` that
drive the JAX package build the PyTorch model.

Own copies of ``load_config`` / ``_deep_merge`` (plain YAML, no framework)
and a ``build_model`` for the model configs of both families: the
two-conditioning talking-face (MEAD) ``LatentDiffusion`` (a VQ or KL first
stage, a ``ClassEmbedder`` and a ``Conv1DTemporalAttention``) and the
one-conditioning face-reenactment (AffectNet) ``LatentDiffusion`` /
``LatentDiffusionCLIP`` (a ``ClassEmbedder`` in one of its three null
layouts). ``build_finetune`` wraps the latter in the DiffusionCLIP
finetune, ``build_guidance_encoders`` builds its frozen CLIP and IR-SE
towers from checkpoint paths, and wraps the talking-face model in the
lip-reading finetune (its lipreader from ``lipread_ckpt``).
``instantiate_from_config`` covers the dataset targets the port's trainers
drive (``SyntheticDataset`` under the JAX package's target names too, the
AffectNet, MEAD and latent-cache datasets) and the end-to-end trainable
wav2vec2 cond stage (``AudioEmbedder``). ``scheduler_config``,
``base_learning_rate`` and ``data`` are read by the trainer as the JAX
trainer reads them. The first-stage targets (``VQModel``,
``AutoencoderKL``) are trained by ``training/vqgan_trainer.py``
(``TRAINERS``), which builds model and loss from the node. Other targets
(the text and landmark encoders, the EfficientNet classifier) raise
``NotImplementedError`` until their modules are ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import yaml

from .data import datasets as D
from .diffusion import make_schedule
from .models.autoencoder import AutoencoderKL, VQModel
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


def _build_kl(params: Dict) -> AutoencoderKL:
    return AutoencoderKL(ddconfig=dict(params["ddconfig"]),
                         embed_dim=params["embed_dim"],
                         dtype=params.get("dtype"))


def _build_class_embedder(params: Dict, null_mode: str,
                          freeze_null: bool = False) -> ClassEmbedder:
    # the reference's default p_uncond is 0.2 for every variant with a null
    # embedding; the plain one ('none') never drops
    return ClassEmbedder(
        embed_dim=params["embed_dim"],
        n_classes=params.get("n_classes", 1000),
        p_uncond=params.get("p_uncond", 0.0 if null_mode == "none" else 0.2),
        null_mode=null_mode, freeze_null=freeze_null,
        key=params.get("key", "class_label"))


def _synthetic(p: Dict) -> D.SyntheticDataset:
    return D.SyntheticDataset(**p)


def _build_audio_embedder(p: Dict):
    from .models.wav2vec2 import AudioEmbedder

    return AudioEmbedder(win_len=p.get("win_len", 4),
                         subspace_dim=p.get("subspace_dim", 768))


_BUILDERS = {
    "ldm.modules.diffusionmodules.openaimodel.UNetModel": _build_unet,
    "ldm.models.autoencoder.VQModelInterface": _build_vq,
    "ldm.models.autoencoder.VQModel": _build_vq,
    "ldm.models.autoencoder.AutoencoderKL": _build_kl,
    "torch.nn.Identity": lambda p: None,   # a first stage's lossconfig
    # face reenactment's embedders: a separate trainable null table
    # (ClassEmbedder3), the same frozen at its init (ClassEmbedder2)
    "ldm.modules.encoders.modules.ClassEmbedder3":
        lambda p: _build_class_embedder(p, "separate"),
    "ldm.modules.encoders.modules.ClassEmbedder2":
        lambda p: _build_class_embedder(p, "separate", freeze_null=True),
    # 'ClassEmbedder' names two reference classes: the talking-face one (an
    # (n_classes + 1)-row table, p_uncond always spelt out in its configs)
    # and face reenactment's plain one (no null row, no drop)
    "ldm.modules.encoders.modules.ClassEmbedder":
        lambda p: _build_class_embedder(
            p, "extra_row" if "p_uncond" in p else "none"),
    "ldm.modules.encoders.modules.Conv1DTemporalAttention":
        lambda p: Conv1DTemporalAttention(**p),
    # end-to-end trainable wav2vec2 conditioning (the reference's MEADBase4
    # experimental path); its conv extractor stays out of the optimizer
    "ldm.modules.encoders.modules.AudioEmbedder": _build_audio_embedder,
    "dsml_thesis_tpu.models.wav2vec2.AudioEmbedder": _build_audio_embedder,
    "dsml_thesis_tpu_torch.data.SyntheticDataset": _synthetic,
    "dsml_thesis_tpu.data.SyntheticDataset": _synthetic,
    "dsml_thesis_tpu.data.datasets.SyntheticDataset": _synthetic,
    "taming.data.custom.AffectnetTrain": lambda p: D.AffectnetTrain(**p),
    "taming.data.custom.AffectnetTest": lambda p: D.AffectnetTest(**p),
    "taming.data.custom.MEADBase3": lambda p: D.MEADBase3(**p),
    "taming.data.custom.MEADBase5": lambda p: D.MEADBase5(**p),
    "ldm.data.latents.LatentTrain": lambda p: D.LatentTrain(**p),
    "ldm.data.latents.LatentTest": lambda p: D.LatentTest(**p),
}

_LDM_TARGETS_1COND = {
    "ldm.models.diffusion.ddpm.LatentDiffusion",
    "ldm.models.diffusion.latent_diffclip.LatentDiffusionCLIP",
}
_LDM_TARGETS_2COND = {
    "ldm.models.diffusion.ddpm2cond.LatentDiffusion",
    "ldm.models.diffusion.ddpm2condtune.LatentDiffusion",
}


def instantiate_from_config(node: Any) -> Any:
    if node in ("__is_first_stage__", "__is_unconditional__"):
        return node
    target = node["target"]
    if target not in _BUILDERS:
        raise NotImplementedError(f"config target {target} is not ported")
    return _BUILDERS[target](dict(node.get("params", {})))


def _one_cond_specs(p: Dict) -> List[CondSpec]:
    """The conditioning of a face-reenactment model: one stream, or none
    (``__is_unconditional__``). ``__is_first_stage__`` pushes the batch value
    through the frozen first stage and channel-concatenates it; an encoder's
    output joins the cross-attention context (``conditioning_key:
    crossattn``) or is channel-concatenated as it is."""
    cs_cfg = p.get("cond_stage_config")
    if not cs_cfg or cs_cfg == "__is_unconditional__":
        return []
    # ``or``: the finetune's YAML spells ``cond_stage_key: null``
    key = p.get("cond_stage_key") or "class_label"
    if cs_cfg == "__is_first_stage__":
        return [CondSpec(key, None, "concat_first_stage", False)]
    route = ("crossattn_feature"
             if p.get("conditioning_key", "crossattn") == "crossattn"
             else "concat_raw")
    return [CondSpec(key, instantiate_from_config(cs_cfg), route,
                     p.get("cond_stage_trainable", False))]


def _two_cond_specs(p: Dict) -> List[CondSpec]:
    """The talking-face model's conditioning: class label and audio feature-
    concatenated into the context, and the masked-motion and identity
    latents channel-concatenated onto the UNet input (detected by the UNet
    taking more channels than a latent)."""
    trainable = p.get("cond_stage_trainable", False)
    specs = [
        CondSpec(p.get("cond_stage_key_1", "class_label"),
                 instantiate_from_config(p["cond_stage_config_1"]),
                 "crossattn_feature", trainable),
        CondSpec(p.get("cond_stage_key_2", "audio"),
                 instantiate_from_config(p["cond_stage_config_2"]),
                 "crossattn_feature", trainable),
    ]
    if p["unet_config"]["params"]["in_channels"] > p.get("channels", 3):
        for key in p.get("concat_keys", ("masked_image", "identity")):
            specs.append(CondSpec(key, None, "concat_first_stage", False))
    return specs


def build_model(model_cfg: Dict) -> LatentDiffusion:
    """Build the LatentDiffusion of a model config node (``cfg["model"]``),
    parameters at their PyTorch default inits in fp32."""
    target = model_cfg["target"]
    if target in _LDM_TARGETS_1COND:
        specs = _one_cond_specs
    elif target in _LDM_TARGETS_2COND:
        specs = _two_cond_specs
    else:
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
    return LatentDiffusion(
        unet=instantiate_from_config(p["unet_config"]),
        first_stage=(instantiate_from_config(p["first_stage_config"])
                     if isinstance(p.get("first_stage_config"), dict)
                     else None),
        cond_specs=specs(p),
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


# --------------------------------------------------------------------------
# the DiffusionCLIP finetune
# --------------------------------------------------------------------------

FINETUNE_TARGETS = (
    "latent_diffclip.LatentDiffusionCLIP",
    "ddpm2condtune.LatentDiffusion",
)


def is_finetune_target(target: str) -> bool:
    return target.endswith(FINETUNE_TARGETS)


def _resolve_edit_attr(name: str) -> int:
    """An ``edit_attr`` name (the reference's SRC_TRG_TXT_DIC spelling or an
    alias) -> AffectNet class index."""
    aliases = {"scared": "fear", "fearful": "fear", "anger": "angry",
               "disgust": "disgusted", "surprise": "surprised",
               "contemptuous": "contempt"}
    return D.EMOTION2LABEL[aliases.get(name, name)]


def build_guidance_encoders(p: Dict, edit_attr: Optional[str] = None,
                            skip: Optional[set] = None,
                            device: Optional[torch.device] = None) -> Dict:
    """The frozen guidance towers from checkpoint paths in the model config
    node's params (keys of this framework: the reference hard-codes its
    downloads):

      clip_ckpt  an OpenAI- or HF-layout CLIP checkpoint -> ``clip_image_embed``
                 (and, with ``clip_bpe``, the BPE merge table, the text
                 directions: per source class toward ``edit_attr``, else per
                 target class)
      id_ckpt    an IR-SE50 ``Backbone`` state_dict -> ``arcface_embed``
      cls_ckpt   raises: the EfficientNet classifier is not ported

    Returns keyword arguments of ``DiffusionCLIPFinetune``; the names in
    ``skip`` are not built. The text directions are computed on ``device``
    (the CPU when None): two batches of 79 prompts a class through the
    text tower."""
    skip = skip or set()
    out: Dict = {}
    if p.get("cls_ckpt") and "classifier_logits" not in skip:
        raise NotImplementedError(
            "cls_ckpt: the emotion classifier (EfficientNet) is not ported")
    want_text = "text_direction" not in skip and p.get("clip_bpe")
    if p.get("clip_ckpt") and ("clip_image_embed" not in skip or want_text):
        from .models import clip as C

        cfg, sd = C.load_clip_checkpoint(
            p["clip_ckpt"], use_quick_gelu=p.get("clip_quick_gelu", True))
        out["clip_image_embed"] = C.make_clip_image_embed(
            cfg, {k[len("visual."):]: v for k, v in sd.items()
                  if k.startswith("visual.")})
        if want_text:
            out.update(_text_directions(cfg, sd, p["clip_bpe"], edit_attr,
                                        device))
    if p.get("id_ckpt") and "arcface_embed" not in skip:
        from .models.insight_face import IRSE, convert_irse, make_id_embed

        sd = torch.load(p["id_ckpt"], map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        tower = IRSE(affine="output_layer.4.weight" in sd)
        tower.load_state_dict(convert_irse(sd), strict=True)
        out["arcface_embed"] = make_id_embed(tower)
    return out


def _text_directions(cfg, sd: Dict, bpe_path: str, edit_attr: Optional[str],
                     device: Optional[torch.device] = None) -> Dict:
    """The CLIP text directions of the finetune, a row a class: with
    ``edit_attr`` from each SOURCE class's emotion text (``face`` for the
    target class itself) toward the edit's text, else from ``face`` toward
    each target class's."""
    from .data.clip_tokenizer import CLIPTokenizer
    from .losses.guidance import EMOTION_PROMPTS, LABEL2EMOTION
    from .models import clip as C

    text = C.CLIPTextTower(cfg)
    text.load_state_dict({k[len("text."):]: v for k, v in sd.items()
                          if k.startswith("text.")}, strict=True)
    text.eval().to(device)
    tok = CLIPTokenizer(bpe_path)

    def tokens(txt):
        # truncate: the template set fits CLIP's 77 tokens; only tiny test
        # contexts ever cut a prompt
        return torch.from_numpy(tok.tokenize(
            [t.format(txt) for t in C.IMAGENET_TEMPLATES],
            context_length=cfg.context_length, truncate=True)).to(device)

    def direction(src_txt, trg_txt):
        return C.compute_text_direction(text, tokens(src_txt), tokens(trg_txt))

    if edit_attr is not None:
        trg_label = _resolve_edit_attr(edit_attr)
        # the target text through the reference's vocabulary: an alias
        # ('fear') still embeds 'scared face'
        trg_txt = {0: "neutral face", 7: "face"}.get(
            trg_label, LABEL2EMOTION[trg_label])
        dirs = [direction("face" if s == trg_label else LABEL2EMOTION[s],
                          trg_txt) for s in sorted(LABEL2EMOTION)]
        by_source = True
    else:
        dirs = [direction(*EMOTION_PROMPTS[c]) for c in sorted(EMOTION_PROMPTS)]
        by_source = False
    return {"text_direction": torch.stack(dirs),
            "direction_by_source": by_source}


def _build_lipread_finetune(p: Dict, ldm: LatentDiffusion,
                            lipreader=None):
    """``LipreadFinetune`` of a ``ddpm2condtune`` config: the lipreader
    handed in, else built from ``lipread_ckpt`` (an LRS3 ``model.pth``,
    activation ``lipread_relu_type``), else none (the L2 term alone)."""
    from .models.lipread_tune import LipreadFinetune

    if lipreader is None and p.get("lipread_ckpt"):
        from .models.lipreader import (load_lipreader_checkpoint,
                                       make_lipreader_apply)

        lipreader = make_lipreader_apply(load_lipreader_checkpoint(
            p["lipread_ckpt"], p.get("lipread_relu_type", "swish")))
    return LipreadFinetune(
        ldm, lipreader=lipreader,
        decode_steps=p.get("decode_steps", 8),
        lr_loss_weight=p.get("lr_loss_w", 1.0),
        start_lr_loss=p.get("start_lr_loss", 0),
        # the reference's mouth geometry; smaller in tiny test configs
        mouth_crop=p.get("mouth_crop", 72),
        mouth_center_crop=p.get("mouth_center_crop", 64),
        mouth_size=p.get("mouth_size", 88))


def build_finetune(model_cfg: Dict, ldm: Optional[LatentDiffusion] = None,
                   device: Optional[torch.device] = None, **encoder_fns):
    """The finetune wrapper of a config's target: ``LatentDiffusionCLIP`` ->
    ``DiffusionCLIPFinetune`` (its knobs: ``num_train_steps``, ``strength``,
    ``*_loss_w``, ``edit_attr``); ``ddpm2condtune`` -> ``LipreadFinetune``
    (``lipread_ckpt``, ``lipread_relu_type``, ``decode_steps``,
    ``lr_loss_w``, ``start_lr_loss``, the ``mouth_*`` geometry).
    ``encoder_fns`` hands in guidance towers (``lipreader_fn`` for the
    lip-reading one); the others are built from the config's checkpoint
    paths; ``device`` is where the text directions are computed."""
    target = model_cfg["target"]
    p = dict(model_cfg.get("params", {}))
    if target.endswith("ddpm2condtune.LatentDiffusion"):
        return _build_lipread_finetune(
            p, ldm if ldm is not None else build_model(model_cfg),
            encoder_fns.get("lipreader_fn"))
    if not target.endswith("latent_diffclip.LatentDiffusionCLIP"):
        raise NotImplementedError(f"finetune target {target}")
    from .models.diffclip import DiffusionCLIPFinetune

    if ldm is None:
        ldm = build_model(model_cfg)
    edit_attr = p.get("edit_attr")
    enc = {**build_guidance_encoders(p, edit_attr=edit_attr,
                                     skip=set(encoder_fns), device=device),
           **encoder_fns}
    return DiffusionCLIPFinetune(
        ldm,
        train_steps=p.get("num_train_steps", 6),
        strength=p.get("strength", 0.5),
        l2_weight=p.get("l2_loss_w", 1.0),
        id_weight=p.get("id_loss_w", 1.0),
        clip_weight=p.get("clip_loss_w", 1.0),
        cls_weight=p.get("cls_loss_w", 0.0),
        clip_image_embed=enc.get("clip_image_embed"),
        arcface_embed=enc.get("arcface_embed"),
        classifier_logits=enc.get("classifier_logits"),
        edit_attr_label=_resolve_edit_attr(edit_attr) if edit_attr else None,
        text_direction=enc.get("text_direction"),
        direction_by_source=enc.get("direction_by_source", False),
    )
