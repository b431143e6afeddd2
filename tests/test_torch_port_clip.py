"""The DiffusionCLIP guidance towers and losses of the port against the JAX
package, on the CPU in fp32.

* CLIP: the vision and text towers (2 layers of width 64, 2 heads), weights
  carried by ``from_jax_tree`` (the free tensors included), and the image
  embedding of [-1, 1] images through the bicubic resize and CLIP's
  normalization (1e-4 of the output's maximum); the bicubic resize against
  the JAX package's matrix form (1e-6); the text direction (1e-4); the
  OpenAI- and HF-layout converters and the checkpoint loader on state_dicts
  in those layouts.
* The tokenizer: equal ids to the JAX package's on a synthetic merge table
  (passed as a list, as a text file and gzipped), shapes and the refusal of
  an over-long prompt.
* IR-SE50 at full depth (the JAX converter knows 50 / 100 / 152 layers
  only), 112 px, batch 1: the embedding through ``from_jax_variables`` and
  through ``convert_irse`` of a reference-layout state_dict (1e-4), with
  and without the final affine, and the identity loss's pooling.
* The guidance losses on fixed embeddings (1e-5).
"""
from __future__ import annotations

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.data import clip_tokenizer as jtok
from dsml_thesis_tpu.losses import guidance as jg
from dsml_thesis_tpu.models import clip as jclip
from dsml_thesis_tpu.models import insight_face as jif
from dsml_thesis_tpu_torch.convert import from_jax_tree, from_jax_variables
from dsml_thesis_tpu_torch.data import clip_tokenizer as ttok
from dsml_thesis_tpu_torch.losses import guidance as tg
from dsml_thesis_tpu_torch.models import clip as tclip
from dsml_thesis_tpu_torch.models import insight_face as tif
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

TINY = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2,
            vision_heads=2, vocab_size=600, context_length=16, text_width=64,
            text_heads=2, text_layers=2, embed_dim=32)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[True, False],
                ids=["quick-gelu", "gelu"])
def clip_pair(request):
    cfg = dict(TINY, use_quick_gelu=request.param)
    jcfg, tcfg = jclip.CLIPConfig(**cfg), tclip.CLIPConfig(**cfg)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((3, 32, 32, 3)), jnp.float32)
    tokens = jnp.asarray(rng.integers(1, 599, (4, 16)), jnp.int32)
    jm = jclip.CLIP(jcfg)
    params = jm.init(jax.random.PRNGKey(0), images, tokens)["params"]
    params = random_params(params, rng)
    tm = tclip.CLIP(tcfg)
    tm.load_state_dict(from_jax_tree(_np(params)), strict=True)
    return jcfg, jm, params, tm, np.asarray(images), np.asarray(tokens)


def test_towers_match_jax(clip_pair):
    jcfg, jm, params, tm, images, tokens = clip_pair
    want_i, want_t = jm.apply({"params": params}, jnp.asarray(images),
                              jnp.asarray(tokens))
    with torch.no_grad():
        got_i, got_t = tm(torch.from_numpy(images), torch.from_numpy(tokens))
    _close(got_i, want_i)
    _close(got_t, want_t)


def test_image_embed_and_text_direction_match_jax(clip_pair):
    jcfg, jm, params, tm, images, tokens = clip_pair
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 20, 20, 3)).astype(np.float32)   # resized
    want = jclip.make_clip_image_embed(jcfg, params["visual"])(jnp.asarray(x))
    embed = tclip.make_clip_image_embed(tm.cfg, tm.visual.state_dict())
    assert not any(p.requires_grad for p in embed.parameters())
    with torch.no_grad():
        _close(embed(torch.from_numpy(x)), want)
    src, trg = tokens[:2], tokens[2:]
    want_d = jclip.compute_text_direction(jcfg, params["text"],
                                          jnp.asarray(src), jnp.asarray(trg))
    got_d = tclip.compute_text_direction(tm.text, torch.from_numpy(src),
                                         torch.from_numpy(trg))
    _close(got_d, want_d)
    zero = tclip.compute_text_direction(tm.text, torch.from_numpy(src),
                                        torch.from_numpy(src))
    assert not zero.any()
    assert tclip.IMAGENET_TEMPLATES == jclip.IMAGENET_TEMPLATES


@pytest.mark.parametrize("hw,out", [((16, 16), 32), ((128, 128), 224),
                                    ((40, 24), 17), ((7, 9), 7)],
                         ids=["up", "affectnet", "down", "odd"])
def test_bicubic_resize_matches_jax(hw, out):
    x = np.random.default_rng(2).uniform(-1, 1, (2,) + hw + (3,)
                                         ).astype(np.float32)
    want = jclip.bicubic_resize_torch(jnp.asarray(x), out, out + 1)
    _close(tclip.bicubic_resize_torch(torch.from_numpy(x), out, out + 1),
           want, rel=1e-6)
    _close(tclip.preprocess_gan_output(torch.from_numpy(x), out),
           jclip.preprocess_gan_output(jnp.asarray(x), out), rel=1e-6)


def _openai_layout(cfg, params):
    """A JAX CLIP tree in the OpenAI checkpoint layout (torch tensors)."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    sd = {}

    def block(src, dst):
        for a, b in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            sd[f"{dst}.{b}.weight"] = t(src[a]["scale"])
            sd[f"{dst}.{b}.bias"] = t(src[a]["bias"])
        sd[f"{dst}.attn.in_proj_weight"] = t(np.asarray(src["qkv"]["kernel"]).T)
        sd[f"{dst}.attn.in_proj_bias"] = t(src["qkv"]["bias"])
        for a, b in (("out_proj", "attn.out_proj"), ("c_fc", "mlp.c_fc"),
                     ("c_proj", "mlp.c_proj")):
            sd[f"{dst}.{b}.weight"] = t(np.asarray(src[a]["kernel"]).T)
            sd[f"{dst}.{b}.bias"] = t(src[a]["bias"])

    v, x = params["visual"], params["text"]
    sd["visual.conv1.weight"] = t(np.transpose(
        np.asarray(v["patch_conv"]["kernel"]), (3, 2, 0, 1)))
    for k in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{k}"] = t(v[k])
    for k in ("ln_pre", "ln_post"):
        sd[f"visual.{k}.weight"] = t(v[k]["scale"])
        sd[f"visual.{k}.bias"] = t(v[k]["bias"])
    for i in range(cfg.vision_layers):
        block(v[f"block_{i}"], f"visual.transformer.resblocks.{i}")
    sd["token_embedding.weight"] = t(x["token_embedding"])
    sd["positional_embedding"] = t(x["positional_embedding"])
    sd["text_projection"] = t(x["text_projection"])
    sd["ln_final.weight"] = t(x["ln_final"]["scale"])
    sd["ln_final.bias"] = t(x["ln_final"]["bias"])
    for i in range(cfg.text_layers):
        block(x[f"block_{i}"], f"transformer.resblocks.{i}")
    return sd


def _hf_layout(openai):
    """The same weights in the HuggingFace CLIPModel layout."""
    sd = {}

    def block(src, dst, width):
        w, b = openai[f"{src}.attn.in_proj_weight"], \
            openai[f"{src}.attn.in_proj_bias"]
        for i, p in enumerate("qkv"):
            sd[f"{dst}.self_attn.{p}_proj.weight"] = w[i * width:(i + 1) * width]
            sd[f"{dst}.self_attn.{p}_proj.bias"] = b[i * width:(i + 1) * width]
        for a, c in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                     ("attn.out_proj", "self_attn.out_proj"),
                     ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
            for p in ("weight", "bias"):
                sd[f"{dst}.{c}.{p}"] = openai[f"{src}.{a}.{p}"]

    e = "vision_model.embeddings."
    sd[e + "patch_embedding.weight"] = openai["visual.conv1.weight"]
    sd[e + "class_embedding"] = openai["visual.class_embedding"]
    sd[e + "position_embedding.weight"] = openai["visual.positional_embedding"]
    sd["visual_projection.weight"] = openai["visual.proj"].t()
    for a, c in (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm")):
        for p in ("weight", "bias"):
            sd[f"vision_model.{c}.{p}"] = openai[f"visual.{a}.{p}"]
    for i in range(TINY["vision_layers"]):
        block(f"visual.transformer.resblocks.{i}",
              f"vision_model.encoder.layers.{i}", TINY["vision_width"])
    sd["text_model.embeddings.token_embedding.weight"] = \
        openai["token_embedding.weight"]
    sd["text_model.embeddings.position_embedding.weight"] = \
        openai["positional_embedding"]
    sd["text_projection.weight"] = openai["text_projection"].t()
    for p in ("weight", "bias"):
        sd[f"text_model.final_layer_norm.{p}"] = openai[f"ln_final.{p}"]
    for i in range(TINY["text_layers"]):
        block(f"transformer.resblocks.{i}", f"text_model.encoder.layers.{i}",
              TINY["text_width"])
    return sd


def test_checkpoint_layouts_match_jax(clip_pair, tmp_path):
    """Both layouts through the JAX converters and the port's give the same
    embeddings; the loader reads either file; ``openai_state_dict`` is the
    OpenAI converter's inverse."""
    jcfg, jm, params, tm, images, tokens = clip_pair
    openai = _openai_layout(jcfg, params)
    quick = jcfg.use_quick_gelu
    for layout, sd in (("openai", openai), ("hf", _hf_layout(openai))):
        if layout == "openai":
            jc, jp = jclip.convert_clip_openai(openai, 2, 2)
            tc, tsd = tclip.convert_clip_openai(openai, 2, 2)
        else:
            jc, jp = jclip.convert_clip_hf(sd, 2, 2, use_quick_gelu=quick)
            tc, tsd = tclip.convert_clip_hf(sd, 2, 2, use_quick_gelu=quick)
        if layout == "openai" and not quick:
            continue   # an OpenAI checkpoint is QuickGELU
        assert dataclasses_equal(jc, tc)
        m = tclip.CLIP(tc)
        m.load_state_dict(tsd, strict=True)
        want_i, want_t = jclip.CLIP(jc).apply(
            {"params": jp}, jnp.asarray(images), jnp.asarray(tokens))
        with torch.no_grad():
            got_i, got_t = m(torch.from_numpy(images),
                             torch.from_numpy(tokens))
        _close(got_i, want_i)
        _close(got_t, want_t)
        path = tmp_path / f"{layout}.pt"
        torch.save(sd, path)
        lc, lsd = tclip.load_clip_checkpoint(str(path), use_quick_gelu=quick)
        assert lc.vision_layers == 2 and set(lsd) == set(tsd)
    if quick:
        back = tclip.openai_state_dict(tm)
        assert set(back) == set(openai)
        for k, v in openai.items():
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    torch.save({"nothing": torch.zeros(1)}, tmp_path / "bad.pt")
    with pytest.raises(ValueError):
        tclip.load_clip_checkpoint(str(tmp_path / "bad.pt"))


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


# --------------------------------------------------------------------------
# the tokenizer
# --------------------------------------------------------------------------

MERGES = [
    "t h", "th e</w>", "f a", "fa c", "fac e</w>", "h a", "ha p", "hap p",
    "happ y</w>", "p h", "ph o", "pho t", "phot o</w>", "o f</w>", "s a",
    "sa d</w>", "a n", "an g", "ang r", "angr y</w>",
]
TEXTS = ["a photo of a happy face.", "THE SAD face!", "angry  face", "face",
         "xyzzy, q-t: 7", "café ²³ naïve ½ Ⅻ 東京 it's", "&amp;lt;tag&gt;",
         "<|startoftext|>hi<|endoftext|>"]


@pytest.mark.parametrize("source", ["list", "text", "gzip"])
def test_tokenizer_matches_jax(source, tmp_path):
    if source == "list":
        merges = MERGES
    else:
        body = "#version: 0.2\n" + "\n".join(MERGES) + "\n"
        path = tmp_path / ("m.txt.gz" if source == "gzip" else "m.txt")
        if source == "gzip":
            with gzip.open(path, "wt", encoding="utf-8") as f:
                f.write(body)
        else:
            path.write_text(body, encoding="utf-8")
        merges = str(path)
    j, t = jtok.CLIPTokenizer(merges), ttok.CLIPTokenizer(merges)
    assert t.vocab_size == j.vocab_size
    for text in TEXTS:
        assert t.encode(text) == j.encode(text), text
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    np.testing.assert_array_equal(t.tokenize(TEXTS, context_length=24,
                                             truncate=True),
                                  j.tokenize(TEXTS, context_length=24,
                                             truncate=True))
    with pytest.raises(RuntimeError):
        t.tokenize(TEXTS[0], context_length=5)


# --------------------------------------------------------------------------
# IR-SE50
# --------------------------------------------------------------------------

def _reference_sd(affine, seed=0):
    """A reference-layout Backbone state_dict with random values (running
    variances positive), from a port tower's key map."""
    tower = tif.IRSE(affine=affine)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tif.reference_state_dict(tower).items():
        r = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if "running_var" in k:
            r = rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32)
        elif v.dim() == 1:
            r = 0.1 * r + (1.0 if k.endswith("weight") else 0.0)
        else:
            r /= np.sqrt(np.prod(v.shape[1:]))
        sd[k] = torch.from_numpy(r)
    return sd


@pytest.mark.parametrize("affine", [True, False])
def test_irse50_matches_jax(affine):
    sd = _reference_sd(affine)
    params, stats = jif.convert_irse(sd)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 112, 112, 3)
                                         ).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(jif.IRSE(affine=affine).apply)(variables, jnp.asarray(x))
    via_tree = tif.IRSE(affine=affine)
    via_tree.load_state_dict(from_jax_variables(_np(variables)), strict=True)
    via_sd = tif.IRSE(affine=affine)
    via_sd.load_state_dict(tif.convert_irse(sd), strict=True)
    with torch.no_grad():
        for tower in (via_tree, via_sd):
            _close(tower(torch.from_numpy(x)), want)
        assert set(tif.reference_state_dict(via_sd)) == set(sd)


def test_id_embed_pools_as_jax():
    x = np.random.default_rng(4).uniform(-1.2, 1.2, (2, 128, 128, 3)
                                         ).astype(np.float32)
    _close(tif.adaptive_avg_pool2d(torch.from_numpy(x), (112, 112)),
           jif.adaptive_avg_pool2d(jnp.asarray(x), (112, 112)), rel=1e-6)
    sd = _reference_sd(True, seed=1)
    params, stats = jif.convert_irse(sd)
    want = jax.jit(jif.make_id_embed_apply())(
        {"params": params, "batch_stats": stats}, jnp.asarray(x[:1]))
    tower = tif.IRSE()
    tower.load_state_dict(tif.convert_irse(sd), strict=True)
    embed = tif.make_id_embed(tower)
    assert not embed.training
    with torch.no_grad():
        _close(embed(torch.from_numpy(x[:1])), want)


# --------------------------------------------------------------------------
# the guidance losses
# --------------------------------------------------------------------------

def test_guidance_losses_match_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((48, 16)).astype(np.float32)
    src = rng.uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    edit = rng.uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    tdir = rng.standard_normal((3, 16)).astype(np.float32)
    labels = np.array([0, 5, 2])
    jfn = lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(w)
    tfn = lambda x: x.reshape(x.shape[0], -1) @ torch.from_numpy(w)
    j = lambda a: jnp.asarray(a)
    t = torch.from_numpy
    pairs = [
        (tg.clip_directional_loss(tfn, t(src), t(edit), t(tdir)),
         jg.clip_directional_loss(jfn, j(src), j(edit), j(tdir))),
        (tg.clip_directional_loss(tfn, t(src), t(edit), t(tdir[0])),
         jg.clip_directional_loss(jfn, j(src), j(edit), j(tdir[0]))),
        (tg.id_loss(tfn, t(src), t(edit)), jg.id_loss(jfn, j(src), j(edit))),
        (tg.cls_loss(tfn, t(edit), t(labels)),
         jg.cls_loss(jfn, j(edit), j(labels))),
        (tg.l2_loss(t(src), t(edit)), jg.l2_loss(j(src), j(edit))),
    ]
    for d in (-0.5, 0.3, 1.0, 1.9, 2.5):
        pairs.append((tg.diffusionclip_direction_loss(torch.tensor(d)),
                      jg.diffusionclip_direction_loss(jnp.asarray(d))))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=0)
    assert tg.LABEL2EMOTION == jg.LABEL2EMOTION
    assert tg.EMOTION_PROMPTS == jg.EMOTION_PROMPTS
