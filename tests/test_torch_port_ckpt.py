"""The port's weight layer against the JAX package's converter, on the CPU.

A test-only writer (``reference_state_dict``) puts a random JAX parameter
tree back under the reference's PyTorch Lightning names (the inverse of
each leaf transform, at the names ``dsml_thesis_tpu/convert.py`` reads). It
is proven first against the JAX package alone: the JAX converter must give
the tree back exactly. On those files the port's ``utils_io.load_params``
must equal ``convert.from_jax_params`` of the JAX converter's tree, EMA on
and off, and a UNet forward after the load must agree with JAX. Two tiny
models cover the layouts: the 2-cond MEAD model (the talking-face
``ClassEmbedder`` with its null row, the audio ``Conv1DTemporalAttention``,
``cond_stage_model_<i>.`` prefixes) and a 1-cond model with
``ClassEmbedder3`` (a separate null embedding, ``cond_stage_model.``).
Also: both first-stage layouts, pickled Lightning extras, ``surgical_load``,
the refusals, a port trainer checkpoint and a bare state_dict.
"""
import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu import convert as jconvert
from dsml_thesis_tpu.config import build_model as jbuild_model
from dsml_thesis_tpu.utils_io import surgical_load as jsurgical_load
from dsml_thesis_tpu_torch import convert as tconvert
from dsml_thesis_tpu_torch.config import build_model
from dsml_thesis_tpu_torch.convert import (from_jax_params, from_jax_tree,
                                           to_jax_params)
from dsml_thesis_tpu_torch.reenactment import load_weights
from dsml_thesis_tpu_torch.utils_io import load_params, surgical_load
from test_ldm import TINY_MEAD_CFG
from test_torch_port_hygiene import one_torch_thread  # noqa: F401
from test_torch_port_pipeline import random_params

# a 1-cond model of the same widths whose class embedder keeps its null
# token in a table of its own (ClassEmbedder3, null_mode "separate")
TINY_C3_CFG = TINY_MEAD_CFG.replace(
    "ldm.models.diffusion.ddpm2cond.LatentDiffusion",
    "ldm.models.diffusion.ddpm.LatentDiffusion").replace(
    "in_channels: 9", "in_channels: 3").replace(
    "context_dim: 48", "context_dim: 16").replace(
    """    cond_stage_key_1: class_label
    cond_stage_key_2: audio
""", """    cond_stage_key: class_label
""").replace(
    """    cond_stage_config_1:
      target: ldm.modules.encoders.modules.ClassEmbedder
""", """    cond_stage_config:
      target: ldm.modules.encoders.modules.ClassEmbedder3
""").split("    cond_stage_config_2:")[0]

CONFIGS = {"mead": TINY_MEAD_CFG, "c3": TINY_C3_CFG}


# --------------------------------------------------------------------------
# the test-only writer: a JAX tree under the reference's names
# --------------------------------------------------------------------------

_INVERSE = {"conv2d": (3, 2, 0, 1), "conv1d": (2, 1, 0), "linear": (1, 0)}


class _Writer:
    """Writes leaves of a JAX-layout tree ('/'-joined paths) as the
    reference's tensors (torch layout, reference names)."""

    def __init__(self, tree, sd):
        self.tree, self.sd = tree, sd

    def node(self, path):
        n = self.tree
        for p in path.split("/"):
            n = n[p]
        return n

    def has(self, path):
        try:
            self.node(path)
            return True
        except KeyError:
            return False

    def put(self, name, a):
        self.sd[name] = torch.from_numpy(np.array(a, np.float32))

    def conv(self, f, t, kind="conv2d"):
        n = self.node(f)
        self.put(f"{t}.weight", np.transpose(np.asarray(n["kernel"]),
                                             _INVERSE[kind]))
        if "bias" in n:
            self.put(f"{t}.bias", n["bias"])

    def norm(self, f, t):
        n = self.node(f)
        self.put(f"{t}.weight", n["scale"])
        self.put(f"{t}.bias", n["bias"])


def _write_unet(w, up, g):
    depth = up.get("transformer_depth", 1)

    def res(f, t):
        w.norm(f"{f}/in_norm", f"{t}.in_layers.0")
        w.conv(f"{f}/in_conv", f"{t}.in_layers.2")
        w.conv(f"{f}/emb_proj", f"{t}.emb_layers.1", "linear")
        w.norm(f"{f}/out_norm", f"{t}.out_layers.0")
        w.conv(f"{f}/out_conv", f"{t}.out_layers.3")
        if w.has(f"{f}/skip"):
            w.conv(f"{f}/skip", f"{t}.skip_connection")

    def attn(f, t):
        w.norm(f"{f}/norm", f"{t}.norm")
        w.conv(f"{f}/proj_in", f"{t}.proj_in")
        for d in range(depth):
            fb, tb = f"{f}/block_{d}", f"{t}.transformer_blocks.{d}"
            for a in ("attn1", "attn2"):
                for p in ("to_q", "to_k", "to_v"):
                    w.conv(f"{fb}/{a}/{p}", f"{tb}.{a}.{p}", "linear")
                w.conv(f"{fb}/{a}/to_out", f"{tb}.{a}.to_out.0", "linear")
            for i in (1, 2, 3):
                w.norm(f"{fb}/norm{i}", f"{tb}.norm{i}")
            w.conv(f"{fb}/ff/proj_in", f"{tb}.ff.net.0.proj", "linear")
            w.conv(f"{fb}/ff/proj_out", f"{tb}.ff.net.2", "linear")
        w.conv(f"{f}/proj_out", f"{t}.proj_out")

    mult, nrb = up["channel_mult"], up["num_res_blocks"]
    attn_res = up["attention_resolutions"]
    w.conv("time_embed_0", g("time_embed.0"), "linear")
    w.conv("time_embed_2", g("time_embed.2"), "linear")
    w.conv("conv_in", g("input_blocks.0.0"))
    idx, ds = 1, 1
    for level in range(len(mult)):
        for i in range(nrb):
            res(f"down_{level}_{i}_res", g(f"input_blocks.{idx}.0"))
            if ds in attn_res:
                attn(f"down_{level}_{i}_attn", g(f"input_blocks.{idx}.1"))
            idx += 1
        if level != len(mult) - 1:
            w.conv(f"down_{level}_ds/conv", g(f"input_blocks.{idx}.0.op"))
            idx, ds = idx + 1, ds * 2
    res("mid_res1", g("middle_block.0"))
    attn("mid_attn", g("middle_block.1"))
    res("mid_res2", g("middle_block.2"))
    idx = 0
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            res(f"up_{level}_{i}_res", g(f"output_blocks.{idx}.0"))
            j = 1
            if ds in attn_res:
                attn(f"up_{level}_{i}_attn", g(f"output_blocks.{idx}.{j}"))
                j += 1
            if level and i == nrb:
                w.conv(f"up_{level}_us/conv", g(f"output_blocks.{idx}.{j}.conv"))
                ds //= 2
            idx += 1
    w.norm("out_norm", g("out.0"))
    w.conv("conv_out", g("out.2"))


def _write_vq(w, dd, g):
    def block(f, t):
        w.norm(f"{f}/norm1", f"{t}.norm1")
        w.conv(f"{f}/conv1", f"{t}.conv1")
        w.norm(f"{f}/norm2", f"{t}.norm2")
        w.conv(f"{f}/conv2", f"{t}.conv2")
        if w.has(f"{f}/nin_shortcut"):
            w.conv(f"{f}/nin_shortcut", f"{t}.nin_shortcut")

    def attn(f, t):
        w.norm(f"{f}/norm", f"{t}.norm")
        for n in ("q", "k", "v", "proj_out"):
            w.conv(f"{f}/{n}", f"{t}.{n}")

    def mid(f, t):
        block(f"{f}/mid_block_1", f"{t}mid.block_1")
        attn(f"{f}/mid_attn_1", f"{t}mid.attn_1")
        block(f"{f}/mid_block_2", f"{t}mid.block_2")

    mult, nrb, attn_res = dd["ch_mult"], dd["num_res_blocks"], \
        dd["attn_resolutions"]
    e, te = "encoder", g("encoder.")
    w.conv(f"{e}/conv_in", f"{te}conv_in")
    res = dd["resolution"]
    for lvl in range(len(mult)):
        for b in range(nrb):
            block(f"{e}/down_{lvl}_block_{b}", f"{te}down.{lvl}.block.{b}")
            if res in attn_res:
                attn(f"{e}/down_{lvl}_attn_{b}", f"{te}down.{lvl}.attn.{b}")
        if lvl != len(mult) - 1:
            w.conv(f"{e}/down_{lvl}_downsample/conv",
                   f"{te}down.{lvl}.downsample.conv")
            res //= 2
    mid(e, te)
    w.norm(f"{e}/norm_out", f"{te}norm_out")
    w.conv(f"{e}/conv_out", f"{te}conv_out")
    d, td = "decoder", g("decoder.")
    w.conv(f"{d}/conv_in", f"{td}conv_in")
    mid(d, td)
    res = dd["resolution"] // 2 ** (len(mult) - 1)
    for lvl in reversed(range(len(mult))):
        for b in range(nrb + 1):
            block(f"{d}/up_{lvl}_block_{b}", f"{td}up.{lvl}.block.{b}")
            if res in attn_res:
                attn(f"{d}/up_{lvl}_attn_{b}", f"{td}up.{lvl}.attn.{b}")
        if lvl != 0:
            w.conv(f"{d}/up_{lvl}_upsample/conv",
                   f"{td}up.{lvl}.upsample.conv")
            res *= 2
    w.norm(f"{d}/norm_out", f"{td}norm_out")
    w.conv(f"{d}/conv_out", f"{td}conv_out")
    w.conv("quant_conv", g("quant_conv"))
    w.conv("post_quant_conv", g("post_quant_conv"))
    w.put(g("quantize.embedding.weight"), w.node("quantize/embedding"))


def _write_cond(w, sd_prefix, kind):
    if kind == "class":
        w.put(f"{sd_prefix}embedding.weight", w.node("embedding/embedding"))
        if w.has("uncond_embedding"):
            w.put(f"{sd_prefix}uncond_embedding.weight",
                  w.node("uncond_embedding/embedding"))
    else:
        for i in range(5):
            w.conv(f"att_conv_{i}", f"{sd_prefix}attentionConvNet.{2 * i}",
                   "conv1d")
        w.conv("att_dense", f"{sd_prefix}attentionNet.0", "linear")


def reference_state_dict(tree, model_cfg, ema_unet=None):
    """A JAX LatentDiffusion tree as the reference's Lightning
    ``state_dict``: ``model.diffusion_model.*``, ``first_stage_model.*``
    where the tree has a first stage, the cond stages under
    ``cond_stage_model.`` (one) or ``cond_stage_model_<i>.`` (several), and,
    with ``ema_unet``, LitEma's shadows of the UNet from that tree."""
    p = model_cfg["params"]
    up = p["unet_config"]["params"]
    sd = {}
    _write_unet(_Writer(tree["unet"], sd), up,
                lambda k: "model.diffusion_model." + k)
    if ema_unet is not None:
        shadows = {}
        _write_unet(_Writer(ema_unet, shadows), up,
                    lambda k: "diffusion_model." + k)
        sd.update({"model_ema." + k.replace(".", ""): v
                   for k, v in shadows.items()})
    if "first_stage" in tree:
        _write_vq(_Writer(tree["first_stage"], sd),
                  p["first_stage_config"]["params"]["ddconfig"],
                  lambda k: "first_stage_model." + k)
    conds = [f"cond/{p[k]}" for k in ("cond_stage_key", "cond_stage_key_1",
                                      "cond_stage_key_2") if k in p]
    for i, group in enumerate(conds):
        prefix = ("cond_stage_model." if len(conds) == 1
                  else f"cond_stage_model_{i + 1}.")
        kind = "audio" if "att_dense" in tree[group] else "class"
        _write_cond(_Writer(tree[group], sd), prefix, kind)
    return sd


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(name):
    """(name, config, JAX model, random tree of the JAX layout, its EMA
    UNet tree, port model, reference state_dict with shadows). The tree's
    paths are the port model's (``to_jax_params``): the JAX converter's
    round trip and the JAX UNet's ``apply`` hold them to the JAX layout."""
    cfg = yaml.safe_load(CONFIGS[name])
    jldm = jbuild_model(cfg["model"])
    torch.manual_seed(0)
    tldm = build_model(cfg["model"])
    tree = random_params(to_jax_params(tldm), np.random.default_rng(1))
    ema = random_params(tree["unet"], np.random.default_rng(2))
    return (name, cfg, jldm, tree, ema, tldm,
            reference_state_dict(tree, cfg["model"], ema_unet=ema))


@pytest.fixture(params=sorted(CONFIGS))
def models(request):
    return _models(request.param)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _save(tmp_path, obj, name="last.ckpt"):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return path


# --------------------------------------------------------------------------
# the writer, proven against the JAX package alone
# --------------------------------------------------------------------------

def test_reference_writer_round_trips_through_the_jax_converter(models):
    name, cfg, jldm, tree, _, _, sd = models
    got = jconvert.load_reference_ldm_checkpoint_from_sd(sd, jldm,
                                                         cfg["model"])
    _assert_trees_equal(got, tree)
    assert any(k.startswith("model_ema.") for k in sd)
    prefix = "cond_stage_model_2." if name == "mead" else "cond_stage_model."
    assert any(k.startswith(prefix) for k in sd)


# --------------------------------------------------------------------------
# the port's load against the JAX converter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_ema", [False, True], ids=["raw", "ema"])
def test_load_params_of_a_lightning_ckpt_equals_the_jax_converter(
        models, tmp_path, use_ema):
    """The JAX ``load_ema_or_raw`` is the oracle: the port's state_dict
    equals ``from_jax_params`` of its tree exactly, and the EMA shadows land
    on the UNet only."""
    _, cfg, jldm, tree, ema, tldm, sd = models
    path = _save(tmp_path, {"state_dict": sd, "global_step": 7})
    want = jconvert.load_ema_or_raw(path, jldm, cfg["model"], use_ema=use_ema)
    got = load_params(path, tldm, cfg["model"], use_ema=use_ema)
    _assert_sd_equal(got, from_jax_params(want))
    unet_w = got["unet.conv_in.weight"]
    src = ema if use_ema else tree["unet"]
    np.testing.assert_array_equal(
        unet_w.numpy(), np.transpose(src["conv_in"]["kernel"], (3, 2, 0, 1)))
    _assert_sd_equal({k: v for k, v in got.items()
                      if not k.startswith("unet.")},
                     {k: v for k, v in from_jax_params(tree).items()
                      if not k.startswith("unet.")})


def test_unet_forward_after_the_load_matches_jax(tmp_path):
    """One UNet forward of the loaded port model (the 2-cond MEAD model)
    against the JAX UNet on the tree (fp32, the existing parity tests'
    1e-4)."""
    _, cfg, jldm, tree, _, tldm, sd = _models("mead")
    path = _save(tmp_path, {"state_dict": sd})
    tldm.load_state_dict(load_params(path, tldm, cfg["model"], use_ema=False))
    up = cfg["model"]["params"]["unet_config"]["params"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, up["in_channels"])).astype(np.float32)
    t = np.array([3, 60], np.int32)
    ctx = rng.standard_normal((2, 1, up["context_dim"])).astype(np.float32)
    want = np.asarray(jax.jit(jldm.unet.apply)(
        {"params": tree["unet"]}, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx)))
    with torch.no_grad():
        got = tldm.unet.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                               torch.from_numpy(ctx)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_reenactment_load_weights_takes_a_lightning_ckpt(models, tmp_path):
    """The scripts' loader (``--ckpt``): EMA preferred."""
    _, cfg, jldm, _, _, tldm, sd = models
    path = _save(tmp_path, {"state_dict": sd})
    load_weights(tldm, path, cfg["model"])
    want = from_jax_params(jconvert.load_ema_or_raw(path, jldm, cfg["model"]))
    _assert_sd_equal(tldm.state_dict(), want)


# --------------------------------------------------------------------------
# single converters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["taming", "ldm", "port-trainer"])
def test_first_stage_checkpoint_layouts(models, tmp_path, layout):
    """A bare taming VQModel, an LDM checkpoint's ``first_stage_model.*``
    (the JAX ``load_first_stage_checkpoint`` is the oracle of both) and the
    port's own first-stage trainer checkpoint."""
    _, cfg, _, tree, _, tldm, sd = models
    dd = cfg["model"]["params"]["first_stage_config"]["params"]["ddconfig"]
    want = from_jax_tree(tree["first_stage"])
    if layout == "port-trainer":
        path = _save(tmp_path, {"model": want, "loss": {}, "step": 3},
                     "state.pt")
    else:
        fs = {k: v for k, v in sd.items() if k.startswith("first_stage_model.")}
        if layout == "taming":
            fs = {k[len("first_stage_model."):]: v for k, v in fs.items()}
        path = _save(tmp_path, {"state_dict": fs})
        _assert_sd_equal(
            from_jax_tree(jconvert.load_first_stage_checkpoint(path, dd)),
            want)
    got = tconvert.load_first_stage_checkpoint(path, dd)
    _assert_sd_equal(got, want)
    tldm.first_stage.load_state_dict(got)


@pytest.mark.parametrize("null_mode", ["extra_row", "separate"])
def test_class_embedder_null_modes(null_mode):
    rng = np.random.default_rng(4)
    rows = 9 if null_mode == "extra_row" else 8
    sd = {"cond_stage_model.embedding.weight":
          torch.from_numpy(rng.standard_normal((rows, 16)).astype(np.float32))}
    if null_mode == "separate":
        sd["cond_stage_model.uncond_embedding.weight"] = torch.from_numpy(
            rng.standard_normal((1, 16)).astype(np.float32))
    want = jconvert.convert_class_embedder(sd, "cond_stage_model.", null_mode)
    got = tconvert.convert_class_embedder(sd, "cond_stage_model.", null_mode)
    _assert_sd_equal(got, from_jax_tree(want))
    assert set(got) == ({"embedding.weight"} if null_mode == "extra_row"
                        else {"embedding.weight", "uncond_embedding.weight"})


def test_conv1d_temporal_attention():
    """The audio stage's pyramid (Conv1d 768 -> ... -> 1 at widths 32 here)
    and its Linear over the window."""
    from dsml_thesis_tpu_torch.models.encoders import Conv1DTemporalAttention

    rng = np.random.default_rng(5)
    chans = (32, 192, 64, 16, 4, 1)
    sd = {}
    for i in range(5):
        t = f"cond_stage_model_2.attentionConvNet.{2 * i}"
        sd[f"{t}.weight"] = rng.standard_normal((chans[i + 1], chans[i], 3))
        sd[f"{t}.bias"] = rng.standard_normal(chans[i + 1])
    sd["cond_stage_model_2.attentionNet.0.weight"] = rng.standard_normal(
        (5, 5))
    sd["cond_stage_model_2.attentionNet.0.bias"] = rng.standard_normal(5)
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    want = jconvert.convert_conv1d_temporal_attention(sd, "cond_stage_model_2.")
    got = tconvert.convert_conv1d_temporal_attention(sd, "cond_stage_model_2.")
    _assert_sd_equal(got, from_jax_tree(want))
    Conv1DTemporalAttention(seq_len=5, subspace_dim=32).load_state_dict(got)


def test_pickled_lightning_extras(models, tmp_path):
    """A Lightning ``.ckpt`` pickles non-tensor extras that
    ``weights_only=True`` refuses; the loader reads them as the reference
    does."""
    _, cfg, jldm, _, _, tldm, sd = models
    path = _save(tmp_path, {
        "state_dict": sd, "epoch": 3, "global_step": 12,
        "hyper_parameters": argparse.Namespace(base_learning_rate=1e-6),
        "callbacks": {"ModelCheckpoint": argparse.Namespace(best=0.5)}})
    with pytest.raises(Exception):
        torch.load(path, weights_only=True)
    want = from_jax_params(jconvert.load_ema_or_raw(path, jldm, cfg["model"]))
    _assert_sd_equal(load_params(path, tldm, cfg["model"]), want)


# --------------------------------------------------------------------------
# surgical_load: the cases of tests/test_utils_io.py
# --------------------------------------------------------------------------

def _surgical_case(case):
    template = {"unet": {"a": np.zeros(2), "b": np.zeros(2)},
                "cond": {"c": np.zeros(2)}}
    loaded = {"unet": {"a": np.ones(2), "b": np.ones(2)},
              "cond": {"c": np.ones(2)}, "extra": {"z": np.ones(2)}}
    kw = {}
    if case == "ignore":
        kw = {"ignore_keys": ["unet/b"]}
    elif case == "only":
        kw = {"only": ["unet"]}
    else:
        loaded = {"unet": {"a": np.ones(2)}}
    return template, loaded, kw


def _dotted(tree):
    return {k.replace("/", "."): torch.from_numpy(np.asarray(v, np.float32))
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize("case", ["ignore", "only", "missing"])
def test_surgical_load_matches_jax(case):
    template, loaded, kw = _surgical_case(case)
    want = jsurgical_load(template, loaded, **kw)
    got = surgical_load(_dotted(template), _dotted(loaded), **kw)
    _assert_sd_equal(got, _dotted(want))
    assert "extra.z" not in got


# --------------------------------------------------------------------------
# refusals and the port's own files
# --------------------------------------------------------------------------

def test_attention_block_unet_is_refused(models):
    _, cfg, _, _, _, _, sd = models
    up = cfg["model"]["params"]["unet_config"]["params"]
    with pytest.raises(NotImplementedError, match="AttentionBlock"):
        tconvert.convert_unet(sd, up["num_res_blocks"], up["channel_mult"],
                              up["attention_resolutions"],
                              prefix="model.diffusion_model.",
                              use_spatial_transformer=False)


def test_landmark_encoder_is_refused(models):
    """The port has no LandmarkEncoder: a cond stage of that kind has no
    converter."""
    _, cfg, _, _, _, tldm, sd = models

    class LandmarkEncoder(torch.nn.Module):
        pass

    spec = tldm.cond_specs[0]
    fake = type("M", (), {"cond_specs": (type(spec)(
        spec.key, LandmarkEncoder(), spec.route),)})()
    with pytest.raises(NotImplementedError, match="LandmarkEncoder"):
        tconvert.load_reference_ldm_checkpoint_from_sd(sd, fake, cfg["model"])


def test_missing_path_and_orbax_directory(models, tmp_path):
    _, cfg, _, _, _, tldm, _ = models
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "nope.ckpt"), tldm, cfg["model"])
    orbax = tmp_path / "run" / "checkpoints" / "last"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="from_jax_params"):
        load_params(str(orbax), tldm, cfg["model"])


@pytest.mark.parametrize("kind", ["trainer-ema", "trainer-raw", "bare"])
def test_port_trainer_checkpoint_and_bare_state_dict(models, tmp_path, kind):
    """A port trainer's ``state.pt`` (or its directory): ``model`` with the
    ``ema`` shadows over the trainable tensors unless ``use_ema`` is False; a
    bare state_dict as it is."""
    _, cfg, _, tree, ema, tldm, _ = models
    raw = from_jax_params(tree)
    shadows = {f"unet.{k}": v for k, v in from_jax_tree(ema).items()}
    if kind == "bare":
        path = _save(tmp_path, raw, "weights.pt")
        want = raw
    else:
        (tmp_path / "last").mkdir()
        path = _save(tmp_path, {"model": raw, "ema": shadows, "step": 5,
                                "optimizer": {}}, "last/state.pt")
        want = dict(raw, **shadows) if kind == "trainer-ema" else raw
        path = str(tmp_path / "last")
    got = load_params(path, tldm, cfg["model"], use_ema=kind != "trainer-raw")
    _assert_sd_equal(got, want)


def test_a_group_the_file_lacks_keeps_the_built_weights(models, tmp_path):
    """The group-level overlay: a UNet-only file keeps the built first stage
    and cond stages; a group with a key missing is refused."""
    _, cfg, _, tree, _, tldm, _ = models
    built = tldm.state_dict()
    unet = {k: v for k, v in from_jax_params(tree).items()
            if k.startswith("unet.")}
    got = load_params(_save(tmp_path, unet, "unet.pt"), tldm, cfg["model"])
    _assert_sd_equal(got, dict(built, **unet))
    del unet["unet.conv_in.bias"]
    with pytest.raises(KeyError, match="unet"):
        load_params(_save(tmp_path, unet, "broken.pt"), tldm, cfg["model"])


def test_sample_script_takes_a_lightning_ckpt(tmp_path):
    """``scripts/sample_affectnet_torch.py --ckpt last.ckpt`` (a reference
    Lightning file, converted, EMA preferred) samples what the same script
    samples from a bare state_dict of the JAX converter's EMA tree."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "sample_affectnet_torch",
        os.path.join(root, "scripts", "sample_affectnet_torch.py"))
    sample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sample)
    _, cfg, jldm, _, _, _, sd = _models("c3")
    config = tmp_path / "c3.yaml"
    config.write_text(yaml.safe_dump(cfg))
    ckpt = _save(tmp_path, {"state_dict": sd, "hyper_parameters":
                            argparse.Namespace(seed=1)})
    bare = _save(tmp_path, from_jax_params(
        jconvert.load_ema_or_raw(ckpt, jldm, cfg["model"])), "bare.pt")
    out = {}
    for tag, path in (("ckpt", ckpt), ("bare", bare)):
        sample.main(["--config", str(config), "--ckpt", path, "--outdir",
                     str(tmp_path / tag), "--n-samples", "1", "--steps", "2",
                     "--classes", "3", "--cpu"])
        out[tag] = np.load(tmp_path / tag / "class_3.npy")
    assert out["ckpt"].shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(out["ckpt"], out["bare"])
