"""The `-fullattn` slice against the JAX package on the CPU: the attention
module's routing under each flag set, a UNet with attention at every level
(`attention_resolutions: [4, 2, 1]`), the whole pipeline on a tiny
`-fullattn` config, and the real YAML built without its weights.

Weights are a JAX tree filled from a numpy seed and carried over by
``from_jax_tree`` / ``from_jax_params``. fp32 on the CPU: one attention
module 1e-5, the UNet 1e-4, pipeline latents 1e-3 (the tolerances of the
first slice's tests, for the same reasons: equal sums in another order,
compounded through the layers and the DDIM chain).

The real sizes route N = 4096 to the packed kernel because it exceeds
``FPROJ_MAX_TOKENS``; the tiny sizes here do the same with that constant
lowered, so that the level-0 attention takes the long-sequence route while
the deeper levels keep the fused op.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.diffusion import (make_ddim_schedule as jax_ddim_schedule,
                                       make_video_pipeline as jax_pipeline)
from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.convert import from_jax_params, from_jax_tree
from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                             make_video_pipeline)
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_ldm import TINY_MEAD_CFG
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULLATTN_YAML = os.path.join(ROOT, "configs", "latent-diffusion",
                             "mead-256-ldm-f4-fullattn.yaml")
ROUTES = ("flash_attention_fproj", "fused_qout_self_attention",
          "packed_multi_head_attention", "multi_head_attention")


@pytest.fixture
def routes(monkeypatch):
    """Names of the attention ops the UNet module called, in order."""
    called = []
    for name in ROUTES:
        real = getattr(tunet, name)
        monkeypatch.setattr(
            tunet, name, lambda *a, _n=name, _f=real, **k: (called.append(_n),
                                                            _f(*a, **k))[1])
    return called


# flag set -> (environment, tokens one q-block covers, train mode, route)
FLAG_SETS = {
    "default": ({}, 1024, False, "flash_attention_fproj"),
    "long-sequence": ({}, 16, False, "packed_multi_head_attention"),
    "long-sequence-partial": ({"DSML_ATTN_FPROJ_PARTIAL": "1"}, 16, False,
                              "fused_qout_self_attention"),
    "fused-proj-off": ({"DSML_ATTN_FUSED_PROJ": "0"}, 1024, False,
                       "packed_multi_head_attention"),
    "fused-proj-off-partial": ({"DSML_ATTN_FUSED_PROJ": "0",
                                "DSML_ATTN_FPROJ_PARTIAL": "1"}, 1024, False,
                               "fused_qout_self_attention"),
    "packed-off": ({"DSML_ATTN_PACKED": "0", "DSML_ATTN_FPROJ_PARTIAL": "1"},
                   1024, False, "multi_head_attention"),
    "train-mode": ({"DSML_ATTN_FPROJ_PARTIAL": "1"}, 1024, True,
                   "packed_multi_head_attention"),
}


@pytest.fixture(scope="module")
def attention_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64, 64)).astype(np.float32)
    jm = junet.CrossAttention(heads=2, dim_head=32)
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = tunet.CrossAttention(64, None, 2, 32)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_self_attention_routes_match_jax(attention_pair, routes, monkeypatch,
                                         name):
    """Every route of the module computes the JAX module's self-attention;
    the JAX side runs under the same flags, its Pallas kernels in interpret
    mode."""
    env, max_tokens, train, route = FLAG_SETS[name]
    jm, params, tm, x = attention_pair
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    monkeypatch.setattr(tatt, "FPROJ_MAX_TOKENS", max_tokens)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.train(train)
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
    finally:
        tm.eval()
    assert routes == [route]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tokens,route", [(1, None),
                                          (3, "packed_multi_head_attention")],
                         ids=["one-token", "three-tokens"])
def test_cross_attention_routes_match_jax(routes, tokens, route):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, tokens, 48)).astype(np.float32)
    jm = junet.CrossAttention(heads=2, dim_head=32)
    params = random_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(ctx))["params"], rng)
    tm = tunet.CrossAttention(64, 48, 2, 32).eval()
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    assert routes == ([route] if route else [])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# a UNet with attention at every level
# --------------------------------------------------------------------------

UNET_KW = dict(in_channels=9, model_channels=32, out_channels=3,
               num_res_blocks=1, attention_resolutions=(4, 2, 1),
               channel_mult=(1, 2, 4), num_head_channels=16,
               use_spatial_transformer=True, transformer_depth=1,
               context_dim=48)


@pytest.fixture(scope="module")
def unets():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    t = np.array([3, 77], np.int32)
    pair = rng.standard_normal((4, 1, 48)).astype(np.float32)
    jm = junet.UNetModel(**UNET_KW)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(pair[:2]))["params"]
    params = random_params(params, rng)
    tm = tunet.UNetModel(**UNET_KW)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(pair),
                               cfg_pairs=True))
    return tm.eval(), (x, t, pair), want


@pytest.mark.parametrize("env,long_route", [
    ({}, "packed_multi_head_attention"),
    ({"DSML_ATTN_FPROJ_PARTIAL": "1"}, "fused_qout_self_attention"),
    ({"DSML_ATTN_FPROJ_PARTIAL": "1", "DSML_PALLAS_GN": "1"},
     "fused_qout_self_attention"),
    ({"DSML_PALLAS_GN": "stats"}, "packed_multi_head_attention")],
    ids=["no-flag", "partial", "partial-gn1", "gn-stats"])
def test_fullattn_unet_matches_jax(unets, routes, monkeypatch, env, long_route):
    """8 x 8 latents, levels of 64, 16 and 4 tokens, a guidance pair. With
    one q-block covering 16 tokens the 3 level-0 self-attentions (1 down, 2
    up) take the long-sequence route, the other 7 the fused op."""
    tm, (x, t, pair), want = unets
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tatt, "FPROJ_MAX_TOKENS", 16)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 torch.from_numpy(pair), cfg_pairs=True).numpy()
    assert got.shape == want.shape == (4, 8, 8, 3)
    assert np.abs(want).max() > 0.1
    assert routes.count(long_route) == 3
    assert routes.count("flash_attention_fproj") == 7
    assert len(routes) == 10
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# the whole pipeline on a tiny -fullattn config
# --------------------------------------------------------------------------

B, F, STEPS, WINDOW = 2, 2, 3, 2


@pytest.fixture(scope="module")
def pipelines():
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    unet_params = cfg["model"]["params"]["unet_config"]["params"]
    unet_params["attention_resolutions"] = [2, 1]   # every level of [1, 2]
    jldm = jax_build_model(cfg["model"])
    batch = {
        "image": jnp.zeros((2, 16, 16, 3)),
        "masked_image": jnp.zeros((2, 16, 16, 3)),
        "identity": jnp.zeros((2, 16, 16, 3)),
        "class_label": jnp.array([1, 5]),
        "audio": jnp.zeros((2, 5, 32)),
    }
    rng = np.random.default_rng(3)
    params = random_params(
        jax.jit(jldm.init_params)(jax.random.PRNGKey(0), batch), rng)
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    inputs = {
        "masked_frames": rng.uniform(-1, 1, (B, F, 16, 16, 3)),
        "audio": rng.standard_normal((B, F + WINDOW, 32)),
        "identity": rng.uniform(-1, 1, (B, 16, 16, 3)),
        "x_T": rng.standard_normal((B, F, 8, 8, 3)),
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs["class_label"] = np.array([1, 5], np.int32)
    return jldm, params, tldm.eval(), inputs


@pytest.mark.parametrize("env", [
    {}, {"DSML_ATTN_FPROJ_PARTIAL": "1", "DSML_PALLAS_GN": "1"},
    {"DSML_PALLAS_GN": "stats"}], ids=["no-flag", "partial-gn1", "gn-stats"])
def test_fullattn_pipeline_latents_match_jax(pipelines, routes, monkeypatch,
                                             env):
    """Latents of 2 frames of a short DDIM chain with guidance 2.0. The JAX side
    runs the production dispatch with its Pallas kernels in interpret mode
    and under the same flags; in the port the 64-token level takes the
    long-sequence route (one q-block set to cover 16 tokens)."""
    jldm, params, tldm, inputs = pipelines
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    monkeypatch.setattr(tatt, "FPROJ_MAX_TOKENS", 16)
    ddim_j = jax_ddim_schedule(jldm.schedule, STEPS, eta=0.0)
    pipe_j = jax_pipeline(jldm, ddim_j, WINDOW, guidance_scale=2.0,
                          decode=False)
    want = np.array(jax.jit(pipe_j)(
        params, jnp.asarray(inputs["masked_frames"]),
        jnp.asarray(inputs["audio"]), jnp.asarray(inputs["identity"]),
        jnp.asarray(inputs["class_label"]), jax.random.PRNGKey(0),
        jnp.asarray(inputs["x_T"])))
    ddim_t = make_ddim_schedule(tldm.schedule, STEPS, eta=0.0)
    pipe_t = make_video_pipeline(tldm, ddim_t, WINDOW, guidance_scale=2.0,
                                 decode=False)
    t = lambda k: torch.from_numpy(inputs[k])
    got = pipe_t(t("masked_frames"), t("audio"), t("identity"),
                 t("class_label").long(), None, x_T=t("x_T")).numpy()
    assert got.shape == want.shape == (B, F, 8, 8, 3)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    long_route = ("fused_qout_self_attention"
                  if "DSML_ATTN_FPROJ_PARTIAL" in env
                  else "packed_multi_head_attention")
    # a UNet call: 3 level-0 self-attentions (64 tokens), 4 deeper ones
    calls = F * ddim_t.num_steps
    assert routes.count(long_route) == 3 * calls
    assert routes.count("flash_attention_fproj") == 4 * calls
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# --------------------------------------------------------------------------
# the real YAML, without its weights
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_fullattn():
    cfg = load_config([FULLATTN_YAML])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    return cfg, ldm


def test_build_model_loads_the_fullattn_yaml(real_fullattn):
    """Level-0 SpatialTransformers appear (2 down, 3 up), 160 wide with 5
    heads of 32; every parameter is on the meta device, so nothing of the
    full width is computed here."""
    _, ldm = real_fullattn
    unet = ldm.unet
    assert unet.attention_resolutions == (4, 2, 1)
    level0 = [n for n, m in unet.named_children()
              if isinstance(m, tunet.SpatialTransformer)
              and m.proj_in.in_channels == 160]
    assert sorted(level0) == ["down_0_0_attn", "down_0_1_attn", "up_0_0_attn",
                              "up_0_1_attn", "up_0_2_attn"]
    attn = unet.down_0_0_attn.block_0.attn1
    assert (attn.heads, attn.dim_head) == (5, 32)
    assert all(p.device.type == "meta" for p in ldm.parameters())


def test_fullattn_state_dict_keys_are_the_jax_tree_paths(real_fullattn):
    """``from_jax_params`` carries the level-0 transformers with no mapping
    code: the port's state_dict keys are the JAX parameter tree's paths. The
    JAX tree comes from ``jax.eval_shape``, so no weight is made."""
    cfg, ldm = real_fullattn
    kw = dict(cfg["model"]["params"]["unet_config"]["params"])
    kw.pop("image_size", None)
    kw["dtype"] = jnp.bfloat16
    jm = junet.UNetModel(**kw)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 9)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 1, 1024)))["params"])
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    carried = from_jax_tree(tree)
    own = {k: tuple(v.shape) for k, v in ldm.unet.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in carried.items()} == own
    assert any(k.startswith("down_0_0_attn.block_0.attn1.to_q") for k in own)


def test_smoke_script_counts_the_real_models_blocks(real_fullattn):
    """The launch arithmetic of ``chip_smoke.py`` on the real `-fullattn`
    model: 11 self-attentions the fused op takes and 5 at N = 4096 a UNet
    call, 51 GroupNorms a call, over a ``fullattn-flags`` batch (2 frames
    of its DDIM chain)."""
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke

    _, ldm = real_fullattn
    assert chip_smoke.count_attentions(ldm.unet, ldm.image_size) == (11, 5)
    assert chip_smoke.count_norms(ldm.unet) == 51
    calls = 2 * chip_smoke.SERVE_DDIM_STEPS["fullattn-flags"]
    expect = chip_smoke.expected_launches(
        ldm, {"DSML_ATTN_FPROJ_PARTIAL": "1", "DSML_PALLAS_GN": "1"},
        unet_calls=calls, encodes=2, decodes=2)
    assert expect["flash_attention_qout"] == 5 * calls
    assert expect["flash_attention_packed"] == 0
    assert expect["flash_attention_fproj"] == 11 * calls
    assert expect["flash_attention"] == 14
    assert expect["group_norm_silu"] == 51 * calls + 40 + 54
    assert expect["gn_channel_stats"] == 0
