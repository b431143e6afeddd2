"""Rows 10 and 1 (fp32, D = 32) of the port, as redesigned for Hopper: the
channel statistics in one launch (``groupnorm.stats_plan``) and the fp32
fused-projection attention on TF32 ``wgmma`` (``attention.fproj_f32_plan``),
on the CPU.

* ``gn_channel_stats_reference`` (what the wrapper runs on a CPU tensor and
  what the kernel is held against on the card) against the JAX package's
  ``_gn_channel_stats_pallas`` in interpret mode, in fp32 and bf16, at B = 1,
  at an N that no block's row count divides and at C = 2080: 1e-5 of each
  sum's largest magnitude (fp32 sums of up to 997 terms in another order).
* ``stats_plan`` at every shape the smoke script's kernels phase times and
  every call the ``DSML_PALLAS_GN=stats`` runs make (the real YAMLs on the
  meta device): no cluster over 16 blocks, at most one wave of blocks, every
  row of a batch row in exactly one block, none empty.
* ``fproj_f32_plan`` at the kernels phase's and mead-128-ldm-f4's shapes:
  head groups that divide the heads, 32-column multiples, the shared memory
  of a block, one output pass at the model's levels; the scratch holds q, k
  and the padded v^T.
* The host path of row 1: on the card with no gradient to track the wrapper
  launches directly, with one it goes through the autograd ``Function``.
* ``chip_smoke.expected_launches`` of the new run ``mead128-stats`` against
  a spy on the wrappers in one CPU call of a tiny model of mead-128's
  structure (no JAX), and on the real YAML.
"""
from __future__ import annotations

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import groupnorm as jgn
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.models import autoencoder as tae
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from dsml_thesis_tpu_torch.training import vqgan_trainer as tvt
from test_torch_port_f32_wrappers import _OnCard
from test_torch_port_hygiene import one_torch_thread  # noqa: F401
from test_torch_port_mead128 import _tiny_cfg
from test_torch_port_mead128_routes import _spy as _wrapper_spy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


# --------------------------------------------------------------------------
# row 10: the plain version against the JAX kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 300, 160), (2, 997, 64),
                                   (2, 9, 2080)],
                         ids=["batch-1", "n-prime", "c-2080"])
def test_channel_stats_reference_matches_jax_kernel(shape, dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5)
                         .astype(np.float32)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = [np.asarray(a) for a in jgn._gn_channel_stats_pallas(
        jx, interpret=True)]
    got = [t.numpy() for t in tgn.gn_channel_stats_reference(x)]
    for g, w in zip(got, want):
        assert g.shape == (shape[0], shape[2]) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # on the CPU the wrapper is its plain version, bit for bit
    assert all(torch.equal(a, b) for a, b in zip(
        tgn.gn_channel_stats(x), tgn.gn_channel_stats_reference(x)))


# --------------------------------------------------------------------------
# row 10: the plan
# --------------------------------------------------------------------------

# the timed and checked shapes of chip_smoke.py's kernels phase
KERNEL_STATS_SHAPES = [(16, 4096, 160), (16, 1024, 640), (16, 256, 1280),
                       (8, 65536, 128), (3, 1000, 160), (2, 77, 2080),
                       (1, 4096, 160), (16, 16384, 128), (16, 4096, 256),
                       (16, 1024, 512), (16, 1024, 160)]


def _check_stats_plan(b, n, c):
    blocks = tgn.stats_plan(b, n, c)
    assert 1 <= blocks <= tgn.STATS_MAX_CLUSTER
    assert blocks & (blocks - 1) == 0 and b * blocks <= max(tgn.SMS, b)
    rows = -(-n // blocks)
    starts = [min(n, k * rows) for k in range(blocks)]
    ends = [min(n, s + rows) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e == s2 for e, s2 in zip(ends, starts[1:]))   # in order, once
    assert all(e > s for s, e in zip(starts, ends))          # none empty


@pytest.mark.parametrize("shape", KERNEL_STATS_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_stats_plan_at_the_kernels_phase_shapes(shape):
    _check_stats_plan(*shape)


@functools.lru_cache(maxsize=None)
def _meta(config, first_stage=False):
    with torch.device("meta"):
        cfg = load_config([config])["model"]
        if not first_stage:
            return build_model(cfg)
        build = tvt.build_vqgan if config == chip_smoke.CONFIG_VQ \
            else tvt.build_kl_ae
        return build(cfg)[0]


def _stats_calls(monkeypatch, run):
    """Shapes of every channel-statistics call of the run's path: a served
    guidance-pair UNet call at batch 8 and a decode of 16 latents (the LDM
    runs), or a first-stage encode and decode at batch 16 and 128 px
    (``ae-kl-stats``)."""
    shapes = []

    def stats(x3):
        shapes.append(tuple(x3.shape))
        zeros = torch.zeros(x3.shape[0], x3.shape[2], device=x3.device)
        return zeros, zeros

    monkeypatch.setattr(tgn, "gn_channel_stats", stats)
    monkeypatch.setattr(tunet.CrossAttention, "forward",
                        lambda self, x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(tae, "multi_head_attention",
                        lambda q, k, v, **kw: torch.empty_like(q))
    meta = functools.partial(torch.empty, device="meta")
    with chip_smoke.flags(DSML_PALLAS_GN="stats"), torch.no_grad():
        if run == "ae-kl-stats":
            model = _meta(chip_smoke.CONFIG_KL, first_stage=True)
            model.encoder(meta(16, 128, 128, 3))
            model.decoder(meta(16, 32, 32, model.decoder.conv_in.in_channels))
        else:
            config = {"headline-stats": chip_smoke.CONFIG,
                      "mead128-stats": chip_smoke.CONFIG_128}[run]
            ldm = _meta(config)
            lat, ch = ldm.image_size, ldm.channels
            cond = {"crossattn": meta(16, 1, ldm.unet.context_dim),
                    "concat": meta(8, lat, lat,
                                   ldm.unet.conv_in.in_channels - ch)}
            ldm.eval().apply_model(meta(8, lat, lat, ch), meta(8), cond,
                                   cfg_pairs=True)
            ldm.decode_first_stage(meta(16, lat, lat, ch),
                                   force_not_quantize=True)
    return shapes


@pytest.mark.parametrize("run", ["headline-stats", "mead128-stats",
                                 "ae-kl-stats"])
def test_stats_plan_at_every_call_of_the_stats_runs(monkeypatch, run):
    shapes = _stats_calls(monkeypatch, run)
    assert len(shapes) > 20
    for shape in set(shapes):
        _check_stats_plan(*shape)


# --------------------------------------------------------------------------
# row 1 at fp32 D = 32: the plan and the scratch
# --------------------------------------------------------------------------

# (B, N, C, heads): the kernels phase's fp32 cases (mead-128-ldm-f4 served:
# 8 clips x the guidance pair; one clip's frame; ragged)
FPROJ_F32_SHAPES = [(16, 1024, 160, 5), (16, 256, 320, 10), (16, 64, 640, 20),
                    (1, 1024, 160, 5), (3, 200, 160, 5), (2, 100, 640, 20),
                    (2, 70, 96, 3)]


def _mead128_self_attentions():
    """(N, C, heads) of every self-attention of mead-128-ldm-f4's UNet."""
    ldm = _meta(chip_smoke.CONFIG_128)
    ds = {ldm.unet.model_channels * m: 2 ** i
          for i, m in enumerate(ldm.unet.channel_mult)}
    return sorted({((ldm.image_size // ds[m.proj_in.in_channels]) ** 2,
                    m.proj_in.in_channels, m.block_0.attn1.heads)
                   for m in ldm.unet.modules()
                   if isinstance(m, tunet.SpatialTransformer)})


def test_mead128_levels_are_the_planned_shapes():
    assert _mead128_self_attentions() == [(64, 640, 20), (256, 320, 10),
                                          (1024, 160, 5)]


@pytest.mark.parametrize("shape", FPROJ_F32_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fproj_f32_plan(shape):
    """A grouping that divides the heads into blocks of whole passes within
    the shared memory and the cluster limit; two warpgroups only past one
    64-row tile; one pass and a full grid (or the fullest) at the model's
    levels."""
    b, n, c, heads = shape
    wgs, groups, cols = tatt.fproj_f32_plan(b, n, c, heads)
    assert wgs in ((1, 2) if n > tatt.F32_FPROJ_ONE_WG_ROWS else (1,))
    assert 1 <= groups <= tatt.F32_FPROJ_MAX_GROUPS and heads % groups == 0
    cg = c // groups
    assert cg % 32 == 0 and cols % 32 == 0 and cg % cols == 0
    assert cols <= tatt.F32_FPROJ_MAX_COLS
    assert tatt.fproj_f32_smem(wgs, heads // groups, cols) <= \
        tatt.SHARED_MEMORY_PER_BLOCK
    blocks = b * -(-n // (64 * wgs)) * groups
    if (n, c, heads) in _mead128_self_attentions():
        assert cg == cols
        one_pass = [(w, g) for w in (1, 2) for g in range(1, 17)
                    if heads % g == 0 and c // g <= 160 and c % (32 * g) == 0
                    and (w == 1 or n > 64)]
        most = max(b * -(-n // (64 * w)) * g for w, g in one_pass)
        assert blocks >= min(tatt.F32_FPROJ_FILL, most)


@pytest.mark.parametrize("shape", FPROJ_F32_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fproj_f32_projection_tiles(shape):
    """The projection launch's column tile divides H*D (so a tile is q, k or
    v alone) and is the widest whose grid fills the card, else 32."""
    b, n, c, heads = shape
    hd = 32 * heads
    cols = tatt.fproj_f32_qkv_cols(b, n, hd)
    assert cols % 32 == 0 and hd % cols == 0 and cols <= 160
    tiles = b * -(-n // (64 if n <= 64 else 128))
    wider = [w for w in range(cols + 32, 161, 32) if hd % w == 0]
    assert all(tiles * 3 * hd // w < tatt.F32_FPROJ_QKV_FILL for w in wider)
    assert cols == 32 or tiles * 3 * hd // cols >= tatt.F32_FPROJ_QKV_FILL


def test_fproj_scratch_holds_q_k_padded_vt_and_rounded_wo():
    # fp32: q and k [B, N, H*D], v^T [B, H, 32, N rounded up to 64], Wo
    assert tatt.fproj_scratch_shape(3, 200, 160, 160, torch.float32) == (
        3 * 160 * (2 * 200 + 256) + 160 * 160,)
    assert tatt.fproj_scratch_shape(16, 64, 640, 640, torch.float32) == (
        16 * 640 * (2 * 64 + 64) + 640 * 640,)
    assert tatt.fproj_scratch_shape(2, 100, 128, 64, torch.bfloat16) == (
        2, 100, 192)


# --------------------------------------------------------------------------
# row 1: the host path
# --------------------------------------------------------------------------

def test_fproj_without_gradient_skips_the_function(monkeypatch):
    """On the card and with nothing to differentiate, the fused-projection
    op launches its kernels directly; with a gradient to track it goes
    through ``_KernelForward``; the CPU runs the plain version."""
    launched, used = [], []
    monkeypatch.setattr(tatt, "_fproj_launch",
                        lambda h, *a: launched.append(a[-1]) or h)
    monkeypatch.setattr(tatt._KernelForward, "apply",
                        lambda *a: used.append(a) or a[4])
    card = lambda *s: torch.zeros(*s).as_subclass(_OnCard)
    h, w, wo, bo = card(2, 64, 160), card(160, 160), card(160, 160), card(160)
    args = (h, w, w, w, wo, bo, 5)
    assert tatt.flash_attention_fproj(*args) is h
    assert len(launched) == 1 and not used
    assert launched[0] == pytest.approx(32 ** -0.5)
    with torch.no_grad():
        tatt.flash_attention_fproj(h, w.requires_grad_(), w, w, wo, bo, 5)
    assert len(launched) == 2 and not used
    tatt.flash_attention_fproj(*args)     # w now requires a gradient
    assert len(used) == 1 and len(launched) == 2
    cpu = torch.zeros(1, 8, 64)
    wc = torch.zeros(64, 64)
    out = tatt.flash_attention_fproj(cpu, wc, wc, wc, wc, torch.zeros(64), 2)
    assert out.shape == cpu.shape and len(used) == 1 and len(launched) == 2


# --------------------------------------------------------------------------
# chip_smoke.py's launch arithmetic of mead128-stats
# --------------------------------------------------------------------------

def test_the_smoke_script_serves_mead128_under_stats():
    runs = {name: (config, env) for name, config, env, _ in chip_smoke.RUNS}
    assert runs["mead128-stats"] == (chip_smoke.CONFIG_128,
                                     {"DSML_PALLAS_GN": "stats"})


def test_smoke_mead128_stats_launches_are_one_cpu_calls_wrapper_calls(
        monkeypatch):
    """One guidance-pair UNet call and one first-stage decode of a tiny fp32
    model of mead-128's structure (random weights) against
    ``expected_launches`` from the same model on the meta device."""
    cfg = _tiny_cfg()
    torch.manual_seed(0)
    tldm = build_model(cfg["model"]).eval()
    with torch.device("meta"):
        meta = build_model(cfg["model"])
    env = {"DSML_PALLAS_GN": "stats"}
    expect = chip_smoke.expected_launches(meta, env, unet_calls=1, encodes=0,
                                          decodes=1)
    gen = np.random.default_rng(5)
    r = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    with chip_smoke.flags(**env), torch.no_grad():
        calls = _wrapper_spy(monkeypatch)
        tldm.apply_model(r(2, 8, 8, 3), torch.full((2,), 50),
                         {"crossattn": r(4, 1, 48), "concat": r(2, 8, 8, 6)},
                         cfg_pairs=True)
        tldm.decode_first_stage(r(1, 8, 8, 3), force_not_quantize=True)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    assert expect["gn_channel_stats"] >= 20
    assert expect["flash_attention_fproj"] >= 7


def test_smoke_mead128_stats_counts_of_the_real_yaml():
    """A served batch of the real YAML (2 frames of ``mead128-stats``'s DDIM
    chain, two encodes, two decodes): GroupNorms 51 a UNet call, 20 an
    encode, 27 a decode."""
    ldm = _meta(chip_smoke.CONFIG_128)
    calls = 2 * chip_smoke.SERVE_DDIM_STEPS["mead128-stats"]
    expect = chip_smoke.expected_launches(
        ldm, {"DSML_PALLAS_GN": "stats"}, unet_calls=calls, encodes=2,
        decodes=2)
    assert {k: v for k, v in expect.items() if v} == {
        "flash_attention_fproj": 16 * calls, "flash_attention": 14,
        "gn_channel_stats": 51 * calls + 40 + 54}
