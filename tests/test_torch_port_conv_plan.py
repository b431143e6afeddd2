"""The plans of the conv + statistics kernel (row 11: ``conv_gn.conv_plan``)
and of the whole-row GroupNorm kernel (row 9: ``groupnorm.gn_plan``) at
every call the shipped configs make, on the CPU, without JAX.

The four LDM YAMLs (one guidance-pair UNet call at batch 8, one training
call at the YAML's batch, one first-stage decode of 16 latents) and the two
first-stage YAMLs (an encode and a decode at batch 16, 128 px) are built on
the meta device and run with spies in place of the two wrappers (and of the
attention ops, which take no meta tensor) under ``DSML_GN_EPILOGUE=1`` and
``res`` and ``DSML_PALLAS_GN=1``. Each call's plan is held to:

* the shared memory a block may use on an H100 (232,448 bytes);
* split ranges that cover K exactly, one after the other, none empty, and
  whole chunks of nine k-tiles in the strip design;
* the design the A/B on the card chose (``PERF.md``): a strip design
  for a 3 x 3 conv with the input norm on image rows of at most 32 pixels
  (two blocks an SM at a served batch's 8 x 8 level and where the tiles
  fill two blocks on every SM), pixel patches for the stems and the first
  stage's wide normed 3 x 3 convs, the implicit GEMM for the rest; the
  cluster for GroupNorm rows of up to 192 Ki elements, the three passes
  past them.

And the layout the implicit GEMM reads: the plain conv on the weight as the
wrapper hands it over ([Cout, K, K, Cin]) equals ``conv_stats_reference``,
and a ``Conv2d`` weight hands it over without a copy.
"""
from __future__ import annotations

import functools
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.models import autoencoder as tae
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import conv_gn as tcg
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from dsml_thesis_tpu_torch.training import vqgan_trainer as tvt
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

LDM = {"mead-256": (chip_smoke.CONFIG, 8),
       "mead-256-fullattn": (chip_smoke.CONFIG_FULLATTN, 8),
       "mead-256-fullattn-dh64": (chip_smoke.CONFIG_DH64, 8),
       "mead-128": (chip_smoke.CONFIG_128, 32)}
AE = {"vqgan-f4": chip_smoke.CONFIG_VQ, "kl-f4": chip_smoke.CONFIG_KL}
FLAGS = {"epilogue": {"DSML_GN_EPILOGUE": "1"},
         "epilogue-res": {"DSML_GN_EPILOGUE": "res"},
         "gn": {"DSML_PALLAS_GN": "1"}}
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _ldm(config):
    with torch.device("meta"):
        return build_model(load_config([config])["model"])


@functools.lru_cache(maxsize=None)
def _ae(config):
    build = tvt.build_vqgan if config == chip_smoke.CONFIG_VQ \
        else tvt.build_kl_ae
    with torch.device("meta"):
        return build(load_config([config])["model"])[0]


def _spies(monkeypatch):
    """(conv calls, GroupNorm calls) as the wrappers see them."""
    convs, norms = [], []

    def conv(x, w, bias, skip=None, in_stats=None, gamma=None, beta=None,
             num_groups=32, **kw):
        b, hh, ww, cin = x.shape
        convs.append((b, hh, ww, cin, w.shape[-1], w.shape[0], x.dtype,
                      in_stats is not None, num_groups))
        cout = w.shape[-1]
        return (torch.empty((b, hh, ww, cout), dtype=x.dtype, device=x.device),
                torch.empty((b, cout), device=x.device),
                torch.empty((b, cout), device=x.device))

    def norm(x, gamma, beta, num_groups=32, **kw):
        norms.append((x.shape[0], x[0].numel() // x.shape[-1], x.shape[-1],
                      x.dtype, num_groups))
        return torch.empty_like(x)

    monkeypatch.setattr(tunet, "conv_stats", conv)
    monkeypatch.setattr(tgn, "group_norm_silu_kernel", norm)
    monkeypatch.setattr(tunet.CrossAttention, "forward",
                        lambda self, x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(tae, "multi_head_attention",
                        lambda q, k, v, **kw: torch.empty_like(q))
    return convs, norms


def _ldm_calls(name, env, monkeypatch):
    config, train_batch = LDM[name]
    ldm = _ldm(config)
    convs, norms = _spies(monkeypatch)
    lat, ch = ldm.image_size, ldm.channels
    meta = functools.partial(torch.empty, device="meta")
    cond = lambda b, pairs: {
        "crossattn": meta((2 if pairs else 1) * b, 1, ldm.unet.context_dim),
        "concat": meta(b, lat, lat, ldm.unet.conv_in.in_channels - ch)}
    with chip_smoke.flags(**env), torch.no_grad():
        ldm.eval().apply_model(meta(8, lat, lat, ch), meta(8), cond(8, True),
                               cfg_pairs=True)
        ldm.train().apply_model(meta(train_batch, lat, lat, ch),
                                meta(train_batch), cond(train_batch, False))
        ldm.eval().decode_first_stage(meta(16, lat, lat, ch),
                                      force_not_quantize=True)
    return convs, norms


def _ae_calls(name, env, monkeypatch):
    model = _ae(AE[name])
    convs, norms = _spies(monkeypatch)
    meta = functools.partial(torch.empty, device="meta")
    with chip_smoke.flags(**env), torch.no_grad():
        model.encoder(meta(16, 128, 128, 3))
        model.decoder(meta(16, 32, 32, model.decoder.conv_in.in_channels))
    return convs, norms


def _expected_design(b, hh, ww, cin, cout, k, dtype, norm):
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if cin % vec:
        return 0
    if k == 3 and norm:
        n_tiles = -(-cout // next(n for n in (160, 128, 64)
                                  if cout % n == 0 or n == 64))
        tiles = -(-b * hh * ww // 128) * n_tiles
        two = (ww <= 8 and tiles <= 32) or tiles >= 2 * 132
        if ww <= 32 and ww * n_tiles <= 64:
            return 3 if two else 2
        return 3 if ww <= 32 and two else 0
    return 1


def _check_conv_plans(convs):
    assert convs, "no call reached the conv + statistics kernel"
    designs = set()
    for b, hh, ww, cin, cout, k, dtype, norm, groups in set(convs):
        if cout < tcg.CONV_MIN_COUT:    # the plain conv, no plan
            continue
        plan = tcg.conv_plan(b, hh, ww, cin, cout, k, dtype, norm, groups)
        shape = (b, hh, ww, cin, cout, k, dtype, norm)
        assert plan.smem <= SMEM_LIMIT, shape
        assert plan.design == _expected_design(*shape), shape
        designs.add(plan.design)
        if plan.design == 0:
            assert plan.splits == 1
            continue
        chunks = -(-cin // tcg.ig_k_chunk(dtype))
        ranges = plan.k_ranges(k, cin, tcg.ig_k_chunk(dtype))
        assert len(ranges) == plan.splits in (1, 2, 4, 8), shape
        assert ranges[0][0] == 0 and ranges[-1][1] == k * k * chunks, shape
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:])), shape
        assert all(lo < hi for lo, hi in ranges), shape
        if plan.design >= 2:
            assert all(lo % 9 == 0 and hi % 9 == 0 for lo, hi in ranges)
        tiles = -(-b * hh * ww // tcg.IG_BM) * -(-cout // plan.block_n)
        per_sm = 1 if plan.design == 2 else 2
        assert tiles * plan.splits <= per_sm * tcg.NUM_SMS or plan.splits == 1
        if plan.design == 3:
            assert plan.smem <= tcg.SMEM_TWO_BLOCKS, shape
        assert plan.partial == (
            -(-b * hh * ww // tcg.IG_BM) * plan.splits,
            tcg.ig_images(tcg.IG_BM // plan.splits, hh * ww, b), 2, cout)
    return designs


def _check_gn_plans(norms):
    assert norms, "no call reached the GroupNorm kernel"
    for b, n, c, dtype, groups in set(norms):
        cluster = tgn.gn_plan(n, c, dtype, groups)
        fits = tgn.gn_cluster_smem(-(-n // 8), c, dtype, groups) <= SMEM_LIMIT
        assert cluster == (8 if fits and n * c <= 196608 else 0), (n, c)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("config", list(LDM))
def test_ldm_calls_plan_within_the_card(config, flag, monkeypatch):
    convs, norms = _ldm_calls(config, FLAGS[flag], monkeypatch)
    if flag == "gn":
        _check_gn_plans(norms)
        assert not convs
        return
    designs = _check_conv_plans(convs)
    if config == "mead-128":
        # fp32: every normed 3 x 3 conv of the UNet (its widths are
        # multiples of 160, the first stage's of 128) takes a strip design
        unet_normed = {c for c in convs if c[5] == 3 and c[7]
                       and c[4] % 160 == 0}
        assert unet_normed and all(
            tcg.conv_plan(*c[:7], c[7]).design in (2, 3) for c in unet_normed)
    assert 1 in designs or flag == "epilogue-res"


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("config", list(AE))
def test_first_stage_calls_plan_within_the_card(config, flag, monkeypatch):
    convs, norms = _ae_calls(config, FLAGS[flag], monkeypatch)
    if flag == "gn":
        _check_gn_plans(norms)
        return
    _check_conv_plans(convs)


def test_mead128_gn_rows_take_the_cluster_where_it_won():
    f32 = torch.float32
    assert tgn.gn_plan(1024, 160, f32) == 8 and tgn.gn_plan(64, 1280, f32) == 8
    assert tgn.gn_plan(256, 960, f32) == 0           # three passes won there
    assert tgn.gn_plan(4096, 160, torch.bfloat16) == 0   # headline rows
    assert tgn.gn_plan(chip_smoke.gn_cluster_rows(160, f32) + 1, 160, f32) == 0


@pytest.mark.parametrize("ksize", [1, 3])
def test_plain_conv_on_the_gemm_layout_is_the_reference(ksize):
    """The weight as the wrapper hands it to the implicit GEMM, [Cout, K, K,
    Cin] (``w.permute(3, 0, 1, 2)``), read back as an OIHW conv weight gives
    the reference's conv, bit for bit, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 7, 24, generator=gen)
    w = torch.randn(ksize, ksize, 24, 40, generator=gen)
    bias = torch.randn(2, 40, generator=gen)
    wk = w.permute(3, 0, 1, 2).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), wk.permute(0, 3, 1, 2),
                 padding=(ksize - 1) // 2).permute(0, 2, 3, 1)
    y = y + bias[:, None, None, :]
    ref = tcg.conv_stats_reference(x, w, bias)[0]
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_conv2d_weight_reaches_the_gemm_uncopied():
    """``fused_conv`` passes ``weight.permute(2, 3, 1, 0)``; the wrapper's
    [Cout, K, K, Cin] view of it is contiguous for a ``Conv2d`` weight, so
    the implicit GEMM reads the parameter itself."""
    conv = tunet.Conv2d(32, 48, 3, padding=1)
    w = conv.weight.permute(2, 3, 1, 0)
    assert w.permute(3, 0, 1, 2).is_contiguous()
    assert w.permute(3, 0, 1, 2).data_ptr() == conv.weight.data_ptr()
