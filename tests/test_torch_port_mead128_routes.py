"""``mead-128-ldm-f4.yaml`` on the routes the first mead-128 slice left out:
the streaming attention in fp32 at 32-wide heads
(``DSML_ATTN_PACKED=0 DSML_FLASH_STREAMING=1``), and its fp32 UNet under the
GroupNorm kernel flags (``DSML_PALLAS_GN=1``, ``DSML_GN_EPILOGUE=1|res``).
On the CPU:

* The plain streaming forward and backward (what the wrappers run on a CPU
  tensor, and what the fp32 D = 32 CUDA kernels are held against on the
  card) against the JAX package's streaming kernels in interpret mode, fp32,
  D = 32: mead-128's head counts (5, 10, 20), ragged N, Nk != Nq, and JAX
  blocks that stream several K / V tiles. Tolerance 1e-5 of each output's
  maximum (fp32 sums in another order).
* The GroupNorm kernel modes take the pair a served fp32 UNet gives them:
  fp32 activations beside parameters cast to bf16 for sampling, as the JAX
  whole-row kernel does (against it in interpret mode, 1e-5), through the
  ``_f32`` entry point on the card.
* The slice: the tiny model of mead-128's structure
  (``test_torch_port_mead128.py:tiny128``: fp32, attention at [4, 2, 1],
  32-wide heads) on the streaming route and under the GroupNorm kernel flags
  against the JAX package with its kernels in interpret mode (attention under
  ``DSML_FLASH_INTERPRET=1``, the conv kernel under the ``interpret``
  spellings of ``DSML_GN_EPILOGUE``, the GroupNorm kernel through
  ``group_norm_silu(..., interpret=True)``): the DDIM chain of the video
  pipeline (latents 1e-3) under each serve run's flags, and one train step
  (loss 1e-5, every gradient leaf 1e-4 of its own maximum, one AdamW step as
  ``test_torch_port_mead128.py``) under each train run's flags and under
  ``DSML_PALLAS_GN=1``.
* ``chip_smoke.py``'s launch arithmetic of the five runs on these routes:
  ``expected_launches`` / ``expected_train_launches`` from the tiny model
  built on the meta device against spies on the wrappers in one CPU UNet call
  and decode / one CPU training step, and the real YAML's counts.
"""
from __future__ import annotations

import copy
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu.ops import groupnorm as jgn
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.ops import conv_gn as tcg
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from test_torch_port_ae_gn import _card, _Library, _no_plain, _Picked
from test_torch_port_mead128 import (MEAD128_RUNS, MEAD128_TRAIN_RUNS,
                                     _meta_mead128, _meta_tiny,
                                     pipeline_latents_vs_jax, tiny128,
                                     train_step_vs_jax)
from test_torch_port_training import B, _batch, _tb
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

assert tiny128   # the fixture, imported for this module's tests

D = 32
STREAMING = {"DSML_ATTN_PACKED": "0", "DSML_FLASH_STREAMING": "1"}
# the port's flags -> the JAX package's (its interpret-mode twins)
ROUTES = {
    "streaming": (STREAMING, STREAMING),
    "gn": ({"DSML_PALLAS_GN": "1"}, {"DSML_PALLAS_GN": "1"}),
    "epilogue": ({"DSML_GN_EPILOGUE": "1"}, {"DSML_GN_EPILOGUE": "interpret"}),
    "epilogue-res": ({"DSML_GN_EPILOGUE": "res"},
                     {"DSML_GN_EPILOGUE": "res-interpret"}),
}


@pytest.fixture
def jax_gn_interpret(monkeypatch):
    """The JAX model's GroupNorm dispatch with ``interpret=True``: under
    ``DSML_PALLAS_GN=1`` it then runs the whole-row Pallas kernel on the
    CPU."""
    monkeypatch.setattr(junet, "group_norm_silu",
                        functools.partial(jgn.group_norm_silu, interpret=True))


# --------------------------------------------------------------------------
# the plain streaming pair against the JAX streaming kernels, fp32, D = 32
# --------------------------------------------------------------------------

# b, heads, Nq, Nk, and the JAX side's block_q / block_k
SHAPES = {
    "level0-5-heads": (2, 5, 64, 64, 32, 16),
    "level1-10-heads": (1, 10, 96, 96, 32, 32),
    "level2-20-heads": (1, 20, 64, 64, 64, 16),
    "ragged-nk-ne-nq": (2, 5, 70, 33, 32, 16),
    "ragged-long-kv": (1, 10, 40, 130, 16, 32),
}


def _heads(seed, b, h, nq, nk):
    """q, k, v, do [B, H, N, 32] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, D)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", list(SHAPES))
def test_streaming_forward_and_backward_match_jax_kernels(shape):
    b, h, nq, nk, bq, bk = SHAPES[shape]
    q, k, v, do = _heads(7, b, h, nq, nk)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o = jatt.flash_attention_streaming(jq, jk, jv, block_q=bq, block_k=bk,
                                       interpret=True)
    plain = tatt.streaming_attention_reference(
        *map(torch.from_numpy, (q, k, v)))
    assert plain.dtype == torch.float32
    _close(plain.numpy(), o)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(tatt.flash_attention_streaming(
        *map(torch.from_numpy, (q, k, v))), plain)
    want = jatt.flash_attention_streaming_bwd(jq, jk, jv, o, jdo, block_q=bq,
                                              block_k=bk, interpret=True)
    got = tatt.streaming_bwd_reference(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    through = torch.autograd.grad(tatt.flash_attention_streaming(*leaves),
                                  leaves, torch.from_numpy(do))
    for w, g, t in zip(want, got, through):
        _close(g.numpy(), w)
        _close(t.numpy(), w)   # the Function's CPU backward, from its own o


def test_streaming_pair_takes_fp32_at_32_on_the_card():
    """Both streaming kernels take fp32 at D = 32 through their ``_f32``
    entry points; a wrapper on a CUDA tensor of another fp32 width raises."""
    f32 = torch.float32
    assert tatt.streaming_kernel_takes(D, f32)
    assert tatt.streaming_kernel_takes(D, f32, backward=True)
    assert tatt.F32_HEAD_DIMS["flash_attention_streaming"] == (32, 512)
    assert tatt.F32_HEAD_DIMS["flash_attention_streaming_bwd"] == (32, 512)
    t = torch.zeros(1, 1, 8, D)
    for kernel in ("flash_attention_streaming",
                   "flash_attention_streaming_bwd"):
        assert tatt._entry(kernel, t, D) == f"dsml_{kernel}_f32"
        for d in (64, 80):
            with pytest.raises(ValueError, match=f"head width {d}"):
                tatt._entry(kernel, torch.zeros(1, 1, 8, d), d)
    # one split at mead-128's shapes, several when the grid is small
    assert tatt.streaming_splits(32 * 5, 1024, 1024) == 1
    assert tatt.streaming_splits(16 * 20, 64, 64) == 1
    assert tatt.streaming_splits(2, 100, 5000) == 40


def test_gn_kernel_takes_bf16_parameters_beside_fp32_activations(
        monkeypatch):
    """A served fp32 UNet (mead-128) has its parameters cast to bf16
    (``utils_io.cast_sampling_params``) while it computes in fp32: the JAX
    whole-row kernel takes that pair (it casts gamma / beta to fp32), and so
    do the port's kernel modes, through the ``_f32`` entry point on the card
    and the plain version on the CPU."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 64, 160)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.standard_normal(160)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(160)).astype(np.float32)
    g16, b16 = (torch.from_numpy(a).bfloat16() for a in (gamma, beta))
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = jgn.group_norm_silu_pallas(jnp.asarray(x), to_jax(g16),
                                      to_jax(b16), interpret=True)
    for fn in (tgn.group_norm_silu_kernel, tgn.group_norm_silu_stats_fused):
        got = fn(torch.from_numpy(x), g16, b16)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)
    _no_plain(monkeypatch)
    monkeypatch.setattr(_build, "load", _Library)
    with pytest.raises(_Picked, match="dsml_group_norm_silu_f32"):
        tgn.group_norm_silu_kernel(_card(2, 64, 160),
                                   _card(160, dtype=torch.bfloat16),
                                   _card(160, dtype=torch.bfloat16))


# --------------------------------------------------------------------------
# the slice: the tiny mead-128-structured model against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["streaming", "gn", "epilogue"])
def test_pipeline_latents_match_jax_on_the_route(tiny128, route, monkeypatch,
                                                 jax_gn_interpret):
    env, jax_env = ROUTES[route]
    pipeline_latents_vs_jax(tiny128, monkeypatch, env, jax_env)


@pytest.mark.parametrize("route", ["streaming", "epilogue-res", "gn"])
def test_train_step_matches_jax_on_the_route(tiny128, route, monkeypatch,
                                             jax_gn_interpret):
    """The JAX side's streaming forward and backward kernels, its conv
    kernel (forward; the reference backward) or its whole-row GroupNorm
    kernel (forward; the reference backward) in interpret mode."""
    env, jax_env = ROUTES[route]
    train_step_vs_jax(tiny128, monkeypatch, env, jax_env)


# --------------------------------------------------------------------------
# chip_smoke.py's launch arithmetic of the runs on these routes
# --------------------------------------------------------------------------

NEW_RUNS = {n: MEAD128_RUNS[n]
            for n in ("mead128-streaming", "mead128-gn", "mead128-epilogue")}
NEW_TRAIN_RUNS = {n: MEAD128_TRAIN_RUNS[n]
                  for n in ("train-mead128-streaming",
                            "train-mead128-epilogue")}


def _spy(monkeypatch):
    """Counts, per kernel, the wrapper calls that launch that kernel for a
    CUDA tensor (on the CPU they run the plain version); the attention
    backward kernels by the backward of the autograd Function that launches
    them; conv + statistics only where the output has the kernel's least
    width (narrower ones take the plain conv on the card too)."""
    calls = dict.fromkeys(tatt.LAUNCHES, 0)

    def count(mod, attr, kernel, launches=lambda *a, **kw: True,
              wrap=lambda f: f):
        real = getattr(mod, attr)

        def spy(*args, **kw):
            calls[kernel] += bool(launches(*args, **kw))
            return real(*args, **kw)
        monkeypatch.setattr(mod, attr, wrap(spy))

    count(tunet, "flash_attention_fproj", "flash_attention_fproj")
    count(tatt, "flash_attention_packed", "flash_attention_packed")
    count(tatt, "flash_attention", "flash_attention")
    count(tatt, "flash_attention_streaming", "flash_attention_streaming")
    count(tatt._PackedAttention, "backward", "flash_attention_bwd_packed",
          wrap=staticmethod)
    count(tatt._FlashAttention, "backward", "flash_attention_bwd",
          wrap=staticmethod)
    count(tatt, "flash_attention_streaming_bwd",
          "flash_attention_streaming_bwd")
    count(tgn, "_whole_row_forward", "group_norm_silu")
    count(tgn, "gn_channel_stats", "gn_channel_stats")
    count(tunet, "conv_stats", "conv_stats",
          lambda x, w, *a, **kw: w.shape[-1] >= tcg.CONV_MIN_COUT)
    return calls


@pytest.mark.parametrize("run", list(NEW_RUNS))
def test_smoke_serve_launches_are_one_cpu_calls_wrapper_calls(tiny128, run,
                                                              monkeypatch):
    """One guidance-pair UNet call and one first-stage decode of the tiny
    model against ``expected_launches`` from the same model built on the
    meta device."""
    _, _, _, tldm, _ = tiny128
    env = NEW_RUNS[run]
    expect = chip_smoke.expected_launches(_meta_tiny(), env, unet_calls=1,
                                          encodes=0, decodes=1)
    tldm = tldm.eval()
    gen = np.random.default_rng(5)
    r = lambda *s: torch.from_numpy(gen.standard_normal(s).astype(np.float32))
    with chip_smoke.flags(**env), torch.no_grad():
        calls = _spy(monkeypatch)
        tldm.apply_model(r(2, 8, 8, 3), torch.full((2,), 50),
                         {"crossattn": r(4, 1, 48), "concat": r(2, 8, 8, 6)},
                         cfg_pairs=True)
        tldm.decode_first_stage(r(1, 8, 8, 3), force_not_quantize=True)
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in expect.items() if v}
    kernel = {"mead128-streaming": "flash_attention_streaming",
              "mead128-gn": "group_norm_silu",
              "mead128-epilogue": "conv_stats"}[run]
    assert expect[kernel] >= 7


@pytest.mark.parametrize("run", list(NEW_TRAIN_RUNS))
def test_smoke_train_launches_are_one_cpu_steps_wrapper_calls(tiny128, run,
                                                              monkeypatch):
    """One training step of the tiny model (three frozen first-stage encodes,
    the UNet forward and backward) against ``expected_train_launches``."""
    _, _, _, tldm, _ = tiny128
    tldm = copy.deepcopy(tldm).train()
    env = NEW_TRAIN_RUNS[run]
    _, per_step = chip_smoke.expected_train_launches(_meta_tiny(), env,
                                                     steps=1, eval_batches=0)
    with chip_smoke.flags(**env):
        calls = _spy(monkeypatch)
        tldm.configure_trainable()
        loss, _ = tldm.training_loss(_tb(_batch(4)), t=torch.full((B,), 10),
                                     noise=torch.zeros(B, 8, 8, 3))
        loss.backward()
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in per_step.items() if v}
    kernel = {"train-mead128-streaming": "flash_attention_streaming_bwd",
              "train-mead128-epilogue": "conv_stats"}[run]
    assert per_step[kernel] >= 7


# the real YAML on the meta device: a served batch of a flag run (DDIM-10:
# 20 UNet calls, two encodes, two decodes; 16 self-attentions a call, the
# first stage's attention blocks 3 an encode, 4 a decode; GroupNorms 51 a
# UNet call, 20 an encode, 27 a decode; fused convs under
# DSML_GN_EPILOGUE=1 67, 23, 30) and a training step (three encodes; under
# res 34 fused convs in the UNet, 16 an encode)
FULL_SIZE = {
    "mead128-streaming": {"flash_attention_streaming": 16 * 20 + 14},
    "mead128-gn": {"flash_attention_fproj": 16 * 20, "flash_attention": 14,
                   "group_norm_silu": 51 * 20 + 40 + 54},
    "mead128-epilogue": {"flash_attention_fproj": 16 * 20,
                         "flash_attention": 14,
                         "conv_stats": 67 * 20 + 46 + 60},
    "train-mead128-streaming": {"flash_attention_streaming": 16 + 9,
                                "flash_attention_streaming_bwd": 16},
    "train-mead128-epilogue": {"flash_attention_packed": 16,
                               "flash_attention_bwd_packed": 16,
                               "flash_attention": 9, "conv_stats": 34 + 48},
}


@pytest.mark.parametrize("run", list(FULL_SIZE))
def test_smoke_counts_of_the_real_yaml(run):
    ldm = _meta_mead128()
    if run in NEW_RUNS:
        expect = chip_smoke.expected_launches(
            ldm, NEW_RUNS[run],
            unet_calls=2 * chip_smoke.SERVE_DDIM_STEPS[run], encodes=2,
            decodes=2)
    else:
        _, expect = chip_smoke.expected_train_launches(
            ldm, NEW_TRAIN_RUNS[run], steps=1, eval_batches=0)
    assert {k: v for k, v in expect.items() if v} == FULL_SIZE[run]


def test_the_kernels_line_has_the_fp32_sub_rows():
    """The ``kernels`` line's sub-rows of the streaming pair (fp32 D = 32
    and D = 512), of GroupNorm, the channel statistics and conv +
    statistics at the fp32 UNet's shapes, and of row 7 at the two
    finetunes' decodes read their launches from the runs that are their
    paths."""
    assert chip_smoke.F32_NARROW["flash_attention_streaming"] \
        == "train-mead128-streaming"
    assert chip_smoke.F32_NARROW["flash_attention_streaming_bwd"] \
        == "train-mead128-streaming"
    assert chip_smoke.F32_UNET == {"group_norm_silu": "mead128-gn",
                                   "gn_channel_stats": "mead128-stats",
                                   "conv_stats": "mead128-epilogue"}
    timed = {"ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
             "bound_by": "operations", "library_ms": 1.5, "max_abs_err": 0.0}
    runs = [r[0] for r in chip_smoke.RUNS + chip_smoke.TRAIN_RUNS
            + chip_smoke.AE_RUNS] + [chip_smoke.AFFECTNET_RUN,
                                     chip_smoke.EDIT_RUN, chip_smoke.TUNE_RUN]
    cases = {name: [dict(timed, shape=[1], dtype="bfloat16"),
                    dict(timed, shape=[2], dtype="float32", head_dim=32),
                    chip_smoke._mead128(dict(timed, shape=[3],
                                             dtype="float32")),
                    dict(timed, shape=[4], dtype="float32", head_dim=512),
                    chip_smoke._affectnet_clip(dict(
                        timed, shape=[5], dtype="float32", head_dim=512)),
                    chip_smoke._lipread_tune(dict(
                        timed, shape=[6], dtype="float32", head_dim=512))]
             for name in chip_smoke.KERNELS}
    launches = {run: dict.fromkeys(chip_smoke.KERNELS, 1) for run in runs}
    launches["train-mead128-streaming"]["flash_attention_streaming_bwd"] = 32
    rows = chip_smoke.kernels_line(cases, launches)["kernels"]
    sub = {(r["name"], r["variant"]): r for r in rows if "variant" in r}
    row = sub[("flash_attention_streaming_bwd", "float32, head width 32")]
    assert row["shape"] == [2] and row["launches"] == 32
    assert row["launches_in_run"] == "train-mead128-streaming"
    gn = sub[("group_norm_silu", "float32, mead-128-ldm-f4 UNet shapes")]
    assert gn["shape"] == [3] and gn["launches_in_run"] == "mead128-gn"
    wide = sub[("flash_attention_streaming_bwd", "float32, head width 512")]
    assert wide["shape"] == [4]
    assert wide["launches_in_run"] == "ae-vq-streaming"
    stats = sub[("gn_channel_stats", "float32, mead-128-ldm-f4 UNet shapes")]
    assert stats["shape"] == [3]
    assert stats["launches_in_run"] == "mead128-stats"
    edit = sub[("flash_attention_bwd",
                "float32, head width 512, DiffusionCLIP finetune decode")]
    assert edit["shape"] == [5] and edit["launches_in_run"] == "affectnet-edit"
    launches["train-mead128-tune"]["flash_attention_bwd"] = 8
    rows = chip_smoke.kernels_line(cases, launches)["kernels"]
    sub = {(r["name"], r["variant"]): r for r in rows if "variant" in r}
    tune = sub[("flash_attention_bwd",
                "float32, head width 512, lip-reading finetune decode")]
    assert tune["shape"] == [6] and tune["launches"] == 8
    assert tune["launches_in_run"] == "train-mead128-tune"
    assert sub[("flash_attention_bwd", "float32, head width 512")][
        "shape"] == [4]
    assert len(rows) == len(chip_smoke.KERNELS) + 16
    for r in rows:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(r)
