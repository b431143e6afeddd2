"""First-stage training under the GroupNorm kernel flags, against the JAX
package on the CPU: one fused VQGAN step and one KL-autoencoder step under
each of ``DSML_PALLAS_GN=1``, ``DSML_PALLAS_GN=stats``,
``DSML_GN_EPILOGUE=1`` and ``DSML_GN_EPILOGUE=res``; the launch counts
``chip_smoke.py`` takes from a model's blocks against the kernel-wrapper
calls of one CPU step; the wrappers' types (fp32 activations pick the
``_f32`` entry points, a mixed call raises) for tensors that say they lie on
the card.

The JAX side runs its kernels in interpret mode, as its own tests run them:
the GroupNorm kernels through ``group_norm_silu(..., interpret=True)`` (in
place of the model's call, which takes the kernels on a TPU only), the conv
kernel under ``DSML_GN_EPILOGUE=interpret`` / ``res-interpret``. The port's
side runs the wrappers' plain versions, which is what a CPU tensor gets.

The tiny config and the tolerances are ``test_torch_port_ae_training.py``'s:
ch 64 (two channels a GroupNorm group), ``ch_mult [1, 2]``, attention at
8 x 8, 16 px, batch 2, ``disc_start: 0``. Losses 1e-5 relative (fp32 sums in
another order); parameters after one Adam step of lr 1e-3 within 1e-2 of lr,
or, for an element whose gradient cancels to near zero (Adam's first step,
lr * g / (|g| + eps), then amplifies the gradient's rounding), held to that
gradient; within 2 lr everywhere (``_same_tree`` states the rule).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu.ops import groupnorm as jgn
from dsml_thesis_tpu.training import kl_ae as jkl
from dsml_thesis_tpu.training import vqgan as jvqgan
from dsml_thesis_tpu.training import vqgan_trainer as jtrainer
from dsml_thesis_tpu_torch.config import load_config
from dsml_thesis_tpu_torch.convert import from_jax_tree, to_jax_tree
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import _build
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.ops import conv_gn as tcg
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from dsml_thesis_tpu_torch.training import vqgan_trainer as ttrainer
from dsml_thesis_tpu_torch.training.kl_ae import make_kl_ae_train_step
from dsml_thesis_tpu_torch.training.vqgan import (create_first_stage_state,
                                                  make_vqgan_train_step)
from test_torch_port_ae_training import (LR, _config, _flat, _images,
                                         _metrics_close, _same_tree)
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

FLAGS = {
    "gn": {"DSML_PALLAS_GN": "1"},
    "gn-stats": {"DSML_PALLAS_GN": "stats"},
    "epilogue": {"DSML_GN_EPILOGUE": "1"},
    "epilogue-res": {"DSML_GN_EPILOGUE": "res"},
}
# the port's epilogue flag value -> the JAX package's interpret-mode twin
JAX_EPILOGUE = {"1": "interpret", "res": "res-interpret"}


def _set_flags(monkeypatch, side, env):
    for k in ("DSML_PALLAS_GN", "DSML_GN_EPILOGUE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        if k == "DSML_GN_EPILOGUE" and side == "jax":
            v = JAX_EPILOGUE[v]
        monkeypatch.setenv(k, v)


@pytest.fixture
def jax_gn_interpret(monkeypatch):
    """The JAX model's GroupNorm dispatch with ``interpret=True``: under
    ``DSML_PALLAS_GN`` it then runs the flag's Pallas kernel on the CPU."""
    monkeypatch.setattr(junet, "group_norm_silu",
                        functools.partial(jgn.group_norm_silu, interpret=True))


def _gradient_capture():
    """An optax transformation that passes the gradients it is handed on
    unchanged and keeps them as its state."""
    import optax

    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        lambda params: zeros(params), lambda g, state, params=None: (g, g))


# flag -> the JAX VQGAN step under it: (config, state before, image, state
# after, metrics); one compile a flag for the module's tests
_JAX_VQ = {}


def _jax_vq_step(monkeypatch, flag):
    """One fused JAX VQGAN step under ``flag``, its autoencoder optimizer
    Adam behind ``_gradient_capture``: the same update as Adam alone, with
    the gradients Adam saw kept in ``ae_opt[0]`` of the new state."""
    if flag not in _JAX_VQ:
        import optax

        cfg = _config("vq")
        jm, jl = jtrainer.build_vqgan(cfg["model"])
        state, ae_tx, disc_tx = jvqgan.create_vqgan_state(
            jm, jl, jax.random.PRNGKey(0), (2, 16, 16, 3), LR)
        tx = optax.chain(_gradient_capture(), ae_tx)
        x = _images(11)
        _set_flags(monkeypatch, "jax", FLAGS[flag])
        new, jmetrics = jax.jit(jvqgan.make_vqgan_train_step(
            jm, jl, tx, disc_tx))(state.replace(ae_opt=tx.init(
                state.ae_params)), {"image": jnp.asarray(x)})
        _JAX_VQ[flag] = (cfg, state, x, new, jmetrics)
    return _JAX_VQ[flag]


def _vq_step(monkeypatch, flag):
    cfg, state, x, new, jmetrics = _jax_vq_step(monkeypatch, flag)
    env = FLAGS[flag]
    _set_flags(monkeypatch, "torch", env)
    tm, tl = ttrainer.build_vqgan(cfg["model"])
    tm.load_state_dict(from_jax_tree(state.ae_params))
    tl.load_state_dict(from_jax_tree(state.loss_params))
    tstate = create_first_stage_state(tm, tl, LR)
    tmetrics = make_vqgan_train_step(tm, tl)(tstate, torch.from_numpy(x))
    return (tm, tl, tmetrics), (state.ae_params, new.ae_params,
                                state.loss_params, new.loss_params, jmetrics)


def _kl_step(monkeypatch, flag):
    env = FLAGS[flag]
    cfg = _config("kl")
    jm, jl = jtrainer.build_kl_ae(cfg["model"])
    state, ae_tx, disc_tx = jkl.create_kl_ae_state(
        jm, jl, jax.random.PRNGKey(2), (2, 16, 16, 3), LR)
    x = _images(13)
    _set_flags(monkeypatch, "jax", env)
    new, jmetrics = jax.jit(jkl.make_kl_ae_train_step(jm, jl, ae_tx, disc_tx))(
        state, {"image": jnp.asarray(x)})
    _, sub = jax.random.split(state.rng)
    noise = np.array(jax.random.normal(sub, (2, 8, 8, 3)))

    _set_flags(monkeypatch, "torch", env)
    tm, tl = ttrainer.build_kl_ae(cfg["model"])
    tm.load_state_dict(from_jax_tree(state.ae_params))
    tl.load_state_dict(from_jax_tree(state.loss_params))
    tstate = create_first_stage_state(tm, tl, LR)
    tmetrics = make_kl_ae_train_step(tm, tl)(tstate, torch.from_numpy(x),
                                             noise=torch.from_numpy(noise))
    return (tm, tl, tmetrics), (state.ae_params, new.ae_params,
                                state.loss_params, new.loss_params, jmetrics)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("kind", ["vq", "kl"])
def test_first_stage_step_matches_jax_under_the_flag(kind, flag, monkeypatch,
                                                     jax_gn_interpret):
    """Losses, d_weight, the updated autoencoder and discriminator after one
    fused step, both sides under the flag (the KL step with the JAX step's
    own posterior noise)."""
    step = _vq_step if kind == "vq" else _kl_step
    (tm, tl, tmetrics), (before, ae_after, loss_before, loss_after,
                          jmetrics) = step(monkeypatch, flag)
    assert float(tmetrics["train/d_weight"]) > 0
    _metrics_close(tmetrics, jmetrics)
    _same_tree(to_jax_tree(tm), ae_after, 1e-2 * LR, _flat(before))
    _same_tree(to_jax_tree(tl.discriminator), loss_after["discriminator"],
               1e-2 * LR, _flat(loss_before["discriminator"]))


@pytest.mark.parametrize("flag", ["epilogue", "epilogue-res"])
def test_vq_generator_gradients_match_jax_under_the_epilogue(
        flag, monkeypatch, jax_gn_interpret):
    """The gradients Adam's first step sees, held directly: every leaf of the
    autoencoder within 1e-4 of its own largest gradient, or 1e-6 of the
    largest of all for a leaf whose gradient is zero by construction (an
    attention block's key bias): fp32 sums in another order, as the LDM
    training tests hold them. ``_same_tree`` holds an element whose gradient
    sits a few Adam eps from zero to that gradient; this holds every
    gradient."""
    cfg, state, x, new, _ = _jax_vq_step(monkeypatch, flag)
    want = _flat(jax.tree_util.tree_map(np.asarray, new.ae_opt[0]))

    _set_flags(monkeypatch, "torch", FLAGS[flag])
    tm, tl = ttrainer.build_vqgan(cfg["model"])
    tm.load_state_dict(from_jax_tree(state.ae_params))
    tl.load_state_dict(from_jax_tree(state.loss_params))
    rec, qloss, _ = tm(torch.from_numpy(x))
    total, _ = tl.generator_loss(qloss, torch.from_numpy(x), rec, 0,
                                 last_layer=tm.decoder.conv_out.weight)
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    got = _flat(to_jax_tree(tm, {n: torch.zeros_like(p) if g is None else g
                                 for n, p, g in zip(names, params, grads)}))
    assert got.keys() == want.keys() and len(got) > 50
    top = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(
            g, want[k], rtol=0, err_msg=k,
            atol=max(1e-4 * np.abs(want[k]).max(), 1e-6 * top))


# --------------------------------------------------------------------------
# launch counts: chip_smoke.py's arithmetic against a spy on the wrappers
# --------------------------------------------------------------------------

def _spy(monkeypatch):
    """Counts, per kernel, the wrapper calls that launch that kernel for a
    CUDA tensor (on the CPU they run the plain version)."""
    calls = dict.fromkeys(tatt.LAUNCHES, 0)

    def count(mod, attr, kernel, launches=lambda *a, **kw: True):
        real = getattr(mod, attr)

        def spy(*args, **kw):
            calls[kernel] += bool(launches(*args, **kw))
            return real(*args, **kw)

        monkeypatch.setattr(mod, attr, spy)

    count(tatt, "flash_attention", "flash_attention")
    count(tatt, "flash_attention_bwd_reference", "flash_attention_bwd")
    count(tatt, "flash_attention_streaming", "flash_attention_streaming")
    count(tatt, "flash_attention_streaming_bwd",
          "flash_attention_streaming_bwd")
    count(tgn, "_whole_row_forward", "group_norm_silu")
    count(tgn, "gn_channel_stats", "gn_channel_stats")
    # narrower outputs take the plain conv on the card too
    count(tunet, "conv_stats", "conv_stats",
          lambda x, w, *a, **kw: w.shape[-1] >= tcg.CONV_MIN_COUT)
    return calls


AE_RUNS = {name: (config, env) for name, config, env, _ in chip_smoke.AE_RUNS}


@pytest.mark.parametrize("run", list(AE_RUNS))
def test_smoke_launch_counts_are_one_cpu_steps_wrapper_calls(run,
                                                             monkeypatch):
    """The counts ``chip_smoke.expected_ae_launches`` takes from a model built
    on the meta device equal the kernel-wrapper calls of one CPU training
    step of the same tiny model under the run's flags."""
    config, env = AE_RUNS[run]
    kind = "vq" if config == chip_smoke.CONFIG_VQ else "kl"
    cfg = _config(kind)
    build = ttrainer.build_vqgan if kind == "vq" else ttrainer.build_kl_ae
    with torch.device("meta"):
        meta_model, _ = build(cfg["model"])
    _, per_step = chip_smoke.expected_ae_launches(meta_model, env, steps=1,
                                                  eval_batches=0)
    with chip_smoke.flags(**env):
        torch.manual_seed(0)
        tm, tl = build(cfg["model"])
        state = create_first_stage_state(tm, tl, LR)
        step = (make_vqgan_train_step if kind == "vq"
                else make_kl_ae_train_step)(tm, tl)
        calls = _spy(monkeypatch)
        step(state, torch.from_numpy(_images(17)))
    assert {k: v for k, v in calls.items() if v} == per_step
    flagged = {"DSML_PALLAS_GN": {"1": "group_norm_silu",
                                  "stats": "gn_channel_stats"},
               "DSML_GN_EPILOGUE": {"1": "conv_stats", "res": "conv_stats"}}
    for flag, value in env.items():
        if flag in flagged:
            assert per_step[flagged[flag][value]] > 0


# the new runs at full size, counted on the meta device: kernel -> launches
# of one step (one forward: one encode, one decode)
FULL_SIZE = {
    "ae-vq-gn": ("group_norm_silu", 47),         # 20 an encode, 27 a decode
    "ae-kl-stats": ("gn_channel_stats", 42),     # 18 + 24
    "ae-vq-epilogue": ("conv_stats", 53),        # 23 + 30
    "ae-kl-epilogue-res": ("conv_stats", 38),    # 2 x (8 + 11) ResnetBlocks
}


@pytest.mark.parametrize("run", list(FULL_SIZE))
def test_smoke_launch_counts_of_the_real_configs(run):
    config, env = AE_RUNS[run]
    cfg = load_config([config])
    build = (ttrainer.build_vqgan if config == chip_smoke.CONFIG_VQ
             else ttrainer.build_kl_ae)
    with torch.device("meta"):
        model, _ = build(cfg["model"])
    runs, per_step = chip_smoke.expected_ae_launches(model, env, steps=2,
                                                     eval_batches=1)
    kernel, n = FULL_SIZE[run]
    attn = chip_smoke.count_attn_blocks(model)
    assert per_step == {kernel: n, "flash_attention": attn,
                        "flash_attention_bwd": attn}
    assert runs[kernel] == 3 * n
    assert runs["flash_attention_bwd"] == 2 * attn


# --------------------------------------------------------------------------
# types: fp32 picks the _f32 entry points, a mixed call raises
# --------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A tensor that says it lies on a CUDA device (this machine has none):
    what a wrapper sees of a tensor on the card before it launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Picked(Exception):
    pass


class _Library:
    """A kernel library that names the entry point asked of it and stops
    there, before any buffer is allocated on the card."""

    def __getattr__(self, name):
        raise _Picked(name)


def _card(*shape, dtype=torch.float32):
    return torch.ones(*shape, dtype=dtype).as_subclass(_OnCard)


def _no_plain(monkeypatch):
    def plain(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((tgn, "group_norm_silu_reference"),
                      (tgn, "gn_channel_stats_reference"),
                      (tcg, "conv_stats_reference")):
        monkeypatch.setattr(mod, name, plain)


CALLS = {
    "group_norm_silu": lambda x: tgn.group_norm_silu_kernel(
        x.reshape(2, 4, 4, 64), _card(64), _card(64), eps=1e-6),
    "gn_channel_stats": lambda x: tgn.gn_channel_stats(x.reshape(2, 16, 64)),
    "conv_stats": lambda x: tcg.conv_stats(
        x.reshape(2, 4, 4, 64), _card(3, 3, 64, 64, dtype=x.dtype),
        _card(2, 64), skip=x.reshape(2, 4, 4, 64),
        in_stats=(_card(2, 64), _card(2, 64)), gamma=_card(64),
        beta=_card(64)),
}
ENTRIES = {"group_norm_silu": "dsml_group_norm_silu",
           "gn_channel_stats": "dsml_gn_channel_stats",
           "conv_stats": "dsml_conv_stats"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", list(CALLS))
def test_a_card_tensor_picks_the_entry_point_of_its_type(op, dtype,
                                                         monkeypatch):
    """For a CUDA tensor each wrapper goes to the kernel library: fp32
    activations to the ``_f32`` entry point, bf16 to the bf16 one, and no
    plain version runs."""
    _no_plain(monkeypatch)
    monkeypatch.setattr(_build, "load", _Library)
    with pytest.raises(_Picked) as picked:
        CALLS[op](_card(2, 4, 4, 64, dtype=dtype))
    suffix = "_f32" if dtype == torch.float32 else ""
    assert str(picked.value) == ENTRIES[op] + suffix
    assert not any(tatt.LAUNCHES.values())


MIXED = {
    # x fp32 beside fp16 parameters (parameters are fp32 or bf16)
    "gn-whole-row": lambda t: tgn.group_norm_silu_kernel(
        t(2, 16, 64), t(64, dtype=torch.float16), t(64, dtype=torch.float16)),
    "gn-stats-mode": lambda t: tgn.group_norm_silu_stats_fused(
        t(2, 16, 64), t(64, dtype=torch.float16), t(64, dtype=torch.float16)),
    "conv-w": lambda t: tcg.conv_stats(
        t(2, 4, 4, 32), t(3, 3, 32, 32, dtype=torch.bfloat16), t(2, 32)),
    "conv-skip": lambda t: tcg.conv_stats(
        t(2, 4, 4, 32, dtype=torch.bfloat16),
        t(1, 1, 32, 32, dtype=torch.bfloat16), t(2, 32),
        skip=t(2, 4, 4, 32)),
    # one operand: a type the kernels do not take
    "channel-stats-fp16": lambda t: tgn.gn_channel_stats(
        t(2, 16, 64, dtype=torch.float16)),
}


@pytest.mark.parametrize("case", list(MIXED))
def test_a_mixed_type_call_raises(case, monkeypatch):
    """On the CPU and on the card alike, before anything is built: x, w and
    skip of one type; gamma / beta fp32 or bf16; activations bf16 or fp32 on
    the card."""
    monkeypatch.setattr(_build, "load", _Library)
    devices = ["card"] if case == "channel-stats-fp16" else ["cpu", "card"]
    for where in devices:
        t = (lambda *s, dtype=torch.float32: torch.ones(*s, dtype=dtype)) \
            if where == "cpu" else _card
        with pytest.raises(TypeError):
            MIXED[case](t)
