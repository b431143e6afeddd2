"""Rematerialisation of the port's UNet (``use_checkpoint`` and
``DSML_REMAT``) on the CPU in fp32.

* A tiny UNet's gradients (every parameter and the input) with
  ``use_checkpoint=True`` under ``DSML_REMAT=full|dots|none`` against the
  same weights without it: equal bits (the recompute runs the same ops on
  the same inputs), in training and in eval mode, also under
  ``DSML_GN_EPILOGUE=res``, whose statistics thread ``(h, st)`` passes
  through the checkpoint.
* The same gradients against ``jax.grad`` of the JAX UNet with
  ``use_checkpoint=True`` under the same ``DSML_REMAT``: every leaf within
  1e-4 of its own maximum (the training tests' tolerance).
* ``dots`` keeps the linears: its backward runs as many ``mm`` / ``addmm``
  as a backward without checkpoints, ``full`` more (it recomputes them).
* Serving (no gradient) is never checkpointed; a bad ``DSML_REMAT`` raises.
* ``chip_smoke.expected_train_launches``' recompute rule against spies on
  the kernel wrappers in one CPU training step of the tiny 2-cond model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu_torch.config import build_model
from dsml_thesis_tpu_torch.convert import from_jax_tree
from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.ops import conv_gn as tcg
from test_ldm import TINY_MEAD_CFG
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

UNET_KW = dict(in_channels=9, model_channels=32, out_channels=3,
               num_res_blocks=1, attention_resolutions=(2, 1),
               channel_mult=(1, 2), num_head_channels=16,
               use_spatial_transformer=True, transformer_depth=1,
               context_dim=48)
MODES = ("full", "dots", "none")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 9)).astype(np.float32),
            np.array([3, 77], np.int32),
            rng.standard_normal((2, 3, 48)).astype(np.float32),
            rng.standard_normal((2, 8, 8, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def unets():
    """(JAX module with use_checkpoint, its params, port UNet without
    checkpoints, port UNet with them), one set of weights."""
    jm = junet.UNetModel(**UNET_KW, use_checkpoint=True)
    x, t, ctx, _ = _inputs()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(ctx))["params"]
    params = random_params(params, np.random.default_rng(1))
    sd = from_jax_tree(jax.tree.map(np.asarray, params))
    plain = tunet.UNetModel(**UNET_KW)
    remat = tunet.UNetModel(**UNET_KW, use_checkpoint=True)
    for m in (plain, remat):
        m.load_state_dict(sd, strict=True)
        m.train()
    return jm, params, plain, remat


@pytest.fixture
def no_flags(monkeypatch):
    for k in KERNEL_FLAGS + ("DSML_REMAT",):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _grads(m, seed=0):
    """{name: gradient} of every parameter and of the input ``x`` for the
    loss sum(unet(x) * w), and the ``mm`` / ``addmm`` its backward ran."""
    x, t, ctx, w = (torch.from_numpy(a) for a in _inputs(seed))
    m.zero_grad(set_to_none=True)
    x = x.requires_grad_(True)
    loss = (m(x, t.long(), ctx) * w).sum()
    with _CountOps() as ops:
        loss.backward()
    mm = sum(ops.n.get(op, 0) for op in tunet.SAVED_UNDER_DOTS)
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    grads["x"] = x.grad.detach().clone()
    return grads, mm


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("epilogue", ["0", "res"])
@pytest.mark.parametrize("mode", MODES)
def test_checkpointed_gradients_equal_the_plain_ones(unets, no_flags, mode,
                                                     epilogue, train):
    """Training mode (the packed self-attention) and eval mode with a
    gradient (the fused-projection op, a finetune's route)."""
    _, _, plain, remat = unets
    if epilogue != "0":
        no_flags.setenv("DSML_GN_EPILOGUE", epilogue)
    try:
        plain.train(train)
        remat.train(train)
        want, _ = _grads(plain)
        no_flags.setenv("DSML_REMAT", mode)
        got, _ = _grads(remat)
    finally:
        plain.train()
        remat.train()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert want["conv_in.weight"].abs().max() > 0


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_checkpointed_gradients_match_jax_grad(unets, no_flags, mode):
    """``jax.grad`` of the JAX UNet with ``use_checkpoint=True`` under the
    same ``DSML_REMAT`` (the JAX side reads it at trace time)."""
    jm, params, _, remat = unets
    no_flags.setenv("DSML_REMAT", mode)
    x, t, ctx, w = _inputs(3)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(t),
                                jnp.asarray(ctx)) * jnp.asarray(w))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    want = from_jax_tree(jax.tree.map(np.asarray, gp))
    want["x"] = torch.from_numpy(np.asarray(gx))
    got, _ = _grads(remat, seed=3)
    assert set(got) == set(want)
    top = max(float(v.abs().max()) for v in want.values())
    for k, wv in want.items():
        wv = wv.float()
        np.testing.assert_allclose(
            got[k].numpy(), wv.numpy(), rtol=0, err_msg=k,
            atol=max(1e-4 * float(wv.abs().max()), 1e-6 * top))


def test_dots_keeps_the_linears_and_full_recomputes_them(unets, no_flags):
    _, _, plain, remat = unets
    _, mm_plain = _grads(plain)
    counts = {}
    for mode in MODES:
        no_flags.setenv("DSML_REMAT", mode)
        counts[mode] = _grads(remat)[1]
    assert counts["dots"] == counts["none"] == mm_plain > 0
    assert counts["full"] > counts["dots"]


def test_no_checkpoint_without_a_gradient(unets, no_flags):
    """A served call (``no_grad``) runs the blocks plainly under any
    ``DSML_REMAT``, with the same output as the unflagged model; a bad value
    raises."""
    _, _, plain, remat = unets
    x, t, ctx, _ = (torch.from_numpy(a) for a in _inputs(5))

    def refuse(*args, **kwargs):
        raise AssertionError("checkpointed without a gradient")

    no_flags.setattr(tunet, "checkpoint", refuse)
    for mode in MODES:
        no_flags.setenv("DSML_REMAT", mode)
        with torch.no_grad():
            got = remat.eval()(x, t.long(), ctx)
            want = plain.eval()(x, t.long(), ctx)
        assert torch.equal(got, want)
    remat.train()
    plain.train()
    no_flags.setenv("DSML_REMAT", "sometimes")
    with pytest.raises(ValueError, match="DSML_REMAT"):
        with torch.no_grad():
            remat(x, t.long(), ctx)


def _spy(monkeypatch):
    """Calls of the wrappers that launch a kernel for a CUDA tensor (on the
    CPU they run the plain versions): the packed forward and backward, the
    split-head forward and backward, conv + statistics."""
    calls = dict.fromkeys(tatt.LAUNCHES, 0)

    def count(mod, attr, kernel, launches=lambda *a, **kw: True,
              wrap=lambda f: f):
        real = getattr(mod, attr)

        def spy(*args, **kw):
            calls[kernel] += bool(launches(*args, **kw))
            return real(*args, **kw)
        monkeypatch.setattr(mod, attr, wrap(spy))

    count(tatt, "flash_attention_packed", "flash_attention_packed")
    count(tatt._PackedAttention, "backward", "flash_attention_bwd_packed",
          wrap=staticmethod)
    count(tatt, "flash_attention", "flash_attention")
    count(tatt._FlashAttention, "backward", "flash_attention_bwd",
          wrap=staticmethod)
    count(tunet, "conv_stats", "conv_stats",
          lambda x, w, *a, **kw: w.shape[-1] >= tcg.CONV_MIN_COUT)
    return calls


def _tiny_cfg():
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    cfg["model"]["params"]["unet_config"]["params"]["use_checkpoint"] = True
    return cfg


@pytest.mark.parametrize("env", [
    {"DSML_REMAT": "full"}, {"DSML_REMAT": "dots"}, {"DSML_REMAT": "none"},
    {"DSML_REMAT": "full", "DSML_GN_EPILOGUE": "res"},
    {"DSML_REMAT": "dots", "DSML_ATTN_PACKED": "0"}],
    ids=["full", "dots", "none", "full-epilogue-res", "dots-split"])
def test_smoke_recompute_rule_is_one_cpu_steps_wrapper_calls(env, no_flags):
    """One training step of the tiny model with ``use_checkpoint`` (three
    frozen first-stage encodes, the UNet forward and backward): the wrapper
    calls against ``expected_train_launches``, which adds, for each kernel
    the UNet's blocks launch in the forward, the same launches again in the
    backward."""
    cfg = _tiny_cfg()
    torch.manual_seed(0)
    ldm = build_model(cfg["model"]).train()
    with torch.device("meta"):
        meta = build_model(cfg["model"])
    _, per_step = chip_smoke.expected_train_launches(meta, env, steps=1,
                                                     eval_batches=0)
    _, unflagged = chip_smoke.expected_train_launches(
        meta, dict(env, DSML_REMAT="none"), steps=1, eval_batches=0)
    rng = np.random.default_rng(4)
    img = lambda: torch.from_numpy(
        rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    batch = {"image": img(), "masked_image": img(), "identity": img(),
             "class_label": torch.tensor([1, 5]),
             "audio": torch.from_numpy(
                 rng.standard_normal((2, 5, 32)).astype(np.float32))}
    for k, v in env.items():
        no_flags.setenv(k, v)
    calls = _spy(no_flags)
    ldm.configure_trainable()
    loss, _ = ldm.training_loss(batch, t=torch.full((2,), 10),
                                noise=torch.zeros(2, 8, 8, 3))
    loss.backward()
    assert {k: v for k, v in calls.items() if v} == {
        k: v for k, v in per_step.items() if v}
    recomputed = {k: per_step[k] - unflagged[k] for k in per_step}
    if env["DSML_REMAT"] == "none":
        assert not any(recomputed.values())
    else:
        fwd = ("flash_attention_packed" if env.get("DSML_ATTN_PACKED", "1")
               == "1" else "flash_attention")
        # every self-attention of the UNet; both 3x3 convs of every ResBlock
        attentions = sum(chip_smoke.count_attentions(meta.unet,
                                                     meta.image_size))
        resblocks = sum(isinstance(m, tunet.ResBlock)
                        for m in meta.unet.modules())
        assert recomputed[fwd] == attentions == 4
        assert recomputed["conv_stats"] == (
            2 * resblocks if "DSML_GN_EPILOGUE" in env else 0)


def test_attention_block_unet_still_raises():
    with pytest.raises(NotImplementedError, match="use_spatial_transformer"):
        tunet.UNetModel(**dict(UNET_KW, use_spatial_transformer=False),
                        use_checkpoint=True)


def test_remat_flag_reaches_the_model_through_the_config():
    cfg = _tiny_cfg()
    with torch.device("meta"):
        assert build_model(cfg["model"]).unet.use_checkpoint
        cfg["model"]["params"]["unet_config"]["params"].pop("use_checkpoint")
        assert not build_model(cfg["model"]).unet.use_checkpoint


def test_smoke_option_runs_and_their_counts_on_the_real_yaml():
    """``chip_smoke.py``'s option runs: the headline config, the remat runs
    with ``use_checkpoint`` by override; a step's launches on the real YAML
    (meta device): the packed forward twice a self-attention under either
    remat mode (11 + 11), once under the bf16 moment, the backward once."""
    from dsml_thesis_tpu_torch.config import load_config

    runs = {n: (c, env) for n, c, env, _ in chip_smoke.TRAIN_RUNS
            if chip_smoke.is_option_run(env)}
    assert runs == {
        "train-remat": (chip_smoke.CONFIG, {"DSML_REMAT": "full"}),
        "train-remat-dots": (chip_smoke.CONFIG, {"DSML_REMAT": "dots"}),
        "train-bf16m": (chip_smoke.CONFIG, {"DSML_OPT_BF16_M": "1"})}
    for name, (config, env) in runs.items():
        cfg = load_config([config], chip_smoke.option_overrides(env))
        with torch.device("meta"):
            ldm = build_model(cfg["model"])
        assert ldm.unet.use_checkpoint == ("DSML_REMAT" in env)
        _, per_step = chip_smoke.expected_train_launches(ldm, env, 2, 1)
        packed = 22 if "DSML_REMAT" in env else 11
        assert {k: v for k, v in per_step.items() if v} == {
            "flash_attention": 9, "flash_attention_packed": packed,
            "flash_attention_bwd_packed": 11}, name


def test_update_difference_of_the_option_runs():
    a = [torch.zeros(3), torch.ones(2)]
    b = [torch.tensor([1.0, 2.0, 4.0]), torch.tensor([1.0, 1.5])]
    assert chip_smoke.update_difference(a, b, a, b) == (True, 0.0, 0.0)
    c = [torch.tensor([1.0, 2.0, 4.1]), torch.tensor([1.0, 1.5])]
    bits, rel, worst = chip_smoke.update_difference(a, c, a, b)
    assert not bits and abs(worst - 0.1 / 4.0) < 1e-6
    assert abs(rel - 0.1 / (1 + 4 + 16 + 0.25) ** 0.5) < 1e-6   # fp32 4.1
