"""The streaming-attention and conv-epilogue routes as a whole on the CPU:
the tiny 2-cond MEAD model's pipeline and one train step under each of the
flags ``DSML_FLASH_STREAMING`` and ``DSML_GN_EPILOGUE``, against the JAX
package under the same flag with its
Pallas kernels in interpret mode (``DSML_FLASH_INTERPRET=1``;
``res-interpret`` / ``interpret`` for the epilogue).

Tolerances, those of the unflagged tests of the same model: latents 1e-3
after 2 frames x 4 DDIM steps; loss 1e-5; every gradient leaf 1e-4 of its own
maximum; after one AdamW step parameters 1e-5 in at least 999 of 1000
elements and nowhere beyond twice the learning rate (a weight whose gradient
is rounding noise moves by the learning rate in a noise direction).
"""
import copy

import jax
import numpy as np
import pytest

from dsml_thesis_tpu.training import train_state as jts
from dsml_thesis_tpu_torch.convert import to_jax_params
from dsml_thesis_tpu_torch.training import train_state as tts
from test_torch_port_pipeline import B, F, WINDOW, _run_jax, _run_torch
from test_torch_port_training import (_batch, _jax_draws, _leaves, _models,
                                      _noise_leaves, _tb,
                                      jax_step_with_grads)
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

# flag value on the port's side -> on the JAX side (its interpret-mode twin)
JAX_MODE = {"res": "res-interpret", "1": "interpret"}


@pytest.fixture(scope="module")
def tiny_ldm():
    jldm, params, tldm = _models(0.0)
    rng = np.random.default_rng(15)
    inputs = {
        "masked_frames": rng.uniform(-1, 1, (B, F, 16, 16, 3)),
        "audio": rng.standard_normal((B, F + WINDOW, 32)),
        "identity": rng.uniform(-1, 1, (B, 16, 16, 3)),
        "x_T": rng.standard_normal((B, F, 8, 8, 3)),
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs["class_label"] = np.array([1, 5], np.int32)
    return jldm, params, tldm, inputs


FLAG_SETS = {
    "streaming": {"DSML_FLASH_STREAMING": "1"},
    "streaming-split-heads": {"DSML_FLASH_STREAMING": "1",
                              "DSML_ATTN_PACKED": "0"},
    "epilogue-res": {"DSML_GN_EPILOGUE": "res"},
    "epilogue": {"DSML_GN_EPILOGUE": "1"},
}


def _set_flags(monkeypatch, side, env):
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    for k, v in env.items():
        if k == "DSML_GN_EPILOGUE" and side == "jax":
            v = JAX_MODE[v]
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_pipeline_latents_match_jax_under_each_flag(tiny_ldm, monkeypatch,
                                                    name):
    jldm, params, tldm, inputs = tiny_ldm
    _set_flags(monkeypatch, "jax", FLAG_SETS[name])
    want = _run_jax(jldm, params, inputs, decode=False)
    _set_flags(monkeypatch, "torch", FLAG_SETS[name])
    tldm.eval()
    got = _run_torch(tldm, inputs, decode=False)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", ["streaming-split-heads", "epilogue-res"])
def test_train_step_matches_jax_under_each_flag(tiny_ldm, monkeypatch, name):
    """Loss, every gradient leaf and one AdamW + EMA step under the flags of
    the two new train runs, the JAX side with its kernels in interpret mode
    (streaming forward and backward; conv kernel forward, reference
    backward)."""
    jldm, params, tldm, _ = tiny_ldm
    tldm = copy.deepcopy(tldm)
    batch, rng, base_lr = _batch(30), jax.random.PRNGKey(21), 1e-4
    _set_flags(monkeypatch, "jax", FLAG_SETS[name])
    # one jitted step: its loss, gradients and new state at its own draws
    jstate, want_m, want_grads = jax_step_with_grads(
        jldm, params, jts.make_optimizer(jldm, params, base_lr), batch, rng)
    want_loss = want_m["train/loss"]

    _set_flags(monkeypatch, "torch", FLAG_SETS[name])
    t, noise = _jax_draws(jax.random.fold_in(rng, 0))
    tldm.configure_trainable()
    tldm.zero_grad(set_to_none=True)
    loss, _ = tldm.training_loss(_tb(batch), t=t, noise=noise)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-5, rtol=0)
    got_l = _leaves(to_jax_params(tldm, {
        n: p.grad for n, p in tldm.named_parameters() if p.grad is not None}))
    want_l = _leaves({g: v for g, v in want_grads.items()
                      if g != "first_stage"})
    top = max(np.abs(w).max() for w in want_l.values())
    assert len(got_l) > 100
    for k, g in got_l.items():
        np.testing.assert_allclose(
            g, want_l[k], rtol=0, err_msg=k,
            atol=max(1e-4 * np.abs(want_l[k]).max(), 1e-6 * top))

    class Draws:
        supports_sample_weights = True

        def training_loss(self, b, generator=None, training=True):
            return tldm.training_loss(b, generator, training=training, t=t,
                                      noise=noise)

    tldm.zero_grad(set_to_none=True)
    draws_rng = jax.random.fold_in(rng, 0)
    t, noise = _jax_draws(draws_rng)
    opt = tts.make_optimizer(tldm, base_lr=base_lr)
    state = tts.create_train_state(tldm, opt, base_lr=base_lr)
    m = tts.make_train_step(Draws())(state, _tb(batch), seed=0)
    np.testing.assert_allclose(float(m["train/loss"]),
                               float(want_m["train/loss"]), atol=1e-5, rtol=0)
    noise_leaves = _noise_leaves(want_grads)
    got_p = _leaves(to_jax_params(tldm, dict(zip(state.names, state.params))))
    want_p = _leaves({k: v for k, v in jstate.params.items()
                      if k != "first_stage"})
    for k, w_ in want_p.items():
        diff = np.abs(got_p[k] - w_)
        assert diff.max() <= 2 * base_lr + 1e-7, k
        if k not in noise_leaves:
            assert (diff > 1e-5).mean() <= 1e-3, k
