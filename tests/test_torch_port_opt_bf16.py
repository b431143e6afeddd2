"""``DSML_OPT_BF16_M=1``: the LDM trainer's AdamW with its first moment kept
in bf16 (``training/train_state.py:AdamWBf16M``), against optax's
``adamw(..., mu_dtype="bfloat16")`` on the CPU.

* Three train steps of the tiny 2-cond MEAD model under a warm-up / cosine
  LR schedule against the jitted JAX steps with the flag set on both sides
  (t and noise from the JAX side's own draws): metrics 1e-5, parameters and
  EMA shadows 1e-5 in all but 1e-3 of a leaf's elements and nowhere beyond
  twice the summed learning rates (the tolerances of
  ``test_torch_port_training.py``'s three-step test).
* The stored first moment is bf16 and, after the first step, within one
  bf16 ulp of optax's ``mu`` (the gradients agree to rounding, and a bf16
  rounding may fall on either side; near the gradients' floor, 1e-6 of the
  tree's largest, the floor); the second moment is fp32. On the same
  gradients, three steps of both optimizers give the same moment bits.
* A saved and reloaded train state continues with the same bits as the one
  that did not stop; a Trainer's checkpoint and resume keep the bf16 moment;
  the flag unset keeps ``torch.optim.AdamW``.
"""
import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch

from dsml_thesis_tpu.training import train_state as jts
from dsml_thesis_tpu_torch.convert import to_jax_params
from dsml_thesis_tpu_torch.training import train_state as tts
from dsml_thesis_tpu_torch.training.trainer import Trainer
from test_torch_port_hygiene import one_torch_thread  # noqa: F401
from test_torch_port_trainer import _config
from test_torch_port_training import (SCHEDULER, _assert_trees_close,
                                      _batch, _InjectedDraws, _jax_draws,
                                      _jb, _leaves, _models, _noise_leaves,
                                      _tb)


@pytest.fixture(scope="module")
def models():
    return _models(0.0)


@pytest.fixture
def bf16_moment(monkeypatch):
    monkeypatch.setenv("DSML_OPT_BF16_M", "1")


def _optax_mu(opt_state):
    """optax's first moment of the trainable groups: {leaf path: float32}."""
    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for n in node:
                visit(n)
        elif isinstance(node, dict):
            for n in node.values():
                visit(n)
        elif hasattr(node, "_fields"):
            for n in node:
                visit(n)
        elif hasattr(node, "inner_states"):
            visit(node.inner_states)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(opt_state)
    (adam,) = found
    mu = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(adam.mu)[0]:
        if hasattr(leaf, "dtype"):
            assert leaf.dtype == jax.numpy.bfloat16
            mu[jax.tree_util.keystr(path)] = np.asarray(leaf, np.float32)
    return mu


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_within_one_ulp(got, want):
    """Every element of every leaf within one bf16 ulp of optax's; an element
    near the gradients' floor (1e-6 of the tree's largest, the training
    tests' rule) within that floor."""
    assert set(want) == set(got) and len(got) > 50
    top = max(np.abs(w).max() for w in want.values())
    assert top > 0
    for k, w in want.items():
        g = got[k]
        ulp = np.maximum(_bf16_ulp(np.maximum(np.abs(g), np.abs(w))),
                         1e-6 * top)
        assert (np.abs(g - w) <= ulp).all(), k


def test_three_steps_match_optax_with_a_bf16_moment(models, bf16_moment):
    jldm, params, tldm = models
    tldm = copy.deepcopy(tldm)
    base_lr, rng = 1e-4, jax.random.PRNGKey(11)
    batches = [_batch(20 + i) for i in range(3)]

    tx = jts.make_optimizer(jldm, params, base_lr, scheduler_config=SCHEDULER)
    jstate = jts.create_train_state(jldm, params, tx)
    jstep = jax.jit(jts.make_train_step(jldm, tx))
    want_metrics, jax_mu = [], []
    for i in range(3):
        jstate, m = jstep(jstate, _jb(batches[i]), rng)
        want_metrics.append({k: float(v) for k, v in m.items()})
        jax_mu.append(_optax_mu(jstate.opt_state))

    draws = [_jax_draws(jax.random.fold_in(rng, i)) for i in range(3)]
    opt = tts.make_optimizer(tldm, base_lr=base_lr)
    assert isinstance(opt, tts.AdamWBf16M)
    state = tts.create_train_state(tldm, opt, base_lr=base_lr,
                                   scheduler_config=SCHEDULER)
    step = tts.make_train_step(_InjectedDraws(tldm, draws))
    port_mu = []
    for i in range(3):
        m = step(state, _tb(batches[i]), seed=0)
        for k, w in want_metrics[i].items():
            np.testing.assert_allclose(float(m[k]), w, atol=1e-5, rtol=0,
                                       err_msg=f"step {i} {k}")
        port_mu.append(_leaves(to_jax_params(tldm, {
            n: opt.state[p]["exp_avg"].float()
            for n, p in zip(state.names, state.params)})))

    noise = _noise_leaves(jax.jit(jax.grad(
        lambda p: jldm.training_loss(p, _jb(batches[0]), rng)[0]))(params))
    loose = dict(loose=noise, loose_atol=2 * sum(state.lr_at(n)
                                                 for n in range(3)))
    trainable = {k: v for k, v in jstate.params.items() if k != "first_stage"}
    _assert_trees_close(to_jax_params(tldm, dict(zip(state.names,
                                                     state.params))),
                        trainable, atol=1e-5, **loose)
    _assert_trees_close(to_jax_params(tldm, dict(zip(state.names,
                                                     state.ema_params))),
                        jstate.ema_params, atol=1e-5, **loose)

    # the moments: bf16 first, fp32 second. After the first step the first
    # within one bf16 ulp of optax's; later the two runs' gradients part by
    # more than rounding where the first step moved a weight whose gradient
    # was rounding noise (the loose leaves above), and the moment follows
    # them: ``test_moments_match_optax_on_the_same_gradients`` holds it there
    moments = [opt.state[p] for p in state.params]
    assert all(s["exp_avg"].dtype == torch.bfloat16 for s in moments)
    assert all(s["exp_avg_sq"].dtype == torch.float32 for s in moments)
    assert all(s["step"] == 3 for s in moments)
    _assert_within_one_ulp(port_mu[0], jax_mu[0])


def test_moments_match_optax_on_the_same_gradients(bf16_moment):
    """Three steps of ``AdamWBf16M`` and of ``optax.adamw(mu_dtype=bf16)``
    (under a schedule, with weight decay) on the same parameters and the
    same gradients, zeros and magnitudes from 1e-8 to 10 among them: the
    first moment equal in bits, the second moment within 1e-6 relative, the
    parameters within 1e-6 relative plus 1e-5 of the largest learning rate
    (an update of about the learning rate, its fp32 roundings and the bias
    corrections' powers in another library)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (64, 32), "b": (513,), "k": (3, 3, 8, 16)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = []
    for i in range(3):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-8, 1, s)
                 ).astype(np.float32) for k, s in shapes.items()}
        g["b"][::7] = 0.0
        grads.append(g)
    lrs = [1e-3, 5e-4, 2e-4]

    tx = optax.adamw(lambda n: jax.numpy.asarray(lrs)[n], b1=0.9, b2=0.999,
                     weight_decay=0.01, mu_dtype="bfloat16")
    jp = jax.tree.map(jax.numpy.asarray, params)
    jst = tx.init(jp)
    upd = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tts.AdamWBf16M(list(tp.values()), lr=lrs[0])
    for i in range(3):
        u, jst = upd(jax.tree.map(jax.numpy.asarray, grads[i]), jst, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[i][k])
        opt.param_groups[0]["lr"] = lrs[i]
        opt.step()
    adam = jst[0]
    for k, p in tp.items():
        st = opt.state[p]
        want_mu = np.asarray(adam.mu[k], np.float32)
        assert adam.mu[k].dtype == jax.numpy.bfloat16
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), want_mu)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-5 * max(lrs))


def test_the_bf16_moment_is_not_torchs_lerp(models, bf16_moment):
    """One step from a nonzero bf16 moment equals optax's moment update as
    the JAX step runs it (jitted: ``b1`` rounded to bf16, the product in
    fp32), and differs from the bf16 ``lerp_`` that ``torch.optim.AdamW``
    would do on a bf16 ``exp_avg``."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    mu0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32)).to(torch.bfloat16)
    p = torch.nn.Parameter(torch.zeros(4096))
    opt = tts.AdamWBf16M([p], lr=1e-3)
    p.grad = g
    opt.step()
    opt.state[p]["exp_avg"].copy_(mu0)
    opt.step()
    got = opt.state[p]["exp_avg"]
    jmu = jax.jit(lambda g, m: optax.tree.update_moment(g, m, 0.9, 1)
                  .astype(jax.numpy.bfloat16))(
        jax.numpy.asarray(g.numpy()),
        jax.numpy.asarray(mu0.float().numpy()).astype(jax.numpy.bfloat16))
    want = torch.from_numpy(np.asarray(jmu, np.float32))
    assert torch.equal(got.float(), want)
    lerp = mu0.clone().lerp_(g.to(torch.bfloat16), 0.1)
    assert not torch.equal(lerp, got)


def test_unset_flag_keeps_torch_adamw(models, monkeypatch):
    monkeypatch.delenv("DSML_OPT_BF16_M", raising=False)
    _, _, tldm = models
    assert type(tts.make_optimizer(copy.deepcopy(tldm), base_lr=1e-4)) \
        is torch.optim.AdamW
    monkeypatch.setenv("DSML_OPT_BF16_M", "maybe")
    with pytest.raises(ValueError, match="DSML_OPT_BF16_M"):
        tts.make_optimizer(copy.deepcopy(tldm), base_lr=1e-4)


def test_checkpoint_and_resume_keep_the_bf16_moment(models, tmp_path,
                                                     bf16_moment):
    """The train state written with ``torch.save`` and read back continues
    with the same bits as the state that did not stop (moments, parameters);
    a Trainer's ``last`` checkpoint restores the bf16 moment equal to the
    saved one, and the resumed run trains on."""
    _, _, tldm = models
    tldm = copy.deepcopy(tldm)
    opt = tts.make_optimizer(tldm, base_lr=1e-4)
    state = tts.create_train_state(tldm, opt, base_lr=1e-4)
    step = tts.make_train_step(tldm)
    step(state, _tb(_batch(60)), seed=1)
    step(state, _tb(_batch(61)), seed=1)
    path = str(tmp_path / "state.pt")
    torch.save({"state": state.state_dict(), "model": tldm.state_dict()},
               path)
    step(state, _tb(_batch(62)), seed=1)
    third = [p.detach().clone() for p in state.params]
    mu3 = [opt.state[p]["exp_avg"].clone() for p in state.params]

    saved = torch.load(path, weights_only=False)
    state.load_state_dict(saved["state"])
    tldm.load_state_dict(saved["model"])
    assert state.step == 2
    assert all(opt.state[p]["exp_avg"].dtype == torch.bfloat16
               for p in state.params)
    step(state, _tb(_batch(62)), seed=1)
    for p, w, m in zip(state.params, third, mu3):
        assert torch.equal(p, w)
        assert torch.equal(opt.state[p]["exp_avg"], m)

    first = Trainer(_config(), str(tmp_path / "run"), seed=3, max_steps=3,
                    device="cpu")
    done = first.fit(epochs=10, log_every=1, val_max_batches=1)
    assert isinstance(done.optimizer, tts.AdamWBf16M)
    again = Trainer(_config(), str(tmp_path / "run"), seed=3, max_steps=4,
                    device="cpu")
    restored = again.restore_checkpoint("last")
    assert restored.step == 3
    for a, b in zip(done.params, restored.params):
        sa, sb = done.optimizer.state[a], restored.optimizer.state[b]
        assert sb["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    final = again.fit(epochs=10, log_every=1, val_max_batches=1)
    assert final.step == 4
    assert all(final.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
               for p in final.params)
    assert os.path.isfile(tmp_path / "run" / "checkpoints" / "last"
                          / "state.pt")
