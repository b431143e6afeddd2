"""The port's training math against the JAX package's, on the CPU in fp32:
the LR schedules, the EMA update, ``LatentDiffusion.training_loss`` with its
one-step gradients, and the train / eval steps (AdamW, gradient accumulation,
EMA, LR schedule) over three steps.

One set of weights (a JAX tree refilled from a numpy seed, carried over by
``from_jax_params`` and compared back through ``to_jax_params``) and one set
of numpy batches go through both. The random draws are the JAX side's own:
t and noise come from the ``jax.random`` calls ``training_loss`` makes and are
handed to the port (``t=``, ``noise=``); the label drop is fixed by setting
``p_uncond`` to 0 (never) and to 1 (always), so that both branches are held
without copying flax's ``make_rng``.

Tolerances: loss 1e-5; every gradient leaf 1e-4 of its own maximum; after
three optimizer steps parameters and EMA shadows 1e-5 absolute (an AdamW step
moves a weight by about the learning rate, 1e-4 here); LR multipliers 1e-7.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu.training import lr_scheduler as jlr
from dsml_thesis_tpu.training import train_state as jts
from dsml_thesis_tpu.training.ema import ema_update as jax_ema_update
from dsml_thesis_tpu_torch.config import build_model
from dsml_thesis_tpu_torch.convert import from_jax_params, to_jax_params
from dsml_thesis_tpu_torch.training import lr_scheduler as tlr
from dsml_thesis_tpu_torch.training import train_state as tts
from dsml_thesis_tpu_torch.training.ema import ema_decay, ema_update
from test_ldm import TINY_MEAD_CFG
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

B = 4
SCHEDULER = {"target": "ldm.lr_scheduler.LambdaWarmUpCosineScheduler",
             "params": {"warm_up_steps": 2, "lr_min": 0.1, "lr_max": 1.0,
                        "lr_start": 0.2, "max_decay_steps": 10,
                        "verbosity_interval": 0}}


# --------------------------------------------------------------------------
# LR schedules and EMA
# --------------------------------------------------------------------------

SCHEDULES = {
    "warmup_cosine": dict(warm_up_steps=5, lr_min=0.01, lr_max=1.0,
                          lr_start=1e-3, max_decay_steps=40),
    "warmup_cosine-no-warmup": dict(warm_up_steps=0, lr_min=0.1, lr_max=1.0,
                                    lr_start=0.5, max_decay_steps=20),
    "warmup_cosine2": dict(warm_up_steps=[3, 2], f_min=[0.1, 0.05],
                           f_max=[1.0, 0.5], f_start=[1e-3, 0.1],
                           cycle_lengths=[10, 15]),
    "lambda_linear": dict(warm_up_steps=[4, 2], f_min=[0.2, 0.1],
                          f_max=[1.0, 0.6], f_start=[0.0, 0.1],
                          cycle_lengths=[12, 8]),
}
STEPS = [0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13, 19, 20, 21, 25, 39, 40, 41,
         100]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_multiplier_matches_jax(name):
    fn = name.split("-")[0]
    want = getattr(jlr, fn)(**SCHEDULES[name])
    got = getattr(tlr, fn)(**SCHEDULES[name])
    for n in STEPS:
        assert isinstance(got(n), float)
        np.testing.assert_allclose(got(n), float(want(n)), atol=1e-7, rtol=0,
                                   err_msg=f"n={n}")


def test_build_lr_multiplier_matches_jax_and_refuses_unknown_targets():
    want, got = jlr.build_lr_multiplier(SCHEDULER), tlr.build_lr_multiplier(
        SCHEDULER)
    for n in range(14):
        np.testing.assert_allclose(got(n), float(want(n)), atol=1e-7, rtol=0)
    with pytest.raises(NotImplementedError):
        tlr.build_lr_multiplier({"target": "torch.optim.lr_scheduler.StepLR"})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16-shadow"])
def test_ema_update_matches_jax(dtype):
    rng = np.random.default_rng(0)
    e = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    p = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    shadows = [torch.from_numpy(a).to(dtype) for a in e]
    want = [jnp.asarray(a).astype(jdt) for a in e]
    for n in (1, 2, 50, 100000):
        want = jax_ema_update(want, [jnp.asarray(a) for a in p], n)
        ema_update(shadows, [torch.from_numpy(a) for a in p], n)
        for s, w in zip(shadows, want):
            assert s.dtype == dtype   # the shadow keeps its type
            np.testing.assert_allclose(
                s.float().numpy(), np.asarray(w, np.float32),
                atol=1e-6 if dtype == torch.float32 else 1e-2, rtol=0)
    assert ema_decay(0) == 0.1 and ema_decay(10 ** 9) == 0.9999


# --------------------------------------------------------------------------
# the tiny 2-cond MEAD model on both sides
# --------------------------------------------------------------------------

def _batch(seed):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    return {"image": img(), "masked_image": img(), "identity": img(),
            "class_label": rng.integers(0, 8, (B,)).astype(np.int32),
            "audio": rng.standard_normal((B, 5, 32)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_step_with_grads(jldm, params, tx, batch, rng):
    """One jitted JAX train step with ``tx`` behind a transformation that
    passes the gradients on unchanged and keeps them: (new state, metrics,
    the gradients), the loss and gradients at the step's own draws
    (``fold_in(rng, 0)``). One compile gives what a gradient and a step
    would in two."""
    import optax

    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, params=None: (g, g))
    jtx = optax.chain(keep, tx)
    state = jts.create_train_state(jldm, params, jtx)
    state, metrics = jax.jit(jts.make_train_step(jldm, jtx))(
        state, _jb(batch), rng)
    return state, metrics, state.opt_state[0]


def _jax_draws(rng, timesteps=100):
    """t and noise exactly as ``training_loss`` draws them from ``rng``."""
    k_t, k_noise, *_ = jax.random.split(rng, 5)
    t = jax.random.randint(k_t, (B,), 0, timesteps)
    noise = jax.random.normal(k_noise, (B, 8, 8, 3), dtype=jnp.float32)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(noise)))


def _models(p_uncond):
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    cfg["model"]["params"]["cond_stage_config_1"]["params"]["p_uncond"] = \
        p_uncond
    jldm = jax_build_model(cfg["model"])
    params = jax.jit(jldm.init_params)(jax.random.PRNGKey(0), _jb(_batch(0)))
    # the JAX init zeroes every block-final conv: fill all weights
    params = random_params(params, np.random.default_rng(1))
    tldm = build_model(cfg["model"])
    tldm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    return jldm, params, tldm


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, atol, loose=(), loose_atol=None):
    """Every leaf within ``atol``. With ``loose_atol`` (the AdamW case, see
    the step test): the leaves named in ``loose`` are held to it instead, and
    in every other leaf at most one element in a thousand may exceed
    ``atol``, none ``loose_atol``."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        if loose_atol is None:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)
            continue
        diff = np.abs(got[k] - w)
        assert diff.max() <= loose_atol, (k, diff.max())
        if k not in loose:
            assert (diff > atol).mean() <= 1e-3, (k, (diff > atol).mean())


def _noise_leaves(grads):
    """Leaves whose gradient is mathematically zero and holds only rounding
    noise (below 1e-6 of the tree's largest): the bias ahead of a GroupNorm
    with one channel a group, which the norm removes."""
    leaves = _leaves(grads)
    top = max(np.abs(w).max() for w in leaves.values())
    return {k for k, w in leaves.items() if 0 < np.abs(w).max() < 1e-6 * top}


@pytest.fixture(scope="module", params=[0.0, 1.0],
                ids=["labels-kept", "labels-dropped"])
def both(request):
    return _models(request.param)


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["jnp-attention", "pallas-interpret"])
def test_training_loss_and_gradients_match_jax(both, interpret, monkeypatch):
    """Loss and every gradient leaf of one batch. With interpret mode the JAX
    side runs its packed forward and backward kernels (the production
    dispatch, custom VJP included) as its own tests run them on the CPU."""
    if interpret:
        monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    jldm, params, tldm = both
    batch, rng = _batch(2), jax.random.PRNGKey(5)
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jldm.training_loss(p, _jb(batch), rng), has_aux=True))(params)

    t, noise = _jax_draws(rng)
    tldm.configure_trainable()
    tldm.zero_grad(set_to_none=True)
    loss, aux = tldm.training_loss(_tb(batch), t=t, noise=noise)
    loss.backward()
    assert tldm.training and not tldm.first_stage.training
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5,
                               rtol=0)
    for k in want_aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), atol=1e-5,
                                   rtol=0)
    grads = {n: p.grad for n, p in tldm.named_parameters()
             if p.grad is not None}
    assert not any(n.startswith("first_stage") for n in grads)  # frozen
    got = to_jax_params(tldm, grads)
    # parameters the loss does not reach have no gradient here and an
    # all-zero one in JAX (q / k of the one-token cross-attention; the null
    # row's table when no label is dropped is inside a leaf that has one)
    want = {g: v for g, v in want_grads.items() if g != "first_stage"}
    want_l, got_l = _leaves(want), _leaves(got)
    for k in set(want_l) - set(got_l):
        assert not want_l[k].any(), k
    assert set(got_l) <= set(want_l) and len(got_l) > 100
    # a leaf of rounding noise (see _noise_leaves) is held to that floor
    top = max(np.abs(w).max() for w in want_l.values())
    assert 0 < len(_noise_leaves(want)) < 20
    for k, g in got_l.items():
        w = want_l[k]
        np.testing.assert_allclose(
            g, w, rtol=0, err_msg=k,
            atol=max(1e-4 * np.abs(w).max(), 1e-6 * top))


def test_label_drop_branches(both):
    """p_uncond = 1 puts the null row in every token, p_uncond = 0 never
    does; ``drop=`` overrides the draw; validation never drops."""
    _, _, tldm = both
    emb = tldm.cond["class_label"]
    labels = torch.tensor([1, 5, 2, 7])
    null = emb.null_token(4)
    kept = emb(labels)
    assert not torch.equal(kept, null)
    gen = torch.Generator().manual_seed(0)
    drawn = emb(labels, training=True, generator=gen)
    assert torch.equal(drawn, null if emb.p_uncond == 1.0 else kept)
    assert torch.equal(emb(labels, training=False, generator=gen), kept)
    if emb.p_uncond > 0:
        assert torch.equal(emb(labels, training=True,
                               drop=torch.tensor(False)), kept)
        assert torch.equal(emb(labels, training=True, drop=torch.tensor(True)),
                           null)


def test_trainable_filter_and_optimizer_membership(both):
    jldm, params, tldm = both
    assert tldm.trainable_filter() == jldm.trainable_filter(params)
    assert tldm.frozen_subpaths() == jldm.frozen_subpaths() == {}
    opt = tts.make_optimizer(tldm, base_lr=1e-4)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in tldm.named_parameters():
        frozen = name.startswith("first_stage")
        assert p.requires_grad == (not frozen), name
        assert (id(p) in in_opt) == (not frozen), name
    g = opt.param_groups[0]
    assert (g["betas"], g["eps"], g["weight_decay"]) == ((0.9, 0.999), 1e-8,
                                                         0.01)


class _InjectedDraws:
    """The port's loss with the JAX side's draws handed in, call by call."""

    supports_sample_weights = True

    def __init__(self, ldm, draws):
        self.ldm, self.draws, self.calls = ldm, draws, 0

    def training_loss(self, batch, generator=None, training=True):
        t, noise = self.draws[self.calls]
        self.calls += 1
        return self.ldm.training_loss(batch, generator, training=training,
                                      t=t, noise=noise)


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["no-accum", "accum-2"])
def test_train_steps_match_jax(both, grad_accum):
    """Three optimizer steps (3 x grad_accum micro-steps) under a warm-up /
    cosine LR schedule: parameters, EMA shadows, step counter and the
    metrics of every micro-step; then one eval step on the final state."""
    jldm, params, tldm = both
    tldm = copy.deepcopy(tldm)
    micro = 3 * grad_accum
    base_lr, rng = 1e-4, jax.random.PRNGKey(11)
    batches = [_batch(20 + i) for i in range(micro)]

    tx = jts.make_optimizer(jldm, params, base_lr, scheduler_config=SCHEDULER,
                            grad_accum=grad_accum)
    jstate = jts.create_train_state(jldm, params, tx)
    jstep = jax.jit(jts.make_train_step(jldm, tx))
    want_metrics = []
    for i in range(micro):
        jstate, m = jstep(jstate, _jb(batches[i]), rng)
        want_metrics.append({k: float(v) for k, v in m.items()})

    eval_rng = jax.random.PRNGKey(3)
    draws = [_jax_draws(jax.random.fold_in(rng, i)) for i in range(micro)]
    draws += [_jax_draws(eval_rng)] * 2     # eval: raw and EMA, same draws
    loss = _InjectedDraws(tldm, draws)
    opt = tts.make_optimizer(tldm, base_lr=base_lr)
    state = tts.create_train_state(tldm, opt, base_lr=base_lr,
                                   scheduler_config=SCHEDULER,
                                   grad_accum=grad_accum)
    step = tts.make_train_step(loss)
    for i in range(micro):
        m = step(state, _tb(batches[i]), seed=0)
        assert set(m) == set(want_metrics[i])
        for k, w in want_metrics[i].items():
            np.testing.assert_allclose(float(m[k]), w, atol=1e-5, rtol=0,
                                       err_msg=f"micro-step {i} {k}")
    assert state.step == int(jstate.step) == micro
    assert state.optimizer_steps == 3
    mult = jlr.build_lr_multiplier(SCHEDULER)
    for n in range(3):
        np.testing.assert_allclose(state.lr_at(n), base_lr * float(mult(n)),
                                   rtol=1e-5)
    assert opt.param_groups[0]["lr"] == state.lr_at(2)

    # AdamW divides a gradient by its own running size, so a weight whose
    # gradient is at the rounding floor moves by up to the learning rate a
    # step in a direction that is noise on both sides. The leaves that are
    # all noise are held to twice the summed learning rates; every other leaf
    # to 1e-5 in at least 999 of 1000 elements (a single weight of a healthy
    # leaf can have such a gradient), and to the loose bound in the rest
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
    # the frozen first stage did not move
    _assert_trees_close(to_jax_params(tldm)["first_stage"],
                        params["first_stage"], atol=0)
    moved = np.abs(_leaves(trainable)["['unet']['conv_in']['kernel']"]
                   - _leaves(params)["['unet']['conv_in']['kernel']"]).max()
    assert moved > 1e-4   # a comparison of parameters that stood still is none

    val_batch = _batch(40)
    want = jax.jit(jts.make_eval_step(jldm))(jstate, _jb(val_batch), eval_rng)
    got = tts.make_eval_step(loss)(state, _tb(val_batch), seed=0)
    assert set(got) == set(want) >= {"val_loss", "val_loss_ema"}
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert float(got["val_loss"]) != float(got["val_loss_ema"])
    assert not tldm.training   # the validation form: eval-mode routing


def test_eval_step_masks_padding_and_restores_raw_weights(both):
    _, _, tldm = both
    tldm = copy.deepcopy(tldm)
    opt = tts.make_optimizer(tldm, base_lr=1e-4)
    state = tts.create_train_state(tldm, opt, base_lr=1e-4)
    with torch.no_grad():
        for e in state.ema_params:
            e.mul_(0.5)
    before = [p.detach().clone() for p in state.params]
    eval_step = tts.make_eval_step(tldm)
    batch = _tb(_batch(50))
    full = eval_step(state, {k: v[:3] for k, v in batch.items()}, seed=4)
    padded = dict(batch)
    padded["_sample_weights"] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    # the same seed draws the same t / noise rows for the first three samples
    # only if the draw is per batch shape: hold the masked mean to itself
    masked = eval_step(state, padded, seed=4)
    again = eval_step(state, padded, seed=4)
    assert float(masked["val_loss"]) == float(again["val_loss"])
    assert np.isfinite(float(full["val_loss"]))
    assert float(masked["val_loss"]) != float(masked["val_loss_ema"])
    for p, b in zip(state.params, before):
        assert torch.equal(p, b)      # the EMA swap put the raw weights back


def test_train_state_round_trips_through_its_state_dict(both):
    _, _, tldm = both
    tldm = copy.deepcopy(tldm)
    opt = tts.make_optimizer(tldm, base_lr=1e-4)
    state = tts.create_train_state(tldm, opt, base_lr=1e-4)
    step = tts.make_train_step(tldm)
    step(state, _tb(_batch(60)), seed=1)
    step(state, _tb(_batch(61)), seed=1)
    saved = copy.deepcopy(state.state_dict())
    model = copy.deepcopy(tldm.state_dict())
    step(state, _tb(_batch(62)), seed=1)
    third = [p.detach().clone() for p in state.params]

    state.load_state_dict(saved)
    tldm.load_state_dict(model)
    assert state.step == 2
    step(state, _tb(_batch(62)), seed=1)
    for p, w in zip(state.params, third):
        assert torch.equal(p, w)      # same stream, same step: same bits
    assert tts.fold_seed(1, 2) != tts.fold_seed(2, 1)
