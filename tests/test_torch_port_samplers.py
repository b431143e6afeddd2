"""The port's sampler layer against the JAX package on the CPU, in fp32: the
DPM-Solver(++) suite, PLMS, ancestral DDPM, the DDIM functions and
split-input tiling, on the same numpy inputs.

The models are closed-form, shared by both sides, so no UNet is involved:
a smooth eps of (x, float t) for the DPM suite (its continuous timesteps),
and the ideal denoiser of one x0 where t is an integer. Random draws cannot
agree between ``torch.Generator`` and ``jax.random``, so every comparison
injects x_T, and where a JAX sampler draws per-step noise the test makes the
same ``jax.random`` draws itself and hands them to the port as its noise
sequence.

Tolerance: 1e-5 of each output's maximum (the two sides round the same
fp32 operations, some in another order or through another libm); the
adaptive solver's iteration count and convergence flag exactly; tiling
1e-5 absolute on outputs of order 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.diffusion import (ddim as jddim, dpm_solver as jdpm,
                                       gaussian as jgauss, plms as jplms,
                                       schedules as jsch, tiling as jtiling)
from dsml_thesis_tpu_torch.diffusion import (ddim as tddim, dpm_solver as tdpm,
                                             gaussian as tgauss, plms as tplms,
                                             schedules as tsch,
                                             tiling as ttiling)
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

SHAPE = (2, 4, 4, 3)
SCHED_KW = dict(linear_start=0.0015, linear_end=0.0205)


def _scheds(timesteps=1000):
    return (jsch.make_schedule("linear", timesteps, **SCHED_KW),
            tsch.make_schedule("linear", timesteps, **SCHED_KW))


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _smooth_eps_jax(x, t):
    return 0.3 * jnp.tanh(x) + 0.1 * jnp.sin(0.01 * t.reshape(-1, 1, 1, 1))


def _smooth_eps_torch(x, t):
    return 0.3 * torch.tanh(x) + 0.1 * torch.sin(0.01 * t.reshape(-1, 1, 1, 1))


def _oracles(jsched, tsched, x0):
    """The ideal denoiser of x0 (integer t) on both sides."""
    x0_j, x0_t = jnp.asarray(x0), torch.from_numpy(x0)

    def j(x, t):
        sa = jnp.take(jsched.sqrt_alphas_cumprod, t).reshape(-1, 1, 1, 1)
        sm = jnp.take(jsched.sqrt_one_minus_alphas_cumprod, t).reshape(-1, 1, 1, 1)
        return (x - sa * x0_j) / sm

    def t_(x, t):
        sa = tsched.sqrt_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        sm = tsched.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        return (x - sa * x0_t) / sm

    return j, t_


def _rand(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# interp and the continuous schedule
# --------------------------------------------------------------------------

def test_interp_matches_jnp_interp_at_knots_between_and_outside():
    xp = np.sort(np.random.default_rng(0).uniform(-2, 3, 40)).astype(np.float32)
    fp = np.random.default_rng(1).standard_normal(40).astype(np.float32)
    mids = (xp[:-1] + xp[1:]) / 2
    x = np.concatenate([xp, mids, [-10.0, xp[0] - 1e-3, xp[-1] + 1e-3, 9.0]]
                       ).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = tdpm.interp(torch.from_numpy(x), torch.from_numpy(xp),
                      torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(got[:40], fp)        # at the knots
    assert got[-4] == fp[0] and got[-1] == fp[-1]      # clamped ends
    one = tdpm.interp(torch.tensor(float(mids[3])), torch.from_numpy(xp),
                      torch.from_numpy(fp))
    assert one.dim() == 0 and abs(float(one) - float(want[43])) <= 2e-7


def test_vp_continuous_matches_jax():
    js, ts = _scheds()
    jvp, tvp = jdpm.make_vp_continuous(js), tdpm.make_vp_continuous(ts)
    np.testing.assert_array_equal(tvp.t_grid.numpy(), np.asarray(jvp.t_grid))
    np.testing.assert_array_equal(tvp.log_alpha.numpy(),
                                  np.asarray(jvp.log_alpha))
    t = np.concatenate([np.linspace(1e-3, 1.0, 37), [1e-3, 0.5, 1.0, 0.0005]]
                       ).astype(np.float32)
    for name in ("marginal_log_alpha", "marginal_alpha", "marginal_std",
                 "marginal_lambda", "model_input_time"):
        _close(getattr(tvp, name)(torch.from_numpy(t)),
               getattr(jvp, name)(jnp.asarray(t)))
    lam = np.linspace(-5.0, 8.0, 29).astype(np.float32)
    _close(tvp.inverse_lambda(torch.from_numpy(lam)),
           jvp.inverse_lambda(jnp.asarray(lam)))


# --------------------------------------------------------------------------
# the DPM-Solver suite
# --------------------------------------------------------------------------

SUITE_CASES = [
    # method, order, steps, predict_x0, solver_type, skip_type, extra
    ("multistep", 1, 6, True, "dpm_solver", "time_uniform", {}),
    ("multistep", 2, 10, True, "dpm_solver", "time_uniform",
     {"denoise_to_zero": True}),
    ("multistep", 3, 10, True, "dpm_solver", "time_uniform", {}),
    ("multistep", 3, 16, False, "dpm_solver", "time_uniform", {}),
    ("multistep", 2, 16, False, "taylor", "logSNR", {}),
    ("multistep", 3, 16, True, "taylor", "time_quadratic", {}),
    ("multistep", 3, 7, False, "dpm_solver", "time_quadratic",
     {"lower_order_final": False}),
    ("multistep", 3, 8, True, "dpm_solver", "logSNR",
     {"t_start": 0.8, "t_end": 0.05}),
    ("singlestep", 1, 5, True, "dpm_solver", "time_uniform", {}),
    ("singlestep", 2, 9, True, "dpm_solver", "time_uniform",
     {"denoise_to_zero": True}),
    ("singlestep", 3, 10, True, "dpm_solver", "logSNR", {}),
    ("singlestep", 3, 11, False, "taylor", "time_quadratic", {}),
    ("singlestep", 2, 8, False, "taylor", "logSNR",
     {"t_start": 0.9, "t_end": 0.01}),
    ("singlestep_fixed", 3, 9, False, "dpm_solver", "logSNR", {}),
    ("singlestep_fixed", 2, 8, True, "taylor", "time_quadratic", {}),
]


@pytest.mark.parametrize(
    "method,order,steps,predict_x0,solver_type,skip,extra", SUITE_CASES,
    ids=[f"{c[0]}-o{c[1]}-s{c[2]}-{'x0' if c[3] else 'eps'}-{c[4]}-{c[5]}"
         + "".join(f"-{k}" for k in c[6]) for c in SUITE_CASES])
def test_suite_matches_jax(method, order, steps, predict_x0, solver_type,
                           skip, extra):
    js, ts = _scheds()
    x_T = _rand(0)
    kw = dict(steps=steps, order=order, method=method, skip_type=skip,
              predict_x0=predict_x0, solver_type=solver_type, **extra)
    want = jax.jit(lambda x: jdpm.dpm_solver_sample_suite(
        js, _smooth_eps_jax, SHAPE, jax.random.PRNGKey(0), x_T=x, **kw))(
            jnp.asarray(x_T))
    calls = []

    def eps(x, t):
        calls.append(t)
        assert t.dtype == torch.float32   # continuous time, never rounded
        return _smooth_eps_torch(x, t)

    got = tdpm.dpm_solver_sample_suite(ts, eps, SHAPE,
                                       x_T=torch.from_numpy(x_T), **kw)
    _close(got, want)
    if method == "multistep":
        n = steps
    elif method == "singlestep":
        n = sum(tdpm._singlestep_orders(steps, order))
    else:
        n = order * (steps // order)
    assert len(calls) == n + bool(extra.get("denoise_to_zero"))


def test_multistep_orders_ramp_and_tail():
    assert tdpm._multistep_orders(10, 3, True) == [1, 2, 3, 3, 3, 3, 3, 3, 2, 1]
    assert tdpm._multistep_orders(16, 3, True) == [1, 2] + [3] * 14
    assert tdpm._multistep_orders(5, 2, False) == [1, 2, 2, 2, 2]
    for steps, order in ((6, 3), (7, 3), (8, 3), (7, 2), (4, 1)):
        assert tdpm._singlestep_orders(steps, order) == \
            jdpm._singlestep_orders(steps, order)


def test_generator_draws_the_initial_noise():
    _, ts = _scheds()
    run = lambda seed: tdpm.dpm_solver_sample_suite(
        ts, _smooth_eps_torch, SHAPE, torch.Generator().manual_seed(seed),
        steps=4)
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="Generator"):
        tdpm.dpm_solver_sample_suite(ts, _smooth_eps_torch, SHAPE, steps=4)


def test_model_output_is_taken_in_fp32():
    """A bf16 eps_fn does not round the fp32 update math."""
    _, ts = _scheds()
    x_T = torch.from_numpy(_rand(1))
    out = tdpm.dpm_solver_sample_suite(
        ts, lambda x, t: _smooth_eps_torch(x, t).bfloat16(), SHAPE, x_T=x_T,
        steps=5)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("order,predict_x0", [(2, True), (3, True), (3, False)])
def test_adaptive_matches_jax(order, predict_x0):
    js, ts = _scheds()
    x_T = _rand(2)
    want, info_j = jax.jit(lambda x: jdpm.dpm_solver_sample_adaptive(
        js, _smooth_eps_jax, SHAPE, jax.random.PRNGKey(0), order=order,
        predict_x0=predict_x0, x_T=x, return_info=True))(jnp.asarray(x_T))
    got, info_t = tdpm.dpm_solver_sample_adaptive(
        ts, _smooth_eps_torch, SHAPE, order=order, predict_x0=predict_x0,
        x_T=torch.from_numpy(x_T), return_info=True)
    assert info_t["iterations"] == int(info_j["iterations"]) > 2
    assert info_t["converged"] == bool(info_j["converged"]) is True
    _close(got, want)
    # the backstop: a partial integration, flagged
    part, info = tdpm.dpm_solver_sample_adaptive(
        ts, _smooth_eps_torch, SHAPE, order=order, x_T=torch.from_numpy(x_T),
        max_iters=2, return_info=True)
    assert info == {"converged": False, "iterations": 2}


@pytest.mark.parametrize("timesteps,steps", [(1000, 10), (1000, 25), (50, 80)],
                         ids=["s10", "s25", "degenerate-nodes"])
def test_2m_sampler_matches_jax(timesteps, steps):
    """dpm_solver_sample on the rounded DDPM timesteps; 80 steps on a
    50-step schedule repeats rounded nodes (h = 0), which both sides
    degrade to first order instead of dividing by zero."""
    js, ts = _scheds(timesteps)
    jd, td = jdpm.make_dpm_schedule(js, steps), tdpm.make_dpm_schedule(ts, steps)
    np.testing.assert_array_equal(td.timesteps.numpy(),
                                  np.asarray(jd.timesteps))
    for name in ("alphas", "sigmas", "lambdas"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    x_T = _rand(3)
    eps_j = lambda x, t: 0.3 * jnp.tanh(x) + 0.001 * t.reshape(-1, 1, 1, 1)
    eps_t = lambda x, t: 0.3 * torch.tanh(x) + 0.001 * t.reshape(-1, 1, 1, 1)
    want = jax.jit(lambda x: jdpm.dpm_solver_sample(
        jd, eps_j, SHAPE, jax.random.PRNGKey(0), x_T=x))(jnp.asarray(x_T))
    got = tdpm.dpm_solver_sample(td, eps_t, SHAPE, x_T=torch.from_numpy(x_T))
    _close(got, want)


BAD_SUITE_ARGS = [
    ({"order": 4}, "order must be 1, 2, or 3"),
    ({"solver_type": "dpmsolver"}, "solver_type"),
    ({"steps": 2, "order": 3, "method": "multistep"}, "steps >= order"),
    ({"t_end": 1e-4}, "outside the discrete schedule"),
    ({"t_start": 0.2, "t_end": 0.5}, "outside the discrete schedule"),
    ({"method": "onestep"}, "onestep"),
    ({"skip_type": "cubic"}, "cubic"),
]


@pytest.mark.parametrize("kw,match", BAD_SUITE_ARGS,
                         ids=[m for _, m in BAD_SUITE_ARGS])
def test_every_input_check_raises_on_both_sides(kw, match):
    js, ts = _scheds(50)
    args = {"steps": 6, **kw}
    with pytest.raises(ValueError, match=match):
        jdpm.dpm_solver_sample_suite(js, lambda x, t: 0.1 * x, (1, 4, 4, 3),
                                     jax.random.PRNGKey(0),
                                     x_T=jnp.zeros((1, 4, 4, 3)), **args)
    with pytest.raises(ValueError, match=match):
        tdpm.dpm_solver_sample_suite(ts, lambda x, t: 0.1 * x, (1, 4, 4, 3),
                                     x_T=torch.zeros(1, 4, 4, 3), **args)


def test_order_checks_outside_the_suite_raise_on_both_sides():
    js, ts = _scheds(50)
    for mod in (jdpm, tdpm):
        with pytest.raises(ValueError, match="order must be"):
            mod._singlestep_orders(6, 4)
    with pytest.raises(ValueError, match="order 2 or 3"):
        jdpm.dpm_solver_sample_adaptive(js, lambda x, t: 0.1 * x, (1, 2, 2, 1),
                                        jax.random.PRNGKey(0), order=1,
                                        x_T=jnp.zeros((1, 2, 2, 1)))
    with pytest.raises(ValueError, match="order 2 or 3"):
        tdpm.dpm_solver_sample_adaptive(ts, lambda x, t: 0.1 * x, (1, 2, 2, 1),
                                        order=1, x_T=torch.zeros(1, 2, 2, 1))


# --------------------------------------------------------------------------
# PLMS, DDPM and DDIM with the ideal denoiser
# --------------------------------------------------------------------------

def test_plms_matches_jax():
    js, ts = _scheds()
    jd, td = (jsch.make_ddim_schedule(js, 12, eta=0.0),
              tsch.make_ddim_schedule(ts, 12, eta=0.0))
    x0, x_T = _rand(4), _rand(5)
    oj, ot = _oracles(js, ts, x0)
    # a mild non-ideal term so that the multistep formulas differ
    eps_j = lambda x, t: oj(x, t) + 0.05 * jnp.tanh(x)
    calls = []
    eps_t = lambda x, t: calls.append(t) or (ot(x, t) + 0.05 * torch.tanh(x))
    want = jax.jit(lambda x: jplms.plms_sample(jd, eps_j, SHAPE,
                                               jax.random.PRNGKey(0), x_T=x))(
        jnp.asarray(x_T))
    got = tplms.plms_sample(td, eps_t, SHAPE, x_T=torch.from_numpy(x_T))
    _close(got, want)
    assert len(calls) == td.num_steps + 1   # step 0 evaluates twice
    noisy = tsch.make_ddim_schedule(ts, 12, eta=0.5)
    for fn, sch, x in ((jplms.plms_sample, jsch.make_ddim_schedule(
            js, 12, eta=0.5), jnp.asarray(x_T)),
                       (tplms.plms_sample, noisy, torch.from_numpy(x_T))):
        with pytest.raises(AssertionError, match="eta=0"):
            fn(sch, lambda x, t: x, SHAPE, None, x_T=x)


@pytest.mark.parametrize("clip", [True, False])
def test_ddpm_loop_matches_jax(clip):
    js, ts = _scheds(40)
    x0 = np.clip(_rand(6), -1, 1)
    x_T, seq = _rand(7), _rand(8, (40,) + SHAPE)
    oj, ot = _oracles(js, ts, x0)
    eps_j = lambda x, t: oj(x, t) + 0.2 * jnp.sin(x)
    calls = []
    eps_t = lambda x, t: calls.append(t) or (ot(x, t) + 0.2 * torch.sin(x))
    want = jax.jit(lambda x, n: jgauss.ddpm_p_sample_loop(
        js, eps_j, SHAPE, jax.random.PRNGKey(0), clip_denoised=clip, x_T=x,
        noise_seq=n))(jnp.asarray(x_T), jnp.asarray(seq))
    got = tgauss.ddpm_p_sample_loop(ts, eps_t, SHAPE, clip_denoised=clip,
                                    x_T=torch.from_numpy(x_T),
                                    noise_seq=torch.from_numpy(seq))
    _close(got, want)
    assert len(calls) == 40 and int(calls[0][0]) == 39 and int(calls[-1][0]) == 0


def _jax_ddim_draws(key, steps, shape, mask):
    """The noise ddim_sample draws from ``key`` with x_T given: per step the
    inpainting re-noise (with a mask), then the step noise."""
    q, n = [], []
    for _ in range(steps):
        if mask:
            key, kq = jax.random.split(key)
            q.append(np.asarray(jax.random.normal(kq, shape)))
        key, kn = jax.random.split(key)
        n.append(np.asarray(jax.random.normal(kn, shape, dtype=jnp.float32)))
    return (np.stack(q) if q else None), np.stack(n)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_ddim_sample_matches_jax(masked):
    """eta 0.5, temperature 0.7, an x0 hook, and (with the mask) the known
    half re-noised from x0 each step; the JAX side's own draws injected."""
    js, ts = _scheds()
    jd, td = (jsch.make_ddim_schedule(js, 8, eta=0.5),
              tsch.make_ddim_schedule(ts, 8, eta=0.5))
    x0, x_T = _rand(9), _rand(10)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :, :2] = 1.0
    oj, ot = _oracles(js, ts, 0.5 * x0)
    key = jax.random.PRNGKey(3)
    q, n = _jax_ddim_draws(key, 8, SHAPE, masked)
    kw_j = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0)) if masked else {}
    want = jax.jit(lambda x: jddim.ddim_sample(
        jd, js, oj, SHAPE, key, x_T=x, temperature=0.7,
        x0_postprocess=lambda p: jnp.clip(p, -1.5, 1.5), **kw_j))(
            jnp.asarray(x_T))
    kw_t = (dict(mask=torch.from_numpy(mask), x0=torch.from_numpy(x0),
                 mask_noise_seq=torch.from_numpy(q)) if masked else {})
    got = tddim.ddim_sample(td, ts, ot, SHAPE, x_T=torch.from_numpy(x_T),
                            temperature=0.7,
                            x0_postprocess=lambda p: p.clamp(-1.5, 1.5),
                            noise_seq=torch.from_numpy(n), **kw_t)
    _close(got, want)
    if masked:
        with pytest.raises(ValueError, match="requires x0"):
            tddim.ddim_sample(td, ts, ot, SHAPE, x_T=torch.from_numpy(x_T),
                              mask=torch.from_numpy(mask))


@pytest.mark.parametrize("log_every", [1, 3])
def test_ddim_sample_with_intermediates_matches_jax(log_every):
    js, ts = _scheds()
    jd, td = (jsch.make_ddim_schedule(js, 10), tsch.make_ddim_schedule(ts, 10))
    x0, x_T = _rand(11), _rand(12)
    oj, ot = _oracles(js, ts, x0)
    eps_j = lambda x, t: oj(x, t) + 0.1 * jnp.tanh(x)
    eps_t = lambda x, t: ot(x, t) + 0.1 * torch.tanh(x)
    want, traj_j = jax.jit(lambda x: jddim.ddim_sample_with_intermediates(
        jd, js, eps_j, SHAPE, jax.random.PRNGKey(0), x_T=x,
        log_every=log_every))(jnp.asarray(x_T))
    got, traj_t = tddim.ddim_sample_with_intermediates(
        td, ts, eps_t, SHAPE, x_T=torch.from_numpy(x_T), log_every=log_every)
    _close(got, want)
    assert traj_t.shape == traj_j.shape
    _close(traj_t, traj_j)


def test_ddim_invert_then_reverse_matches_jax():
    """Inversion, the deterministic reverse chain, the noisy one (the JAX
    side's fold_in draws injected), latent manipulation, on a strength
    schedule."""
    js, ts = _scheds()
    jd = jsch.make_ddim_schedule(js, 6, eta=1.0, strength=0.6)
    td = tsch.make_ddim_schedule(ts, 6, eta=1.0, strength=0.6)
    np.testing.assert_array_equal(td.timesteps.numpy(), np.asarray(jd.timesteps))
    np.testing.assert_allclose(td.sqrt_one_minus_alphas_prev.numpy(),
                               np.asarray(jd.sqrt_one_minus_alphas_prev),
                               rtol=0, atol=1e-7)
    x0 = _rand(13)
    oj, ot = _oracles(js, ts, 0.8 * x0)
    eps_j = lambda x, t: oj(x, t) + 0.1 * jnp.sin(x)
    eps_t = lambda x, t: ot(x, t) + 0.1 * torch.sin(x)
    oj2, ot2 = _oracles(js, ts, -0.5 * x0)

    lat_j = jax.jit(lambda x: jddim.ddim_invert(jd, eps_j, x))(jnp.asarray(x0))
    lat_t = tddim.ddim_invert(td, eps_t, torch.from_numpy(x0))
    _close(lat_t, lat_j)

    back_j = jax.jit(lambda x: jddim.ddim_reverse_from(jd, eps_j, x))(lat_j)
    back_t = tddim.ddim_reverse_from(td, eps_t, lat_t)
    _close(back_t, back_j)

    rng = jax.random.PRNGKey(5)
    seq = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i),
                                                 SHAPE, dtype=jnp.float32))
                    for i in range(6)])
    noisy_j = jax.jit(lambda x: jddim.ddim_reverse_from(jd, eps_j, x, rng))(
        lat_j)
    noisy_t = tddim.ddim_reverse_from(td, eps_t, lat_t,
                                      noise_seq=torch.from_numpy(seq))
    _close(noisy_t, noisy_j)

    edit_j, inv_j = jax.jit(lambda x: jddim.latent_manipulation(
        jd, eps_j, oj2, x))(jnp.asarray(x0))
    edit_t, inv_t = tddim.latent_manipulation(td, eps_t, ot2,
                                              torch.from_numpy(x0))
    _close(inv_t, inv_j)
    _close(edit_t, edit_j)


def test_stochastic_encode_matches_jax():
    js, ts = _scheds()
    jd, td = (jsch.make_ddim_schedule(js, 20), tsch.make_ddim_schedule(ts, 20))
    x0, noise = _rand(14), _rand(15)
    idx = np.array([3, 17], np.int32)
    want = jddim.stochastic_encode(jd, jnp.asarray(x0), jnp.asarray(idx),
                                   jnp.asarray(noise))
    got = tddim.stochastic_encode(td, torch.from_numpy(x0),
                                  torch.from_numpy(idx).long(),
                                  torch.from_numpy(noise))
    _close(got, want)
    _close(tddim.stochastic_encode(td, torch.from_numpy(x0), 7,
                                   torch.from_numpy(noise)),
           jddim.stochastic_encode(jd, jnp.asarray(x0), jnp.int32(7),
                                   jnp.asarray(noise)))


def test_gradient_through_ddim_reverse_from_matches_jax_grad():
    """ddim_reverse_from stays differentiable: the gradient of a loss of its
    output with respect to the starting latent and to a linear eps_fn's
    weights, against jax.grad of the same."""
    js, ts = _scheds()
    jd, td = (jsch.make_ddim_schedule(js, 5), tsch.make_ddim_schedule(ts, 5))
    x_lat, target = _rand(16), _rand(17)
    w = (0.3 * np.random.default_rng(18).standard_normal((3, 3))
         ).astype(np.float32)
    bias = np.float32(0.05)

    def loss_j(x, w):
        eps = lambda v, t: v @ w + bias * jnp.cos(0.01 * t).reshape(-1, 1, 1, 1)
        out = jddim.ddim_reverse_from(jd, eps, x)
        return jnp.sum((out - jnp.asarray(target)) ** 2)

    gx_j, gw_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(x_lat), jnp.asarray(w))
    x_t = torch.from_numpy(x_lat).requires_grad_(True)
    w_t = torch.from_numpy(w).requires_grad_(True)
    eps = lambda v, t: v @ w_t + bias * torch.cos(
        0.01 * t.float()).reshape(-1, 1, 1, 1)
    out = tddim.ddim_reverse_from(td, eps, x_t)
    ((out - torch.from_numpy(target)) ** 2).sum().backward()
    _close(x_t.grad, gx_j)
    _close(w_t.grad, gw_j)


# --------------------------------------------------------------------------
# tiling
# --------------------------------------------------------------------------

def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("ks,stride", [((4, 4), (2, 2)), ((5, 3), (3, 2)),
                                       ((8, 8), (8, 8))])
def test_unfold_fold_match_jax(ks, stride):
    x = _nhwc(0, (2, 9, 8, 3))
    p_j = jtiling.unfold(jnp.asarray(x), ks, stride)
    p_t = ttiling.unfold(torch.from_numpy(x), ks, stride)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(
        ttiling.fold(p_t, (9, 8), stride).numpy(),
        np.asarray(jtiling.fold(p_j, (9, 8), stride)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tie", [False, True])
def test_weighting_and_normalization_match_jax(tie):
    params = {"ks": [4, 6], "stride": [2, 3], "tie_braker": tie,
              "clip_min_weight": 0.05}
    np.testing.assert_array_equal(
        ttiling.tile_weighting((4, 6), 3, 4, params),
        jtiling.tile_weighting((4, 6), 3, 4, params))
    np.testing.assert_array_equal(
        ttiling.overlap_normalization((8, 15), (4, 6), (2, 3), params),
        jtiling.overlap_normalization((8, 15), (4, 6), (2, 3), params))


@pytest.mark.parametrize("uf,df", [(1, 1), (2, 1), (1, 2)])
def test_tiled_apply_matches_jax(uf, df):
    x = _nhwc(1, (2, 12, 10, 3))
    params = {"ks": [6, 4], "stride": [2, 2], "tie_braker": True}
    w = _nhwc(2, (3, 5)) * 0.5

    def fn_j(z, L):
        z = jnp.tanh(z @ jnp.asarray(w))
        if uf > 1:
            z = jnp.repeat(jnp.repeat(z, uf, axis=1), uf, axis=2)
        return z[:, ::df, ::df]

    def fn_t(z, L):
        z = torch.tanh(z @ torch.from_numpy(w))
        if uf > 1:
            z = z.repeat_interleave(uf, 1).repeat_interleave(uf, 2)
        return z[:, ::df, ::df]

    want = jtiling.tiled_apply(fn_j, jnp.asarray(x), params, uf=uf, df=df)
    got = ttiling.tiled_apply(fn_t, torch.from_numpy(x), params, uf=uf, df=df)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # an input smaller than a patch clamps the kernel to it: one patch
    small = _nhwc(3, (1, 4, 4, 3))
    np.testing.assert_allclose(
        ttiling.tiled_apply(fn_t, torch.from_numpy(small), params,
                            uf=uf, df=df).numpy(),
        np.asarray(jtiling.tiled_apply(fn_j, jnp.asarray(small), params,
                                       uf=uf, df=df)), rtol=0, atol=1e-5)
