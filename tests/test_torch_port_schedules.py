"""Schedules and the DDIM step of the port against the JAX package (1e-6:
both compute the tables in float64 numpy and keep them in float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.diffusion import ddim as jddim
from dsml_thesis_tpu.diffusion import schedules as jsch
from dsml_thesis_tpu_torch.diffusion import ddim as tddim
from dsml_thesis_tpu_torch.diffusion import schedules as tsch
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedule(kind):
    np.testing.assert_array_equal(
        tsch.make_beta_schedule(kind, 100, 0.0015, 0.0205),
        jsch.make_beta_schedule(kind, 100, 0.0015, 0.0205))
    with pytest.raises(ValueError):
        tsch.make_beta_schedule("nope", 10)


def test_make_schedule_fields():
    kw = dict(timesteps=1000, linear_start=0.0015, linear_end=0.0205)
    t, j = tsch.make_schedule(**kw), jsch.make_schedule(**kw)
    assert t.num_timesteps == j.num_timesteps == 1000
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=1e-6,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("method,steps,total", [("uniform", 50, 1000),
                                                ("uniform", 4, 100),
                                                ("uniform", 3, 100),
                                                ("quad", 20, 1000)])
def test_ddim_timesteps(method, steps, total):
    np.testing.assert_array_equal(
        tsch.make_ddim_timesteps(method, steps, total),
        jsch.make_ddim_timesteps(method, steps, total))


@pytest.mark.parametrize("steps,eta", [(50, 0.0), (50, 0.5), (7, 1.0)])
def test_ddim_schedule(steps, eta):
    kw = dict(timesteps=1000, linear_start=0.0015, linear_end=0.0205)
    t = tsch.make_ddim_schedule(tsch.make_schedule(**kw), steps, eta=eta)
    j = jsch.make_ddim_schedule(jsch.make_schedule(**kw), steps, eta=eta)
    assert t.num_steps == j.num_steps
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    for name in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_extract():
    a = np.linspace(0, 1, 10).astype(np.float32)
    t = np.array([0, 3, 9])
    got = tsch.extract(torch.from_numpy(a), torch.from_numpy(t), 4)
    want = jsch.extract(jnp.asarray(a), jnp.asarray(t), 4)
    assert tuple(got.shape) == want.shape == (3, 1, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("index", [0, 2, 3])
@pytest.mark.parametrize("with_noise", [False, True])
def test_p_sample_ddim_step(index, with_noise):
    rng = np.random.default_rng(index)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32) * 0.5
    noise = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(timesteps=100, linear_start=0.0015, linear_end=0.0205)
    td = tsch.make_ddim_schedule(tsch.make_schedule(**kw), 4, eta=0.7)
    jd = jsch.make_ddim_schedule(jsch.make_schedule(**kw), 4, eta=0.7)
    # a model whose output depends on x and on t
    t_eps = lambda x, t: x @ torch.from_numpy(w) + 0.01 * t.float()[:, None, None, None]
    j_eps = lambda x, t: x @ jnp.asarray(w) + 0.01 * t.astype(jnp.float32)[:, None, None, None]
    got = tddim.p_sample_ddim(
        td, t_eps, torch.from_numpy(x), index,
        noise=torch.from_numpy(noise) if with_noise else None)
    want = jddim.p_sample_ddim(
        jd, j_eps, jnp.asarray(x), index,
        noise=jnp.asarray(noise) if with_noise else None)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_cfg_eps_fn(scale):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    c = rng.standard_normal((2, 1, 1, 3)).astype(np.float32)
    u = rng.standard_normal((2, 1, 1, 3)).astype(np.float32)
    t_fn = tddim.cfg_eps_fn(lambda x, t, c: x * c["crossattn"],
                            {"crossattn": torch.from_numpy(c)},
                            {"crossattn": torch.from_numpy(u)}, scale)
    j_fn = jddim.cfg_eps_fn(lambda x, t, c: x * c["crossattn"],
                            {"crossattn": jnp.asarray(c)},
                            {"crossattn": jnp.asarray(u)}, scale)
    got = t_fn(torch.from_numpy(x), torch.zeros(2, dtype=torch.long))
    want = j_fn(jnp.asarray(x), jnp.zeros((2,), jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
