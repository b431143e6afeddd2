"""The port's Gaussian-diffusion training math against the JAX package's, on
the CPU in fp32: the schedule's training quantities, ``q_sample``,
``predict_start_from_noise``, ``q_posterior``, ``get_loss`` and ``p_losses``
(both parameterizations, both loss types, with and without ``logvar`` and
``sample_weights``). Same numpy inputs through both; tolerance 1e-6 relative
to each result's maximum (elementwise fp32 arithmetic, means summed in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.diffusion import gaussian as jg
from dsml_thesis_tpu.diffusion.schedules import make_schedule as jax_schedule
from dsml_thesis_tpu_torch.diffusion import gaussian as tg
from dsml_thesis_tpu_torch.diffusion.schedules import make_schedule
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

KW = dict(beta_schedule="linear", timesteps=100, linear_start=0.0015,
          linear_end=0.0205)
FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights")


def _close(got, want, rel=1e-6):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _data(seed=0, b=6, shape=(8, 8, 3), timesteps=100):
    rng = np.random.default_rng(seed)
    r = lambda: rng.standard_normal((b,) + shape).astype(np.float32)
    return dict(x=r(), noise=r(), eps=r(),
                t=rng.integers(0, timesteps, (b,)).astype(np.int32),
                w=np.array([1, 1, 1, 1, 0, 0], np.float32),
                logvar=(0.1 * rng.standard_normal(timesteps)).astype(np.float32))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("kind", ["eps", "x0", "cosine-v0.3"])
def test_schedule_field_matches_jax(kind, field):
    kw = dict(KW)
    if kind == "x0":
        kw["parameterization"] = "x0"
    if kind.startswith("cosine"):
        kw.update(beta_schedule="cosine", v_posterior=0.3)
    _close(getattr(make_schedule(**kw), field),
           getattr(jax_schedule(**kw), field))


@pytest.mark.parametrize("fn", ["q_sample", "predict_start_from_noise"])
def test_pointwise_functions_match_jax(fn):
    d = _data(1)
    want = getattr(jg, fn)(jax_schedule(**KW), jnp.asarray(d["x"]),
                           jnp.asarray(d["t"]), jnp.asarray(d["noise"]))
    got = getattr(tg, fn)(make_schedule(**KW), torch.from_numpy(d["x"]),
                          torch.from_numpy(d["t"]), torch.from_numpy(d["noise"]))
    assert got.shape == want.shape
    _close(got, want)


def test_q_posterior_matches_jax():
    d = _data(2)
    want = jg.q_posterior(jax_schedule(**KW), jnp.asarray(d["x"]),
                          jnp.asarray(d["noise"]), jnp.asarray(d["t"]))
    got = tg.q_posterior(make_schedule(**KW), torch.from_numpy(d["x"]),
                         torch.from_numpy(d["noise"]), torch.from_numpy(d["t"]))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_get_loss_matches_jax(loss_type):
    d = _data(3)
    _close(tg.get_loss(torch.from_numpy(d["eps"]), torch.from_numpy(d["x"]),
                       loss_type),
           jg.get_loss(jnp.asarray(d["eps"]), jnp.asarray(d["x"]), loss_type))
    with pytest.raises(NotImplementedError):
        tg.get_loss(torch.zeros(1), torch.zeros(1), "huber")


@pytest.mark.parametrize("weights", [False, True], ids=["mean", "weighted"])
@pytest.mark.parametrize("logvar", [False, True], ids=["no-logvar", "logvar"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("param", ["eps", "x0"])
def test_p_losses_matches_jax(param, loss_type, logvar, weights):
    d = _data(4)
    kw = dict(parameterization=param, loss_type=loss_type,
              l_simple_weight=0.7, original_elbo_weight=0.3)
    skw = dict(KW, parameterization=param)
    want_loss, want_aux = jg.p_losses(
        jax_schedule(**skw), jnp.asarray(d["eps"]), jnp.asarray(d["x"]),
        jnp.asarray(d["noise"]), jnp.asarray(d["t"]),
        logvar=jnp.asarray(d["logvar"]) if logvar else None,
        sample_weights=jnp.asarray(d["w"]) if weights else None, **kw)
    got_loss, got_aux = tg.p_losses(
        make_schedule(**skw), torch.from_numpy(d["eps"]),
        torch.from_numpy(d["x"]), torch.from_numpy(d["noise"]),
        torch.from_numpy(d["t"]),
        logvar=torch.from_numpy(d["logvar"]) if logvar else None,
        sample_weights=torch.from_numpy(d["w"]) if weights else None, **kw)
    _close(got_loss, want_loss)
    assert set(got_aux) == set(want_aux) == {"loss_simple", "loss_vlb", "loss"}
    for k in want_aux:
        _close(got_aux[k], want_aux[k])


def test_p_losses_weights_mask_padding_rows():
    """Rows of weight 0 do not move the means: the weighted loss of a padded
    batch is the plain loss of its real rows."""
    d = _data(5)
    sched = make_schedule(**KW)
    t = lambda k: torch.from_numpy(d[k])
    padded, _ = tg.p_losses(sched, t("eps"), t("x"), t("noise"), t("t"),
                            sample_weights=t("w"))
    real, _ = tg.p_losses(sched, t("eps")[:4], t("x")[:4], t("noise")[:4],
                          t("t")[:4])
    _close(padded, real.numpy())
    with pytest.raises(NotImplementedError):
        tg.p_losses(sched, t("eps"), t("x"), t("noise"), t("t"),
                    parameterization="mu")


def test_p_losses_differentiates():
    d = _data(6)
    eps = torch.from_numpy(d["eps"]).requires_grad_()
    loss, _ = tg.p_losses(make_schedule(**KW), eps, torch.from_numpy(d["x"]),
                          torch.from_numpy(d["noise"]),
                          torch.from_numpy(d["t"]))
    loss.backward()
    want = 2 * (d["eps"] - d["noise"]) / d["eps"].size
    _close(eps.grad, want, rel=1e-5)
