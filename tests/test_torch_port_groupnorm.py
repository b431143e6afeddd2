"""The port's GroupNorm ops against the JAX package's, on the CPU.

The plain PyTorch versions (``group_norm_silu_reference``,
``gn_channel_stats_reference``, ``group_norm_silu_from_stats``) are what the
wrappers run on a CPU tensor and what the CUDA kernels are held against on
the card. Here they are held against the JAX reference and against the two
Pallas kernels in interpret mode, as the JAX package's own tests run them.
fp32: 1e-4 for the whole-row kernel and 2e-4 for the statistics path (the
JAX package's own tolerances: sums in another order, then a division by a
small standard deviation). bf16: 2e-2 of the output's maximum (one rounding
of the output on each side, of values a few units large).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import groupnorm as jgn
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from dsml_thesis_tpu_torch.ops._launch import LAUNCHES, reset_launches
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


def _inputs(seed, shape, mean=1.0, std=3.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * std + mean).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


SHAPES = [((2, 8, 8, 160), 32), ((2, 16, 320), 32), ((1, 4, 4, 128), 32),
          ((3, 100, 64), 32)]
IDS = ["nhwc-cg5", "tokens-cg10", "cg4", "ragged-cg2"]


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", SHAPES, ids=IDS)
def test_group_norm_reference_matches_jax_fp32(shape, groups, eps, silu):
    x, gamma, beta = _inputs(0, shape)
    jargs = tuple(map(jnp.asarray, (x, gamma, beta)))
    kw = dict(num_groups=groups, eps=eps, silu=silu)
    want_ref = np.asarray(jgn.group_norm_silu_reference(*jargs, **kw))
    want_kernel = np.asarray(jgn.group_norm_silu_pallas(*jargs, interpret=True,
                                                        **kw))
    targs = tuple(map(torch.from_numpy, (x, gamma, beta)))
    got = tgn.group_norm_silu_reference(*targs, **kw).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want_ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want_kernel, atol=1e-4, rtol=1e-4)
    # on the CPU the kernel's wrapper is its plain version, bit for bit
    assert torch.equal(tgn.group_norm_silu_kernel(*targs, **kw),
                       torch.from_numpy(got))


@pytest.mark.parametrize("shape", [(2, 64, 160), (3, 100, 64), (1, 4097, 32)],
                         ids=["cg5", "ragged", "two-spatial-blocks"])
def test_channel_stats_match_jax_pallas(shape):
    """Sums of up to 4097 values a few units large: 1e-3 absolute on sums of
    the order of 1e3 to 1e5 is fp32 rounding in another order."""
    x, _, _ = _inputs(1, shape)
    want_sum, want_sq = (np.asarray(a) for a in jgn._gn_channel_stats_pallas(
        jnp.asarray(x), interpret=True))
    got_sum, got_sq = (t.numpy() for t in tgn.gn_channel_stats(
        torch.from_numpy(x)))
    assert got_sum.shape == got_sq.shape == (shape[0], shape[2])
    assert got_sum.dtype == np.float32
    np.testing.assert_allclose(got_sum, want_sum, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_sq, want_sq, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 160), 32),
                                          ((3, 100, 64), 32)],
                         ids=["nhwc-cg5", "ragged"])
def test_stats_fused_matches_jax(shape, groups):
    x, gamma, beta = _inputs(2, shape, mean=0.5, std=2.0)
    jargs = tuple(map(jnp.asarray, (x, gamma, beta)))
    want = np.asarray(jgn.group_norm_silu_stats_fused(
        *jargs, num_groups=groups, interpret=True))
    want_ref = np.asarray(jgn.group_norm_silu_reference(*jargs,
                                                        num_groups=groups))
    targs = tuple(map(torch.from_numpy, (x, gamma, beta)))
    got = tgn.group_norm_silu_stats_fused(*targs, num_groups=groups).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, want_ref, atol=2e-4, rtol=2e-4)


def test_from_stats_matches_jax_on_given_sums():
    x, gamma, beta = _inputs(3, (2, 50, 96))
    ch_sum, ch_sq = x.sum(1), (x * x).sum(1)
    want = np.asarray(jgn.group_norm_silu_from_stats(
        *map(jnp.asarray, (x, ch_sum, ch_sq, gamma, beta)), num_groups=32,
        eps=1e-6, silu=False))
    got = tgn.group_norm_silu_from_stats(
        *map(torch.from_numpy, (x, ch_sum, ch_sq, gamma, beta)), num_groups=32,
        eps=1e-6, silu=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fn", ["group_norm_silu_reference",
                                "group_norm_silu_kernel",
                                "group_norm_silu_stats_fused"])
def test_group_norm_bf16_matches_jax(fn):
    """bf16 in and out, fp32 gamma / beta and statistics, C/G = 5."""
    x, gamma, beta = _inputs(4, (2, 8, 8, 160))
    want = np.asarray(jgn.group_norm_silu_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(gamma),
        jnp.asarray(beta), interpret=True).astype(jnp.float32))
    got = getattr(tgn, fn)(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("fn", ["group_norm_silu_reference",
                                "group_norm_silu_kernel",
                                "group_norm_silu_stats_fused"])
def test_group_norm_large_mean_is_finite(fn):
    """|mean| >> spread: E[x^2] - E[x]^2 cancels in fp32 and may go
    negative; the clamp keeps the root real, as in the JAX package."""
    rs = np.random.RandomState(0)
    x = (300.0 + 0.01 * rs.randn(2, 8, 8, 64)).astype(np.float32)
    gamma, beta = np.ones(64, np.float32), np.zeros(64, np.float32)
    want = np.asarray(jgn.group_norm_silu_reference(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32))
    got = getattr(tgn, fn)(*map(torch.from_numpy, (x, gamma, beta)), 32)
    assert np.isfinite(want).all()
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("mode,expect", [
    (None, "group_norm_silu_reference"), ("0", "group_norm_silu_reference"),
    ("1", "group_norm_silu_kernel"), ("stats", "group_norm_silu_stats_fused"),
    ("off", "group_norm_silu_reference")])
def test_dispatch_follows_the_flag(monkeypatch, mode, expect):
    """DSML_PALLAS_GN picks the function, as in the JAX package; every mode
    gives the JAX dispatch's result on the CPU."""
    if mode is None:
        monkeypatch.delenv("DSML_PALLAS_GN", raising=False)
    else:
        monkeypatch.setenv("DSML_PALLAS_GN", mode)
    called = []
    for name in ("group_norm_silu_reference", "group_norm_silu_kernel",
                 "group_norm_silu_stats_fused"):
        real = getattr(tgn, name)
        monkeypatch.setattr(
            tgn, name, lambda *a, _n=name, _f=real, **k: (called.append(_n),
                                                          _f(*a, **k))[1])
    x, gamma, beta = _inputs(5, (2, 6, 6, 64))
    got = tgn.group_norm_silu(*map(torch.from_numpy, (x, gamma, beta)),
                              eps=1e-6, silu=False).numpy()
    assert called[0] == expect
    want = np.asarray(jgn.group_norm_silu(
        *map(jnp.asarray, (x, gamma, beta)), eps=1e-6, silu=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_dispatch_refuses_an_unknown_mode(monkeypatch):
    monkeypatch.setenv("DSML_PALLAS_GN", "fast")
    with pytest.raises(ValueError):
        tgn.group_norm_silu(torch.zeros(1, 4, 32), torch.ones(32),
                            torch.zeros(32))


def test_cpu_wrappers_count_no_launch_and_check_shapes():
    reset_launches()
    x = torch.randn(2, 10, 64)
    tgn.group_norm_silu_kernel(x, torch.ones(64), torch.zeros(64))
    tgn.gn_channel_stats(x)
    assert not any(LAUNCHES.values())
    with pytest.raises(ValueError):
        tgn.group_norm_silu_kernel(torch.zeros(1, 4, 48), torch.ones(48),
                                   torch.zeros(48))           # 48 % 32
    with pytest.raises(ValueError):
        tgn.group_norm_silu_kernel(x, torch.ones(32), torch.zeros(64))
    with pytest.raises(ValueError):
        tgn.gn_channel_stats(torch.zeros(2, 4, 4, 64))


@pytest.mark.parametrize("n,c,chunks", [
    (4096, 160, 41), (65536, 128, 512), (256, 1280, 22), (5, 2080, 1),
    (1, 32, 1)])
def test_gn_chunks(n, c, chunks):
    """The cut of a batch row into blocks: about 16,384 elements each, at
    least one row, never more chunks than rows."""
    got = tgn.gn_chunks(n, c)
    assert got == chunks
    assert 1 <= got <= n
