"""The port's UNet against the JAX package's on the CPU in fp32, weights
carried by ``from_jax_tree``. Tolerance 1e-4: the same sums in another order
through a few dozen layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu_torch.convert import from_jax_tree
from dsml_thesis_tpu_torch.models import unet as tunet
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

UNET_KW = dict(in_channels=9, model_channels=32, out_channels=3,
               num_res_blocks=1, attention_resolutions=(2, 1),
               channel_mult=(1, 2), num_head_channels=16,
               use_spatial_transformer=True, transformer_depth=1,
               context_dim=48)


def _inputs(seed=0, b=2, tokens=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 8, 8, 9)).astype(np.float32),
            np.array([3, 77][:b], np.int32),
            rng.standard_normal((b, tokens, 48)).astype(np.float32))


@pytest.fixture(scope="module")
def unets():
    jm = junet.UNetModel(**UNET_KW)
    x, t, ctx = _inputs()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(ctx))["params"]
    params = random_params(params, np.random.default_rng(1))
    tm = tunet.UNetModel(**UNET_KW)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("tokens", [1, 3], ids=["one-token", "three-tokens"])
def test_unet_forward_matches_jax(unets, tokens):
    """One context token takes the broadcast branch of cross-attention,
    three the packed branch; self-attention takes the fused op."""
    jm, params, tm = unets
    x, t, ctx = _inputs(2, tokens=tokens)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_unet_cfg_pairs_matches_jax_and_the_doubled_call(unets):
    jm, params, tm = unets
    x, t, _ = _inputs(3)
    rng = np.random.default_rng(4)
    pair = rng.standard_normal((4, 1, 48)).astype(np.float32)  # [uncond; cond]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(pair),
                               cfg_pairs=True))
    with torch.no_grad():
        tx, tt = torch.from_numpy(x), torch.from_numpy(t).long()
        got = tm(tx, tt, torch.from_numpy(pair), cfg_pairs=True)
        doubled = tm(torch.cat([tx, tx]), torch.cat([tt, tt]),
                     torch.from_numpy(pair))
    assert tuple(got.shape) == want.shape == (4, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the prefix computed once and tiled equals the prefix computed twice
    np.testing.assert_allclose(got.numpy(), doubled.numpy(), atol=1e-5, rtol=0)


def test_unet_train_mode_takes_the_composed_attention(unets):
    """The fused op is for eval-mode self-attention; in train mode the same
    function goes through projections + packed attention + to_out."""
    _, _, tm = unets
    x, t, ctx = map(torch.from_numpy, _inputs(5))
    with torch.no_grad():
        want = tm(x, t.long(), ctx)
        tm.train()
        try:
            got = tm(x, t.long(), ctx)
        finally:
            tm.eval()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_geglu_is_tanh_by_default(monkeypatch):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    jm = junet.GEGLUFeedForward()
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = tunet.GEGLUFeedForward(16)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        a, gate = tm.proj_in(torch.from_numpy(x)).chunk(2, dim=-1)
        erf = tm.proj_out(a * torch.nn.functional.gelu(gate)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - erf).max() > 1e-5  # PyTorch's default form differs
    monkeypatch.setenv("DSML_GELU_EXACT", "1")
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), erf,
                                   atol=1e-6, rtol=0)
    want_exact = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(erf, want_exact, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 500, 999], np.int32)
    want = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
    got = tunet.timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unet_bf16_compute_with_cast_params(unets):
    """The serving form: bf16 compute and weights cast once, against the JAX
    bf16 forward. The two frameworks round at other places (inside GELU and
    SiLU, after the norms), and a few dozen layers in series compound that:
    5e-2 of the output's maximum at the worst element, 1e-2 on average. A
    wrong cast (a norm in bf16, fp32 weights left uncast) is far outside."""
    from dsml_thesis_tpu.utils_io import cast_sampling_params as jcast
    from dsml_thesis_tpu_torch.utils_io import cast_sampling_params

    _, params, _ = unets
    jm = junet.UNetModel(dtype=jnp.bfloat16, **UNET_KW)
    tm = tunet.UNetModel(dtype="bfloat16", **UNET_KW)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)))
    tm = cast_sampling_params(tm).eval()
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    x, t, ctx = _inputs(7)
    want = np.asarray(jm.apply({"params": jcast(params)}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 torch.from_numpy(ctx))
    assert got.dtype == torch.float32  # the caller's type comes back
    top = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2 * top, rtol=0)
    assert np.abs(got.numpy() - want).mean() < 1e-2 * top


def test_dropout_is_refused():
    with pytest.raises(NotImplementedError):
        tunet.UNetModel(dropout=0.1, **UNET_KW)
