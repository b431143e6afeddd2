"""The port's streaming attention against the JAX package's, on the CPU.

``streaming_attention_reference`` and ``streaming_bwd_reference`` are what the
wrappers run on a CPU tensor and what the CUDA kernels are held against on
the card. Here they are held against ``flash_attention_streaming`` and
``flash_attention_streaming_bwd`` of the JAX package, run in Pallas interpret
mode as its own tests run them (``tests/test_ops.py``), and the dispatch
``multi_head_attention`` and the models that call it against the JAX package
under ``DSML_FLASH_STREAMING`` with ``DSML_FLASH_INTERPRET=1``.

Tolerances. fp32: 2e-5 absolute, the JAX tests' own (sums in another order;
the online rescale across k-blocks against one whole-row softmax). bf16: 2e-2
of the output's maximum (bf16 keeps 8 bits; both sides round q times the
folded scale, P and the result, the JAX side per k-block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.models import autoencoder as jae
from dsml_thesis_tpu.models import unet as junet
from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.convert import from_jax_tree
from dsml_thesis_tpu_torch.models import autoencoder as tae
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_pipeline import random_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


def _qkv(seed, b, h, nq, nk, d, extra=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk) + (nq,) * extra]


SHAPES = {"square": (2, 3, 64, 64, 16), "ragged-kv": (2, 3, 64, 100, 16),
          "ragged-both": (1, 2, 70, 33, 16), "long-kv": (1, 2, 40, 200, 32),
          "one-key": (1, 1, 9, 1, 8)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_streaming_reference_matches_jax_streaming_fp32(name):
    q, k, v = _qkv(0, *SHAPES[name])
    want = np.asarray(jatt.flash_attention_streaming(
        *map(jnp.asarray, (q, k, v)), block_q=32, block_k=64, interpret=True))
    got = tatt.flash_attention_streaming(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), tatt.attention_reference(
            *map(torch.from_numpy, (q, k, v))).numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["square", "ragged-both"])
def test_streaming_reference_matches_jax_streaming_bf16(name):
    q, k, v = _qkv(1, *SHAPES[name])
    want = np.asarray(jatt.flash_attention_streaming(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        block_q=32, block_k=128, interpret=True).astype(jnp.float32))
    got = tatt.flash_attention_streaming(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)


def test_streaming_reference_rounds_where_the_kernel_rounds():
    """q times scale * log2(e) is rounded in q's type and the denominator
    sums the probabilities as cast to v's type: in bf16 both show against
    the resident kernel's plain version, in fp32 neither does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 2, 32, 48, 16))
    same = tatt.streaming_attention_reference(q, k, v)
    assert torch.allclose(same, tatt.attention_reference(q, k, v), atol=2e-6)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    # one whole-row block on the JAX side: the same roundings, so the same
    # values up to the order of fp32 sums (at most one bf16 step)
    want = jatt.flash_attention_streaming(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), block_q=32, block_k=128, interpret=True)
    got = tatt.streaming_attention_reference(q, k, v).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    assert np.mean(got == want) > 0.9


def test_streaming_extreme_scores_stay_finite():
    q, k, v = _qkv(3, 1, 1, 16, 24, 8)
    q, k = q * 200, k * 200
    got = tatt.flash_attention_streaming(*map(torch.from_numpy, (q, k, v)))
    assert bool(torch.isfinite(got).all())
    want = np.asarray(jatt.flash_attention_streaming(
        *map(jnp.asarray, (q, k, v)), block_q=8, block_k=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["square", "ragged-kv", "ragged-both",
                                  "long-kv"])
def test_streaming_bwd_reference_matches_jax_streaming_bwd_fp32(name):
    q, k, v, do = _qkv(4, *SHAPES[name], extra=1)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o = jatt.flash_attention_streaming(jq, jk, jv, block_q=32, block_k=64,
                                       interpret=True)
    want = jatt.flash_attention_streaming_bwd(jq, jk, jv, o, jdo, block_q=32,
                                              block_k=64, interpret=True)
    got = tatt.flash_attention_streaming_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=0)


def test_streaming_bwd_reference_matches_jax_streaming_bwd_bf16():
    q, k, v, do = _qkv(5, 2, 2, 64, 48, 32, extra=1)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    o = jatt.flash_attention_streaming(bf(q), bf(k), bf(v), block_q=32,
                                       block_k=128, interpret=True)
    want = jatt.flash_attention_streaming_bwd(
        bf(q), bf(k), bf(v), o, bf(do), block_q=32, block_k=128,
        interpret=True)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    got = tatt.flash_attention_streaming_bwd(
        tb(q), tb(k), tb(v),
        torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16(), tb(do))
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w_,
                                   atol=2e-2 * np.abs(w_).max(), rtol=0)


@pytest.mark.parametrize("name", ["square", "ragged-both"])
def test_streaming_gradient_through_autograd_matches_jax_grad(name):
    """The ``Function`` that pairs the two ops against ``jax.grad`` of the
    JAX package's custom VJP (streaming forward and streaming backward, both
    in interpret mode)."""
    q, k, v, do = _qkv(6, *SHAPES[name], extra=1)

    def loss(jq, jk, jv):
        out = jatt._streaming_attention_diff(jq, jk, jv, 0.2, 32, 64, True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tatt.flash_attention_streaming(*leaves, scale=0.2)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=0)


def test_streaming_auto_is_the_jax_fit_rule():
    """``streaming_auto`` against ``_fit_block_q(...) is None`` at the JAX
    package's default request, over a grid that crosses the boundary at every
    head width, ragged and tiny Nq included."""
    nqs = (1, 7, 8, 100, 333, 1024, 4096, 16384)
    nks = (1, 77, 4096, 8192, 8265, 8266, 16384, 61000, 62500, 114000,
           114700, 115000, 200000)
    checked = streams = 0
    for d in (32, 64, 512):
        for nq in nqs:
            for nk in nks:
                want = jatt._fit_block_q(nq, nk, d, 1024) is None
                assert tatt.streaming_auto(nq, nk, d) == want, (nq, nk, d)
                checked += 1
                streams += want
    assert 0 < streams < checked
    assert tatt.streaming_auto(16384, 16384, 512)       # a 512 px image
    assert not tatt.streaming_auto(4096, 4096, 512)     # the shipped configs


@pytest.mark.parametrize("mode,route", [
    ("1", "streaming"), ("0", "resident"), ("auto", "resident"),
    (None, "resident")])
def test_multi_head_attention_dispatch(monkeypatch, mode, route):
    calls = []
    for name, tag in (("flash_attention_streaming", "streaming"),
                      ("flash_attention", "resident")):
        real = getattr(tatt, name)
        monkeypatch.setattr(
            tatt, name,
            lambda *a, _t=tag, _f=real, **kw: (calls.append(_t),
                                               _f(*a, **kw))[1])
    if mode is None:
        monkeypatch.delenv("DSML_FLASH_STREAMING", raising=False)
    else:
        monkeypatch.setenv("DSML_FLASH_STREAMING", mode)
    q, k, v = map(torch.from_numpy, _qkv(7, 1, 2, 16, 24, 8))
    out = tatt.multi_head_attention(q, k, v)
    assert calls == [route]
    assert torch.allclose(out, tatt.attention_reference(q, k, v), atol=1e-5)


def test_multi_head_attention_auto_streams_past_the_fit(monkeypatch):
    calls = []
    monkeypatch.setattr(tatt, "streaming_auto", lambda nq, nk, d: nk > 20)
    real = tatt.flash_attention_streaming
    monkeypatch.setattr(tatt, "flash_attention_streaming",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    q, k, v = map(torch.from_numpy, _qkv(8, 1, 1, 8, 24, 8))
    monkeypatch.setenv("DSML_FLASH_STREAMING", "auto")
    tatt.multi_head_attention(q, k, v)
    monkeypatch.setenv("DSML_FLASH_STREAMING", "0")
    tatt.multi_head_attention(q, k, v)
    assert calls == [1]
    monkeypatch.setenv("DSML_FLASH_STREAMING", "maybe")
    with pytest.raises(ValueError):
        tatt.multi_head_attention(q, k, v)


def test_streaming_splits_cover_the_keys():
    for bh, nq, nk in ((1, 100, 5000), (8, 4096, 4096), (1, 64, 64),
                       (2, 333, 77), (1, 16384, 16384), (1, 1, 100000)):
        splits = tatt.streaming_splits(bh, nq, nk)
        tiles = -(-nk // 64)
        per = -(-tiles // splits)
        assert 1 <= splits <= tiles
        assert (splits - 1) * per < tiles <= splits * per   # none is empty
    assert tatt.streaming_splits(8, 4096, 4096) == 1
    assert tatt.streaming_splits(1, 100, 5000) == 79


def test_streaming_wrappers_check_shapes():
    q, k, v = map(torch.from_numpy, _qkv(9, 1, 1, 16, 16, 8))
    with pytest.raises(ValueError):
        tatt.flash_attention_streaming(q, k[:, :, :8], v)
    with pytest.raises(ValueError):
        tatt.flash_attention_streaming_bwd(q, k, v, q[:, :, :8], q)


# --------------------------------------------------------------------------
# the modules that call the dispatch, under DSML_FLASH_STREAMING=1
# --------------------------------------------------------------------------

def _spy_streaming(monkeypatch):
    calls = []
    real = tatt.flash_attention_streaming
    monkeypatch.setattr(tatt, "flash_attention_streaming",
                        lambda *a, **kw: (calls.append(a[0].shape),
                                          real(*a, **kw))[1])
    return calls


def test_unet_cross_attention_split_heads_streams(monkeypatch):
    """``DSML_ATTN_PACKED=0 DSML_FLASH_STREAMING=1``: the UNet's attention
    module goes through the streaming op, forward and gradient, as the JAX
    module does with its streaming kernels in interpret mode."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    g = rng.standard_normal((2, 48, 64)).astype(np.float32)
    jm = junet.CrossAttention(heads=2, dim_head=32)
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = tunet.CrossAttention(64, None, 2, 32)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)))
    monkeypatch.setenv("DSML_ATTN_PACKED", "0")
    monkeypatch.setenv("DSML_FLASH_STREAMING", "1")
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    calls = _spy_streaming(monkeypatch)

    want, vjp = jax.vjp(lambda xx: jm.apply({"params": params}, xx),
                        jnp.asarray(x))
    want_gx, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    got_gx, = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert calls == [(2, 2, 48, 32)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), atol=2e-5,
                               rtol=0)


def test_packed_unet_attention_stays_packed_under_streaming(monkeypatch):
    monkeypatch.setenv("DSML_FLASH_STREAMING", "1")
    calls = _spy_streaming(monkeypatch)
    tm = tunet.CrossAttention(64, None, 2, 32).train()
    tm(torch.zeros(1, 16, 64))
    assert calls == []


def test_first_stage_attn_block_streams(monkeypatch):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 5, 32)).astype(np.float32)
    jm = jae.AttnBlock()
    params = random_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = tae.AttnBlock(32)
    tm.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params)))
    monkeypatch.setenv("DSML_FLASH_STREAMING", "1")
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    calls = _spy_streaming(monkeypatch)
    want, _ = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert calls == [(2, 1, 30, 32)]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=2e-5, rtol=0)
