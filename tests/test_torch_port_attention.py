"""The port's attention ops against the JAX package's, on the CPU.

The plain PyTorch versions (``attention_reference``, ``fproj_reference``) are
what the wrappers run on a CPU tensor and what the CUDA kernels are held
against on the card. Here they are held against the JAX functions, with the
Pallas kernels run in interpret mode as the JAX package's own tests run them.
fp32: 1e-5 absolute (sums in another order). bf16: 2e-2 of the output's
maximum (bf16 keeps 8 bits; both sides round q / k / v, P and the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_hygiene import one_torch_thread  # noqa: F401


def _qkv(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk)]


@pytest.mark.parametrize("shape", [(2, 2, 128, 128, 16), (1, 3, 64, 192, 32),
                                   (2, 1, 100, 100, 64), (1, 2, 70, 33, 16)],
                         ids=["square", "long-kv", "ragged-q", "ragged-both"])
def test_attention_reference_matches_jax_flash(shape):
    q, k, v = _qkv(0, *shape)
    want_ref = np.asarray(jatt.attention_reference(*map(jnp.asarray, (q, k, v))))
    want_flash = np.asarray(jatt.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=64, interpret=True))
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_flash, atol=1e-5, rtol=0)


def test_attention_scale_argument():
    q, k, v = _qkv(1, 1, 2, 32, 32, 8)
    want = np.asarray(jatt.attention_reference(
        *map(jnp.asarray, (q, k, v)), scale=0.3))
    got = tatt.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                   scale=0.3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _fproj_inputs(seed, b, n, c, heads, d):
    rng = np.random.default_rng(seed)
    hd = heads * d
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(h=r(b, n, c), wq=r(c, hd) / np.sqrt(c), wk=r(c, hd) / np.sqrt(c),
                wv=r(c, hd) / np.sqrt(c), wo=r(hd, c) / np.sqrt(hd),
                bo=0.1 * r(c))


def _fproj_both(x, heads, dtype_j, dtype_t, interpret=True):
    """(JAX result, port result) as float32 numpy. JAX weights are [in, out];
    the port takes torch.nn.Linear's [out, in]."""
    j = {k: jnp.asarray(v).astype(dtype_j) for k, v in x.items()}
    if interpret:
        want = jatt.flash_attention_fproj(
            j["h"], j["wq"], j["wk"], j["wv"], j["wo"], j["bo"], heads,
            block_q=64, interpret=True)
    else:
        d = x["wq"].shape[1] // heads
        want = jatt._fproj_reference(
            j["h"], j["wq"], j["wk"], j["wv"], j["wo"], j["bo"], heads=heads,
            scale=d ** -0.5)
    t = lambda k, tr=False: torch.from_numpy(
        np.ascontiguousarray(x[k].T if tr else x[k])).to(dtype_t)
    got = tatt.flash_attention_fproj(
        t("h"), t("wq", True), t("wk", True), t("wv", True), t("wo", True),
        t("bo"), heads)
    return (np.asarray(want.astype(jnp.float32)), got.float().numpy())


@pytest.mark.parametrize("shape", [(2, 64, 32, 2, 16), (1, 128, 48, 3, 16),
                                   (2, 100, 32, 4, 8)],
                         ids=["one-block", "two-blocks", "ragged"])
@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas-interpret", "composed"])
def test_fproj_reference_matches_jax_fp32(shape, interpret):
    b, n, c, heads, d = shape
    want, got = _fproj_both(_fproj_inputs(2, b, n, c, heads, d), heads,
                            jnp.float32, torch.float32, interpret)
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fproj_reference_matches_jax_bf16():
    want, got = _fproj_both(_fproj_inputs(3, 2, 64, 32, 2, 16), 2,
                            jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(),
                               rtol=0)


def test_attention_reference_matches_jax_bf16():
    q, k, v = _qkv(4, 2, 2, 64, 64, 16)
    want = np.asarray(jatt.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        block_q=64, interpret=True).astype(jnp.float32))
    got = tatt.flash_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v))).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(),
                               rtol=0)


def test_fproj_casts_between_stages():
    """q, k, v and the attention output are rounded to the activation type
    between the stages, as the TPU kernel rounds them: in bf16 the result
    must differ from an fp32 evaluation rounded once at the end."""
    x = _fproj_inputs(5, 1, 64, 32, 2, 16)
    t = lambda k, tr=False: torch.from_numpy(
        np.ascontiguousarray(x[k].T if tr else x[k]))
    args = [t("h"), t("wq", True), t("wk", True), t("wv", True),
            t("wo", True), t("bo")]
    staged = tatt.fproj_reference(*(a.bfloat16() for a in args), 2).float()
    once = tatt.fproj_reference(
        *(a.bfloat16().float() for a in args), 2).bfloat16().float()
    assert not torch.equal(staged, once)
    assert (staged - once).abs().max() < 2e-2 * once.abs().max()


def test_cpu_wrappers_count_no_launch_and_check_shapes():
    tatt.reset_launches()
    q, k, v = map(torch.from_numpy, _qkv(6, 1, 1, 16, 16, 8))
    tatt.flash_attention(q, k, v)
    assert set(tatt.LAUNCHES) == {
        "flash_attention", "flash_attention_fproj", "flash_attention_packed",
        "flash_attention_qout", "flash_attention_bwd",
        "flash_attention_bwd_packed", "flash_attention_streaming",
        "flash_attention_streaming_bwd", "group_norm_silu",
        "gn_channel_stats", "conv_stats"}
    assert not any(tatt.LAUNCHES.values())
    with pytest.raises(ValueError):
        tatt.flash_attention(q, k[:, :, :8], v)
    with pytest.raises(ValueError):
        tatt.flash_attention_fproj(torch.zeros(1, 8, 16), torch.zeros(16, 16),
                                   torch.zeros(16, 16), torch.zeros(16, 16),
                                   torch.zeros(16, 8), torch.zeros(16), 2)


@pytest.mark.parametrize("c,d,dtype,takes", [
    (320, 32, torch.bfloat16, True), (640, 32, torch.bfloat16, True),
    (128, 64, torch.bfloat16, True), (320, 32, torch.float32, True),
    (48, 16, torch.bfloat16, False), (336, 32, torch.bfloat16, False)])
def test_fproj_kernel_takes(c, d, dtype, takes):
    assert tatt.fproj_kernel_takes(c, d, dtype) is takes


# --------------------------------------------------------------------------
# packed attention and the q/out-fused op
# --------------------------------------------------------------------------

def _packed_inputs(seed, b, nq, nk, heads, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, heads * d)).astype(np.float32)
            for n in (nq, nk, nk)]


@pytest.mark.parametrize("shape", [(2, 300, 300, 5, 32), (1, 100, 37, 4, 8),
                                   (2, 64, 64, 3, 64)],
                         ids=["five-heads-ragged", "cross-nk-ne-nq",
                              "64-wide-heads"])
def test_packed_reference_matches_jax_packed_fp32(shape):
    """Against the Pallas packed kernel in interpret mode, as the JAX
    package's own test runs it. fp32: 2e-5 (its tolerance there; the same
    sums in another order)."""
    *_, heads, _ = shape
    q, k, v = _packed_inputs(7, *shape)
    want = np.asarray(jatt.flash_attention_packed(
        *map(jnp.asarray, (q, k, v)), heads, block_q=128, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tatt.flash_attention_packed(tq, tk, tv, heads).numpy()
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # the dispatch gives the same on the CPU, and equals the split-head op
    got_d = tatt.packed_multi_head_attention(tq, tk, tv, heads)
    assert torch.equal(got_d, torch.from_numpy(got))
    b, nq, nk, _, d = shape
    sp = lambda t, n: t.reshape(b, n, heads, d).permute(0, 2, 1, 3)
    split = tatt.flash_attention(sp(tq, nq), sp(tk, nk), sp(tv, nk))
    np.testing.assert_allclose(
        got, split.permute(0, 2, 1, 3).reshape(b, nq, heads * d).numpy(),
        atol=1e-6, rtol=0)


def test_packed_dispatch_matches_jax_dispatch():
    q, k, v = _packed_inputs(8, 2, 128, 128, 2, 16)
    want = np.asarray(jatt.packed_multi_head_attention(
        *map(jnp.asarray, (q, k, v)), 2, use_pallas=True, interpret=True))
    got = tatt.packed_multi_head_attention(
        *map(torch.from_numpy, (q, k, v)), 2).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_packed_reference_matches_jax_bf16():
    q, k, v = _packed_inputs(9, 2, 64, 64, 2, 16)
    want = np.asarray(jatt.flash_attention_packed(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), 2,
        block_q=64, interpret=True).astype(jnp.float32))
    got = tatt.flash_attention_packed(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)


def _qout_inputs(seed, b, n, nk, c, heads, d):
    rng = np.random.default_rng(seed)
    hd = heads * d
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(h=0.3 * r(b, n, c), k=0.3 * r(b, nk, hd), v=0.3 * r(b, nk, hd),
                wq=r(c, hd) / np.sqrt(c), wo=r(hd, c) / np.sqrt(hd),
                bo=0.1 * r(c))


def _qout_both(x, heads, dtype_j, dtype_t, interpret, dispatch=False):
    """(JAX result, port result) as float32 numpy; JAX weights are [in, out],
    the port's [out, in]."""
    j = {k: jnp.asarray(v).astype(dtype_j) for k, v in x.items()}
    d = x["k"].shape[-1] // heads
    if interpret:
        want = jatt.flash_attention_qout(
            j["h"], j["k"], j["v"], j["wq"], j["wo"], j["bo"], heads,
            block_q=128, interpret=True)
    else:
        want = jatt._qout_reference(
            j["h"], j["k"], j["v"], j["wq"], j["wo"], j["bo"], heads=heads,
            scale=d ** -0.5)
    t = lambda k, tr=False: torch.from_numpy(
        np.ascontiguousarray(x[k].T if tr else x[k])).to(dtype_t)
    fn = tatt.fused_qout_self_attention if dispatch else tatt.flash_attention_qout
    got = fn(t("h"), t("k"), t("v"), t("wq", True), t("wo", True), t("bo"),
             heads)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("shape", [(2, 256, 256, 64, 2, 32),
                                   (1, 100, 100, 48, 3, 16),
                                   (2, 70, 33, 32, 4, 8)],
                         ids=["two-blocks", "ragged", "nk-ne-n"])
@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas-interpret", "composed"])
def test_qout_reference_matches_jax_fp32(shape, interpret):
    """fp32: 2e-5, the JAX package's own tolerance for this kernel."""
    b, n, nk, c, heads, d = shape
    want, got = _qout_both(_qout_inputs(10, *shape), heads, jnp.float32,
                           torch.float32, interpret)
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_qout_dispatch_and_bf16_match_jax():
    x = _qout_inputs(11, 2, 64, 64, 32, 2, 16)
    want, got = _qout_both(x, 2, jnp.float32, torch.float32, True,
                           dispatch=True)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    want, got = _qout_both(x, 2, jnp.bfloat16, torch.bfloat16, True)
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(),
                               rtol=0)


def test_qout_casts_between_stages():
    """q and the attention output are rounded to k's type between the
    stages, as the TPU kernel rounds them."""
    x = _qout_inputs(12, 1, 64, 64, 32, 2, 16)
    t = lambda k, tr=False: torch.from_numpy(
        np.ascontiguousarray(x[k].T if tr else x[k]))
    args = [t("h"), t("k"), t("v"), t("wq", True), t("wo", True), t("bo")]
    staged = tatt.qout_reference(*(a.bfloat16() for a in args), 2).float()
    once = tatt.qout_reference(
        *(a.bfloat16().float() for a in args), 2).bfloat16().float()
    assert not torch.equal(staged, once)
    assert (staged - once).abs().max() < 2e-2 * once.abs().max()


def test_new_cpu_wrappers_check_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):
        tatt.flash_attention_packed(z(1, 8, 16), z(1, 8, 32), z(1, 8, 32), 2)
    with pytest.raises(ValueError):
        tatt.flash_attention_packed(z(1, 8, 15), z(1, 8, 15), z(1, 8, 15), 2)
    with pytest.raises(ValueError):
        tatt.flash_attention_qout(z(1, 8, 16), z(1, 8, 32), z(1, 8, 32),
                                  z(32, 8), z(16, 32), z(16), 2)


@pytest.mark.parametrize("c,hd,d,dtype,takes", [
    (160, 160, 32, torch.bfloat16, True), (640, 640, 32, torch.bfloat16, True),
    (160, 160, 80, torch.bfloat16, True),      # -fullattn-dh64, level 0
    (240, 240, 80, torch.bfloat16, True),      # H*D % 32 == 16: 3 heads of 80
    (80, 80, 80, torch.bfloat16, True),        # one head of 80
    (640, 640, 64, torch.bfloat16, True), (1280, 1280, 32, torch.bfloat16, True),
    (1280, 1280, 64, torch.bfloat16, False),   # tiles beyond shared memory
    (2560, 2560, 32, torch.bfloat16, False),
    (160, 160, 32, torch.float32, False), (168, 160, 32, torch.bfloat16, False),
    (48, 48, 16, torch.bfloat16, False)])
def test_qout_kernel_takes(c, hd, d, dtype, takes):
    assert tatt.qout_kernel_takes(c, hd, d, dtype) is takes


@pytest.mark.parametrize("d,dtype,takes", [
    (32, torch.bfloat16, True), (64, torch.bfloat16, True),
    (16, torch.bfloat16, False), (32, torch.float32, True)])
def test_packed_kernel_takes(d, dtype, takes):
    assert tatt.packed_kernel_takes(d, dtype) is takes
