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
    assert tatt.LAUNCHES == {"flash_attention": 0, "flash_attention_fproj": 0}
    with pytest.raises(ValueError):
        tatt.flash_attention(q, k[:, :, :8], v)
    with pytest.raises(ValueError):
        tatt.flash_attention_fproj(torch.zeros(1, 8, 16), torch.zeros(16, 16),
                                   torch.zeros(16, 16), torch.zeros(16, 16),
                                   torch.zeros(16, 8), torch.zeros(16), 2)


@pytest.mark.parametrize("c,d,dtype,takes", [
    (320, 32, torch.bfloat16, True), (640, 32, torch.bfloat16, True),
    (128, 64, torch.bfloat16, True), (320, 32, torch.float32, False),
    (48, 16, torch.bfloat16, False), (336, 32, torch.bfloat16, False)])
def test_fproj_kernel_takes(c, d, dtype, takes):
    assert tatt.fproj_kernel_takes(c, d, dtype) is takes
