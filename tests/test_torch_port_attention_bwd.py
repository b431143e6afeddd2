"""Gradients of the port's attention and GroupNorm ops against the JAX
package's, on the CPU.

The plain backward versions (``flash_attention_bwd_reference``,
``packed_bwd_reference``) are what the two ``autograd.Function``s run on a CPU
tensor and what the CUDA backward kernels are held against on the card. Here
they, and the ``Function``s, are held against the JAX backward kernels
(``flash_attention_bwd`` / ``flash_attention_bwd_packed`` in Pallas interpret
mode) and against ``jax.grad`` through ``packed_multi_head_attention`` under
``DSML_FLASH_INTERPRET=1`` (the production dispatch with its custom VJP).

Tolerances: fp32 2e-5 absolute (sums in another order); bf16 2e-2 of each
gradient's maximum (both sides round q / k / v / do and the results to 8
bits, at different places). The fused-projection, q/out-fused and GroupNorm
wrappers differentiate their composed formula on both sides: 1e-4 of each
gradient's maximum in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu.ops import groupnorm as jgn
from dsml_thesis_tpu_torch.ops import attention as tatt
from dsml_thesis_tpu_torch.ops import groupnorm as tgn
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

# (batch, heads, Nq, Nk, D)
SHAPES = [(2, 2, 64, 64, 32), (1, 3, 100, 100, 32), (2, 2, 70, 33, 32),
          (1, 2, 96, 96, 64), (1, 1, 50, 130, 64)]
IDS = ["square-d32", "ragged-d32", "nk-differs-d32", "square-d64",
       "ragged-nk-differs-d64"]
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _inputs(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk, nq)]   # q, k, v, do


def _pack(a):
    b, h, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d))


def _close(got, want, bf16):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    tol = 2e-2 * np.abs(want).max() if bf16 else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _torch_grads(fn, arrays, do, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, torch.from_numpy(do).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_split_head_backward_matches_jax_kernel(shape, dtype):
    _, jdt, tdt = dtype
    q, k, v, do = _inputs(0, *shape)
    want = jatt.flash_attention_bwd(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v, do)), block_q=64,
        interpret=True)
    plain = tatt.flash_attention_bwd_reference(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)))
    through = _torch_grads(tatt.flash_attention, (q, k, v), do, tdt)
    for w, p, t in zip(want, plain, through):
        assert p.dtype == tdt and t.dtype == tdt
        _close(p.float().numpy(), w, jdt == jnp.bfloat16)
        # the Function's backward is the plain formula: the same bits
        assert torch.equal(p, t)


@pytest.mark.parametrize("dtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_packed_backward_matches_jax_kernel(shape, dtype):
    _, jdt, tdt = dtype
    heads = shape[1]
    q, k, v, do = map(_pack, _inputs(1, *shape))
    want = jatt.flash_attention_bwd_packed(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v, do)), heads,
        block_q=64, interpret=True)
    plain = tatt.packed_bwd_reference(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)), heads)
    through = _torch_grads(
        lambda *a: tatt.flash_attention_packed(*a, heads), (q, k, v), do, tdt)
    for w, p, t in zip(want, plain, through):
        assert p.shape == w.shape
        _close(p.float().numpy(), w, jdt == jnp.bfloat16)
        assert torch.equal(p, t)


@pytest.mark.parametrize("dtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[4:],
                         ids=IDS[:3] + IDS[4:])
def test_packed_dispatch_gradient_matches_jax_grad(shape, dtype, monkeypatch):
    """``jax.grad`` through the JAX dispatch (forward kernel, custom VJP,
    packed backward kernel, all in interpret mode) against autograd through
    the port's dispatch."""
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    _, jdt, tdt = dtype
    heads = shape[1]
    q, k, v, do = map(_pack, _inputs(2, *shape))
    jdo = jnp.asarray(do).astype(jdt)

    def loss(q_, k_, v_):
        out = jatt.packed_multi_head_attention(q_, k_, v_, heads)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    got = _torch_grads(
        lambda *a: tatt.packed_multi_head_attention(*a, heads), (q, k, v), do,
        tdt)
    for w, g in zip(want, got):
        _close(g.float().numpy(), w, jdt == jnp.bfloat16)


def test_backward_scale_argument_and_forward_values():
    """A scale other than 1/sqrt(D), and the Function's forward is still the
    plain forward."""
    q, k, v, do = _inputs(3, 1, 2, 40, 24, 32)
    want = jatt.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)),
                                    scale=0.3, interpret=True)
    got = _torch_grads(lambda *a: tatt.flash_attention(*a, scale=0.3),
                       (q, k, v), do, torch.float32)
    for w, g in zip(want, got):
        _close(g.numpy(), w, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert torch.equal(tatt.flash_attention(tq, tk, tv, scale=0.3),
                       tatt.attention_reference(tq, tk, tv, scale=0.3))


def test_function_takes_a_non_contiguous_upstream_gradient():
    """Autograd may hand the backward an expanded gradient (``sum()``)."""
    q, k, v, _ = _inputs(4, 1, 2, 16, 16, 32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tatt.flash_attention(*leaves).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jatt.attention_reference(*a)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for w, leaf in zip(want, leaves):
        _close(leaf.grad.numpy(), w, False)


def test_backward_kernels_refuse_what_they_do_not_take():
    assert tatt.BWD_HEAD_DIMS == (32, 64, 80)
    assert "flash_attention_bwd" in tatt.LAUNCHES
    assert "flash_attention_bwd_packed" in tatt.LAUNCHES
    with pytest.raises(ValueError):
        tatt.flash_attention_packed(torch.zeros(1, 8, 30), torch.zeros(1, 8, 30),
                                    torch.zeros(1, 8, 30), 4)


# --------------------------------------------------------------------------
# the wrappers whose backward differentiates the composed formula
# --------------------------------------------------------------------------

def _rel_close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _fused_inputs(seed, b, n, nk, c, heads, d):
    rng = np.random.default_rng(seed)
    hd = heads * d
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(h=r(b, n, c), k=r(b, nk, hd), v=r(b, nk, hd),
                wq=r(c, hd) / np.sqrt(c), wk=r(c, hd) / np.sqrt(c),
                wv=r(c, hd) / np.sqrt(c), wo=r(hd, c) / np.sqrt(hd),
                bo=0.1 * r(c), g=r(b, n, c))


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)
                            ).requires_grad_()


@pytest.mark.parametrize("through_function", [False, True],
                         ids=["wrapper", "kernel-forward-function"])
def test_fproj_gradient_matches_jax_grad(through_function, monkeypatch):
    """``through_function`` drives ``_KernelForward`` (what a CUDA tensor
    takes) with the plain version standing in for the kernel launch."""
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    x = _fused_inputs(5, 2, 64, 64, 32, 2, 16)
    names = ("h", "wq", "wk", "wv", "wo", "bo")

    def loss(*a):
        out = jatt.fused_proj_self_attention(*a, 2)
        return jnp.sum(out * jnp.asarray(x["g"]))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x[n]) for n in names))
    leaves = [_t(x[n], transpose=n.startswith("w")) for n in names]
    if through_function:
        launch = lambda *a: tatt.fproj_reference(*a[:-1], scale=a[-1])
        out = tatt._KernelForward.apply(launch, tatt.fproj_reference, 2, 0.25,
                                        *leaves)
    else:
        out = tatt.flash_attention_fproj(*leaves, 2)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(x["g"]))
    for n, w, g in zip(names, want, got):
        _rel_close(g.numpy().T if n.startswith("w") else g.numpy(), w)


@pytest.mark.parametrize("through_function", [False, True],
                         ids=["wrapper", "kernel-forward-function"])
def test_qout_gradient_matches_jax_grad(through_function, monkeypatch):
    monkeypatch.setenv("DSML_FLASH_INTERPRET", "1")
    x = _fused_inputs(6, 2, 64, 40, 32, 2, 16)
    names = ("h", "k", "v", "wq", "wo", "bo")

    def loss(*a):
        out = jatt.fused_qout_self_attention(*a, 2)
        return jnp.sum(out * jnp.asarray(x["g"]))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x[n]) for n in names))
    leaves = [_t(x[n], transpose=n.startswith("w")) for n in names]
    if through_function:
        launch = lambda *a: tatt.qout_reference(*a[:-1], scale=a[-1])
        out = tatt._KernelForward.apply(launch, tatt.qout_reference, 2, 0.25,
                                        *leaves)
    else:
        out = tatt.flash_attention_qout(*leaves, 2)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(x["g"]))
    for n, w, g in zip(names, want, got):
        _rel_close(g.numpy().T if n.startswith("w") else g.numpy(), w)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("mode", ["1", "stats"])
def test_groupnorm_kernel_modes_gradient_matches_jax_grad(mode, silu,
                                                          monkeypatch):
    """Both kernel modes: forward through the mode's own function, backward
    through the plain GroupNorm, on both sides (the JAX side in interpret
    mode under the same flag)."""
    monkeypatch.setenv("DSML_PALLAS_GN", mode)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 6, 64)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(*a):
        out = jgn.group_norm_silu(*a, num_groups=32, eps=1e-5, silu=silu,
                                  interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                  (x, gamma, beta)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    out = tgn.group_norm_silu(*leaves, num_groups=32, eps=1e-5, silu=silu)
    assert out.grad_fn is not None
    assert "ReferenceBackward" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for w, t in zip(want, got):
        _rel_close(t.numpy(), w)
