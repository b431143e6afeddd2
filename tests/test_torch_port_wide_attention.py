"""The bf16 attention forwards at head width 512 (the first stage's AttnBlock:
one head of 512 channels) against the JAX package.

On the card the split-head forward (``flash_attention``) and the streaming
forward (``flash_attention_streaming``) run ``csrc/hopper_wide.cuh`` at
D = 512; here their wrappers run the plain versions, which state the
kernels' arithmetic. The same numpy inputs go through the JAX Pallas
kernels in interpret mode (K / V in 64-key blocks where the JAX kernel takes
a key block, as the CUDA kernel streams them) and through the port. The
shapes end their keys mid-tile, so the masks of the last tile are held too.

Tolerance: 2e-2 of the output's maximum, the bf16 tolerance of the other
attention tests (a bf16 output step is 2^-8 of its magnitude; the two sides
sum in other orders and round the probabilities at other places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

D = 512
# [B, H, Nq, Nk]: keys ending mid-tile (130 = 2 x 64 + 2, 77 = 64 + 13),
# fewer keys than a tile, and a whole tile
SHAPES = {"ragged-kv": (1, 1, 70, 130), "two-heads": (1, 2, 33, 77),
          "short-kv": (1, 1, 40, 20), "one-tile": (2, 1, 64, 64)}


def _qkv(seed, b, h, nq, nk, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((b, h, n, D))).astype(np.float32)
            for n in (nq, nk, nk)]


def _bf16(arrays):
    """The same bf16 values on both sides (jax and torch round alike)."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", list(SHAPES))
def test_flash_attention_d512_matches_jax(name):
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(0, *SHAPES[name]))
    want = jatt.flash_attention(jq, jk, jv, block_q=32, interpret=True)
    _close(tatt.attention_reference(tq, tk, tv), want)
    _close(tatt.flash_attention(tq, tk, tv), want)


@pytest.mark.parametrize("name", list(SHAPES))
def test_streaming_attention_d512_matches_jax(name):
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(1, *SHAPES[name]))
    want = jatt.flash_attention_streaming(jq, jk, jv, block_q=32, block_k=64,
                                          interpret=True)
    _close(tatt.streaming_attention_reference(tq, tk, tv), want)
    _close(tatt.flash_attention_streaming(tq, tk, tv), want)


def test_d512_scores_that_saturate_stay_finite():
    """Scores of several hundred in base 2 (q and k at 4 sigma): the
    running maxima and the -1e30 mask of the last tile keep both forwards
    finite, and they agree with the JAX kernels."""
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(2, 1, 1, 40, 100, scale=4.0))
    for ours, theirs in (
            (tatt.flash_attention(tq, tk, tv),
             jatt.flash_attention(jq, jk, jv, block_q=8, interpret=True)),
            (tatt.flash_attention_streaming(tq, tk, tv),
             jatt.flash_attention_streaming(jq, jk, jv, block_q=8,
                                            block_k=64, interpret=True))):
        assert bool(torch.isfinite(ours.float()).all())
        _close(ours, theirs)


def test_d512_takes_the_bf16_kernels():
    """Both rows have a bf16 instantiation at D = 512, so a first-stage
    attention on the card launches a kernel and never its plain version."""
    assert tatt.flash_kernel_takes(D, torch.bfloat16)
    assert tatt.streaming_kernel_takes(D, torch.bfloat16)
    assert not tatt.flash_kernel_takes(D, torch.bfloat16, backward=True)


# (B*H, Nq, Nk) -> splits of the keys at the D = 512 shapes the kernels
# phase of chip_smoke.py runs: one block a q-tile where the q-tiles fill the
# card, up to one split a 64-key unit where they do not
SPLITS = {(8, 4096, 4096): 1, (16, 4096, 4096): 1, (1, 16384, 16384): 1,
          (1, 64, 2000): 32, (2, 1000, 1000): 8, (2, 1000, 333): 6}


@pytest.mark.parametrize("shape", list(SPLITS))
def test_streaming_splits_at_d512_shapes(shape):
    bh, nq, nk = shape
    splits = tatt.streaming_splits(bh, nq, nk)
    assert splits == SPLITS[shape]
    # the kernel cuts the keys in 64-key units, each split non-empty
    assert tatt.STREAMING_TILE == 64
    units = -(-nk // 64)
    per = -(-units // splits)
    assert (splits - 1) * per < units <= splits * per
