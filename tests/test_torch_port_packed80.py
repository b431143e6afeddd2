"""The packed attention at 80-wide heads and the streaming backward at the
edges of its tiles, on the CPU.

``packed_reference`` (what the packed op runs on a CPU tensor, and what its
CUDA kernel is held against on the card) is held against the JAX package's
``flash_attention_packed`` in Pallas interpret mode at head width 80, the
level-0 heads of ``mead-256-ldm-f4-fullattn-dh64.yaml`` (160 channels, 2
heads under the legacy head-width rule). fp32: 2e-5 absolute, the tolerance
of the other packed tests (the same sums in another order).

The shipped ``-fullattn`` configs are built on the meta device and every
eval-mode self-attention runs through ``CrossAttention.forward`` unflagged:
each one that goes to the packed op must be one its kernel takes, and none
may reach the split-head dispatch (on the card, a shape no kernel takes
raises in a served batch).

``streaming_bwd_reference`` is held against ``flash_attention_streaming_bwd``
in interpret mode in bf16 at the shapes where the kernels' tiles end: a
128-row owned tile plus one row, fewer keys than one 64-row streamed tile,
exactly one 64-row query tile, and 64-wide heads with a ragged key count.
bf16: 2e-2 of each gradient's maximum (bf16 keeps 8 bits; both sides round
q times the folded scale and the gradients, the JAX side per k-block).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_thesis_tpu.ops import attention as jatt
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.flags import KERNEL_FLAGS
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs", "latent-diffusion")


@pytest.mark.parametrize("shape", [(2, 130, 130, 2), (1, 70, 70, 3),
                                   (2, 100, 37, 2)],
                         ids=["two-heads-square", "three-heads-hd-240",
                              "cross-nk-ne-nq"])
def test_packed_reference_matches_jax_packed_at_80(shape):
    b, nq, nk, heads = shape
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, n, heads * 80)).astype(np.float32)
               for n in (nq, nk, nk))
    want = np.asarray(jatt.flash_attention_packed(
        *map(jnp.asarray, (q, k, v)), heads, block_q=128, interpret=True))
    got = tatt.packed_multi_head_attention(
        *map(torch.from_numpy, (q, k, v)), heads)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("d,dtype,takes", [
    (80, torch.bfloat16, True), (16, torch.bfloat16, False),
    (128, torch.bfloat16, False), (80, torch.float32, False)])
def test_packed_kernel_takes_80_wide_heads(d, dtype, takes):
    assert tatt.packed_kernel_takes(d, dtype) is takes


@pytest.mark.parametrize("name,packed_route", [
    ("mead-256-ldm-f4-fullattn.yaml", (4096, 160, 5)),
    ("mead-256-ldm-f4-fullattn-dh64.yaml", (4096, 160, 2)),  # heads of 80
])
def test_packed_kernel_takes_every_unflagged_self_attention(name,
                                                            packed_route,
                                                            monkeypatch):
    cfg = load_config([os.path.join(CONFIG_DIR, name)])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    unet = ldm.unet.eval()
    packed, fproj = [], []

    def spy_packed(q, k, v, heads, scale=None):
        packed.append((q.shape[1], q.shape[-1], heads, q.dtype))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def spy_fproj(h, wq, *args, **kwargs):
        heads = args[-1] if len(args) == 5 else kwargs["heads"]
        fproj.append((h.shape[1], h.shape[-1], wq.shape[0], heads, h.dtype))
        return torch.empty(h.shape, dtype=h.dtype, device=h.device)

    def split_heads(*args, **kwargs):
        raise AssertionError("a self-attention reached the split-head path")

    for flag in KERNEL_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    monkeypatch.setattr(tunet, "packed_multi_head_attention", spy_packed)
    monkeypatch.setattr(tunet, "flash_attention_fproj", spy_fproj)
    monkeypatch.setattr(tunet, "multi_head_attention", split_heads)
    ds = {unet.model_channels * m: 2 ** i
          for i, m in enumerate(unet.channel_mult)}
    for m in unet.modules():
        if isinstance(m, tunet.SpatialTransformer):
            n = (64 // ds[m.proj_in.in_channels]) ** 2
            for blk in range(m.depth):
                attn = getattr(m, f"block_{blk}").attn1
                x = torch.empty(2, n, attn.to_q.in_features,
                                dtype=torch.bfloat16, device="meta")
                assert attn(x).shape == x.shape

    assert fproj and packed
    for n, c, hd, heads, dtype in fproj:   # the card sends these there too
        assert tatt.fproj_one_q_block(n)
        assert tatt.fproj_kernel_takes(c, hd // heads, dtype)
    for n, hd, heads, dtype in packed:
        assert not tatt.fproj_one_q_block(n)
        assert tatt.packed_kernel_takes(hd // heads, dtype), (hd, heads)
    assert sorted(set(p[:3] for p in packed)) == [packed_route]
    assert len(packed) == 5   # the level-0 transformer blocks of a UNet call


def test_smoke_script_counts_the_dh64_packed_launches():
    """The launch arithmetic of ``chip_smoke.py``'s unflagged `-dh64` serve
    run on the real model: 11 self-attentions the fused op takes and 5 at
    N = 4096 (the packed kernel at 2 heads of 80) a UNet call."""
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = load_config([chip_smoke.CONFIG_DH64])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    assert chip_smoke.count_attentions(ldm.unet, ldm.image_size) == (11, 5)
    expect = chip_smoke.expected_launches(ldm, {}, unet_calls=100, encodes=2,
                                          decodes=2)
    assert expect["flash_attention_packed"] == 500
    assert expect["flash_attention_fproj"] == 1100
    assert expect["flash_attention_qout"] == 0
    assert ("fullattn-dh64", chip_smoke.CONFIG_DH64, {}, 8) in chip_smoke.RUNS


def _bf16_qkvdo(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (nq, nk, nk, nq)]


@pytest.mark.parametrize("shape", [(1, 2, 129, 129, 32), (2, 2, 100, 40, 32),
                                   (1, 3, 64, 200, 32), (1, 2, 70, 150, 64)],
                         ids=["owned-tile-plus-one", "nk-under-a-tile",
                              "one-query-tile", "d64-ragged-nk"])
def test_streaming_bwd_reference_matches_jax_at_tile_edges(shape):
    q, k, v, do = _bf16_qkvdo(12, *shape)
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
        assert g.dtype == torch.bfloat16 and g.shape == w_.shape
        np.testing.assert_allclose(g.float().numpy(), w_,
                                   atol=2e-2 * np.abs(w_).max(), rtol=0)
