"""The q/out-fused kernel takes every self-attention the shipped `-fullattn`
configs send it under ``DSML_ATTN_FPROJ_PARTIAL=1``.

Each real YAML is built on the meta device (no weight is made) and every
self-attention of its UNet runs through ``CrossAttention.forward`` itself at
the 64 x 64 latent's sequence length, with the two fused ops replaced by
spies that record what they were handed. On the card the fused-projection
op takes a sequence of one q-block only when its kernel takes the shape, and
the q/out-fused op must take everything else: a shape its kernel refused
would raise in a served batch.
"""
from __future__ import annotations

import os

import pytest
import torch

from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.models import unet as tunet
from dsml_thesis_tpu_torch.ops import attention as tatt
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs", "latent-diffusion")


@pytest.mark.parametrize("name,long_route", [
    ("mead-256-ldm-f4-fullattn.yaml", (5, 160, 160, 5)),
    ("mead-256-ldm-f4-fullattn-dh64.yaml", (5, 160, 160, 2)),  # heads of 80
])
def test_qout_kernel_takes_every_shipped_self_attention(name, long_route,
                                                        monkeypatch):
    cfg = load_config([os.path.join(CONFIG_DIR, name)])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    unet = ldm.unet.eval()
    qout, fproj = [], []

    def spy(calls):
        def op(h, *args, **kwargs):
            heads = args[-1] if len(args) in (6, 7) else kwargs["heads"]
            calls.append((h.shape[1], h.shape[-1], args[0].shape[-1], heads,
                          h.dtype))
            return torch.empty(h.shape, dtype=h.dtype, device=h.device)
        return op

    # (h, k, v, wq, wo, bo, heads) and (h, wq, wk, wv, wo, bo, heads): the
    # width H*D is k's last dimension, or wq's first
    monkeypatch.setattr(tunet, "fused_qout_self_attention", spy(qout))
    monkeypatch.setattr(tunet, "flash_attention_fproj", spy(fproj))
    monkeypatch.setenv("DSML_ATTN_FPROJ_PARTIAL", "1")
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

    assert fproj and qout
    for n, c, hd, heads, dtype in fproj:   # the card sends these there too
        assert tatt.fproj_one_q_block(n)
        assert tatt.fproj_kernel_takes(c, hd // heads, dtype)
    for n, c, hd, heads, dtype in qout:
        assert not tatt.fproj_one_q_block(n)
        assert tatt.qout_kernel_takes(c, hd, hd // heads, dtype), (c, hd, heads)
    n_long, c, hd, heads = long_route
    assert sorted(set(q[1:4] for q in qout)) == [(c, hd, heads)]
    assert len(qout) == n_long
