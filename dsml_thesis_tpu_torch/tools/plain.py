"""The plain path: every kernel's plain version put in its place in the
models, for the measurement tools that hold the kernel path against it on
the card (``chip_smoke.py``'s model, train and edit checks, and the
reference run of ``scripts/fidelity_gate_torch.py``). No serve, train or
sample entry point calls it: there a CUDA tensor launches its kernel or
raises.

One list says what the plain path replaces: the attention ops of the UNet
and of the first stage by name (the fused-projection, packed, q/out-fused
and split-head ops), conv + statistics by name, and GroupNorm by leaving
``DSML_PALLAS_GN`` unset (its plain ops). The other flags stay as given.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional
from unittest import mock

from ..flags import KERNEL_FLAGS


@contextlib.contextmanager
def kernel_flags(values: Dict[str, str]):
    """The kernel flags set to ``values`` (every other one unset) inside the
    block, and restored after it; ``values`` may also name other flags
    (``DSML_REMAT``, ``DSML_OPT_BF16_M``), restored likewise."""
    names = tuple(KERNEL_FLAGS) + tuple(k for k in values
                                        if k not in KERNEL_FLAGS)
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update(values)
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


@contextlib.contextmanager
def plain_path(env: Optional[Dict[str, str]] = None):
    """Inside the block the models run every kernel's plain version under
    the routing flags of ``env`` (``DSML_PALLAS_GN`` left unset)."""
    from ..models import autoencoder, unet
    from ..ops import attention as A
    from ..ops import conv_gn as C

    env = dict(env or {})

    def plain_qout(h, k, v, wq, wo, bo, heads, scale=None):
        wq, wo, bo = (w.to(h.dtype) for w in (wq, wo, bo))
        return A.qout_reference(h, k, v, wq, wo, bo, heads, scale=scale)

    split_head = (A.streaming_attention_reference
                  if env.get("DSML_FLASH_STREAMING") == "1"
                  else A.attention_reference)
    with kernel_flags({k: v for k, v in env.items()
                       if k != "DSML_PALLAS_GN"}), \
            mock.patch.object(unet, "flash_attention_fproj", A.fproj_reference), \
            mock.patch.object(unet, "packed_multi_head_attention",
                              A.packed_reference), \
            mock.patch.object(unet, "fused_qout_self_attention", plain_qout), \
            mock.patch.object(unet, "multi_head_attention", split_head), \
            mock.patch.object(autoencoder, "multi_head_attention", split_head), \
            mock.patch.object(unet, "conv_stats", C.conv_stats_reference):
        yield
