"""Kernels of the port, each beside its plain PyTorch version."""
from .attention import (  # noqa: F401
    LAUNCHES,
    attention_reference,
    flash_attention,
    flash_attention_fproj,
    fproj_reference,
    reset_launches,
)
from .groupnorm import group_norm_silu  # noqa: F401
