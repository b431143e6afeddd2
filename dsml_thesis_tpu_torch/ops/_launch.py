"""What every kernel wrapper of ``ops/`` shares: the launch counts and the
checks made on a CUDA operand before a launch and on the code after it."""
from __future__ import annotations

from typing import Dict

import torch

# launches per kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {
    "flash_attention": 0, "flash_attention_fproj": 0,
    "flash_attention_packed": 0, "flash_attention_qout": 0,
    "flash_attention_bwd": 0, "flash_attention_bwd_packed": 0,
    "flash_attention_streaming": 0, "flash_attention_streaming_bwd": 0,
    "group_norm_silu": 0, "gn_channel_stats": 0, "conv_stats": 0,
}


# activation types of the GroupNorm and conv + statistics kernels: bf16 (the
# UNet, the first stage in sampling) and fp32 (first-stage training)
ACTIVATION_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda_operand(name: str, t: torch.Tensor, like: torch.Tensor,
                       dtypes=(torch.bfloat16,)) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} lies on {t.device}, expected {like.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)} only")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def typed_entry(name: str, t: torch.Tensor) -> str:
    """The C entry point of a kernel for t's type: ``name`` for bf16,
    ``name + "_f32"`` for fp32."""
    return name + ("_f32" if t.dtype == torch.float32 else "")


def raise_on_error(code: int, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: shape not taken by the CUDA kernel")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def current_stream(t: torch.Tensor) -> int:
    """The raw pointer of t's device's current stream: the value
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object at every launch (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
