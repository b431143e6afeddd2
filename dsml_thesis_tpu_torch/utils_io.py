"""Parameter utilities of the port."""
from __future__ import annotations

import torch
import torch.nn as nn


def cast_sampling_params(module: nn.Module,
                         dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every fp32 parameter and buffer of ``module`` to ``dtype`` (bf16),
    in place, for sampling: it halves the weight bytes read per model call.
    The layers compute in their own stated type and the norms take their
    statistics in fp32 whatever the parameters' type, so this only rounds
    the weights once. Training state stays fp32: sampling paths only."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.dtype == torch.float32:
            t.data = t.data.to(dtype)
    return module
