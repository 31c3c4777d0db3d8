"""Where the port's tensors live.

Entry points take ``device=None``, which means ``"cuda"``. Without a GPU
they raise unless the caller asked for the CPU explicitly: the port never
carries on quietly on the CPU when the card was expected.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device (no GPU is visible); "
            "pass device='cpu' to run on the CPU")
    return dev


def as_i64(x, device) -> torch.Tensor:
    """Any array-like (numpy, list, tensor) as an int64 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.array(x, dtype=np.int64)).to(device)
