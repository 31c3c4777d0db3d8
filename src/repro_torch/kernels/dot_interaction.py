"""Wrapper of the CUDA kernel ``csrc/dot_interaction.cu``: the strictly lower
triangle of X Xᵀ per sample, in float32.

It replaces the Pallas kernel ``dot_interaction`` of the JAX package (a TPU
kernel) and is DLRM's feature interaction
(:meth:`repro_torch.models.dlrm.DLRM.forward`), one launch per batch. Unlike
the Pallas kernel, which casts its float32 sums back to the input's type,
it returns float32, as DLRM's ``_interact`` does. Its plain twin is
:func:`repro_torch.kernels.ref.dot_interaction_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dot_interaction_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (B, F, D) float32 or bfloat16, contiguous, on a CUDA device.
    Returns (B, F(F-1)/2) float32 in ``tril_indices(F, -1)`` order. Any B is
    accepted; B == 0 launches nothing. One sample's rows, padded, must fit
    in one block's shared memory (F * D up to about 56K floats); the kernel
    refuses a larger sample and the launch raises."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"dot_interaction_cuda takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError("dot_interaction_cuda takes a (B, F, D) tensor")
    if x.device.type != "cuda":
        raise ValueError("dot_interaction_cuda needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("dot_interaction_cuda takes a contiguous tensor")
    b, f, d = x.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _build.launch("dot_interaction", "dot_interaction", x.device, x.data_ptr(),
                  out.data_ptr(), b, f, d, _DTYPES[x.dtype])
    return out
