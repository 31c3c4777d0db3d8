"""Wrapper of the CUDA kernel ``csrc/embedding_bag.cu``: sum or mean of the
table rows of each bag.

It replaces the Pallas kernel ``embedding_bag`` of the JAX package (a TPU
kernel) and is DLRM's lookup (:meth:`repro_torch.models.dlrm.DLRM.fields`):
one launch per batch over B * 26 single-row bags of the concatenated
tables. Its plain twin is :func:`repro_torch.kernels.ref.embedding_bag_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
_COMBINERS = {"sum": 0, "mean": 1}


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       combiner: str = "sum") -> torch.Tensor:
    """table (V, D) float32 or bfloat16, indices (B, L) int32 or int64 with
    values in [-1, V) (negative = padding), both contiguous on one CUDA
    device. Returns (B, D) in the table's dtype, summed in float32. Any B
    and D are accepted; B == 0 launches nothing."""
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag_cuda takes a float32 or bfloat16 table, not {table.dtype}")
    if indices.dtype not in _INDEX_DTYPES:
        raise TypeError(f"embedding_bag_cuda takes int32 or int64 indices, not {indices.dtype}")
    if combiner not in _COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("embedding_bag_cuda takes a (V, D) table and (B, L) indices")
    dev = table.device
    if dev.type != "cuda" or indices.device != dev:
        raise ValueError("embedding_bag_cuda needs both tensors on one CUDA device")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("embedding_bag_cuda takes contiguous tensors")
    (n_rows, d), (n_bags, bag_len) = table.shape, indices.shape
    out = torch.empty((n_bags, d), dtype=table.dtype, device=dev)
    if n_bags == 0 or d == 0:
        return out
    _build.launch("embedding_bag", "embedding_bag", dev, table.data_ptr(),
                  indices.data_ptr(), out.data_ptr(), n_bags, n_rows, bag_len, d,
                  _DTYPES[table.dtype], _INDEX_DTYPES[indices.dtype], _COMBINERS[combiner])
    return out
