"""Wrapper of the CUDA kernel ``csrc/digram_count.cu``: digram pair counts.

It replaces the Pallas kernel ``digram_pair_counts`` of the JAX package (a
TPU kernel) and computes the pair stage of the initial full Count inside
:func:`repro_torch.core.repair.compress` (through
:func:`repro_torch.core.digram.digram_counts`). Its plain twin is
:func:`repro_torch.kernels.ref.digram_pair_counts_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def digram_pair_counts_cuda(its: torch.Tensor, cnts: torch.Tensor):
    """its, cnts: (N, K) int32, contiguous, on one CUDA device. Returns
    (lo, hi, count), each (N, K(K+1)/2) int32. Any N is accepted."""
    dev = its.device
    if dev.type != "cuda" or cnts.device != dev:
        raise ValueError("digram_pair_counts_cuda needs CUDA tensors on one device")
    if its.dtype != torch.int32 or cnts.dtype != torch.int32:
        raise TypeError("digram_pair_counts_cuda takes int32 its and cnts")
    if its.dim() != 2 or cnts.shape != its.shape:
        raise ValueError("digram_pair_counts_cuda takes two (N, K) tensors")
    if not (its.is_contiguous() and cnts.is_contiguous()):
        raise ValueError("digram_pair_counts_cuda takes contiguous tensors")
    n, k = its.shape
    p = k * (k + 1) // 2
    lo = torch.empty((n, p), dtype=torch.int32, device=dev)
    hi = torch.empty((n, p), dtype=torch.int32, device=dev)
    cnt = torch.empty((n, p), dtype=torch.int32, device=dev)
    if n * p == 0:
        return lo, hi, cnt
    _build.launch("digram_count", "digram_pair_counts", dev, its.data_ptr(),
                  cnts.data_ptr(), lo.data_ptr(), hi.data_ptr(), cnt.data_ptr(), n, k)
    return lo, hi, cnt
