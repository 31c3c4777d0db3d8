"""Wrapper of the CUDA kernel ``csrc/bitvec_rank.cu``: batched rank1.

It replaces the Pallas kernel ``bitvec_rank`` of the JAX package (a TPU
kernel) and serves :meth:`repro_torch.core.succinct.bitvector.BitVector.rank1`
(the scalar ``K2Tree.access``). The batched k²-tree seed no longer calls
it once a level: its rank is fused into the descent of
:mod:`repro_torch.kernels.k2_lines`. Its plain twin is
:func:`repro_torch.kernels.ref.bitvec_rank_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bitvec_rank_cuda(words: torch.Tensor, word_ranks: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """words (W+1,) int32 bit patterns, word_ranks (W+1,) int64, positions
    (Q,) int64 with ``pos >> 5 <= W``, all contiguous on one CUDA device.
    Returns (Q,) int64. Q == 0 launches nothing."""
    dev = positions.device
    if dev.type != "cuda" or words.device != dev or word_ranks.device != dev:
        raise ValueError("bitvec_rank_cuda needs all tensors on one CUDA device")
    if words.dtype != torch.int32 or word_ranks.dtype != torch.int64 \
            or positions.dtype != torch.int64:
        raise TypeError("bitvec_rank_cuda takes int32 words, int64 word_ranks "
                        "and int64 positions")
    if words.dim() != 1 or word_ranks.shape != words.shape or positions.dim() != 1:
        raise ValueError("bitvec_rank_cuda takes 1-D words and word_ranks of "
                         "one length and 1-D positions")
    if not (words.is_contiguous() and word_ranks.is_contiguous()
            and positions.is_contiguous()):
        raise ValueError("bitvec_rank_cuda takes contiguous tensors")
    q = positions.numel()
    out = torch.empty(q, dtype=torch.int64, device=dev)
    if q == 0:
        return out
    _build.launch("bitvec_rank", "bitvec_rank", dev, words.data_ptr(),
                  word_ranks.data_ptr(), positions.data_ptr(), out.data_ptr(), q)
    return out
