"""The fused k²-tree row / column expansion: the wrapper of the two CUDA
kernels ``k2_lines_count`` and ``k2_lines_write`` in ``csrc/bitvec_rank.cu``
and the flat tree layout they read.

It replaces the per-level loop around the Pallas kernel ``bitvec_rank`` of
the JAX package (a TPU kernel, one launch a tree level) and is
:meth:`repro_torch.core.succinct.k2tree.K2Tree.rows_many` /
``cols_many``, the S/O seed of every triple pattern with S or O bound. A
call is two launches and one host sync: the count pass writes each query's
result count, a cumulative sum places each query's results, one host read
of the total sizes the output, and the write pass fills it, each query's
coordinates already in order. Its plain twins are
:func:`repro_torch.kernels.ref.k2_lines_ref` (the level loop, the CPU path)
and :func:`repro_torch.kernels.ref.k2_lines_walk_ref` (the kernel's own
walk).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import k2_stack_cap

STACK_ENTRY_BYTES = 13  # int64 coordinate prefix, int32 block, uint8 level
SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory (opt-in limit)


@dataclass(frozen=True)
class K2Layout:
    """A k²-tree's levels as one flat layout, on one device.

    words (sum of W_t + 1,) int32 holds every level's packed LSB-first words
    as uint32 bit patterns, each level followed by one zero pad word;
    ranks (same length) int64 the exclusive prefix popcounts of each
    level's words (so its last entry is the level's count of ones);
    word_off (h + 1,) int64 where each level starts in both; nbits (h,)
    int64 each level's length in bits. ``offsets`` and ``bits`` are the
    same two as Python ints. A tree that stores fewer than h levels (the
    empty one) has 0-bit levels after them."""

    k: int
    h: int
    n_rows: int
    n_cols: int
    words: torch.Tensor
    ranks: torch.Tensor
    word_off: torch.Tensor
    nbits: torch.Tensor
    offsets: tuple
    bits: tuple

    def level(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Level t's words (with its pad) and word ranks, as views."""
        lo, hi = self.offsets[t], self.offsets[t + 1]
        return self.words[lo:hi], self.ranks[lo:hi]

    def limits(self, axis: int) -> tuple[int, int]:
        """(limit of the fixed coordinate, limit of the free one)."""
        return (self.n_rows, self.n_cols) if axis == 0 else (self.n_cols, self.n_rows)


def stack_bytes(k: int, h: int) -> int:
    """Shared memory one warp's walk stack takes."""
    return k2_stack_cap(k, h) * STACK_ENTRY_BYTES


def k2_lines_cuda(lay: K2Layout, fixed: torch.Tensor, axis: int):
    """Rows (axis 0) or columns (axis 1) ``fixed`` (Q,) int64 of the tree
    ``lay``, on its CUDA device: (idx, coords) int64, query ``idx[i]`` has a
    1 at free coordinate ``coords[i]``, sorted by (idx, coord); fixed values
    out of range yield nothing. Q == 0 launches nothing; a batch with no
    result launches only the count pass."""
    tensors = (lay.words, lay.ranks, lay.word_off, lay.nbits)
    if fixed.dtype != torch.int64 or lay.words.dtype != torch.int32 \
            or any(t.dtype != torch.int64 for t in tensors[1:]):
        raise TypeError("k2_lines_cuda takes int64 fixed values, int32 words and "
                        "int64 ranks, offsets and bit lengths")
    if fixed.dim() != 1 or lay.words.dim() != 1 or lay.ranks.shape != lay.words.shape \
            or lay.word_off.shape != (lay.h + 1,) or lay.nbits.shape != (lay.h,) \
            or not all(t.is_contiguous() for t in (fixed, *tensors)):
        raise ValueError("k2_lines_cuda takes contiguous 1-D tensors: words and ranks "
                         "of one length, h + 1 offsets, h bit lengths")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, not {axis}")
    if not (2 <= lay.k <= 32 and 1 <= lay.h <= 64):
        raise ValueError(f"k2_lines_cuda takes 2 <= k <= 32 and 1 <= h <= 64 "
                         f"(k={lay.k}, h={lay.h})")
    if stack_bytes(lay.k, lay.h) > SMEM_PER_BLOCK:
        raise ValueError(f"the walk's stack for k={lay.k}, h={lay.h} "
                         f"({stack_bytes(lay.k, lay.h)} B) does not fit in shared memory")
    if lay.k ** lay.h >= 2**63 or max(lay.bits) >= 2**31:
        raise ValueError("k2_lines_cuda takes int64 coordinates and levels of fewer "
                         "than 2**31 bits")
    dev = fixed.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("k2_lines_cuda needs the layout and fixed on one CUDA device")
    q = fixed.numel()
    idx = torch.empty(0, dtype=torch.int64, device=dev)
    if q == 0:
        return idx, idx.clone()
    limit_fixed, limit_free = lay.limits(axis)
    shape = (q, lay.k, lay.h, axis, limit_fixed, limit_free, k2_stack_cap(lay.k, lay.h))
    ptrs = [t.data_ptr() for t in tensors]
    counts = torch.empty(q, dtype=torch.int64, device=dev)
    _build.launch("bitvec_rank", "k2_lines_count", dev, *ptrs, fixed.data_ptr(),
                  counts.data_ptr(), *shape)
    ends = torch.cumsum(counts, 0)
    total, low = torch.stack((ends[-1], counts.min())).tolist()  # the call's one host sync
    if low < 0:
        raise RuntimeError("k2_lines: a walk overflowed its stack")
    if total == 0:
        return idx, idx.clone()
    starts = ends - counts
    idx = torch.empty(total, dtype=torch.int64, device=dev)
    coords = torch.empty(total, dtype=torch.int64, device=dev)
    _build.launch("bitvec_rank", "k2_lines_write", dev, *ptrs, fixed.data_ptr(),
                  starts.data_ptr(), idx.data_ptr(), coords.data_ptr(), *shape)
    return idx, coords
