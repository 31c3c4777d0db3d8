"""Wrappers of the CUDA kernels ``csrc/digram_count.cu``: digram counting.

They replace the Pallas kernel ``digram_pair_counts`` of the JAX package (a
TPU kernel). :func:`digram_pair_counts_cuda` keeps its dense interface (its
plain twin is :func:`repro_torch.kernels.ref.digram_pair_counts_ref`); the
build no longer calls it. In its place the paper's Count and Update Count
(:class:`repro_torch.core.digram.DigramCounter`) run on a
:class:`DigramTable` that stays on the card: :func:`digram_pair_accum_cuda`
adds the signed pair counts of a CSR of node histograms to it, and
:func:`digram_select_cuda` picks its most frequent digram. Their twins are
:func:`repro_torch.kernels.ref.digram_pair_accum_ref` and
:func:`repro_torch.kernels.ref.digram_select_ref`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

EMPTY = -1               # a free slot's key in a hashed table
SKIP, POPPED = 1, 2      # flag bits: a selection passes over a slot whose flag is not 0
SELECT_BLOCKS = 264      # the most partials digram_select writes (csrc/digram_count.cu)


@dataclass
class DigramTable:
    """Digram key (``lo << 32 | hi``) -> count (int64), with a flag byte a key.

    Hashed (on the card, :meth:`hashed`): open addressing over a power-of-two
    capacity, free slots keyed ``EMPTY``, ``used`` the slots taken (a key is
    never deleted; its count may fall to 0) and ``scratch`` the selection's
    partials. Sorted (the plain twin's, :meth:`sorted`): keys ascending,
    ``used`` and ``scratch`` None. Only :meth:`live` and the selections are
    the same for both.
    """

    keys: torch.Tensor
    counts: torch.Tensor
    flags: torch.Tensor
    used: torch.Tensor | None = None
    scratch: torch.Tensor | None = None

    @classmethod
    def hashed(cls, capacity: int, device) -> DigramTable:
        """An empty hashed table of at least `capacity` slots (a power of two)."""
        cap = 1 << max(capacity - 1, 1).bit_length()
        return cls(torch.full((cap,), EMPTY, dtype=torch.int64, device=device),
                   torch.zeros(cap, dtype=torch.int64, device=device),
                   torch.zeros(cap, dtype=torch.uint8, device=device),
                   torch.zeros(1, dtype=torch.int64, device=device),
                   torch.zeros(3 * SELECT_BLOCKS + 1, dtype=torch.int64, device=device))

    @classmethod
    def sorted(cls, device) -> DigramTable:
        """An empty sorted table."""
        none = torch.zeros(0, dtype=torch.int64, device=device)
        return cls(none, none.clone(), torch.zeros(0, dtype=torch.uint8, device=device))

    @property
    def capacity(self) -> int | None:
        """Slots of a hashed table; None for a sorted one, which has no bound."""
        return None if self.used is None else self.keys.numel()

    def live(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(keys, counts) of the keys with a count > 0, keys ascending."""
        ok = self.counts > 0
        keys, counts = self.keys[ok], self.counts[ok]
        order = torch.argsort(keys)
        return keys[order], counts[order]


def _check_cuda(what: str, dev, *tensors) -> None:
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} needs CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")


def _check_hashed(what: str, table: DigramTable) -> None:
    if table.used is None:
        raise ValueError(f"{what} takes a hashed DigramTable")
    if (table.keys.dtype, table.counts.dtype, table.flags.dtype) != \
            (torch.int64, torch.int64, torch.uint8):
        raise TypeError(f"{what} takes int64 keys and counts and uint8 flags")


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


def digram_pair_accum_cuda(table: DigramTable, row_ptr: torch.Tensor, its: torch.Tensor,
                           cnts: torch.Tensor, sign: torch.Tensor) -> None:
    """Add, for each CSR row r and slot pair i <= j of it, ``sign[r] *
    (cnts[i] // 2 if i == j else min(cnts[i], cnts[j]))`` to the key
    ``(min(its[i], its[j]), max(...))`` of the hashed `table`, in place,
    where that value is not 0. row_ptr (R+1,) int64 from 0; its, cnts
    (row_ptr[R],) int32 with its >= 0; sign (R,) int32. The caller keeps
    the table's occupancy under half its capacity (the kernel signals a
    full table through ``table.used``). R == 0 launches nothing."""
    dev = row_ptr.device
    _check_hashed("digram_pair_accum_cuda", table)
    _check_cuda("digram_pair_accum_cuda", dev, row_ptr, its, cnts, sign, table.keys,
                table.counts, table.used)
    if row_ptr.dtype != torch.int64 or sign.dtype != torch.int32 \
            or its.dtype != torch.int32 or cnts.dtype != torch.int32:
        raise TypeError("digram_pair_accum_cuda takes int64 row_ptr and int32 its, cnts, sign")
    n_rows = sign.numel()
    if row_ptr.dim() != 1 or row_ptr.numel() != n_rows + 1 or its.shape != cnts.shape \
            or its.dim() != 1:
        raise ValueError("digram_pair_accum_cuda takes row_ptr (R+1,), its and cnts of one "
                         "length and sign (R,)")
    if n_rows == 0:
        return
    _build.launch("digram_count", "digram_pair_accum", dev, table.keys.data_ptr(),
                  table.counts.data_ptr(), table.used.data_ptr(), table.capacity,
                  row_ptr.data_ptr(), its.data_ptr(), cnts.data_ptr(), sign.data_ptr(), n_rows)


def digram_select_cuda(table: DigramTable) -> torch.Tensor:
    """(key, count, slot, used), int64, on the card: the largest count > 0
    among the slots of the hashed `table` whose flag is 0, the smallest key
    among equal counts; key and slot -1 and count 0 when no slot
    qualifies. ``used`` is the table's slots taken."""
    dev = table.keys.device
    _check_hashed("digram_select_cuda", table)
    _check_cuda("digram_select_cuda", dev, table.keys, table.counts, table.flags,
                table.used, table.scratch)
    out = torch.empty(4, dtype=torch.int64, device=dev)
    _build.launch("digram_count", "digram_select", dev, table.keys.data_ptr(),
                  table.counts.data_ptr(), table.flags.data_ptr(), table.used.data_ptr(),
                  table.scratch.data_ptr(), out.data_ptr(), table.capacity)
    return out
