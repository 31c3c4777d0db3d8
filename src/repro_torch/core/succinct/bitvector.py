"""Rank/select bitvector over packed 32-bit words, on a torch device.

Bit ``i`` lives at word ``i // 32``, bit position ``i % 32`` (LSB-first), as
in the reference. Words are held as int64 lanes with values in [0, 2**32):
torch has no ``>>`` for uint32 on the CPU, and ``>>`` on int32 is
arithmetic, and either breaks the SWAR popcount on words whose top bit is
set. The batched :meth:`BitVector.rank1` goes through
:func:`repro_torch.kernels.ops.bitvec_rank`, which on a CUDA tensor
launches the hand-written kernel; that kernel reads the same bits as a
32-bit buffer with one trailing zero word, so ``pos == n`` stays in bounds.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64, offsets_from_counts
from repro_torch.device import as_i64, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import popcount32


def _lanes(device) -> torch.Tensor:
    return torch.arange(32, dtype=I64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 tensor into int64 words holding 32 bits each (LSB-first)."""
    n = bits.numel()
    n_words = (n + 31) // 32
    padded = torch.zeros(n_words * 32, dtype=I64, device=bits.device)
    padded[:n] = bits.to(I64)
    return (padded.reshape(n_words, 32) << _lanes(bits.device)).sum(dim=1)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`, as uint8."""
    lanes = (words[:, None] >> _lanes(words.device)) & 1
    return lanes.reshape(-1)[:n_bits].to(torch.uint8)


def to_u32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) as int32 tensors with the same bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


class BitVector:
    """Immutable bitvector with O(1) rank1 and O(log) select1."""

    def __init__(self, bits, device=None):
        dev = bits.device if isinstance(bits, torch.Tensor) and device is None \
            else resolve_device(device)
        bits = as_i64(bits, dev)
        self.n = int(bits.numel())
        self._set_words(pack_bits(bits))

    def _set_words(self, words: torch.Tensor) -> None:
        self.words = words
        # word_ranks[w] = number of 1s strictly before word w (W+1 entries)
        self.word_ranks = offsets_from_counts(popcount32(words))
        self.n_ones = int(self.word_ranks[-1])
        self._rank_words = None  # lazy padded 32-bit copy for the rank kernel

    @classmethod
    def from_positions(cls, positions, n: int, device=None) -> "BitVector":
        dev = positions.device if isinstance(positions, torch.Tensor) \
            and device is None else resolve_device(device)
        bits = torch.zeros(n, dtype=I64, device=dev)
        positions = as_i64(positions, dev)
        if positions.numel():
            bits[positions] = 1
        return cls(bits)

    @classmethod
    def from_words(cls, words, n: int, device=None) -> "BitVector":
        """Reconstruct from already-packed words (uint32 values): only the
        rank index is recomputed."""
        dev = words.device if isinstance(words, torch.Tensor) and device is None \
            else resolve_device(device)
        self = cls.__new__(cls)
        self.n = int(n)
        words = as_i64(words, dev) & 0xFFFFFFFF
        if words.numel() != (self.n + 31) // 32:
            raise ValueError(f"{words.numel()} words cannot back {self.n} bits")
        self._set_words(words)
        return self

    @property
    def device(self) -> torch.device:
        return self.words.device

    def __len__(self) -> int:
        return self.n

    def access(self, i) -> torch.Tensor:
        i = as_i64(i, self.device)
        return ((self.words[i >> 5] >> (i & 31)) & 1).to(torch.uint8)

    def rank1(self, i) -> torch.Tensor:
        """Number of set bits in [0, i); i in [0, n], scalar or tensor."""
        i = as_i64(i, self.device)
        if self._rank_words is None:
            self._rank_words = to_u32_bits(torch.cat(
                [self.words, torch.zeros(1, dtype=I64, device=self.device)]))
        out = ops.bitvec_rank(self._rank_words, self.word_ranks,
                              i.reshape(-1).contiguous())
        return out.reshape(i.shape)

    def select1(self, j) -> torch.Tensor:
        """Position of the j-th (0-based) set bit; scalar or tensor."""
        j = as_i64(j, self.device)
        if bool(((j >= self.n_ones) | (j < 0)).any()):
            raise IndexError("select1 argument out of range")
        return self._select1(j)

    def _select1(self, j: torch.Tensor) -> torch.Tensor:
        """:meth:`select1` without its range check (and its host sync), for
        callers whose j lie in [0, n_ones) by construction."""
        flat = j.reshape(-1)
        w = torch.searchsorted(self.word_ranks, flat, right=True) - 1
        within = flat - self.word_ranks[w]
        lanes = (self.words[w][:, None] >> _lanes(self.device)) & 1
        before = torch.cumsum(lanes, dim=1) - lanes  # ones strictly before
        hit = (lanes == 1) & (before == within[:, None])
        out = (w << 5) + hit.to(I64).argmax(dim=1)
        return out.reshape(j.shape)

    def size_in_bytes(self, include_rank_index: bool = True) -> int:
        n_words = self.words.numel()
        base = 4 * n_words
        if include_rank_index:
            # production layout: one 32-bit cumulative count per 8 words
            base += 4 * ((n_words + 7) // 8)
        return base
