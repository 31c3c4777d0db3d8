"""Quasi-succinct Elias–Fano encoding of non-decreasing sequences.

Used by ITR for the sorted per-edge label ids of the start graph. Same
split and layout as the reference: an upper bitvector with a one at
``high[i] + i`` and the low bits packed LSB-first into 32-bit words.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core._arrays import I64
from repro_torch.core.succinct.bitvector import BitVector
from repro_torch.core.succinct.delta_code import _pack_codes
from repro_torch.device import as_i64, resolve_device


class EliasFano:
    def __init__(self, values, universe: int | None = None, device=None):
        dev = values.device if isinstance(values, torch.Tensor) and device is None \
            else resolve_device(device)
        values = as_i64(values, dev)
        n = int(values.numel())
        if n and bool((values[1:] < values[:-1]).any()):
            raise ValueError("EliasFano requires a non-decreasing sequence")
        last = int(values[-1]) if n else 0
        if n and int(values[0]) < 0:
            raise ValueError("EliasFano requires non-negative values")
        self.n = n
        self.universe = int(universe if universe is not None else (last + 1 if n else 1))
        if n and self.universe <= last:
            raise ValueError(
                f"EliasFano universe {self.universe} too small for max value "
                f"{last} (need universe > max value)")
        nn = max(n, 1)
        self.l = max(0, int(math.floor(math.log2(max(self.universe, 1) / nn)))) \
            if self.universe > nn else 0
        self._lows = values & ((1 << self.l) - 1)
        highs = values >> self.l
        n_upper = n + (int(highs[-1]) if n else 0) + 1
        self._upper = BitVector.from_positions(
            highs + torch.arange(n, dtype=I64, device=dev), n_upper)
        if self.l == 0 or n == 0:
            self._low_words, self._low_bits = torch.zeros(0, dtype=I64, device=dev), 0
        else:
            self._low_words, self._low_bits = _pack_codes(
                self._lows, torch.full((n,), self.l, dtype=I64, device=dev))

    @classmethod
    def from_parts(cls, n: int, universe: int, l: int, lows, upper_words, upper_n: int,
                   low_words, low_bits: int) -> "EliasFano":
        """Adopt stored internals (the snapshot load path) word for word: no
        re-derivation of the split and no re-packing of the low bits; only
        the upper bitvector's rank index is recomputed. The parts are
        tensors, and the device is theirs."""
        dev = upper_words.device
        self = cls.__new__(cls)
        self.n = int(n)
        self.universe = int(universe)
        self.l = int(l)
        self._lows = as_i64(lows, dev)
        self._upper = BitVector.from_words(upper_words, upper_n, device=dev)
        self._low_words = as_i64(low_words, dev)
        self._low_bits = int(low_bits)
        return self

    @property
    def device(self) -> torch.device:
        return self._upper.device

    def _low(self, i: torch.Tensor) -> torch.Tensor:
        if self.l == 0:
            return torch.zeros_like(i)
        starts = i * self.l
        w0 = starts >> 5
        s = starts & 31
        w = self._low_words
        lo = w[w0]
        nxt = w0 + 1
        mid = torch.where(nxt < w.numel(), w[nxt.clamp(max=w.numel() - 1)], 0)
        # keep only the bits of `mid` that belong to this value, so the
        # shifted lane stays below 2**63
        need = (self.l - 32 + s).clamp(min=0)
        mid = mid & ((torch.ones_like(need) << need) - 1)
        return ((lo >> s) | (mid << (32 - s))) & ((1 << self.l) - 1)

    def access(self, i) -> torch.Tensor:
        """values[i]; scalar or tensor."""
        i = as_i64(i, self.device)
        high = self._upper.select1(i) - i
        return (high << self.l) | self._low(i)

    def to_tensor(self) -> torch.Tensor:
        """Every stored value, in order (the counterpart of the reference's
        ``to_numpy``)."""
        if self.n == 0:
            return torch.zeros(0, dtype=I64, device=self.device)
        return self.access(torch.arange(self.n, dtype=I64, device=self.device))

    def rank_leq(self, x: int) -> int:
        """Number of stored values <= x (binary search on access)."""
        lo, hi = 0, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if int(self.access(mid)) <= x:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def size_in_bytes(self) -> int:
        return self._upper.size_in_bytes() + 4 * self._low_words.numel() + 16
