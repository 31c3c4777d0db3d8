"""k²-tree over a sparse 0/1 matrix, built from COO, on a torch device.

Same layout as the reference: one :class:`BitVector` per level, and the
child block of the j-th set bit of level t is block j of level t+1. The
batched row / column expansion (:meth:`K2Tree.rows_many`,
:meth:`K2Tree.cols_many`) reads the levels as one flat layout
(:meth:`K2Tree.layout`, built once) through
:func:`repro_torch.kernels.ops.k2_lines`. On the card that is one fused
descent of the whole tree, two launches (a count pass and a write pass)
and one host sync to size the output; on the CPU it is the reference's
level loop, one batched ``rank1`` per level. :meth:`K2Tree.row` and
:meth:`K2Tree.col` (the scalar query path's seed) are a batch of one.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64
from repro_torch.core.succinct.bitvector import BitVector, to_u32_bits
from repro_torch.device import as_i64, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.k2_lines import K2Layout


class K2Tree:
    def __init__(self, rows, cols, n_rows: int, n_cols: int, k: int = 2,
                 device=None):
        dev = rows.device if isinstance(rows, torch.Tensor) and device is None \
            else resolve_device(device)
        rows = as_i64(rows, dev)
        cols = as_i64(cols, dev)
        if rows.numel():
            if bool((rows.min() < 0) | (rows.max() >= n_rows)
                    | (cols.min() < 0) | (cols.max() >= n_cols)):
                raise ValueError("point out of bounds")
        self.n_rows, self.n_cols, self.k = int(n_rows), int(n_cols), int(k)
        side = max(n_rows, n_cols, 1)
        h = 1
        while k**h < side:
            h += 1
        self.h = h
        self.side = k**h
        self.n_points = 0
        self._device = dev
        self._layout = None
        self.levels: list[BitVector] = []
        self._build(rows, cols)

    @classmethod
    def from_levels(cls, n_rows: int, n_cols: int, k: int, h: int,
                    n_points: int, level_words: list, level_bits: list,
                    device=None) -> "K2Tree":
        """Reconstruct from per-level bitvector words (uint32 values)."""
        self = cls.__new__(cls)
        self.n_rows, self.n_cols, self.k = int(n_rows), int(n_cols), int(k)
        self.h = int(h)
        self.side = self.k ** self.h
        self.n_points = int(n_points)
        if len(level_words) != self.h and not (len(level_words) == 1
                                               and n_points == 0):
            raise ValueError(
                f"{len(level_words)} levels for a height-{self.h} k2-tree")
        dev = level_words[0].device if isinstance(level_words[0], torch.Tensor) \
            and device is None else resolve_device(device)
        self._device = dev
        self._layout = None
        self.levels = [BitVector.from_words(w, int(nb), device=dev)
                       for w, nb in zip(level_words, level_bits)]
        return self

    @property
    def device(self) -> torch.device:
        return self._device

    def _build(self, rows: torch.Tensor, cols: torch.Tensor):
        k, k2, h = self.k, self.k * self.k, self.h
        dev = self._device
        if rows.numel() == 0:
            self.levels = [BitVector(torch.zeros(k2, dtype=I64, device=dev))]
            return
        flat = torch.unique(rows * self.n_cols + cols)  # dedup points
        rows = flat // self.n_cols
        cols = flat % self.n_cols
        self.n_points = int(flat.numel())

        levels = []
        keys = torch.zeros(rows.numel(), dtype=I64, device=dev)  # root = 0
        for t in range(h):
            scale = k ** (h - 1 - t)
            child = (rows // scale % k) * k + (cols // scale % k)
            pair = keys * k2 + child
            uniq_keys = torch.unique(keys)
            uniq_pair = torch.unique(pair)
            bits = torch.zeros(uniq_keys.numel() * k2, dtype=I64, device=dev)
            # set child bit: parent's index in level order * k2 + child
            parent_of_pair = torch.searchsorted(uniq_keys, uniq_pair // k2)
            bits[parent_of_pair * k2 + uniq_pair % k2] = 1
            levels.append(BitVector(bits))
            # next level's node key = index of (key, child) among the set bits
            keys = torch.searchsorted(uniq_pair, pair)
        self.levels = levels

    # ---------------- queries ----------------

    def access(self, r: int, c: int) -> int:
        k, k2 = self.k, self.k * self.k
        block = 0
        for t in range(self.h):
            scale = k ** (self.h - 1 - t)
            child = (r // scale % k) * k + (c // scale % k)
            bitpos = block * k2 + child
            if bitpos >= self.levels[t].n or not int(self.levels[t].access(bitpos)):
                return 0
            block = int(self.levels[t].rank1(bitpos))
        return 1

    def row(self, r: int) -> torch.Tensor:
        """All columns c with M[r, c] = 1, sorted; empty for a row out of
        range. One batched expansion of a single row."""
        return self._lines([int(r)], axis=0)[1]

    def col(self, c: int) -> torch.Tensor:
        """All rows r with M[r, c] = 1, sorted; see :meth:`row`."""
        return self._lines([int(c)], axis=1)[1]

    def rows_many(self, rs) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched row expansion. Returns (idx, cols): query rs[idx[i]] has a
        1 at column cols[i], sorted by (idx, col); out-of-range rows yield
        nothing."""
        return self._lines(rs, axis=0)

    def cols_many(self, cs) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched column expansion; see :meth:`rows_many`."""
        return self._lines(cs, axis=1)

    def _lines(self, fixed, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
        return ops.k2_lines(self.layout(), as_i64(fixed, self.device).contiguous(), axis)

    def layout(self) -> K2Layout:
        """The levels as one flat layout (:class:`K2Layout`), built on first
        use; the empty tree's missing levels have 0 bits."""
        if self._layout is None:
            dev = self.device
            pad = torch.zeros(1, dtype=I64, device=dev)
            words, ranks, offsets, bits = [], [], [0], []
            for t in range(self.h):
                if t < len(self.levels):
                    lv = self.levels[t]
                    words += [lv.words, pad]
                    ranks.append(lv.word_ranks)
                    bits.append(lv.n)
                else:
                    words.append(pad)
                    ranks.append(pad)
                    bits.append(0)
                offsets.append(offsets[-1] + ranks[-1].numel())
            self._layout = K2Layout(
                self.k, self.h, self.n_rows, self.n_cols, to_u32_bits(torch.cat(words)),
                torch.cat(ranks), torch.tensor(offsets, dtype=I64, device=dev),
                torch.tensor(bits, dtype=I64, device=dev), tuple(offsets), tuple(bits))
        return self._layout

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.n_rows, self.n_cols), dtype=torch.uint8,
                          device=self.device)
        r_idx, cols = self.rows_many(torch.arange(self.n_rows, device=self.device))
        out[r_idx, cols] = 1
        return out

    def size_in_bytes(self) -> int:
        return sum(lv.size_in_bytes() for lv in self.levels) + 8 * len(self.levels)
