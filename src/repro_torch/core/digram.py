"""Incidence-types, digrams, and the paper's occurrence counting, on the device.

An incidence-type is ``(label a, connection-type m)``, flattened to
``it_offsets[a] + m``; a digram is an unordered pair of incidence-types,
flattened to ``min(it1, it2) << 32 | max``. The per-node digram score is
``min(c(v,i1), c(v,i2))`` for ``i1 != i2`` and ``c(v,i1) // 2`` for
``i1 == i2``, summed over nodes.

* :func:`digram_counts` is the full recount: one ``digram_pair_accum``
  launch over the CSR of every node's histogram (cut to its `cap` most
  frequent types) into an empty :class:`DigramTable`.
* :class:`DigramCounter` is the paper's Count and Update Count steps with
  the state on the device: the node histograms as tensors, the digram
  counts in a :class:`DigramTable`. A replacement is one signed
  ``digram_pair_accum`` launch over the touched nodes, a selection one
  ``digram_select`` launch.
"""
from __future__ import annotations

import bisect
import math

import torch

from repro_torch.core._arrays import I64, empty, lexsort, offsets_from_counts
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.kernels import ops
from repro_torch.kernels.digram_count import POPPED, SKIP, DigramTable

DIGRAM_SHIFT = 32
_MASK32 = (1 << 32) - 1
LOAD = 0.5        # a hashed table is rebuilt larger before its slots taken pass this share
MIN_SLOTS = 1024  # the smallest hashed table

def digram_key(it1: int, it2: int) -> int:
    lo, hi = (it1, it2) if it1 <= it2 else (it2, it1)
    return (lo << DIGRAM_SHIFT) | hi


def split_digram(key: int) -> tuple[int, int]:
    return key >> DIGRAM_SHIFT, key & _MASK32


def split_it(it: int, it_offsets: list[int]) -> tuple[int, int]:
    """Inverse of it_offsets[label] + m -> (label, m), on a host list."""
    label = bisect.bisect_right(it_offsets, it) - 1
    return label, it - it_offsets[label]


def incidences(graph: Hypergraph, table: LabelTable) -> tuple[torch.Tensor, torch.Tensor]:
    """(node, incidence_type_id) for every edge slot; one scan over edges."""
    ranks = graph.ranks()
    total = int(graph.nodes_flat.numel())
    it_offsets = table.it_offsets()
    pos = torch.arange(total, dtype=I64, device=graph.device) \
        - torch.repeat_interleave(graph.offsets[:-1], ranks, output_size=total)
    its = torch.repeat_interleave(it_offsets[graph.labels], ranks, output_size=total) + pos
    return graph.nodes_flat, its


def node_it_counts(graph: Hypergraph, table: LabelTable):
    """The mapping c : V x IT -> N as parallel tensors (v, it, count), sorted."""
    nodes, its = incidences(graph, table)
    n_it = int(table.it_offsets()[-1])
    uk, cnts = torch.unique(nodes * n_it + its, return_counts=True)
    return uk // n_it, uk % n_it, cnts.to(I64)


def _rank_in_node(node: torch.Tensor, cnt: torch.Tensor, stamp: torch.Tensor) -> torch.Tensor:
    """Each entry's place among the entries of its node, by count descending,
    then stamp ascending: the reference's stable sort of a node's dict by
    count, whose ties keep the dict's insertion order."""
    order = lexsort((stamp, -cnt, node))
    ns = node[order]
    ar = torch.arange(ns.numel(), dtype=I64, device=ns.device)
    head = torch.ones(ns.numel(), dtype=torch.bool, device=ns.device)
    head[1:] = ns[1:] != ns[:-1]
    start = torch.cummax(torch.where(head, ar, 0), 0).values
    return torch.empty_like(ar).scatter_(0, order, ar - start)


def _compact(mask: torch.Tensor, csum: torch.Tensor, n: int, rows: torch.Tensor) -> torch.Tensor:
    """The rows of `rows` where `mask` holds, in order. `csum` is the
    cumulative sum of `mask` and `n` its last value, known to the host, so
    there is no sync."""
    dest = torch.where(mask, csum - 1, n)
    out = torch.empty((n + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_copy_(0, dest, rows)[:n]


def _capped(key: torch.Tensor, cnt: torch.Tensor, stamp: torch.Tensor, cap: int) -> torch.Tensor:
    """`cnt` of entries (node << 32 | it, count, stamp) grouped by node, 0
    past each node's `cap` most frequent types: a type of count 0 adds
    nothing to any pair."""
    return torch.where(_rank_in_node(key >> DIGRAM_SHIFT, cnt, stamp) < cap, cnt, 0)


def _capped_csr(key: torch.Tensor, cnt: torch.Tensor, stamp: torch.Tensor, cap: int | None):
    """The CSR of every node's histogram cut to its `cap` most frequent
    types (ties by stamp), from entries (node << 32 | it, count, stamp)
    sorted by key: (row_ptr, its, cnts, pairs), pairs the rows' slot pairs.
    Syncs with the host."""
    node = key >> DIGRAM_SHIFT
    if cap is not None:
        keep = torch.nonzero(_rank_in_node(node, cnt, stamp) < cap).reshape(-1)
        key, cnt, node = key[keep], cnt[keep], node[keep]
    its = key & _MASK32
    if its.numel() and (int(its.max()) >= 2**31 or int(cnt.max()) >= 2**31):
        raise ValueError("incidence types and counts must fit in int32")
    lens = torch.unique_consecutive(node, return_counts=True)[1]
    pairs = int((lens * (lens + 1) // 2).sum())
    return offsets_from_counts(lens), its.to(torch.int32), cnt.to(torch.int32), pairs


def _count(key: torch.Tensor, cnt: torch.Tensor, stamp: torch.Tensor, cap: int | None,
           slots: int = 0) -> DigramTable:
    """The Count: a new table (hashed on the card, with room for at least
    `slots` keys; sorted on the CPU) holding the digram counts of the
    histograms, from one ``digram_pair_accum`` launch with sign +1 over
    every node's capped types."""
    row_ptr, its, cnts, pairs = _capped_csr(key, cnt, stamp, cap)
    dev = key.device
    if dev.type == "cuda":
        table = DigramTable.hashed(max(MIN_SLOTS, math.ceil(max(pairs, slots) / LOAD)), dev)
    else:
        table = DigramTable.sorted(dev)
    n_rows = row_ptr.numel() - 1
    if n_rows:
        ops.digram_pair_accum(table, row_ptr, its, cnts,
                              torch.ones(n_rows, dtype=torch.int32, device=dev))
    return table


def digram_counts(graph: Hypergraph, table: LabelTable, cap: int | None = 64):
    """Full recount. Returns (digram_keys, counts), counts > 0, keys sorted."""
    v, it, cnts = node_it_counts(graph, table)
    if v.numel() == 0:
        return empty(graph.device), empty(graph.device)
    stamp = torch.arange(v.numel(), dtype=I64, device=v.device)
    return _count((v << DIGRAM_SHIFT) | it, cnts, stamp, cap).live()


class DigramCounter:
    """Incremental digram counts (paper's Count + Update Count steps), on
    the graph's device.

    The node histograms are entries (``node << 32 | it``, count, stamp),
    sorted by key, every count > 0; the stamp orders a node's entries as
    the reference's dict does (insertion order), which decides the cap's
    ties. The digram counts live in ``table``. A replacement notifies the
    counter with the removed / added incidence tensors; one signed
    ``digram_pair_accum`` launch takes the touched nodes' capped types out
    of the table as they were and puts them back as they are. A selection
    is one ``digram_select`` launch: the largest count, then the smallest
    key, among live keys not skipped and not popped, which is the order in
    which the reference's lazy heap pops. Keys given in `skip` stay
    skipped (the callers only add to that set), and entries popped by
    :meth:`peek_pop` are pushed back before the next :meth:`apply_delta`.
    """

    def __init__(self, graph: Hypergraph, table: LabelTable, cap: int | None = 64):
        self.cap = cap
        self.n_nodes = graph.n_nodes
        v, it, cnts = node_it_counts(graph, table)  # sorted by (node, it)
        self._key = (v << DIGRAM_SHIFT) | it
        self._cnt = cnts
        self._stamp = torch.arange(v.numel(), dtype=I64, device=v.device)  # it order
        self._next_stamp = v.numel()
        self._skipped: set[int] = set()  # keys flagged SKIP in the table
        self._last: tuple[int, int] | None = None  # (key, slot) of the last selection
        self._popped: list[tuple[int, int]] = []   # (key, slot) popped, not pushed back
        self._rebuild(0)

    def _rebuild(self, slots: int) -> None:
        """A new table from the histograms (the Count), with the skipped keys
        flagged again."""
        self.table = _count(self._key, self._cnt, self._stamp, self.cap, slots)
        self._used = 0 if self.table.used is None else int(self.table.used[0])
        if self._skipped:
            self._flag_keys(sorted(self._skipped))
        self._last, self._popped = None, []

    # -- update after replacement ----------------------------------------
    def apply_delta(self, removed, added):
        """removed / added: (nodes, its) incidence tensors of deleted / new
        edges, on the counter's device. One host sync (the sizes of the
        update), then one ``digram_pair_accum`` launch."""
        rem_v, rem_it = removed
        add_v, add_it = added
        nr, na = rem_v.numel(), add_v.numel()
        if nr + na == 0:
            return
        dev = self._key.device
        m = self._key.numel()
        n = m + nr + na
        # merge the histogram entries with the incidence deltas by key
        ks, order = torch.sort(torch.cat([self._key, (rem_v << DIGRAM_SHIFT) | rem_it,
                                          (add_v << DIGRAM_SHIFT) | add_it]), stable=True)
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = ks[1:] != ks[:-1]
        gid = torch.cumsum(head, 0) - 1
        # per group: the count and stamp of its entry (0 where there is
        # none), its removals and its additions; the groups past the last
        # have key 0 and all of these 0, so they keep nothing below
        per_row = torch.zeros((n, 4), dtype=I64, device=dev)
        per_row[:m, 0], per_row[:m, 1] = self._cnt, self._stamp
        per_row[m:m + nr, 2], per_row[m + nr:, 3] = 1, 1
        old, stamp_old, n_rem, n_add = torch.zeros((n, 4), dtype=I64, device=dev).index_add_(
            0, gid, per_row[order]).unbind(1)
        gkey = torch.zeros(n, dtype=I64, device=dev).scatter_(0, gid, ks)
        big = torch.iinfo(torch.int64).max
        first_add = torch.full((n,), big, dtype=I64, device=dev).scatter_reduce_(
            0, gid, torch.where(order >= m + nr, order - (m + nr), big), "amin")
        new = old - n_rem + n_add
        # an entry created, or emptied by the removals and refilled by the
        # additions, goes to the end of its node's order, as in the dict
        reborn = (old - n_rem == 0) & (n_add > 0)
        stamp_new = torch.where(reborn, self._next_stamp + first_add, stamp_old)
        self._next_stamp += na

        gnode = gkey >> DIGRAM_SHIFT
        touched = torch.zeros(self.n_nodes, dtype=torch.bool, device=dev)
        touched.index_fill_(0, rem_v, True).index_fill_(0, add_v, True)
        aff = touched[gnode]
        # before, after, live; scanned along rows (a scan down columns runs
        # one thread a column on the card)
        keep = torch.stack([aff & (old > 0), aff & (new > 0), new > 0])
        csum = torch.cumsum(keep, 1)
        t_csum = torch.cumsum(touched, 0)
        lens = torch.zeros((self.n_nodes, 2), dtype=I64, device=dev).index_add_(
            0, gnode, keep[:2].t().to(I64))  # a node's types before and after
        n_aff, n_b, n_a, n_live, pairs_a, longest = torch.cat(
            [t_csum[-1:], csum[:, -1], torch.stack([(lens[:, 1] * (lens[:, 1] + 1) // 2).sum(),
                                                    lens.max()])]).tolist()  # the one host sync

        # one signed CSR: the touched nodes' types before (-1) and after (+1)
        row_ptr = offsets_from_counts(_compact(touched, t_csum, n_aff, lens).t().reshape(-1))
        now = torch.stack([gkey, new, stamp_new], 1)
        before = _compact(keep[0], csum[0], n_b, torch.stack([gkey, old, stamp_old], 1))
        after = _compact(keep[1], csum[1], n_a, now)
        sign = torch.ones(2 * n_aff, dtype=torch.int32, device=dev)
        sign[:n_aff] = -1
        its = (torch.cat([before[:, 0], after[:, 0]]) & _MASK32).to(torch.int32)
        if self.cap is not None and longest > self.cap:
            cnts = torch.cat([_capped(*before.unbind(1), self.cap),
                              _capped(*after.unbind(1), self.cap)])
        else:
            cnts = torch.cat([before[:, 1], after[:, 1]])
        cnts = cnts.to(torch.int32)
        self._key, self._cnt, self._stamp = _compact(keep[2], csum[2], n_live, now).unbind(1)

        if self._popped:
            self.table.flags.bitwise_and_(SKIP)
        self._last, self._popped = None, []
        capacity = self.table.capacity
        if capacity is not None and self._used + pairs_a > LOAD * capacity:
            self._rebuild(2 * (self._used + pairs_a))  # the Count of the new histograms
            return
        ops.digram_pair_accum(self.table, row_ptr, its, cnts, sign)
        self._used += pairs_a  # at most this many new keys

    # -- selection ---------------------------------------------------------
    def _flag(self, slot: int, bit: int, on: bool = True) -> None:
        f = self.table.flags[slot:slot + 1]
        if on:
            f.bitwise_or_(bit)
        else:
            f.bitwise_and_(0xFF ^ bit)

    def _flag_keys(self, keys: list[int]) -> None:
        hit = torch.isin(self.table.keys, torch.tensor(keys, dtype=I64, device=self.table.keys.device))
        self.table.flags.bitwise_or_(hit.to(torch.uint8) * SKIP)

    def _select(self, skip: set | None):
        """(key, count, slot) of the best selectable digram, or None; new
        keys of `skip` are flagged first, through the slot a selection
        returned where there is one."""
        new = [k for k in skip if k not in self._skipped] if skip else []
        if new:
            self._skipped.update(new)
            slots = dict(self._popped + ([self._last] if self._last else []))
            for k in [k for k in new if k in slots]:
                self._flag(slots[k], SKIP)
            rest = [k for k in new if k not in slots]
            if rest:
                self._flag_keys(rest)
        # the selection's one host sync: 32 bytes
        key, count, slot, used = ops.digram_select(self.table).tolist()
        capacity = self.table.capacity
        if capacity is not None:
            if used > capacity:
                raise RuntimeError("the digram table overflowed")
            self._used = used
        if key < 0:
            return None
        self._last = (key, slot)
        return key, count, slot

    def peek_pop(self, skip: set | None = None) -> tuple[int, int] | None:
        """Take the current best (digram_key, count) off the selectable keys,
        or None, until :meth:`push_back`; digrams in `skip` are dropped."""
        got = self._select(skip)
        if got is None:
            return None
        key, count, slot = got
        self._flag(slot, POPPED)
        self._popped.append((key, slot))
        return key, count

    def push_back(self, key: int, count: int) -> None:
        """Return an entry obtained from :meth:`peek_pop`."""
        for i, (k, slot) in enumerate(self._popped):
            if k == key:
                del self._popped[i]
                self._flag(slot, POPPED, on=False)
                return

    def pop_best(self, skip: set | None = None) -> tuple[int, int] | None:
        """(digram_key, count) with the highest current count, or None; the
        entry stays selectable."""
        got = self._select(skip)
        return None if got is None else got[:2]

    def as_tensors(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(keys, counts) of the live digrams, keys ascending."""
        keys, cnts = self.table.live()
        return keys.to(device), cnts.to(device)
