"""Incidence-types, digrams, and the paper's occurrence counting.

An incidence-type is ``(label a, connection-type m)``, flattened to
``it_offsets[a] + m``; a digram is an unordered pair of incidence-types,
flattened to ``min(it1, it2) << 32 | max``. The per-node digram score is
``min(c(v,i1), c(v,i2))`` for ``i1 != i2`` and ``c(v,i1) // 2`` for
``i1 == i2``, summed over nodes.

* :func:`digram_counts` is the full recount on the device. Its pair stage
  is the hand-written ``digram_pair_counts`` kernel, run once per group of
  nodes with the same histogram size d (K = d, so no node pads to `cap`),
  followed by a segment-sum over the keys in torch.
* :class:`DigramCounter` is the paper's Update Count step. It takes its
  initial counts and heap from :func:`digram_counts`; its per-replacement
  update stays host Python, as in the reference.
"""
from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

import torch

from repro_torch.core._arrays import I64, empty, group_starts, lexsort
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.kernels import ops

DIGRAM_SHIFT = 32
_MASK32 = (1 << 32) - 1


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


def digram_counts(graph: Hypergraph, table: LabelTable, cap: int | None = 64):
    """Full recount. Returns (digram_keys, counts), counts > 0, keys sorted."""
    dev = graph.device
    v, it, cnts = node_it_counts(graph, table)
    if v.numel() == 0:
        return empty(dev), empty(dev)
    order = lexsort((-cnts, v))  # by node, then count descending
    v, it, cnts = v[order], it[order], cnts[order]
    starts = group_starts(v)
    sizes = torch.diff(starts, append=torch.tensor([v.numel()], device=dev))
    if cap is not None:
        rank_in_group = torch.arange(v.numel(), device=dev) \
            - torch.repeat_interleave(starts, sizes)
        keep = torch.nonzero(rank_in_group < cap).reshape(-1)
        v, it, cnts = v[keep], it[keep], cnts[keep]
        starts = group_starts(v)
        sizes = torch.diff(starts, append=torch.tensor([v.numel()], device=dev))
    if int(it.max()) >= 2**31 or int(cnts.max()) >= 2**31:
        raise ValueError("incidence types and counts must fit in int32")
    it32, cnt32 = it.to(torch.int32), cnts.to(torch.int32)

    all_keys, all_cv = [], []
    for d in torch.unique(sizes).tolist():
        g_starts = starts[sizes == d]
        idx = g_starts[:, None] + torch.arange(d, device=dev)[None, :]  # (G, d)
        lo, hi, cv = ops.digram_pair_counts(it32[idx].contiguous(),
                                            cnt32[idx].contiguous())
        mask = cv > 0
        all_keys.append((lo[mask].to(I64) << DIGRAM_SHIFT) | hi[mask].to(I64))
        all_cv.append(cv[mask].to(I64))
    keys = torch.cat(all_keys)
    cv = torch.cat(all_cv)
    uk, inv = torch.unique(keys, return_inverse=True)
    sums = torch.zeros(uk.numel(), dtype=I64, device=dev).index_add_(0, inv, cv)
    return uk, sums


class DigramCounter:
    """Incremental digram counts (paper's Count + Update Count steps).

    Holds per-node incidence-type histograms and the global digram count
    table as host dicts; a replacement notifies it with the removed / added
    incidence lists and only the touched nodes are recomputed. A lazy
    max-heap serves "most frequent digram" queries. The heap pops by
    (-count, key) and keys are unique, so the pop order depends only on the
    counts.
    """

    def __init__(self, graph: Hypergraph, table: LabelTable, cap: int | None = 64):
        self.cap = cap
        self.node_hist: dict[int, dict[int, int]] = defaultdict(dict)
        v, it, cnts = node_it_counts(graph, table)
        v_l, it_l, cnt_l = v.tolist(), it.tolist(), cnts.tolist()
        hist = self.node_hist
        for node, t, c in zip(v_l, it_l, cnt_l):  # sorted by (node, it)
            hist[node][t] = c
        keys, counts = digram_counts(graph, table, cap)
        self.pair_counts: dict[int, int] = defaultdict(
            int, zip(keys.tolist(), counts.tolist()))
        self._heap: list[tuple[int, int]] = [(-c, k) for k, c in self.pair_counts.items()]
        heapq.heapify(self._heap)

    # -- per-node contributions ------------------------------------------
    def _node_items(self, node: int):
        items = self.node_hist.get(node)
        if not items:
            return ()
        if self.cap is not None and len(items) > self.cap:
            return sorted(items.items(), key=lambda kv: -kv[1])[: self.cap]
        return tuple(items.items())

    def _apply_contrib(self, node: int, sign: int, touch: set | None = None):
        items = self._node_items(node)
        n = len(items)
        pc = self.pair_counts
        for i in range(n):
            it1, c1 = items[i]
            half = c1 // 2
            if half:
                k = (it1 << DIGRAM_SHIFT) | it1
                pc[k] += sign * half
                if touch is not None:
                    touch.add(k)
            for j in range(i + 1, n):
                it2, c2 = items[j]
                cv = c1 if c1 < c2 else c2
                if cv:
                    k = digram_key(it1, it2)
                    pc[k] += sign * cv
                    if touch is not None:
                        touch.add(k)

    # -- update after replacement ----------------------------------------
    def apply_delta(self, removed, added):
        """removed / added: (nodes, its) incidence tensors of deleted / new edges."""
        rem_v, rem_it = (x.tolist() for x in removed)
        add_v, add_it = (x.tolist() for x in added)
        affected = set(rem_v) | set(add_v)
        touched: set = set()
        for node in affected:
            self._apply_contrib(node, -1, touched)
        for v_arr, it_arr, sign in ((rem_v, rem_it, -1), (add_v, add_it, +1)):
            for v, it in zip(v_arr, it_arr):
                h = self.node_hist[v]
                nv = h.get(it, 0) + sign
                if nv:
                    h[it] = nv
                else:
                    h.pop(it, None)
        for node in affected:
            self._apply_contrib(node, +1, touched)
        for k in touched:
            c = self.pair_counts.get(k, 0)
            if c > 0:
                heapq.heappush(self._heap, (-c, k))
            elif c == 0:
                self.pair_counts.pop(k, None)

    def peek_pop(self, skip: set | None = None) -> tuple[int, int] | None:
        """Pop the current best (digram_key, count) off the heap, or None.
        Stale entries are reinserted at their current count; digrams in
        `skip` are dropped."""
        while self._heap:
            negc, key = heapq.heappop(self._heap)
            cur = self.pair_counts.get(key, 0)
            if cur <= 0 or (skip is not None and key in skip):
                continue
            if cur != -negc:
                heapq.heappush(self._heap, (-cur, key))
                continue
            return key, cur
        return None

    def push_back(self, key: int, count: int) -> None:
        heapq.heappush(self._heap, (-count, key))

    def pop_best(self, skip: set | None = None) -> tuple[int, int] | None:
        """(digram_key, count) with the highest current count, or None; the
        entry stays on the heap."""
        item = self.peek_pop(skip)
        if item is not None:
            self.push_back(*item)
        return item

    def as_tensors(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        items = sorted((k, c) for k, c in self.pair_counts.items() if c > 0)
        keys = torch.tensor([k for k, _ in items], dtype=I64, device=device)
        cnts = torch.tensor([c for _, c in items], dtype=I64, device=device)
        return keys, cnts
