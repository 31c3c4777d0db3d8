"""Per-engine mutation overlay: an uncompressed triple delta over a grammar,
as tensors on the engine's device.

The grammar is a static compression of a triple set: inserting or deleting
one triple would invalidate digram counts, rule bodies and the succinct
encoding at once. Each :class:`~repro_torch.core.query.TripleQueryEngine`
instead carries a :class:`DeltaOverlay`: a small buffer of inserted triples
(sorted by (s, p, o)) plus a set of tombstones, deleted *base* triples.
Queries stay exact because the engine merges the overlay into every
executed batch (:meth:`DeltaOverlay.merge_batch`):

* edges the grammar answers that match a tombstone are dropped (rank-2
  edges only);
* inserted triples matching the pattern are appended.

Both steps run over the whole unique-pattern batch on the device (a
``(n_queries, n_inserts)`` mask for the inserts, one row-set membership
pass for the tombstones), so the overlay's cost scales with its size,
which the engine bounds: past its budget (:func:`resolve_delta_budget`) it
recompresses base and delta into a fresh grammar and the overlay empties.

Set semantics: the logical triple set is ``(base - tombstones) + inserts``,
with inserts never in the visible base and tombstones always in it. The
engine keeps these invariants with a membership query before each mutation
batch, so re-inserting a deleted triple drops its tombstone and deleting an
overlay insert drops the buffered row: ``size`` counts real divergence from
the compressed base.

Rows are ``(n, 3)`` int64 tensors on the overlay's device; nothing here
moves them through the host.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64, lexsort, offsets_from_counts
from repro_torch.core.hypergraph import _ragged_take
from repro_torch.device import as_i64

# default rebuild budget: overlay rows tolerated before auto-recompression
DEFAULT_DELTA_BUDGET = 4096


def resolve_delta_budget(value=None) -> int | None:
    """A rebuild budget as ``int`` (the threshold; ``0`` recompresses after
    every applied mutation batch) or ``None`` (auto-rebuild off: only an
    explicit ``rebuild()`` recompresses). ``value=None`` gives
    :data:`DEFAULT_DELTA_BUDGET`; a negative value means off."""
    if value is None:
        return DEFAULT_DELTA_BUDGET
    value = int(value)
    return None if value < 0 else value


def _empty_rows(device) -> torch.Tensor:
    return torch.zeros((0, 3), dtype=I64, device=device)


def as_triple_rows(triples, device) -> torch.Tensor:
    """Validate and canonicalize a mutation batch: ``(n, 3)`` int64 rows on
    `device`, non-negative ids, deduplicated and sorted (mutations have set
    semantics, so duplicate rows in one batch are one mutation)."""
    rows = as_i64(triples, device)
    if rows.dim() != 2 or rows.shape[1] != 3:
        raise ValueError(f"expected (n, 3) triple rows, got shape {tuple(rows.shape)}")
    if rows.shape[0] == 0:
        return _empty_rows(device)
    if bool((rows < 0).any()):
        raise ValueError("triple ids must be non-negative (-1 means 'unbound' "
                         "in query patterns, not in data)")
    return torch.unique(rows, dim=0)


def rows_in(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise set membership: bool[len(a)], True where row a[i] occurs in b."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    _, inv = torch.unique(torch.cat([b, a]), dim=0, return_inverse=True)
    in_b = torch.zeros(int(b.shape[0] + a.shape[0]), dtype=torch.bool, device=a.device)
    in_b[inv[:b.shape[0]]] = True
    return in_b[inv[b.shape[0]:]]


def _in_sorted(values: torch.Tensor, sorted_col: torch.Tensor) -> torch.Tensor:
    """bool per value: does it occur in the sorted, non-empty `sorted_col`?"""
    at = torch.searchsorted(sorted_col, values).clamp(max=sorted_col.numel() - 1)
    return sorted_col[at] == values


def _sorted_rows(rows: torch.Tensor) -> torch.Tensor:
    return rows[lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


class DeltaOverlay:
    """Uncompressed (inserts, tombstones) delta over a compressed triple set
    on `device`.

    A plain data structure: the engine decides what is an insert and what a
    resurrection (see the module docstring); the overlay stores rows,
    answers patterns over its insert buffer and rewrites batch results.
    """

    __slots__ = ("device", "_inserts", "_tombstones")

    def __init__(self, device):
        self.device = torch.device(device)
        self._inserts = _empty_rows(self.device)
        self._tombstones = _empty_rows(self.device)

    # -- introspection ---------------------------------------------------
    @property
    def inserts(self) -> torch.Tensor:
        """Buffered inserted triples, sorted by (s, p, o)."""
        return self._inserts

    @property
    def tombstones(self) -> torch.Tensor:
        """Deleted base triples, sorted."""
        return self._tombstones

    @property
    def n_inserts(self) -> int:
        return int(self._inserts.shape[0])

    @property
    def n_tombstones(self) -> int:
        return int(self._tombstones.shape[0])

    @property
    def size(self) -> int:
        """Rows buffered either way: the divergence from the compressed base
        that the engine's budget bounds."""
        return self.n_inserts + self.n_tombstones

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    def clear(self) -> None:
        self._inserts = _empty_rows(self.device)
        self._tombstones = _empty_rows(self.device)

    def load_rows(self, inserts, tombstones) -> None:
        """Restore persisted overlay rows (the snapshot load path). Each side
        must already be canonical (sorted, deduplicated, disjoint from the
        other, with the module's invariants kept by whoever persisted them);
        they are adopted as they are."""
        self._inserts = as_i64(inserts, self.device).reshape(-1, 3)
        self._tombstones = as_i64(tombstones, self.device).reshape(-1, 3)

    # -- mutation --------------------------------------------------------
    def insert_rows(self, rows: torch.Tensor) -> int:
        """Record insertions of `rows`, which the caller has checked are NOT
        visible. Tombstoned rows are resurrected (their tombstone dropped);
        the rest join the sorted insert buffer."""
        n = int(rows.shape[0])
        if n == 0:
            return 0
        tombed = rows_in(rows, self._tombstones)
        if bool(tombed.any()):
            self._tombstones = self._tombstones[~rows_in(self._tombstones, rows[tombed])]
        fresh = rows[~tombed]
        if fresh.shape[0]:
            self._inserts = _sorted_rows(torch.cat([self._inserts, fresh]))
        return n

    def delete_rows(self, rows: torch.Tensor) -> int:
        """Record deletions of `rows`, which the caller has checked ARE
        visible. Overlay inserts are dropped from the buffer; base rows gain
        a tombstone."""
        n = int(rows.shape[0])
        if n == 0:
            return 0
        buffered = rows_in(rows, self._inserts)
        if bool(buffered.any()):
            self._inserts = self._inserts[~rows_in(self._inserts, rows[buffered])]
        base = rows[~buffered]
        if base.shape[0]:
            self._tombstones = _sorted_rows(torch.cat([self._tombstones, base]))
        return n

    # -- query side ------------------------------------------------------
    def apply(self, triples: torch.Tensor) -> torch.Tensor:
        """The logical triple set: `triples` (the decompressed base) minus
        tombstones, then the insert buffer. Base duplicates survive."""
        out = as_i64(triples, self.device).reshape(-1, 3)
        if self.n_tombstones:
            out = out[~rows_in(out, self._tombstones)]
        if self.n_inserts:
            out = torch.cat([out, self._inserts])
        return out

    def merge_batch(self, res, s: torch.Tensor, p: torch.Tensor, o: torch.Tensor):
        """Rewrite one executed unique-pattern batch under the overlay.

        `res` is the engine's ``(qids, labels, nodes_flat, offsets)`` result
        over the compressed base; `s` / `p` / `o` are the aligned pattern
        columns (-1 = unbound). Tombstoned rank-2 edges are dropped, then
        each query gains its matching inserted triples as appended rank-2
        edges. Returns the same tuple shape, on the same device.
        """
        qids, labels, nodes, offsets = res
        tombs = self._tombstones
        if tombs.shape[0] and labels.numel():
            ranks = offsets[1:] - offsets[:-1]
            starts = offsets[:-1]
            t_idx = torch.nonzero(ranks == 2).reshape(-1)
            # a cheap one-column prefilter before the row-wise membership
            # test, which sorts whole (s, p, o) rows: on an unselective
            # result (a ?p? scan) only edges sharing a tombstoned subject
            # reach it. The tombstones are sorted, so their subjects are a
            # sorted column to search
            if t_idx.numel():
                t_idx = t_idx[_in_sorted(nodes[starts[t_idx]], tombs[:, 0].contiguous())]
            if t_idx.numel():
                first = starts[t_idx]
                edge_rows = torch.stack([nodes[first], labels[t_idx], nodes[first + 1]], 1)
                dead = rows_in(edge_rows, tombs)
                if bool(dead.any()):
                    keep = torch.ones(labels.numel(), dtype=torch.bool, device=labels.device)
                    keep[t_idx[dead]] = False
                    idx = torch.nonzero(keep).reshape(-1)
                    ranks = ranks[idx]
                    take = _ragged_take(offsets, idx, ranks)
                    qids, labels, nodes = qids[idx], labels[idx], nodes[take]
                    offsets = offsets_from_counts(ranks)
        ins = self._inserts
        if ins.shape[0]:
            # (n_queries, n_inserts) mask: the budget bounds the insert
            # buffer, so it stays small even for wide batches
            match = ((s[:, None] < 0) | (ins[None, :, 0] == s[:, None])) \
                & ((p[:, None] < 0) | (ins[None, :, 1] == p[:, None])) \
                & ((o[:, None] < 0) | (ins[None, :, 2] == o[:, None]))
            qi, ri = torch.nonzero(match).unbind(1)
            if qi.numel():
                add_nodes = ins[ri][:, [0, 2]].reshape(-1)
                step = 2 * torch.arange(1, ri.numel() + 1, dtype=I64, device=ins.device)
                qids = torch.cat([qids, qi])
                labels = torch.cat([labels, ins[ri, 1]])
                nodes = torch.cat([nodes, add_nodes])
                offsets = torch.cat([offsets, offsets[-1] + step])
        return qids, labels, nodes, offsets
