"""Triple queries on the compressed grammar, batched, on the device.

The port's engine behaves as the reference's ``TripleQueryEngine`` with
``cache=None, crossover=0, delta_budget=None``: every batch runs through
the level-synchronous frontier.

* S or O bound  -> the start graph's incidence k²-tree expands one row per
  query (``rows_many``: on the card one fused descent of the whole tree,
  the ``k2_lines_count`` and ``k2_lines_write`` launches with one host
  sync between them) to seed the frontier.
* only P bound  -> start edges labeled P plus the edges of every
  nonterminal whose NT row says it can generate P.
* nothing bound -> all start edges.

Each frontier level then matches terminals into a result arena, prunes
nonterminals by S/O containment and NT[label, P], and expands the rest
through the flattened grammar's CSR gathers.

Results come back as a :class:`QueryResultView`: one entry per unique
(S, P, O) pattern of the batch, all entries in one flat buffer, plus the
query -> entry map.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64, empty, lexsort, offsets_from_counts
from repro_torch.core.encode import EncodedGrammar, encode
from repro_torch.core.flatten import FlatGrammar, FrontierArena, _ragged_arange
from repro_torch.core.grammar import Grammar
from repro_torch.core.hypergraph import Hypergraph, _ragged_take
from repro_torch.core.succinct import K2Tree
from repro_torch.device import as_i64, resolve_device

_ORACLE_CHUNK = 256  # queries per oracle scan step: 256 x 50k triples = 12.8 MB mask


class QueryResultView:
    """Batch results as query id -> entry, one entry per unique pattern.

    Entry i is ``labels[b_i:b_{i+1}]`` with its node tuples, where ``b`` is
    ``entry_bounds``; duplicate queries share an entry. :meth:`materialize`
    gives the flat per-query layout of ``query_batch_arrays``.
    """

    __slots__ = ("labels", "nodes", "offsets", "entry_bounds", "qid_entry")

    def __init__(self, labels, nodes, offsets, entry_bounds, qid_entry):
        self.labels = labels
        self.nodes = nodes
        self.offsets = offsets
        self.entry_bounds = entry_bounds
        self.qid_entry = qid_entry

    @property
    def n_queries(self) -> int:
        return int(self.qid_entry.numel())

    @property
    def n_entries(self) -> int:
        return int(self.entry_bounds.numel()) - 1

    def entry_at(self, i: int):
        """(labels, nodes_flat, offsets) of entry i (views, offsets rebased)."""
        e0, e1 = int(self.entry_bounds[i]), int(self.entry_bounds[i + 1])
        n0, n1 = int(self.offsets[e0]), int(self.offsets[e1])
        return self.labels[e0:e1], self.nodes[n0:n1], self.offsets[e0:e1 + 1] - n0

    def entry(self, qid: int):
        return self.entry_at(int(self.qid_entry[qid]))

    def entry_counts(self) -> torch.Tensor:
        return self.entry_bounds[1:] - self.entry_bounds[:-1]

    def result_counts(self) -> torch.Tensor:
        """Matching-edge count per query id."""
        return self.entry_counts()[self.qid_entry]

    def total_results(self) -> int:
        return int(self.result_counts().sum())

    def materialize(self):
        """(qids, labels, nodes_flat, offsets) with every duplicate query's
        results replicated, as ``query_batch_arrays`` returns them."""
        return _replicate_sorted(self.labels, self.nodes, self.offsets[1:] - self.offsets[:-1],
                                 self.offsets, self.entry_counts(), self.qid_entry)


class TripleQueryEngine:
    """Query engine over a grammar and its succinct encoding, on the
    grammar's device."""

    def __init__(self, grammar: Grammar, encoded: EncodedGrammar | None = None):
        self.grammar = grammar
        self.encoded = encoded if encoded is not None else encode(grammar)
        start = grammar.start
        start = start.gather_edges(torch.sort(start.labels, stable=True).indices)
        self._init_state(grammar.table.n_terminals, FlatGrammar.from_grammar(grammar),
                         start, self.encoded.incidence)

    def _init_state(self, T: int, flat: FlatGrammar, start_sorted: Hypergraph,
                    incidence: K2Tree) -> None:
        self.T = int(T)
        self.flat = flat
        self.incidence = incidence
        self.device = start_sorted.device
        self._start_sorted = start_sorted
        self._sorted_labels = start_sorted.labels
        self._sorted_ranks = start_sorted.ranks()
        self._sorted_offsets = start_sorted.offsets
        self._sorted_nodes = start_sorted.nodes_flat
        self._arena = FrontierArena(self.device)

    @classmethod
    def from_numpy_state(cls, arrays: dict, meta: dict, device=None) -> "TripleQueryEngine":
        """Build the query side from plain numpy arrays named as the
        reference's engine snapshot names them: ``table_ranks``,
        ``start_labels`` / ``start_nodes`` / ``start_offsets`` (label-sorted
        start graph), ``flat_<field>`` and ``k2_level_<i>``; `meta` carries
        the manifest's ``n_terminals``, ``start_n_nodes`` and ``k2`` fields."""
        dev = resolve_device(device)
        T = int(meta["n_terminals"])
        start = Hypergraph(int(meta.get("start_n_nodes", 0)),
                           as_i64(arrays["start_labels"], dev),
                           as_i64(arrays["start_nodes"], dev),
                           as_i64(arrays["start_offsets"], dev))
        if start.n_edges > 1 and bool((start.labels[1:] < start.labels[:-1]).any()):
            raise ValueError("from_numpy_state needs a label-sorted start graph")
        flat = FlatGrammar.from_arrays(
            T, {name: arrays[f"flat_{name}"] for name in FlatGrammar._ARRAY_FIELDS}, dev)
        k2m = meta["k2"]
        n_levels = len(k2m["level_bits"])
        incidence = K2Tree.from_levels(
            k2m["n_rows"], k2m["n_cols"], k2m["k"], k2m["h"], k2m["n_points"],
            [as_i64(arrays[f"k2_level_{i}"], dev) for i in range(n_levels)],
            k2m["level_bits"], device=dev)
        if int(as_i64(arrays["table_ranks"], "cpu").numel()) != flat.rule_index.numel():
            raise ValueError("table_ranks and flat_rule_index disagree on #labels")
        self = cls.__new__(cls)
        self.grammar = None
        self.encoded = None
        self._init_state(T, flat, start, incidence)
        return self

    # -- batched seeding -------------------------------------------------
    def _seed_batch(self, s, p, o):
        """Start-graph edge ids seeding each query; returns (qids, edge_ids)."""
        dev = self.device
        all_qids, all_eids = [], []

        so = (s >= 0) | (o >= 0)
        so_q = torch.nonzero(so).reshape(-1)
        if so_q.numel():
            nodes = torch.where(s[so_q] >= 0, s[so_q], o[so_q])
            idx, eids = self.incidence.rows_many(nodes)
            all_qids.append(so_q[idx])
            all_eids.append(eids)

        p_q = torch.nonzero(~so & (p >= 0)).reshape(-1)
        if p_q.numel():
            pq = p[p_q]
            # seed labels: the terminal P itself + every NT generating P
            seed_labels, owners = [pq], [p_q]
            valid = (pq >= 0) & (pq < self.T)
            if self.flat.n_rules and bool(valid.any()):
                ntmask = self.flat.nt_gen[:, pq.clamp(0, self.T - 1)].T & valid[:, None]
                qi, ri = torch.nonzero(ntmask).unbind(1)
                seed_labels.append(self.flat.rule_labels[ri])
                owners.append(p_q[qi])
            lbls = torch.cat(seed_labels)
            own = torch.cat(owners)
            lo = torch.searchsorted(self._sorted_labels, lbls)
            hi = torch.searchsorted(self._sorted_labels, lbls, right=True)
            counts = hi - lo
            total = int(counts.sum())
            all_eids.append(torch.repeat_interleave(lo, counts, output_size=total)
                            + _ragged_arange(counts, total))
            all_qids.append(torch.repeat_interleave(own, counts, output_size=total))

        open_q = torch.nonzero(~so & (p < 0)).reshape(-1)
        if open_q.numel():
            E = self._sorted_labels.numel()
            all_eids.append(torch.arange(E, dtype=I64, device=dev).repeat(open_q.numel()))
            all_qids.append(torch.repeat_interleave(open_q, E))

        if not all_qids:
            return empty(dev), empty(dev)
        return torch.cat(all_qids), torch.cat(all_eids)

    # -- batched frontier ------------------------------------------------
    def _run_batch_unique(self, s, p, o):
        """Frontier over a batch; returns (qids, labels, nodes_flat, offsets)
        of the matching terminal edges, unordered across queries."""
        qids, eids = self._seed_batch(s, p, o)
        labels = self._sorted_labels[eids]
        ranks = self._sorted_ranks[eids]
        nodes = self._sorted_nodes[_ragged_take(self._sorted_offsets, eids, ranks)]
        offsets = offsets_from_counts(ranks)
        # which prunes can fire at all, decided once per batch
        any_s, any_p, any_o = (bool((c >= 0).any()) for c in (s, p, o))

        arena = self._arena
        arena.reset()
        guard = 0
        while labels.numel():
            guard += 1
            assert guard <= self.flat.n_rules + 2, "frontier expansion did not terminate"
            is_nt = labels >= self.T
            n_nt = int(is_nt.sum())

            # terminals: match filter -> arena
            if n_nt < labels.numel():
                tl, tn, to, (tq,) = _ragged_select(labels, nodes, offsets, ~is_nt, qids)
                tr = to[1:] - to[:-1]
                first = _slot(tn, to, tr, 0)
                second = _slot(tn, to, tr, 1)
                sq, pq, oq = s[tq], p[tq], o[tq]
                match = (pq < 0) | (tl == pq)
                match &= (sq < 0) | ((tr >= 1) & (first == sq))
                match &= (oq < 0) | ((tr >= 2) & (second == oq))
                midx = torch.nonzero(match).reshape(-1)
                if midx.numel():
                    mranks = tr[midx]
                    arena.push(tq[midx], tl[midx], mranks, tn[_ragged_take(to, midx, mranks)])

            if n_nt == 0:
                break
            # nonterminals: S/O-containment and NT[label, P] prunes as masks
            nl, nn, no, (nq,) = _ragged_select(labels, nodes, offsets, is_nt, qids)
            nr = no[1:] - no[:-1]
            sq, pq, oq = s[nq], p[nq], o[nq]
            keep = torch.ones(nl.numel(), dtype=torch.bool, device=self.device)
            if any_s:
                keep &= (sq < 0) | _contains(nn, nr, sq)
            if any_o:
                keep &= (oq < 0) | _contains(nn, nr, oq)
            if any_p:
                valid_p = (pq >= 0) & (pq < self.T)
                gen = self.flat.generates(nl, pq.clamp(0, max(self.T - 1, 0)))
                keep &= (pq < 0) | (valid_p & gen)
            el, en, eo, (eq,) = _ragged_select(nl, nn, no, keep, nq)
            if el.numel() == 0:
                break
            labels, nodes, offsets, (qids,) = self.flat.expand(el, en, eo, eq)

        return arena.finish()

    # -- main entries ----------------------------------------------------
    def query_batch_arrays(self, s_arr, p_arr, o_arr):
        """Array-native batch query; -1 (or None) marks an unbound slot.

        Returns (qids, labels, nodes_flat, offsets): matching terminal edge
        i belongs to query qids[i], has label labels[i] and node tuple
        nodes_flat[offsets[i]:offsets[i+1]].
        """
        s, p, o = _normalize_batch(s_arr, p_arr, o_arr, self.device)
        n = s.numel()
        if n > 1:  # dedup never helps a batch of one
            uniq, inv = torch.unique(torch.stack([s, p, o], dim=1), dim=0,
                                     return_inverse=True)
            if uniq.shape[0] < n:
                view = _split_per_query(
                    self._run_batch_unique(uniq[:, 0], uniq[:, 1], uniq[:, 2]),
                    uniq.shape[0], inv.reshape(-1))
                return view.materialize()
        return self._run_batch_unique(s, p, o)

    def query_batch_view(self, s_arr, p_arr, o_arr) -> QueryResultView:
        """Batch query returning a :class:`QueryResultView`: one entry per
        unique pattern and the query -> entry map."""
        s, p, o = _normalize_batch(s_arr, p_arr, o_arr, self.device)
        return self._run_batch_view(s, p, o)

    def _run_batch_view(self, s, p, o) -> QueryResultView:
        if s.numel() == 1:
            return _split_per_query(self._run_batch_unique(s, p, o), 1,
                                    torch.zeros(1, dtype=I64, device=self.device))
        uniq, inv = torch.unique(torch.stack([s, p, o], dim=1), dim=0, return_inverse=True)
        res = self._run_batch_unique(uniq[:, 0], uniq[:, 1], uniq[:, 2])
        return _split_per_query(res, uniq.shape[0], inv.reshape(-1))


# ----------------------------------------------------------------------
def _normalize_batch(s_arr, p_arr, o_arr, device):
    """None / -1-sentinel columns -> aligned int64 tensors with -1 = unbound."""
    if s_arr is None and p_arr is None and o_arr is None:
        raise ValueError(
            "at least one of s/p/o must be an array; with all three None the "
            "batch size is unknown (for all-unbound queries pass [None] * n)")
    n = max(len(c) for c in (s_arr, p_arr, o_arr) if c is not None)
    cols = []
    for c in (s_arr, p_arr, o_arr):
        if c is None:
            cols.append(torch.full((n,), -1, dtype=I64, device=device))
        elif isinstance(c, (list, tuple)):
            cols.append(torch.tensor([-1 if v is None else int(v) for v in c],
                                     dtype=I64, device=device))
        else:
            cols.append(as_i64(c, device).reshape(-1))
    s, p, o = cols
    assert s.numel() == p.numel() == o.numel(), "query columns must be aligned"
    return s, p, o


def _ragged_select(labels, nodes, offsets, mask, *payload):
    """Edges where mask holds from a ragged (labels, nodes, offsets) batch;
    payload columns are filtered alongside."""
    idx = torch.nonzero(mask).reshape(-1)
    ranks = (offsets[1:] - offsets[:-1])[idx]
    take = _ragged_take(offsets, idx, ranks)
    return (labels[idx], nodes[take], offsets_from_counts(ranks),
            tuple(c[idx] for c in payload))


def _slot(nodes, offsets, ranks, m: int) -> torch.Tensor:
    """nodes[offsets[e] + m] per edge, -1 where rank <= m."""
    if nodes.numel() == 0:
        return torch.full((ranks.numel(),), -1, dtype=I64, device=ranks.device)
    vals = nodes[(offsets[:-1] + m).clamp(max=nodes.numel() - 1)]
    return torch.where(ranks > m, vals, -1)


def _contains(nodes, ranks, targets) -> torch.Tensor:
    """Per edge e: does targets[e] occur among its nodes? (segment any)"""
    n_edges = ranks.numel()
    total = nodes.numel()
    seg = torch.repeat_interleave(torch.arange(n_edges, device=nodes.device), ranks,
                                  output_size=total)
    hits = (nodes == torch.repeat_interleave(targets, ranks, output_size=total)).to(I64)
    return torch.zeros(n_edges, dtype=I64, device=nodes.device).index_add_(0, seg, hits) > 0


def _split_per_query(res, nq: int, qid_entry: torch.Tensor) -> QueryResultView:
    """Group batch results by query id (one stable sort) into a view whose
    entry i holds unique query i's results."""
    r_q, r_l, r_n, r_o = res
    order = torch.sort(r_q, stable=True).indices
    ranks = (r_o[1:] - r_o[:-1])[order]
    nodes = r_n[_ragged_take(r_o, order, ranks)]
    bounds = offsets_from_counts(torch.bincount(r_q, minlength=nq))
    return QueryResultView(r_l[order], nodes, offsets_from_counts(ranks), bounds, qid_entry)


def _replicate_sorted(u_l, u_n, u_ranks, u_o, counts, inv):
    """Unique results grouped in unique-query order (`counts[u]` edges for
    unique query u) -> the full batch, where query q receives unique query
    inv[q]'s results."""
    starts = offsets_from_counts(counts)[:-1]
    out_counts = counts[inv]
    n_out = int(out_counts.sum()) if out_counts.numel() else 0
    eidx = torch.repeat_interleave(starts[inv], out_counts, output_size=n_out) \
        + _ragged_arange(out_counts, n_out)
    r_q = torch.repeat_interleave(torch.arange(inv.numel(), device=inv.device), out_counts,
                                  output_size=n_out)
    ranks = u_ranks[eidx]
    r_n = u_n[_ragged_take(u_o, eidx, ranks)]
    return r_q, u_l[eidx], r_n, offsets_from_counts(ranks)


def result_rows(qids, labels, nodes, offsets) -> torch.Tensor:
    """Rank-2 results as (qid, s, p, o) rows in canonical (sorted) order."""
    first = nodes[offsets[:-1]] if labels.numel() else labels
    second = nodes[offsets[:-1] + 1] if labels.numel() else labels
    rows = torch.stack([qids, first, labels, second], dim=1)
    return rows[lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))]


def query_oracle(triples, s, p, o) -> torch.Tensor:
    """Plain scan of the uncompressed triples, for checks: every (qid, s,
    p, o) row where triple (s, p, o) matches query qid, in canonical order.
    Queries are -1 where unbound; the scan holds one (chunk x triples)
    match mask at a time."""
    triples = triples.to(I64)
    dev = triples.device
    s, p, o = (as_i64(c, dev).reshape(-1) for c in (s, p, o))
    ts, tp, to = triples[:, 0][None, :], triples[:, 1][None, :], triples[:, 2][None, :]
    qs, es = [], []
    for c0 in range(0, s.numel(), _ORACLE_CHUNK):
        ss, pp, oo = (c[c0:c0 + _ORACLE_CHUNK, None] for c in (s, p, o))
        m = ((ss < 0) | (ts == ss)) & ((pp < 0) | (tp == pp)) & ((oo < 0) | (to == oo))
        qi, ei = torch.nonzero(m).unbind(1)
        qs.append(qi + c0)
        es.append(ei)
    if not qs:
        return torch.zeros((0, 4), dtype=I64, device=dev)
    q, e = torch.cat(qs), torch.cat(es)
    rows = torch.cat([q[:, None], triples[e]], dim=1)
    return rows[lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))]
