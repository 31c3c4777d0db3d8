"""Triple queries on the compressed grammar, on the device, with a result
cache and a mutation overlay.

A batch of unique patterns takes one of two executors
(:meth:`TripleQueryEngine._execute_unique`):

* the **scalar worklist** (:meth:`TripleQueryEngine.query_scalar`) when the
  batch holds at most ``crossover`` patterns, each with S or O bound. It
  reads one row of the start graph's incidence k²-tree a query
  (:meth:`~repro_torch.core.succinct.K2Tree.row`: on the card one
  ``k2_lines_count`` and one ``k2_lines_write`` launch) and walks the rule
  bodies in Python, over host copies of the start graph and the rules made
  at build with one device-to-host copy: a worklist over card tensors
  would launch a kernel per edge. Its NT prune reads the NT k²-tree
  (``nt_k2``); one ``rows_many`` over every rule row fills a host cache of
  them at first use. ``crossover`` is measured at build on this grammar
  and device (:meth:`TripleQueryEngine._calibrate_crossover`) unless the
  caller gives it.
* the level-synchronous **frontier** otherwise:

  - S or O bound  -> the incidence k²-tree expands one row per query
    (``rows_many``: on the card one fused descent of the whole tree, the
    ``k2_lines_count`` and ``k2_lines_write`` launches with one host sync
    between them) to seed the frontier.
  - only P bound  -> start edges labeled P plus the edges of every
    nonterminal whose NT row says it can generate P.
  - nothing bound -> all start edges.

  Each frontier level then matches terminals into a result arena, prunes
  nonterminals by S/O containment and NT[label, P], and expands the rest
  through the flattened grammar's CSR gathers.

Both executors answer over the compressed base; ``_execute_unique`` then
merges the mutation overlay (:class:`~repro_torch.core.delta.DeltaOverlay`)
into their result on the device, so every path above it sees the logical
triple set. Above that sits the cross-request
:class:`~repro_torch.core.result_cache.QueryResultCache`: a batch's unique
patterns are looked up first (their keys read to the host once a batch),
only the misses execute, and each miss is stored as an entry owning its
storage.

Results come back as a :class:`QueryResultView`: one entry per unique
(S, P, O) pattern of the batch, all entries in one flat buffer, plus the
query -> entry map. :meth:`TripleQueryEngine.query_batch` and
:meth:`TripleQueryEngine.query` give (label, node tuple) pairs; the
paper's neighbourhood queries (``neighbors_out`` / ``neighbors_in`` and
their batched forms) give a node's distinct objects or subjects.

Above the single patterns sit the join and string surfaces: ``query_bgp``
evaluates a basic graph pattern through ``query_batch_view``
(:mod:`repro_torch.core.bgp`, planned by ``selectivity()``), and with an
attached :class:`~repro_torch.core.term_dict.TermDict` ``query_strings`` /
``query_bgp_strings`` take term strings, resolved on the host.

The engine is also the write surface: ``insert_triples`` /
``delete_triples`` record mutations in the overlay and bump the cache's
generation; past ``delta_budget`` overlay rows, :meth:`TripleQueryEngine.rebuild`
recompresses base and delta on the device (``compress`` -> ``encode`` -> a
fresh engine) and swaps the engine's state in one step.
"""
from __future__ import annotations

import bisect
import time

import torch

from repro_torch.core._arrays import I64, empty, lexsort, offsets_from_counts
from repro_torch.core.bgp import SelectivityStats, execute_bgp
from repro_torch.core.delta import DeltaOverlay, as_triple_rows, resolve_delta_budget
from repro_torch.core.encode import EncodedGrammar, encode
from repro_torch.core.flatten import FlatGrammar, FrontierArena, _ragged_arange
from repro_torch.core.grammar import Grammar
from repro_torch.core.hypergraph import Hypergraph, LabelTable, _ragged_take
from repro_torch.core.repair import compress
from repro_torch.core.result_cache import PackedEntry, QueryResultCache
from repro_torch.core.succinct import K2Tree
from repro_torch.core.term_dict import (
    bgp_result_to_terms,
    resolve_string_bgp,
    resolve_string_triple,
)
from repro_torch.device import as_i64, resolve_device
from repro_torch.persist.crash import crash_point

_ORACLE_CHUNK = 256  # queries per oracle scan step: 256 x 50k triples = 12.8 MB mask

# calibration cap: scalar routing never extends past this batch width
_MAX_CROSSOVER = 8

# sentinel: "a QueryResultCache of the default sizes"
_DEFAULT_CACHE = object()

# sentinel: "the default rebuild budget" (resolve_delta_budget())
_DEFAULT_BUDGET = object()


class QueryResultView:
    """Batch results as query id -> entry, one entry per unique pattern.

    Entry i is ``labels[b_i:b_{i+1}]`` with its node tuples, where ``b`` is
    ``entry_bounds``; duplicate queries share an entry. With a result cache
    the buffer is assembled once from the cached entries and the executed
    misses; a one-query view aliases its cached entry, so its tensors must
    not be written. :meth:`materialize` gives the flat per-query layout of
    ``query_batch_arrays``.
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

    def entry_tuples(self, index: int) -> list[tuple]:
        """Entry `index` as (label, (v0..vk)) pairs, read to the host in one
        copy (a per-element read would sync once an element on the card)."""
        labels, nodes, offsets = self.entry_at(index)
        n, m = labels.numel(), nodes.numel()
        host = torch.cat([labels, nodes, offsets]).tolist()
        nd, off = host[n:n + m], host[n + m:]
        return [(host[j], tuple(nd[off[j]:off[j + 1]])) for j in range(n)]

    def tuples(self, qid: int) -> list[tuple]:
        return self.entry_tuples(int(self.qid_entry[qid]))

    def tuple_lists(self) -> list[tuple]:
        """Per query id, its (label, nodes) pairs as a tuple, built once an
        entry: duplicate queries share one immutable tuple. The whole view
        comes to the host in one ``tolist``: the service's flush path."""
        n, m, ne = self.labels.numel(), self.nodes.numel(), self.n_entries
        host = torch.cat([self.labels, self.nodes, self.offsets, self.entry_bounds,
                          self.qid_entry]).tolist()
        labels, nodes = host[:n], host[n:n + m]
        off = host[n + m:2 * n + m + 1]
        bounds = host[2 * n + m + 1:2 * n + m + ne + 2]
        shared: list = [None] * ne
        out: list[tuple] = []
        for e in host[2 * n + m + ne + 2:]:
            t = shared[e]
            if t is None:
                t = shared[e] = tuple((labels[j], tuple(nodes[off[j]:off[j + 1]]))
                                      for j in range(bounds[e], bounds[e + 1]))
            out.append(t)
        return out

    @staticmethod
    def empty(device="cpu") -> "QueryResultView":
        """The zero-query view (what an empty flush returns)."""
        z = torch.zeros(1, dtype=I64, device=device)
        return QueryResultView(empty(device), empty(device), z, z.clone(), empty(device))

    @staticmethod
    def concat(views: list["QueryResultView"]) -> "QueryResultView":
        """Views over consecutive query-id ranges (micro-batch chunks) as
        one: the buffers concatenated, offsets, entry bounds and query ->
        entry maps shifted on the device by sizes the host already knows."""
        if not views:
            return QueryResultView.empty()
        if len(views) == 1:
            return views[0]
        dev = views[0].labels.device
        offs, bounds, qids = [torch.zeros(1, dtype=I64, device=dev)], [], []
        n_base = e_base = ent_base = 0
        bounds.append(offs[0])
        for v in views:
            offs.append(v.offsets[1:] + n_base)
            bounds.append(v.entry_bounds[1:] + e_base)
            qids.append(v.qid_entry + ent_base)
            n_base += v.nodes.numel()
            e_base += v.labels.numel()
            ent_base += v.n_entries
        return QueryResultView(torch.cat([v.labels for v in views]),
                               torch.cat([v.nodes for v in views]), torch.cat(offs),
                               torch.cat(bounds), torch.cat(qids))


class TripleQueryEngine:
    """Query engine over a grammar and its succinct encoding, on the
    grammar's device.

    `cache` is the cross-request result cache: by default a
    :class:`~repro_torch.core.result_cache.QueryResultCache` of its default
    sizes, ``None`` for none, or a cache (or a
    :class:`~repro_torch.core.result_cache.ShardCacheView` of a shared one)
    to share or size it. `crossover` is the batch width at or below which
    unique patterns with S or O bound take the scalar worklist instead of
    the frontier: ``None`` measures it on this grammar at build
    (``calibration`` then keeps the two best times it came from, in
    seconds), ``0`` always takes the frontier, a negative value counts as
    0. `delta_budget` bounds the mutation overlay before :meth:`rebuild`
    runs by itself (default 4,096 rows; ``None`` never, ``0`` after every
    applied mutation batch; see
    :func:`~repro_torch.core.delta.resolve_delta_budget`). `config` is the
    :class:`~repro_torch.core.repair.RepairConfig` rebuilds compress with:
    pass the one the grammar was built with."""

    def __init__(self, grammar: Grammar, encoded: EncodedGrammar | None = None,
                 cache=_DEFAULT_CACHE, crossover: int | None = None,
                 delta_budget=_DEFAULT_BUDGET, config=None):
        self.grammar = grammar
        self.encoded = encoded if encoded is not None else encode(grammar)
        start = grammar.start
        start = start.gather_edges(torch.sort(start.labels, stable=True).indices)
        self._init_state(grammar.table.n_terminals, FlatGrammar.from_grammar(grammar),
                         start, self.encoded.incidence, grammar.nt_generates(), crossover,
                         grammar.table.ranks.tolist(), cache, _budget(delta_budget), config)

    def _init_state(self, T: int, flat: FlatGrammar, start_sorted: Hypergraph,
                    incidence: K2Tree, nt_gen: torch.Tensor, crossover: int | None,
                    label_ranks: list[int], cache, delta_budget: int | None,
                    config) -> None:
        self.T = int(T)
        self._label_ranks = label_ranks  # host copy: insert_triples checks predicates
        self.flat = flat
        self.incidence = incidence
        self.device = start_sorted.device
        self._start_sorted = start_sorted
        self._sorted_labels = start_sorted.labels
        self._sorted_ranks = start_sorted.ranks()
        self._sorted_offsets = start_sorted.offsets
        self._sorted_nodes = start_sorted.nodes_flat
        self._arena = FrontierArena(self.device)
        # NT reachability matrix, k²-compressed (paper: matrix NT); rows are
        # label - T. Only the scalar worklist reads it.
        if nt_gen.numel():
            r, c = torch.nonzero(nt_gen).unbind(1)
            self.nt_k2 = K2Tree(r, c, nt_gen.shape[0], nt_gen.shape[1])
        else:
            self.nt_k2 = None
        self._nt_rows: dict[int, set] | None = None  # label -> terminals, filled at first use
        self._host_labels, self._edge_cache, self._rules = _host_structures(flat, start_sorted)
        self.cache = QueryResultCache() if cache is _DEFAULT_CACHE else cache
        # the mutation overlay, merged into every executed batch and bounded
        # by the rebuild budget
        self.delta = DeltaOverlay(self.device)
        self.delta_budget = delta_budget
        self.config = config  # the RepairConfig rebuilds compress with
        self.rebuild_count = 0
        self._base_edges: int | None = None  # |base triples|, counted at first use
        self.calibration = None  # the calibration's best times, when it ran
        self._select_stats = None  # SelectivityStats, computed at first use
        self.term_dict = None  # an attached TermDict (attach_term_dict)
        self.crossover = self._calibrate_crossover() if crossover is None \
            else max(0, int(crossover))

    @classmethod
    def from_numpy_state(cls, arrays: dict, meta: dict, device=None,
                         crossover: int | None = None, cache=_DEFAULT_CACHE,
                         delta_budget: int | None = None,
                         config=None) -> "TripleQueryEngine":
        """Build the query side from plain numpy arrays named as the
        reference's engine snapshot names them: ``table_ranks``,
        ``start_labels`` / ``start_nodes`` / ``start_offsets`` (label-sorted
        start graph), ``flat_<field>`` and ``k2_level_<i>``; `meta` carries
        the manifest's ``n_terminals``, ``start_n_nodes``, ``k2`` and
        ``crossover`` fields. `crossover` overrides the manifest's; with
        neither, it is measured.

        The engine has no grammar: its cache, overlay and mutations work
        (the predicates are checked against ``table_ranks``), but
        ``base_triples``, ``current_triples`` and ``rebuild`` raise, so
        `delta_budget` must stay ``None`` (no automatic rebuild)."""
        if delta_budget is not None and resolve_delta_budget(delta_budget) is not None:
            raise ValueError("an engine made by from_numpy_state has no grammar to rebuild "
                             "from: give delta_budget=None")
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
        label_ranks = as_i64(arrays["table_ranks"], "cpu").tolist()
        if len(label_ranks) != flat.rule_index.numel():
            raise ValueError("table_ranks and flat_rule_index disagree on #labels")
        self = cls.__new__(cls)
        self.grammar = None
        self.encoded = None
        # the NT tree from the flat bitsets, as the reference's from_state
        # does (rule labels are contiguous, so flat rows are label - T)
        self._init_state(T, flat, start, incidence, flat.nt_gen,
                         meta.get("crossover") if crossover is None else crossover,
                         label_ranks, cache, None, config)
        return self

    @classmethod
    def from_state(cls, grammar: Grammar, encoded: EncodedGrammar, flat: FlatGrammar, *,
                   crossover: int, cache=_DEFAULT_CACHE, delta_budget: int | None = None,
                   config=None, base_edges: int | None = None,
                   rebuild_count: int = 0) -> "TripleQueryEngine":
        """An engine from prebuilt parts: the snapshot load path. No RePair,
        no ``encode``, no ``FlatGrammar.from_grammar`` and no calibration:
        the stored `crossover` is kept. `grammar.start` must be label-sorted
        (the order ``encoded.incidence`` indexes); the NT tree comes from
        ``flat.nt_gen``. The overlay starts empty: callers restore it with
        :meth:`~repro_torch.core.delta.DeltaOverlay.load_rows`."""
        start = grammar.start
        if start.n_edges > 1 and bool((start.labels[1:] < start.labels[:-1]).any()):
            raise ValueError("from_state needs a label-sorted start graph")
        self = cls.__new__(cls)
        self.grammar = grammar
        self.encoded = encoded
        self._init_state(grammar.table.n_terminals, flat, start, encoded.incidence,
                         flat.nt_gen, int(crossover), grammar.table.ranks.tolist(), cache,
                         None if delta_budget is None else resolve_delta_budget(delta_budget),
                         config)
        # _init_state starts both afresh
        self._base_edges = None if base_edges is None else int(base_edges)
        self.rebuild_count = int(rebuild_count)
        return self

    # -- crossover calibration -------------------------------------------
    def _calibrate_crossover(self) -> int:
        """Measured batch width at or below which the scalar worklist beats
        a frontier of the same width on a selective probe: the ratio of the
        best of three times of a one-query frontier to that of one
        worklist query, clipped to [0, ``_MAX_CROSSOVER``]. The frontier's
        time counts only finished work: the device is synchronised before
        the clock is read."""
        probe = next((nodes[0] for _, nodes in self._edge_cache if nodes), None)
        if probe is None:
            return 1
        s1 = torch.tensor([probe], dtype=I64, device=self.device)
        u1 = torch.full((1,), -1, dtype=I64, device=self.device)
        t_scalar = t_batch = float("inf")
        for _ in range(3):
            _synchronize(self.device)
            t0 = time.perf_counter()
            self.query_scalar(probe, None, None)
            t_scalar = min(t_scalar, time.perf_counter() - t0)
            t0 = time.perf_counter()
            self._run_batch_unique(s1, u1, u1)
            _synchronize(self.device)
            t_batch = min(t_batch, time.perf_counter() - t0)
        self.calibration = {"scalar_s": t_scalar, "frontier_s": t_batch}
        if t_scalar <= 0:
            return 1
        return int(min(t_batch / t_scalar, _MAX_CROSSOVER))

    # -- scalar-path helpers -----------------------------------------------
    def _nt_generates(self, label: int, p: int) -> bool:
        """NT[label, p] from the host cache of NT k²-tree rows."""
        if self.nt_k2 is None:
            return False
        if self._nt_rows is None:
            self._nt_rows = self._fill_nt_rows()
        return p in self._nt_rows.get(label, ())

    def _fill_nt_rows(self) -> dict[int, set]:
        """Every rule's NT row as a host set, from one ``rows_many`` over
        all rule rows (one device-to-host copy)."""
        labels = self.flat.rule_labels
        idx, cols = self.nt_k2.rows_many(labels - self.T)
        host = torch.cat([labels, idx, cols]).tolist()
        n, m = labels.numel(), idx.numel()
        lbls = host[:n]
        rows = {lbl: set() for lbl in lbls}
        for i, c in zip(host[n:n + m], host[n + m:]):
            rows[lbls[i]].add(c)
        return rows

    def _edges_with_label(self, label: int) -> range:
        """Sorted-start edge ids labeled `label`."""
        return range(bisect.bisect_left(self._host_labels, label),
                     bisect.bisect_right(self._host_labels, label))

    def _row_edges(self, node: int) -> list[int]:
        """Edges incident to `node` via one incidence k²-tree row."""
        if node < 0 or node >= self.incidence.n_rows:
            return []
        return self.incidence.row(node).tolist()

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

    # -- dispatch ----------------------------------------------------------
    def _execute_unique(self, s, p, o):
        """Crossover dispatch over unique patterns: a batch of at most
        ``crossover`` patterns, all with S or O bound, takes the scalar
        worklist; everything else takes the frontier. Both answer over the
        compressed base; the mutation overlay is merged in here, on the
        device, so every path above sees the logical triple set. Returns
        (qids, labels, nodes_flat, offsets) on the engine's device."""
        w = s.numel()
        if 0 < w <= self.crossover and bool(((s >= 0) | (o >= 0)).all()):
            res = self._run_scalar_batch(s, p, o)
        else:
            res = self._run_batch_unique(s, p, o)
        if not self.delta.is_empty:
            res = self.delta.merge_batch(res, s, p, o)
        return res

    def _run_scalar_batch(self, s, p, o):
        """Per-query worklist over a tiny batch, frontier-shaped results
        (one host read of the batch, one copy of the results back)."""
        qids, labels, nodes, offsets = [], [], [], [0]
        for i, (si, pi, oi) in enumerate(zip(*torch.stack([s, p, o]).tolist())):
            for lbl, nd in self.query_scalar(si if si >= 0 else None, pi if pi >= 0 else None,
                                             oi if oi >= 0 else None):
                qids.append(i)
                labels.append(lbl)
                nodes.extend(nd)
                offsets.append(len(nodes))
        flat = torch.tensor(qids + labels + nodes + offsets, dtype=I64).to(self.device)
        n, m = len(labels), len(nodes)
        return flat[:n], flat[n:2 * n], flat[2 * n:2 * n + m], flat[2 * n + m:]

    # -- main entries ----------------------------------------------------
    def query_batch_arrays(self, s_arr, p_arr, o_arr):
        """Array-native batch query; -1 (or None) marks an unbound slot.

        Returns (qids, labels, nodes_flat, offsets): matching terminal edge
        i belongs to query qids[i], has label labels[i] and node tuple
        nodes_flat[offsets[i]:offsets[i+1]].
        """
        return self._run_batch(*_normalize_batch(s_arr, p_arr, o_arr, self.device))

    def _run_batch(self, s, p, o):
        """The flat batch layout. Without a cache, duplicate patterns run
        once and their results are replicated; with one, the cached view
        path runs, and a one-query batch aliases its cached entry."""
        if self.cache is not None:
            view = self._run_batch_view(s, p, o)
            if view.n_queries == 1:  # the hot serving path: no gather
                return (torch.zeros(view.labels.numel(), dtype=I64, device=self.device),
                        view.labels, view.nodes, view.offsets)
            return view.materialize()
        n = s.numel()
        if n > 1:  # dedup never helps a batch of one
            uniq, inv = torch.unique(torch.stack([s, p, o], dim=1), dim=0,
                                     return_inverse=True)
            if uniq.shape[0] < n:
                view = _split_per_query(
                    self._execute_unique(uniq[:, 0], uniq[:, 1], uniq[:, 2]),
                    uniq.shape[0], inv.reshape(-1))
                return view.materialize()
        return self._execute_unique(s, p, o)

    def query_batch_view(self, s_arr, p_arr, o_arr) -> QueryResultView:
        """Batch query returning a :class:`QueryResultView`: one entry per
        unique pattern and the query -> entry map."""
        s, p, o = _normalize_batch(s_arr, p_arr, o_arr, self.device)
        return self._run_batch_view(s, p, o)

    def _run_batch_view(self, s, p, o) -> QueryResultView:
        """One entry per unique pattern. With a cache, the unique patterns
        are looked up first (their keys read to the host once), only the
        misses execute, and each miss is stored as an entry owning its
        storage; the view is one buffer assembled from hits and misses."""
        cache = self.cache
        one = torch.zeros(1, dtype=I64, device=self.device)
        if cache is None:
            if s.numel() == 1:
                return _split_per_query(self._execute_unique(s, p, o), 1, one)
            uniq, inv = torch.unique(torch.stack([s, p, o], dim=1), dim=0,
                                     return_inverse=True)
            res = self._execute_unique(uniq[:, 0], uniq[:, 1], uniq[:, 2])
            return _split_per_query(res, uniq.shape[0], inv.reshape(-1))
        if s.numel() == 1:  # the hot serving path: no unique / split machinery
            cols = torch.stack([s, p, o])
            return _view_of_entries([self._cached_one(cols.reshape(-1).tolist(), cols)], one)
        uniq, inv = torch.unique(torch.stack([s, p, o], dim=1), dim=0, return_inverse=True)
        inv = inv.reshape(-1)
        keys = uniq.tolist()
        entries = [_packed(cache.lookup(*k)) for k in keys]
        miss = [i for i, e in enumerate(entries) if e is None]
        if not miss:
            return _view_of_entries(entries, inv)
        part = uniq if len(miss) == len(keys) else \
            uniq[torch.tensor(miss, dtype=I64).to(self.device)]
        fresh = _split_per_query(self._execute_unique(part[:, 0], part[:, 1], part[:, 2]),
                                 len(miss), inv)
        for i, entry in zip(miss, _owned_entries(fresh)):
            entries[i] = entry
            cache.insert(*keys[i], entry)
        if len(miss) == len(keys):
            return fresh  # every pattern missed: the executed batch is the view
        return _view_of_entries(entries, inv)

    def _cached_one(self, key: list, cols=None):
        """One pattern's cached entry: a hit, or the pattern executed (its
        (3, 1) columns `cols`, made from `key` when None) and stored."""
        hit = _packed(self.cache.lookup(*key))
        if hit is None:
            if cols is None:
                cols = torch.tensor(key, dtype=I64).reshape(3, 1).to(self.device)
            _, labels, nodes, offsets = self._execute_unique(*cols)
            hit = _own_entry(labels, nodes, offsets)
            self.cache.insert(*key, hit)
        return hit

    def query_batch(self, s_arr, p_arr, o_arr) -> list[list[tuple]]:
        """Batch query returning, per query, (label, (v0..vk)) pairs: the
        contents of ``query_scalar`` / the oracle per query."""
        s, p, o = _normalize_batch(s_arr, p_arr, o_arr, self.device)
        r_q, r_l, r_n, r_o = self._run_batch(s, p, o)
        order = torch.sort(r_q, stable=True).indices
        n, m = order.numel(), r_n.numel()
        host = torch.cat([r_q[order], r_l[order], r_o[:-1][order], r_o[1:][order],
                          r_n]).tolist()
        nodes = host[4 * n:4 * n + m]
        results: list[list[tuple]] = [[] for _ in range(s.numel())]
        for q, lbl, a, b in zip(host[:n], host[n:2 * n], host[2 * n:3 * n], host[3 * n:4 * n]):
            results[q].append((lbl, tuple(nodes[a:b])))
        return results

    def query(self, s: int | None, p: int | None, o: int | None) -> list[tuple]:
        """Matching terminal edges as (label, (v0..vk)) pairs. With S or O
        bound, a crossover of at least 1, no cache and an empty overlay the
        scalar worklist (which answers over the base) answers directly,
        without the array round trip."""
        if self.cache is None:
            if self.crossover >= 1 and self.delta.is_empty and (s is not None or o is not None):
                return self.query_scalar(s, p, o)
            return self.query_batch([s], [p], [o])[0]
        # the key is on the host already: look it up without a device round
        # trip, and read a hit back in one copy
        key = [-1 if v is None else int(v) for v in (s, p, o)]
        entry = self._cached_one(key)
        n, m = entry.n_edges, entry.n_nodes
        host = entry.buf.tolist()  # [labels | nodes | offsets]
        nodes = host[n:n + m]
        return [(lbl, tuple(nodes[a:b]))
                for lbl, a, b in zip(host[:n], host[n + m:n + m + n], host[n + m + 1:])]

    def query_scalar(self, s: int | None, p: int | None, o: int | None) -> list[tuple]:
        """Per-query Python worklist over the host copies of the start graph
        and the rules, over the compressed base only (the overlay is merged
        above it, in ``_execute_unique``); None marks an unbound slot. The
        executor the crossover dispatch routes tiny selective batches to."""
        if s is not None or o is not None:
            r = s if s is not None else o
            seeds = [self._edge_cache[j] for j in self._row_edges(int(r))]
        elif p is not None:
            seeds = [self._edge_cache[j] for j in self._edges_with_label(int(p))]
            for lbl in self._rules:
                if self._nt_generates(lbl, int(p)):
                    seeds.extend(self._edge_cache[j] for j in self._edges_with_label(lbl))
        else:
            seeds = list(self._edge_cache)

        out: list[tuple] = []
        z = seeds
        while z:
            label, nodes = z.pop()
            if label >= self.T:  # nonterminal
                if s is not None and s not in nodes:
                    continue
                if o is not None and o not in nodes:
                    continue
                if p is not None and not self._nt_generates(label, p):
                    continue
                for child_label, params in self._rules[label]:
                    z.append((child_label, tuple(nodes[j] for j in params)))
            elif self._matches(label, nodes, s, p, o):
                out.append((label, nodes))
        return out

    @staticmethod
    def _matches(label, nodes, s, p, o) -> bool:
        if p is not None and label != p:
            return False
        if s is not None and (len(nodes) < 1 or nodes[0] != s):
            return False
        if o is not None and (len(nodes) < 2 or nodes[1] != o):
            return False
        return True

    # -- mutation --------------------------------------------------------
    def insert_triples(self, triples) -> int:
        """Insert (s, p, o) rows; returns how many were new.

        Rows already visible (in the base and not tombstoned, or buffered)
        are no-ops; tombstoned rows are resurrected. Predicates must be
        rank-2 terminal labels of this grammar; node ids may pass the base
        graph's (the node universe grows at the next rebuild). An applied
        mutation bumps the cache's generation and, once the overlay exceeds
        `delta_budget`, runs :meth:`rebuild`. The rows stay on the engine's
        device."""
        rows = as_triple_rows(triples, self.device)
        if rows.shape[0]:
            preds = torch.unique(rows[:, 1]).tolist()
            if preds[-1] >= self.T:
                raise ValueError(f"predicate ids must be < {self.T} (terminal labels); "
                                 f"got {preds[-1]}")
            if any(self._label_ranks[q] != 2 for q in preds):
                raise ValueError("predicates must be rank-2 terminal labels (the node-label "
                                 "terminals of ITR+ are not triple predicates)")
            rows = rows[~self._exists_rows(rows)]
        applied = self.delta.insert_rows(rows)
        self._after_mutation(applied)
        return applied

    def delete_triples(self, triples) -> int:
        """Delete (s, p, o) rows; returns how many were present. Deleting an
        overlay insert drops it from the buffer, deleting a base triple
        tombstones it, deleting an absent triple does nothing; the cache and
        the budget as in :meth:`insert_triples`."""
        rows = as_triple_rows(triples, self.device)
        if rows.shape[0]:
            rows = rows[self._exists_rows(rows)]
        applied = self.delta.delete_rows(rows)
        self._after_mutation(applied)
        return applied

    def contains_triples(self, triples) -> torch.Tensor:
        """bool per (s, p, o) row: is it visible on this engine (base minus
        tombstones plus inserts)? Aligned with the input (no dedup, no sort)
        and run with the cache detached."""
        rows = as_i64(triples, self.device)
        if rows.numel() == 0:
            return torch.zeros(0, dtype=torch.bool, device=self.device)
        if rows.dim() != 2 or rows.shape[1] != 3:
            raise ValueError(f"expected (n, 3) triple rows, got shape {tuple(rows.shape)}")
        return self._exists_rows(rows)

    @property
    def base_edges(self) -> int:
        """Triple count of the compressed base, counted by decompressing it
        once a grammar (a rebuild sets it from its rows)."""
        if self._base_edges is None:
            self._base_edges = int(self.base_triples().shape[0])
        return self._base_edges

    def _exists_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """bool per row: is this triple visible? One batch query with the
        cache detached: a membership probe must not fill the cache with
        entries the mutation is about to invalidate."""
        cache, self.cache = self.cache, None
        try:
            view = self._run_batch_view(rows[:, 0], rows[:, 1], rows[:, 2])
        finally:
            self.cache = cache
        return view.result_counts() > 0

    def _after_mutation(self, applied: int) -> None:
        if not applied:
            return
        if self.cache is not None:
            self.cache.bump_generation()
        if self.delta_budget is not None and self.delta.size > self.delta_budget:
            self.rebuild()

    def _require_grammar(self, what: str) -> Grammar:
        if self.grammar is None:
            raise NotImplementedError(
                f"{what} needs the grammar, and an engine made by from_numpy_state from bare "
                f"arrays has none; open a snapshot with repro_torch.persist.load_snapshot "
                f"for an engine that has one")
        return self.grammar

    def base_triples(self) -> torch.Tensor:
        """The compressed base as (n, 3) rows, in the decompression's order;
        the grammar must be a pure triple grammar (every decompressed edge
        of rank 2)."""
        g = self._require_grammar("base_triples").decompress()
        if g.n_edges == 0:
            return torch.zeros((0, 3), dtype=I64, device=self.device)
        if not bool((g.ranks() == 2).all()):
            raise ValueError("base graph has non-triple (rank != 2) edges; "
                             "triple mutation and rebuild need a pure triple set")
        starts = g.offsets[:-1]
        return torch.stack([g.nodes_flat[starts], g.labels, g.nodes_flat[starts + 1]], 1)

    def current_triples(self) -> torch.Tensor:
        """The logical triple set: the decompressed base with the overlay
        applied (tombstones removed, inserts appended)."""
        return self.delta.apply(self.base_triples())

    def rebuild(self, config=None) -> bool:
        """Recompress base and delta into a fresh grammar and swap it in.

        ``compress`` runs on the device over the overlay-applied triples
        with `config` (default: the engine's), then ``encode`` and a fresh
        engine at this engine's crossover (no recalibration); the engine's
        attributes are replaced in one ``__dict__`` update, so it is never
        seen half rebuilt between method calls (queries running
        concurrently with the swap must be serialised against it). The
        cache survives and gets a generation bump. Returns False when the
        overlay is empty (nothing to do)."""
        if self.delta.is_empty:
            return False
        grammar = self._require_grammar("rebuild")
        config = config if config is not None else self.config
        triples = self.current_triples()
        n_nodes = grammar.start.n_nodes
        if triples.shape[0]:
            n_nodes = max(n_nodes, int(triples[:, [0, 2]].max()) + 1)
        table = LabelTable.terminals(grammar.table.ranks[:self.T].clone(),
                                     names=grammar.table.names)
        fresh_grammar, _ = compress(Hypergraph.from_triples(triples, n_nodes), table, config)
        fresh = TripleQueryEngine(fresh_grammar, cache=self.cache, crossover=self.crossover,
                                  delta_budget=self.delta_budget, config=config)
        fresh._base_edges = int(triples.shape[0])  # the new base is these rows
        rebuilds = self.rebuild_count + 1
        term_dict = self.term_dict  # survives the swap, as the cache does
        # a kill here loses only memory: the swap below never touches disk
        crash_point("engine.rebuild")
        self.__dict__.update(fresh.__dict__)
        self.rebuild_count = rebuilds
        self.term_dict = term_dict
        if self.cache is not None:
            self.cache.bump_generation()
        return True

    # -- BGP joins -------------------------------------------------------
    def selectivity(self) -> SelectivityStats:
        """Join-ordering stats (per-predicate cardinalities, distinct
        subject and object counts) of the compressed base, from the flat
        grammar and the label-sorted start graph without decompressing:
        the per-rule counts on the host, from the rule bodies copied there
        at build. Computed at first use; a rebuild swaps in a fresh engine's
        state, so the next call recomputes them. The overlay is ignored:
        stats only order joins."""
        if self._select_stats is None:
            self._select_stats = SelectivityStats.from_csr(
                self._sorted_labels, self._sorted_ranks, self._sorted_nodes,
                self._sorted_offsets, self.flat, self.T, rules=self._rules)
        return self._select_stats

    def query_bgp(self, patterns):
        """Evaluate a basic graph pattern, a conjunction of triple patterns
        with shared ``?var`` terms such as ``"?x 0 ?y . ?y 1 17"``, as a
        :class:`~repro_torch.core.bgp.BGPResult`. :meth:`selectivity` plans
        the joins and each step runs through :meth:`query_batch_view`, so
        sub-patterns take the frontier or the worklist, the cache and the
        overlay merge."""
        return execute_bgp(patterns, self.query_batch_view, self.selectivity())

    # -- string terms (an attached TermDict) ---------------------------------
    def attach_term_dict(self, term_dict) -> None:
        """Attach a :class:`~repro_torch.core.term_dict.TermDict` for the
        string surfaces (:meth:`query_strings`, :meth:`query_bgp_strings`).
        It survives :meth:`rebuild`."""
        self.term_dict = term_dict

    def _require_term_dict(self):
        if self.term_dict is None:
            raise ValueError(
                "no term dictionary attached: call attach_term_dict() "
                "(or ingest through repro_torch.data.ingest, which attaches one)")
        return self.term_dict

    def query_strings(self, s: str | None, p: str | None, o: str | None) -> list[tuple]:
        """One (S, P, O) pattern in term strings, ``None`` unbound. Terms
        resolve to ids here, on the host; a bound term the dictionary has
        never seen answers ``[]`` without executing. Returns ``(s, p, o)``
        term triples."""
        td = self._require_term_dict()
        s_id, p_id, o_id, known = resolve_string_triple(td, s, p, o)
        if not known:
            return []
        out = []
        for label, nodes in self.query(s_id, p_id, o_id):
            if len(nodes) != 2:
                raise ValueError(f"string queries need rank-2 edges, got rank {len(nodes)}")
            out.append((td.node_term(nodes[0]), td.pred_term(label), td.node_term(nodes[1])))
        return out

    def query_bgp_strings(self, patterns) -> list[dict]:
        """:meth:`query_bgp` in string terms: (s, p, o) tuples of ``?var``
        names and constant term strings. An unknown constant answers ``[]``
        without executing. Returns ``[{var: term}, ...]`` in the result's
        row order."""
        td = self._require_term_dict()
        id_patterns, pred_vars, known = resolve_string_bgp(td, patterns)
        if not known:
            return []
        return bgp_result_to_terms(td, self.query_bgp(id_patterns), pred_vars)

    # -- neighbourhood queries ---------------------------------------------
    def neighbors_out_batch(self, vs) -> list[torch.Tensor]:
        """Per v: its distinct objects (outgoing neighbourhood), sorted, one
        batch. Duplicate vs share one tensor; a negative v has none."""
        return self._neighbors(vs, 1)

    def neighbors_in_batch(self, vs) -> list[torch.Tensor]:
        """Per v: its distinct subjects (incoming neighbourhood), one batch."""
        return self._neighbors(vs, 0)

    def _neighbors(self, vs, slot: int) -> list[torch.Tensor]:
        vs = as_i64(vs, self.device).reshape(-1)
        neg = vs < 0
        # a negative id would read as unbound: it queries an out-of-range
        # row and answers empty below, whatever the overlay holds there
        vs = torch.where(neg, self.incidence.n_rows, vs)
        unbound = torch.full_like(vs, -1)
        cols = (vs, unbound, unbound) if slot == 1 else (unbound, unbound, vs)
        view = self._run_batch_view(*cols)
        per_entry = _entry_distinct_slot(view, slot)
        n = vs.numel()
        host = torch.cat([view.qid_entry, neg.to(I64)]).tolist()
        none = empty(self.device)
        return [none if host[n + i] else per_entry[host[i]] for i in range(n)]

    def neighbors_out(self, v: int) -> torch.Tensor:
        """v ? ? -> distinct objects (outgoing neighbourhood)."""
        return self.neighbors_out_batch([v])[0]

    def neighbors_in(self, v: int) -> torch.Tensor:
        """? ? v -> distinct subjects (incoming neighbourhood)."""
        return self.neighbors_in_batch([v])[0]


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


def _own_entry(labels, nodes, offsets) -> PackedEntry:
    """One query's (labels, nodes_flat, offsets) copied into one buffer of
    its own, so a cache entry pins nothing else."""
    return PackedEntry(torch.cat([labels, nodes, offsets]), labels.numel(), nodes.numel())


def _owned_entries(g: QueryResultView) -> list[PackedEntry]:
    """Each entry of grouped view `g` in one buffer of its own size (a slice
    of the batch's buffer would keep the whole batch alive and defeat the
    cache's edge budgets): one host read of the entries' sizes, one scatter
    that lays every entry out as [labels | nodes | offsets from 0], then
    the entries copied out in batched launches (``_foreach_add`` of 0, out
    of place; a ``clone`` an entry costs a launch and an allocation of host
    time each, the batched copy an allocation)."""
    ne = g.n_entries
    if ne == 0:
        return []
    bounds = g.entry_bounds
    node_bounds = g.offsets[bounds]
    host = torch.cat([bounds, node_bounds]).tolist()
    eb, nb = host[:ne + 1], host[ne + 1:]
    n_e = [eb[i + 1] - eb[i] for i in range(ne)]
    n_n = [nb[i + 1] - nb[i] for i in range(ne)]
    dev = bounds.device
    e_t = bounds[1:] - bounds[:-1]
    n_t = node_bounds[1:] - node_bounds[:-1]
    at = offsets_from_counts(2 * e_t + n_t + 1)  # where each entry starts
    ids = torch.arange(ne, dtype=I64, device=dev)
    packed = torch.empty(2 * eb[-1] + nb[-1] + ne, dtype=I64, device=dev)
    ent = torch.repeat_interleave(ids, e_t, output_size=eb[-1])
    packed[(at[:-1] - bounds[:-1])[ent] + torch.arange(eb[-1], dtype=I64, device=dev)] = g.labels
    ent = torch.repeat_interleave(ids, n_t, output_size=nb[-1])
    packed[(at[:-1] + e_t - node_bounds[:-1])[ent]
           + torch.arange(nb[-1], dtype=I64, device=dev)] = g.nodes
    n_o = eb[-1] + ne  # each entry's offsets, one longer than its edges
    ent = torch.repeat_interleave(ids, e_t + 1, output_size=n_o)
    j = _ragged_arange(e_t + 1, n_o)
    packed[(at[:-1] + e_t + n_t)[ent] + j] = \
        g.offsets[bounds[:-1][ent] + j] - node_bounds[:-1][ent]
    sizes = [2 * e + n + 1 for e, n in zip(n_e, n_n)]
    owned = torch._foreach_add(list(torch.split(packed, sizes)), 0)
    return [PackedEntry(buf, e, n) for buf, e, n in zip(owned, n_e, n_n)]


def _view_of_entries(entries: list, qid_entry: torch.Tensor) -> QueryResultView:
    """A view over packed entries in entry order: one concatenation of
    their buffers, then labels, nodes and offsets gathered out of it on the
    device (sizes from the entries, no host sync); a single entry is
    aliased."""
    dev = qid_entry.device
    if len(entries) == 1:
        e = entries[0]
        labels, nodes, offsets = e.parts()
        return QueryResultView(labels, nodes, offsets,
                               torch.tensor([0, e.n_edges], dtype=I64).to(dev), qid_entry)
    if not entries:
        return QueryResultView(empty(dev), empty(dev), torch.zeros(1, dtype=I64, device=dev),
                               torch.zeros(1, dtype=I64, device=dev), qid_entry)
    n_e = [e.n_edges for e in entries]
    n_n = [e.n_nodes for e in entries]
    eb, nb, at = [0], [0], [0]  # each entry's first edge, node and buffer position
    for e, n in zip(n_e, n_n):
        eb.append(eb[-1] + e)
        nb.append(nb[-1] + n)
        at.append(at[-1] + 2 * e + n + 1)
    buf = torch.cat([e.buf for e in entries])
    e_t, n_t, eb_t, nb_t, at_t = torch.tensor(
        [n_e, n_n, eb[:-1], nb[:-1], at[:-1]], dtype=I64).to(dev).unbind(0)
    ids = torch.arange(len(entries), dtype=I64, device=dev)
    ent = torch.repeat_interleave(ids, e_t, output_size=eb[-1])
    k = torch.arange(eb[-1], dtype=I64, device=dev) - eb_t[ent]  # the edge within its entry
    labels = buf[at_t[ent] + k]
    # an edge's end offset sits after its entry's labels, nodes and leading 0
    ends = buf[(at_t + e_t + n_t + 1)[ent] + k] + nb_t[ent]
    ent = torch.repeat_interleave(ids, n_t, output_size=nb[-1])
    nodes = buf[(at_t + e_t - nb_t)[ent] + torch.arange(nb[-1], dtype=I64, device=dev)]
    offsets = torch.cat([torch.zeros(1, dtype=I64, device=dev), ends])
    return QueryResultView(labels, nodes, offsets, offsets_from_counts(e_t), qid_entry)


def _gather_entries(src: QueryResultView, piece_src: torch.Tensor, piece_dst: torch.Tensor,
                    n_entries: int, qid_entry: torch.Tensor) -> QueryResultView:
    """A view of `n_entries` entries, each the concatenation of the `src`
    entries ``piece_src`` names for it: ``piece_dst[i]`` (non-decreasing)
    is the entry piece i lands in; an entry no piece names is empty. One
    replication pass on the device, two host syncs (its sizes), whatever
    the number of pieces."""
    counts = src.entry_counts()
    _, labels, nodes, offsets = _replicate_sorted(
        src.labels, src.nodes, src.offsets[1:] - src.offsets[:-1], src.offsets, counts,
        piece_src)
    per_entry = torch.zeros(n_entries, dtype=I64, device=src.labels.device).index_add_(
        0, piece_dst, counts[piece_src])
    return QueryResultView(labels, nodes, offsets, offsets_from_counts(per_entry), qid_entry)


def _packed(entry):
    """A cache hit as a :class:`PackedEntry` (None stays None): the engine
    stores only those, but a shared cache may hold a caller's tuples."""
    if entry is None or isinstance(entry, PackedEntry):
        return entry
    return _own_entry(*entry)


def _budget(delta_budget) -> int | None:
    """The constructor's `delta_budget`: the sentinel gives the default,
    ``None`` turns automatic rebuilds off, an int resolves as
    :func:`~repro_torch.core.delta.resolve_delta_budget` says."""
    if delta_budget is _DEFAULT_BUDGET:
        return resolve_delta_budget()
    return None if delta_budget is None else resolve_delta_budget(delta_budget)


def _entry_distinct_slot(view: QueryResultView, slot: int) -> list[torch.Tensor]:
    """Per entry of `view`: the distinct nodes at tuple position `slot`,
    sorted; one ``torch.unique`` over (entry, value) keys for the whole
    view, split by entry (views of one buffer)."""
    n_entries = view.n_entries
    if n_entries == 0:
        return []
    ranks = view.offsets[1:] - view.offsets[:-1]
    entry = torch.repeat_interleave(torch.arange(n_entries, device=ranks.device),
                                    view.entry_counts(), output_size=ranks.numel())
    keep = ranks > slot
    keys = torch.stack([entry[keep], _slot(view.nodes, view.offsets, ranks, slot)[keep]], 1)
    uniq = torch.unique(keys, dim=0)
    counts = torch.bincount(uniq[:, 0], minlength=n_entries)
    return list(torch.split(uniq[:, 1].contiguous(), counts.tolist()))


def _host_structures(flat: FlatGrammar, start_sorted: Hypergraph):
    """The scalar worklist's host structures, from one device-to-host copy
    of the label-sorted start graph and the rule bodies: the sorted start
    labels, each start edge as (label, node tuple), and each rule label's
    body as (child label, parameter tuple) pairs."""
    g = start_sorted
    parts = (g.labels, g.offsets, g.nodes_flat, flat.rule_labels, flat.edge_offsets,
             flat.edge_labels, flat.param_offsets, flat.params)
    host = torch.cat(parts).tolist()
    cols, pos = [], 0
    for t in parts:
        cols.append(host[pos:pos + t.numel()])
        pos += t.numel()
    labels, offsets, nodes, rule_labels, edge_offsets, edge_labels, param_offsets, params = cols
    edges = [(labels[j], tuple(nodes[offsets[j]:offsets[j + 1]])) for j in range(len(labels))]
    rules = {lbl: [(edge_labels[e], tuple(params[param_offsets[e]:param_offsets[e + 1]]))
                   for e in range(edge_offsets[r], edge_offsets[r + 1])]
             for r, lbl in enumerate(rule_labels)}
    return labels, edges, rules


def _synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
