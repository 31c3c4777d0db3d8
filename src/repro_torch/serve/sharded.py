"""Sharded triple serving: partitioned engines on one card behind a
scatter-gather router with a shared result-cache tier; the twin of
``repro.serve.sharded``.

One engine per graph partition (:mod:`repro_torch.distributed.partition`),
all sharing one :class:`~repro_torch.core.result_cache.QueryResultCache`
keyed by ``(shard, S, P, O)`` through per-shard views: one budget, one stats
block, no collisions. The router sends each pattern to the one shard that
owns it when the partition axis is bound (P under ``predicate_hash``, S
under ``node_range``) and scatter-gathers the others across every shard,
in one micro-batch a shard a ``max_batch`` chunk, however many patterns
scatter.

The plan is host state (numpy, the reference's code): pattern columns
come from host lists and are routed there; a write's rows come to the host
once to be routed, and each shard's rows go to the card in one copy.

Merging stays on the card. Each shard answers its sub-batch as
:class:`~repro_torch.core.query.QueryResultView` chunks (one flat buffer
each); the flush concatenates them, and one gather builds the flush's view:
an owned pattern's entry is its shard's, a scattered pattern's is the
concatenation of its per-shard entries in shard order (partitions are
disjoint, so no dedup), duplicate tickets share an entry. A flush's own host
syncs are a handful, however many patterns it holds: no read an entry or a
pattern. Merged scattered results are cached in a reserved namespace of
the shared tier (``_MERGED_SHARD``), so a warm scattered pattern is one
lookup.

Partitions are mutable. ``insert_triples`` / ``delete_triples`` route rows
to their owning shard (``PartitionPlan.route_triples``, the build's own
placement rule) and apply them to that engine's overlay; only the mutated
shards' cache generations are bumped (plus the merged namespace). A shard
whose overlay outgrows its delta budget recompresses on its own;
:meth:`ShardedTripleService.rebuild` is the explicit handle.

Partitions re-cut themselves. The tier watches its live per-shard edge
counts; when their ``max/mean`` skew reaches ``rebalance_skew`` (or on an
explicit :meth:`ShardedTripleService.rebalance`) it computes a successor
plan (:mod:`repro_torch.distributed.rebalance`) and migrates the rows whose
owner changed, in bounded batches, each arriving at its destination before
it leaves its source inside one call. While moves are pending the router
trusts single-shard ownership only where the outgoing and incoming plans
agree, and scatters the rest; writes of rows in motion delete on both
candidate shards, or insert on the incoming owner after probing the
outgoing one.

Thread contract: queries are *readers* under the service's
:class:`~repro_torch.serve.concurrency.RWLock`; every write, rebuild,
rebalance step and failure handling is an exclusive *writer*. Within one
flush, per-shard work fans out over a thread pool of ``serve_threads``;
per-engine locks serialise each engine's scratch state, every thread
launches on the caller's current CUDA stream (one stream), and the merge
runs in shard order, so threaded and sequential flushes give equal views.

Reads may go to replicas. Once a durable service attaches a
:class:`~repro_torch.serve.replication.ReplicationManager`, a flush runs
whole on one dispatchable replica group (its own engines on the card, its
own cache namespaces) or, when none is, or when the flushing thread holds
the write lock, on the primary.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core._arrays import I64, empty
from repro_torch.core.bgp import (
    SelectivityStats,
    bgp_cache_key,
    bgp_variables,
    decode_result_entry,
    encode_result_entry,
    execute_bgp,
    parse_bgp,
)
from repro_torch.core.delta import as_triple_rows
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.core.query import (
    _DEFAULT_BUDGET,
    QueryResultView,
    TripleQueryEngine,
    _gather_entries,
    _owned_entries,
    _packed,
    _view_of_entries,
)
from repro_torch.core.repair import compress
from repro_torch.core.result_cache import QueryResultCache
from repro_torch.core.term_dict import (
    bgp_result_to_terms,
    resolve_string_bgp,
    resolve_string_triple,
)
from repro_torch.device import resolve_device
from repro_torch.distributed.partition import PartitionPlan, make_plan, partition_triples
from repro_torch.distributed.rebalance import (
    live_shard_edges,
    measure_skew,
    plan_rebalance,
    resolve_rebalance_skew,
)
from repro_torch.persist.crash import crash_point
from repro_torch.serve.concurrency import RWLock, resolve_serve_threads
from repro_torch.serve.triple_service import MicroBatchService

# sentinel: "a shared QueryResultCache of the default sizes"
_DEFAULT_CACHE = object()

# sentinel: "the default rebalance trigger" (resolve_rebalance_skew())
_DEFAULT_SKEW = object()

# migration rows an automatically triggered rebalance applies a mutation
# call: the trigger starts the migration and each later applied mutation
# drains another bounded chunk (an explicit rebalance() drains it all)
_AUTO_MOVES_PER_CALL = 4096

# reserved shard id of merged scattered results in the shared tier (real
# shards are >= 0, -1 is a lone engine's namespace); invalidate() bumps it
# beside any shard, since a merged entry depends on every shard's data
_MERGED_SHARD = -2


@dataclass
class ShardedServiceStats:
    """Rolling counters of the scatter-gather router.

    `owned` / `scattered` count unique patterns a flush; `shard_batches`
    the engine micro-batches, ``ceil(sub_batch / max_batch)`` a shard a
    flush, where a shard's sub-batch is its owned patterns plus every
    scattered one."""

    queries: int = 0
    flushes: int = 0
    results: int = 0
    unique_patterns: int = 0
    owned: int = 0
    scattered: int = 0
    merged_hits: int = 0  # scattered patterns answered from the merged tier
    shard_batches: int = 0
    inserted: int = 0     # triples actually added (mutation no-ops excluded)
    deleted: int = 0      # triples actually removed
    rebuilds: int = 0     # per-shard recompressions (automatic and explicit)
    rebalances: int = 0   # migrations started (automatic and explicit)
    migrated_rows: int = 0  # rows moved between shards by rebalancing
    degraded_patterns: int = 0  # patterns answered around a failed shard
    replica_flushes: int = 0  # flushes served by a read replica group
    bgp_queries: int = 0      # whole-BGP joins answered (hits and executions)
    bgp_cache_hits: int = 0   # BGPs served from the merged cache
    string_queries: int = 0   # query_strings / query_bgp_strings calls
    unknown_term_empties: int = 0  # string queries answered [] for an unknown term
    total_s: float = 0.0
    last_flush_qps: float = 0.0

    @property
    def qps(self) -> float:
        return self.queries / self.total_s if self.total_s > 0 else 0.0


def _host_ids(x) -> np.ndarray:
    """int64 ids on the host (a tensor is copied once)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def _host_rows(triples) -> np.ndarray:
    """A mutation batch canonicalised on the host (validated, deduplicated,
    sorted: :func:`~repro_torch.core.delta.as_triple_rows`), as numpy."""
    return as_triple_rows(triples, "cpu").numpy()


class ShardedTripleService(MicroBatchService):
    """Scatter-gather front end over P partitioned
    :class:`~repro_torch.core.query.TripleQueryEngine` s on one device.

    Construct it from built engines and their plan (one engine a shard, in
    shard order, all on one device), or with :meth:`build` from triples.
    The request plane (`submit` / `flush` / `query_many`) is
    :class:`~repro_torch.serve.triple_service.MicroBatchService`'s.
    `bgp_cache` keeps whole-BGP results in the merged namespace.
    """

    def __init__(self, engines: list[TripleQueryEngine], plan: PartitionPlan,
                 cache: QueryResultCache | None = None, max_batch: int = 1024,
                 config=None, rebalance_skew=_DEFAULT_SKEW,
                 serve_threads: int | None = None, bgp_cache: bool = True, device=None):
        super().__init__()
        if len(engines) != plan.n_shards:
            raise ValueError(f"{len(engines)} engines for {plan.n_shards} shards")
        self.engines = engines
        self.plan = plan
        # the engines' device; `device` names it when a recovering caller
        # passes placeholders (None) for shards it will mark failed
        self.device = torch.device(device) if device is not None \
            else next(e.device for e in engines if e is not None)
        self.cache = cache  # the shared tier (engines hold shard views of it)
        self.bgp_cache = bool(bgp_cache)
        self.max_batch = int(max_batch)
        self.config = config  # the RepairConfig shard rebuilds compress with
        self.stats = ShardedServiceStats()
        # queries read-lock, every mutating surface write-locks
        self._rw = RWLock()
        # engines keep scratch state (the frontier arena), so two threads of
        # one flush must not enter the same engine at once
        self._engine_locks = [threading.Lock() for _ in engines]
        self._stats_lock = threading.Lock()  # stats blocks are not atomic
        #: scatter fan-out width (threads a flush); 1 = sequential
        self.serve_threads = resolve_serve_threads(serve_threads)
        self._pool: ThreadPoolExecutor | None = None  # made at first use
        self._pool_lock = threading.Lock()
        # auto-rebalance trigger (max/mean live-edge skew); None = explicit only
        if rebalance_skew is _DEFAULT_SKEW:
            self.rebalance_skew = resolve_rebalance_skew()
        else:
            self.rebalance_skew = None if rebalance_skew is None \
                else resolve_rebalance_skew(rebalance_skew)
        self._migration = None        # the RebalancePlan in flight, or None
        self._futile_total: int | None = None  # the auto trigger's backoff anchor
        #: shards whose recovery failed: served as empty holes, writes refused
        self.failed_shards: set[int] = set()
        # durability hook: called as _journal(kind, payload) BEFORE a
        # rebalance state change applies; None until a durable service
        # installs one
        self._journal = None
        # cache-namespace indirection: shard k's entries live under
        # namespace _cache_ns[k] of the shared tier, merged scattered results
        # under _merged_ns. The primary uses the identity mapping; replica
        # group services (repro_torch.serve.replication) take disjoint
        # negative namespaces, so a lagging replica serves its own
        # generation's entries and never mixes them with the primary's
        self._cache_ns: list[int] = list(range(plan.n_shards))
        self._merged_ns: int = _MERGED_SHARD
        # read-replica dispatch: a ReplicationManager once the durable
        # service enables replication (flushes then prefer a replica group)
        self._replicas = None
        # optional TermDict for the string surfaces (attach_term_dict)
        self.term_dict = None

    # -- construction ----------------------------------------------------
    @classmethod
    def build(cls, triples, n_nodes: int, n_preds: int, n_shards: int = 4,
              strategy: str = "predicate_hash", config=None, cache=_DEFAULT_CACHE,
              crossover: int | None = None, max_batch: int = 1024,
              delta_budget=_DEFAULT_BUDGET, rebalance_skew=_DEFAULT_SKEW,
              serve_threads: int | None = None, bgp_cache: bool = True,
              device=None) -> "ShardedTripleService":
        """Partition, compress each subgraph on `device`, one engine a shard.

        `cache` is the shared result-cache tier (default: one
        :class:`QueryResultCache` shared by every shard; ``None`` for none).
        `delta_budget` is each engine's overlay rebuild threshold (default
        4,096; ``None`` never). `rebalance_skew` is the live ``max/mean``
        shard load at or above which a write starts an online rebalance
        (default 4.0; ``None`` only an explicit ``rebalance()``).
        `serve_threads` is the scatter fan-out width (default the core
        count). `device` ``None`` means CUDA, and raises without a GPU
        unless the caller asks for ``"cpu"``. The plan is cut on the host
        (the triples are copied there once when given as a tensor)."""
        dev = resolve_device(device)
        triples = _host_ids(triples)
        plan = make_plan(strategy, n_shards, n_nodes, n_preds, triples=triples)
        if cache is _DEFAULT_CACHE:
            cache = QueryResultCache()
        engine_kwargs = {} if delta_budget is _DEFAULT_BUDGET \
            else {"delta_budget": delta_budget}
        engines = []
        for k, sub in enumerate(partition_triples(triples, plan)):
            table = LabelTable.terminals([2] * n_preds, device=dev)
            graph = Hypergraph.from_triples(sub, n_nodes, device=dev)
            grammar, _ = compress(graph, table, config)
            engine = TripleQueryEngine(
                grammar, cache=cache.shard_view(k) if cache is not None else None,
                crossover=crossover, config=config, **engine_kwargs)
            engine._base_edges = len(sub)  # skew checks skip the decompression
            engines.append(engine)
        return cls(engines, plan, cache, max_batch, config=config,
                   rebalance_skew=rebalance_skew, serve_threads=serve_threads,
                   bgp_cache=bgp_cache)

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    # -- request plane ---------------------------------------------------
    def _flush_columns(self, s, p, o) -> QueryResultView:
        """Execute one batch under the reader lock (columns on the host or a
        tensor, copied to the host once). Safe from any number of threads:
        the read lock pins one (plan, migration, engines) state for the
        whole flush, and what `_run` touches concurrently (the shared cache,
        each engine, the stats) is locked at its own level."""
        s, p, o = _host_ids(s), _host_ids(p), _host_ids(o)
        n = len(s)
        t0 = time.perf_counter()
        with self._rw.read():
            group = None
            if self._replicas is not None and not self._rw.write_held:
                # write_held while we hold read means WE are the writer (a
                # probe inside a write section): it must see the primary's
                # half-applied state, not a replica's
                group = self._replicas.acquire()
            if group is not None:
                try:
                    # the whole flush runs on ONE replica group, so merged
                    # results never mix generations; the group's read lock
                    # excludes its WAL-tail applies
                    with group.service._rw.read():
                        view = group.service._run(s, p, o)
                finally:
                    self._replicas.release(group)
            else:
                view = self._run(s, p, o)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            st = self.stats
            st.queries += n
            st.flushes += 1
            st.results += view.total_results()
            st.total_s += dt
            st.last_flush_qps = n / dt if dt > 0 else 0.0
            if group is not None:
                st.replica_flushes += 1
        return view

    def query_bgp(self, patterns):
        """Evaluate a basic graph pattern over the tier.

        Each join step's batch goes through :meth:`_flush_columns`, so it
        takes the whole serving stack: dedup, the shared cache, owned or
        scattered routing and the fan-out pool. Whole-BGP results are cached
        in the merged namespace (``bgp_cache``) under the canonical pattern
        list; `invalidate()` bumps that namespace on any shard change, so a
        stale join is never served.

        Each step takes the read lock on its own, so a BGP is atomic a step,
        not across steps: a write between steps can show a mixed view, as
        two separate queries would. The insert is guarded by the generation
        seen before the first step, so such a result is never cached."""
        patterns = parse_bgp(patterns)
        out_vars = bgp_variables(patterns)
        cache = self.cache if self.bgp_cache else None
        key = gen0 = None
        if cache is not None:
            key = bgp_cache_key(patterns)
            gen0 = cache.generation(self._merged_ns)
            hit = cache.lookup(*key, shard=self._merged_ns)
            if hit is not None:
                with self._stats_lock:
                    self.stats.bgp_queries += 1
                    self.stats.bgp_cache_hits += 1
                return decode_result_entry(hit, out_vars)
        with self._rw.read():  # pin the engines for the stats pass only
            stats = SelectivityStats.merge(eng.selectivity() for eng in self.engines)
        result = execute_bgp(patterns, self._flush_columns, stats)
        if cache is not None and cache.generation(self._merged_ns) == gen0:
            cache.insert(*key, encode_result_entry(result), shard=self._merged_ns)
        with self._stats_lock:
            self.stats.bgp_queries += 1
        return result

    # -- string-term surfaces (an attached TermDict) ---------------------
    def attach_term_dict(self, term_dict) -> None:
        """Attach a :class:`~repro_torch.core.term_dict.TermDict` mapping
        term strings to the ids this tier serves. One dictionary covers the
        whole tier (ids are global; shards partition the id space)."""
        self.term_dict = term_dict

    def _require_term_dict(self):
        if self.term_dict is None:
            raise ValueError(
                "no term dictionary attached: call attach_term_dict() "
                "(or ingest through repro_torch.data.ingest, which attaches one)")
        return self.term_dict

    def query_strings(self, s: str | None, p: str | None, o: str | None) -> list[tuple]:
        """One (S, P, O) pattern in term strings (``None`` unbound); a bound
        term the dictionary has never seen answers ``[]`` without touching
        any shard. Returns (s, p, o) term triples."""
        td = self._require_term_dict()
        s_id, p_id, o_id, known = resolve_string_triple(td, s, p, o)
        with self._stats_lock:
            self.stats.string_queries += 1
            if not known:
                self.stats.unknown_term_empties += 1
        if not known:
            return []
        out = []
        for label, nodes in self.query(s_id, p_id, o_id):
            if len(nodes) != 2:
                raise ValueError(f"string queries need rank-2 edges, got rank {len(nodes)}")
            out.append((td.node_term(nodes[0]), td.pred_term(label), td.node_term(nodes[1])))
        return out

    def query_bgp_strings(self, patterns) -> list[dict]:
        """`query_bgp` in string terms: (s, p, o) tuples of ``?var`` names
        and constant term strings; an unknown constant answers ``[]``
        without executing any step. Returns ``[{var: term}, ...]``."""
        td = self._require_term_dict()
        id_patterns, pred_vars, known = resolve_string_bgp(td, patterns)
        with self._stats_lock:
            self.stats.string_queries += 1
            if not known:
                self.stats.unknown_term_empties += 1
        if not known:
            return []
        return bgp_result_to_terms(td, self.query_bgp(id_patterns), pred_vars)

    def add_node_terms(self, terms) -> torch.Tensor:
        """Mint node ids for `terms` (known terms keep theirs), in input
        order. Node ids may pass the build-time universe: the plan routes
        them (clipped node ranges, hashed predicates)."""
        with self._rw.write():
            return self._require_term_dict().add_node_terms(terms)

    def add_pred_terms(self, terms) -> torch.Tensor:
        """Mint predicate ids for `terms`. The predicate capacity is fixed at
        build (`n_preds` terminal labels an engine), so terms that would mint
        past it raise: size `n_preds` up front for streaming ingestion."""
        with self._rw.write():
            td = self._require_term_dict()
            fresh = [t for t in dict.fromkeys(terms) if td.pred_id(t) is None]
            if td.n_preds + len(fresh) > self.plan.n_preds:
                raise ValueError(
                    f"predicate capacity exhausted: tier was built with "
                    f"n_preds={self.plan.n_preds}, dictionary holds "
                    f"{td.n_preds}, cannot mint {len(fresh)} more; rebuild "
                    "the tier with a larger predicate capacity")
            return td.add_pred_terms(terms)

    # -- fan-out pool ------------------------------------------------------
    def set_serve_threads(self, n: int | None) -> int:
        """Change the scatter fan-out width; returns the resolved value
        (``None``: the core count). The old pool is drained; the next
        threaded flush makes a new one."""
        self.serve_threads = resolve_serve_threads(n)
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        return self.serve_threads

    def close(self) -> None:
        """Shut down the replica tier, if one is attached, then drain the
        fan-out pool. Idempotent across the hierarchy: each close here and
        in the groups' own services is a no-op the second time; the tier
        stays usable (a later threaded flush makes a new pool)."""
        replicas, self._replicas = self._replicas, None
        if replicas is not None:
            replicas.close()  # closes each group service's pool too
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                width = min(self.serve_threads, max(1, self.n_shards))
                self._pool = ThreadPoolExecutor(max_workers=width,
                                                thread_name_prefix="shard-serve")
            return self._pool

    # -- scatter-gather core ---------------------------------------------
    def _run(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> QueryResultView:
        # dedup on the host: each unique pattern is routed and merged once
        key = np.stack([s, p, o], axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        nu = len(uniq)
        u_s, u_p, u_o = uniq[:, 0], uniq[:, 1], uniq[:, 2]
        routes = self._route_patterns(u_s, u_p, u_o)
        cache = self.cache

        # a scattered pattern's merged result is cached itself, so a warm
        # repeat is one lookup, not a fan-out
        scatter: list[int] = []
        hit_u: list[int] = []
        hits: list = []
        for u in np.flatnonzero(routes < 0).tolist():
            hit = cache.lookup(int(u_s[u]), int(u_p[u]), int(u_o[u]),
                               shard=self._merged_ns) if cache is not None else None
            if hit is None:
                scatter.append(u)
            else:
                hit_u.append(u)
                hits.append(_packed(hit))
        scatter = np.asarray(scatter, dtype=np.int64)
        degraded = 0
        if self.failed_shards:
            # every pattern owned by (or scattered across) a failed shard is
            # answered with that shard's rows missing: count the holes
            degraded = int(np.isin(routes, sorted(self.failed_shards)).sum()) + len(scatter)
        with self._stats_lock:
            self.stats.unique_patterns += nu
            self.stats.merged_hits += len(hits)
            self.stats.owned += int((routes >= 0).sum())
            self.stats.scattered += int((routes < 0).sum())
            self.stats.degraded_patterns += degraded

        # a shard's sub-batch: its owned patterns, then every scattered miss
        work: list[tuple[int, np.ndarray, np.ndarray]] = []
        for k in range(len(self.engines)):
            if k in self.failed_shards:
                continue  # a hole: owned patterns fall through to empty entries
            own = np.flatnonzero(routes == k)
            idx = own if len(scatter) == 0 else np.concatenate([own, scatter])
            if len(idx):
                work.append((k, own, idx))
        if len(work) > 1 and self.serve_threads > 1:
            # pool workers call _shard_entries only; they never touch the
            # RWLock (a worker taking read while a writer waits on the
            # submitting reader would deadlock by writer preference), and
            # they launch on the caller's stream
            pool = self._ensure_pool()
            stream = torch.cuda.current_stream(self.device) \
                if self.device.type == "cuda" else None
            futs = [pool.submit(self._shard_entries, k, u_s[idx], u_p[idx], u_o[idx], stream)
                    for k, _, idx in work]
            results = [f.result() for f in futs]
        else:
            results = [self._shard_entries(k, u_s[idx], u_p[idx], u_o[idx])
                       for k, _, idx in work]
        with self._stats_lock:
            self.stats.shard_batches += sum(nb for _, nb in results)
        return self._merge(work, [views for views, _ in results], uniq, inv, scatter,
                           hit_u, hits)

    def _merge(self, work, shard_views, uniq, inv, scatter, hit_u, hits) -> QueryResultView:
        """The flush's view from the shards' chunk views (in work order),
        the merged-tier hits and the scattered misses, in one gather on the
        device: every source view concatenated, then each unique pattern's
        entry made of its pieces, a position of a shard's sub-batch (shard
        order, so a scattered pattern's chunks concatenate as the reference
        merges them) or a hit. Merged misses are stored in the merged tier,
        each in a buffer of its own. The host builds the piece map from what
        it routed; nothing is read back an entry."""
        dev = self.device
        nu = len(uniq)
        sources: list[QueryResultView] = []
        piece_src: list[torch.Tensor] = []
        piece_u: list[np.ndarray] = []
        base = 0
        for (_, _, idx), views in zip(work, shard_views):
            for v in views:  # the chunks cover idx in order
                sources.append(v)
                piece_src.append(v.qid_entry + base)
                base += v.n_entries
            piece_u.append(idx)
        if hits:
            sources.append(_view_of_entries(hits, torch.arange(len(hits), device=dev)))
            piece_src.append(torch.arange(base, base + len(hits), dtype=I64, device=dev))
            piece_u.append(np.asarray(hit_u, dtype=np.int64))
        src = QueryResultView.concat(sources) if sources else QueryResultView.empty(dev)
        pieces = torch.cat(piece_src) if piece_src else empty(dev)
        dst = np.concatenate(piece_u) if piece_u else np.zeros(0, dtype=np.int64)
        # pieces of one pattern in shard order: positions are shard-ascending
        order = np.argsort(dst, kind="stable")
        n, m = len(order), len(scatter)
        # the host's maps go to the device in one copy
        maps = torch.from_numpy(np.concatenate(
            [order, dst[order], inv, scatter, np.arange(m)])).to(dev)
        view = _gather_entries(src, pieces[maps[:n]], maps[n:2 * n], nu,
                               maps[2 * n:2 * n + len(inv)])
        cache = self.cache
        if cache is not None and m:
            # the merged entries again, each in a buffer of its own: a slice
            # of this flush's buffer would pin the whole flush in the cache.
            # A scattered result is held twice (per-shard chunks and merged):
            # warm repeats cost a lookup, while a single-shard invalidate()
            # re-executes one shard, not all
            at = 2 * n + len(inv)
            merged = _gather_entries(view, maps[at:at + m], maps[at + m:], m, empty(dev))
            for u, entry in zip(scatter.tolist(), _owned_entries(merged)):
                cache.insert(int(uniq[u, 0]), int(uniq[u, 1]), int(uniq[u, 2]), entry,
                             shard=self._merged_ns)
        return view

    def _route_patterns(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> np.ndarray:
        """Owning shard a unique pattern (-1: scatter-gather).

        While a migration is in flight a pattern goes to one shard only when
        the outgoing and incoming plans agree on it: rows changing owner may
        sit on either side, and agreement means none of the pattern's rows
        are among them. The rest scatter, exact on disjoint partitions
        wherever each row sits."""
        routes = self.plan.route_batch(s, p, o)
        if self._migration is not None:
            incoming = self._migration.new_plan.route_batch(s, p, o)
            routes = np.where(routes == incoming, routes, -1)
        return routes

    def _shard_entries(self, k: int, s, p, o, stream=None) -> tuple[list, int]:
        """One shard's views of its sub-batch, one engine micro-batch a
        `max_batch` chunk, on `stream` when given (a pool worker runs on
        its caller's stream). Returns ``(views, n_batches)``; runs under the
        shard's engine lock, so threaded fan-out never interleaves inside
        one engine."""
        engine = self.engines[k]
        out: list = []
        with self._engine_locks[k], \
                torch.cuda.stream(stream) if stream is not None else nullcontext():
            for lo in range(0, len(s), self.max_batch):
                hi = min(lo + self.max_batch, len(s))
                out.append(engine.query_batch_view(s[lo:hi], p[lo:hi], o[lo:hi]))
        return out, len(out)

    # -- mutation ---------------------------------------------------------
    def insert_triples(self, triples) -> int:
        """Insert (s, p, o) rows; returns how many were new.

        Each row goes to its owning shard (`PartitionPlan.route_triples`)
        and that engine's overlay; only the mutated shards' cache
        generations are bumped (and the merged namespace). A shard whose
        overlay passes its delta budget recompresses on the spot."""
        return self._mutate(triples, insert=True)

    def delete_triples(self, triples) -> int:
        """Delete (s, p, o) rows; returns how many were present. Routing,
        invalidation and the budget as in :meth:`insert_triples`."""
        return self._mutate(triples, insert=False)

    def _mutate(self, triples, insert: bool) -> int:
        rows = _host_rows(triples)
        if len(rows) == 0:
            return 0
        if int(rows[:, 1].max()) >= self.plan.n_preds:
            raise ValueError(f"predicate ids must be < {self.plan.n_preds}; "
                             f"got {int(rows[:, 1].max())}")
        with self._rw.write():  # no flush sees a half-applied mutation
            if self._migration is None:
                applied = self._apply_rows(rows, insert, self.plan.route_triples(rows))
            else:
                applied = self._mutate_in_flight(rows, insert)
            if insert:
                self.stats.inserted += applied
            else:
                self.stats.deleted += applied
            if applied:
                self._maybe_auto_rebalance()
        return applied

    def _apply_rows(self, rows: np.ndarray, insert: bool, shards: np.ndarray) -> int:
        """Apply host rows to the given per-row shards (each shard's rows go
        to its engine in one copy); bump only the shards that changed."""
        if self.failed_shards and np.isin(shards, sorted(self.failed_shards)).any():
            raise RuntimeError(
                f"cannot mutate failed shards {sorted(self.failed_shards)}; "
                "restore them with reingest_shard() first")
        applied = 0
        for k in np.unique(shards).tolist():
            engine = self.engines[k]
            sub = rows[shards == k]
            before = engine.rebuild_count
            n = engine.insert_triples(sub) if insert else engine.delete_triples(sub)
            self.stats.rebuilds += engine.rebuild_count - before
            if n:  # only mutated shards lose their warm entries
                applied += n
                self.invalidate(k)
        return applied

    def _mutate_in_flight(self, rows: np.ndarray, insert: bool) -> int:
        """Mutations while a migration is in flight.

        Rows the outgoing and incoming plans place alike apply normally:
        none is in motion. A row changing owner may sit on either side, so
        deletes are first discarded from the pending moves (a later batch
        must not resurrect them) and then applied to both candidate shards
        (set semantics no-op the side without the row), and inserts probe
        the outgoing owner and land on the incoming one only if the row is
        not visible there (else it would be duplicated across shards)."""
        mig = self._migration
        old_s = self.plan.route_triples(rows)
        new_s = mig.new_plan.route_triples(rows)
        stable = old_s == new_s
        applied = self._apply_rows(rows[stable], insert, old_s[stable]) \
            if stable.any() else 0
        if stable.all():
            return applied
        moving = ~stable
        mrows, ma, mb = rows[moving], old_s[moving], new_s[moving]
        if insert:
            present = np.zeros(len(mrows), dtype=bool)
            for k in np.unique(ma).tolist():
                sel = ma == k
                present[sel] = self.engines[k].contains_triples(mrows[sel]).cpu().numpy()
            if not present.all():
                applied += self._apply_rows(mrows[~present], True, mb[~present])
        else:
            mig.discard(mrows)
            applied += self._apply_rows(mrows, False, ma)
            applied += self._apply_rows(mrows, False, mb)
        return applied

    def contains_triples(self, triples) -> torch.Tensor:
        """bool a (s, p, o) row, on the tier's device: is it visible in the
        tier? The rows are answered as ONE flush of fully bound patterns,
        routed like any query, so it is exact mid-migration and while
        degraded (rows on a failed shard read as absent). A negative id is
        an unbound slot, as in a query. Tickets others have pending stay
        pending."""
        rows = _host_ids(triples).reshape(-1, 3)
        if len(rows) == 0:
            return torch.zeros(0, dtype=torch.bool, device=self.device)
        return self._flush_columns(rows[:, 0], rows[:, 1], rows[:, 2]).result_counts() > 0

    def rebuild(self, shard: int | None = None, force: bool = False) -> list[int]:
        """Recompress dirty shards; returns the rebuilt shard ids.

        With `shard`, that shard rebuilds if its overlay is not empty. With
        ``shard=None``, every shard whose overlay passes its engine's budget
        rebuilds, or every shard with any overlay under ``force=True``.
        Clean shards are never touched: the cost follows the mutated share
        of the graph, not its size."""
        shards = range(self.n_shards) if shard is None else [int(shard)]
        rebuilt: list[int] = []
        with self._rw.write():  # a rebuild swaps engine state under no flush
            for k in shards:
                engine = self.engines[k]
                if engine.delta.is_empty:
                    continue
                over = engine.delta_budget is not None \
                    and engine.delta.size > engine.delta_budget
                if shard is not None or force or over:
                    engine.rebuild(self.config)
                    self.stats.rebuilds += 1
                    self.invalidate(k)
                    rebuilt.append(k)
        return rebuilt

    def delta_sizes(self) -> list[int]:
        """Overlay rows a shard (the quantity :meth:`rebuild` budgets)."""
        return [e.delta.size for e in self.engines]

    # -- online rebalancing ------------------------------------------------
    def rebalance(self, force: bool = False, max_moves: int | None = None) -> dict:
        """Re-cut the partition online and migrate rows between shards.

        With a migration in flight this continues it, up to `max_moves`
        rows (``None``: to the end). Otherwise the live ``max/mean`` skew is
        measured and, at or above the trigger (or under ``force=True``), a
        successor plan is computed and the migration starts. Each batch
        arrives through the destination's overlay and leaves the source
        through tombstones inside this call; only the shards a batch touched
        lose their warm entries. A re-cut that cannot move anything is
        adopted as it is and arms the auto trigger's backoff.

        Returns ``skew`` (at entry), ``moved`` (rows this call migrated),
        ``pending`` and ``active``."""
        with self._rw.write():  # routing state swaps exclusively
            if self.failed_shards:
                raise RuntimeError(
                    f"cannot rebalance with failed shards "
                    f"{sorted(self.failed_shards)}; restore them with "
                    "reingest_shard() first")
            skew = self.skew()
            if self._migration is None:
                threshold = self.rebalance_skew
                if not force and (threshold is None or skew < threshold):
                    return {"skew": skew, "moved": 0, "pending": 0, "active": False}
                mig = plan_rebalance(self.plan, self.engines)
                if mig.total_rows == 0:
                    # the same owner for every live row: adopt the re-cut
                    # (later routing may still improve) and back off
                    self._journal_event("plan_swap", mig.new_plan)
                    self.plan = mig.new_plan
                    self._futile_total = int(live_shard_edges(self.engines).sum())
                    return {"skew": skew, "moved": 0, "pending": 0, "active": False}
                self._journal_event("rebalance_begin", mig.new_plan)
                self._migration = mig
                self.stats.rebalances += 1
                self._futile_total = None
            moved = self._apply_migration(max_moves)
            return {"skew": skew, "moved": moved,
                    "pending": self._migration.pending_rows
                    if self._migration is not None else 0,
                    "active": self._migration is not None}

    def _apply_migration(self, max_moves: int | None = None) -> int:
        """Migrate up to `max_moves` pending rows; once drained, the
        successor plan (by then the exact map of where every row lives)
        becomes the routing plan."""
        mig = self._migration
        moved = 0
        for src, dst, batch in mig.take(max_moves):
            self._journal_event("migrate", (src, dst, batch))
            moved += self._apply_migration_batch(src, dst, batch)
        self.stats.migrated_rows += moved
        if mig.done:
            self._journal_event("plan_swap", mig.new_plan)
            self.plan = mig.new_plan
            self._migration = None
        return moved

    def _apply_migration_batch(self, src: int, dst: int, batch: torch.Tensor) -> int:
        """Move one batch (rows on the card) from `src` to `dst`,
        idempotently: only the rows still visible at the source arrive at
        the destination, so a batch applied twice duplicates nothing and a
        batch replayed after its rows were deleted resurrects none. The
        source's delete is set-semantic."""
        e_src, e_dst = self.engines[src], self.engines[dst]
        batch = batch[e_src.contains_triples(batch)]
        if batch.shape[0] == 0:
            return 0
        before = e_src.rebuild_count + e_dst.rebuild_count
        crash_point("migrate.pre_apply")
        e_dst.insert_triples(batch)
        crash_point("migrate.mid_apply")
        e_src.delete_triples(batch)
        self.stats.rebuilds += e_src.rebuild_count + e_dst.rebuild_count - before
        self.invalidate(src)
        self.invalidate(dst)
        return int(batch.shape[0])

    def _journal_event(self, kind: str, payload) -> None:
        """Hand a rebalance state change to the installed durability hook
        BEFORE it applies (write-ahead order); a no-op without one."""
        if self._journal is not None:
            self._journal(kind, payload)

    def _maybe_auto_rebalance(self) -> None:
        """The mutation path's trigger: start a rebalance once the live skew
        reaches the threshold, migrating at most ``_AUTO_MOVES_PER_CALL``
        rows a call, so no write blocks on the whole diff. Backoff: after a
        re-cut that could move nothing, automatic checks stay off until the
        tier's live size drifts by more than 25% from that snapshot."""
        if self.rebalance_skew is None or self.n_shards < 2 or self.failed_shards:
            return
        if self._migration is not None:  # drain the migration in flight
            self._apply_migration(_AUTO_MOVES_PER_CALL)
            return
        counts = live_shard_edges(self.engines)
        total = int(counts.sum())
        if self._futile_total is not None and \
                abs(total - self._futile_total) * 4 <= self._futile_total:
            return
        if measure_skew(counts) >= self.rebalance_skew:
            self.rebalance(force=True, max_moves=_AUTO_MOVES_PER_CALL)

    @property
    def migration_active(self) -> bool:
        """True while moves are pending (routing in its dual-plan mode)."""
        return self._migration is not None

    def live_edges(self) -> list[int]:
        """Live triple count a shard (base + overlay), the load signal
        rebalancing watches (:meth:`shard_sizes` counts start-graph edges)."""
        return [int(v) for v in live_shard_edges(self.engines)]

    def skew(self) -> float:
        """Live ``max/mean`` shard load (1.0 balanced)."""
        return measure_skew(live_shard_edges(self.engines))

    # -- degraded serving --------------------------------------------------
    def mark_shard_failed(self, shard: int) -> None:
        """Serve around one shard instead of failing with it.

        The shard's engine is replaced by an empty one; owned patterns
        answer empty, scattered ones merge the surviving shards, and every
        affected pattern counts in ``stats.degraded_patterns``. Writes to
        the shard and rebalancing raise until :meth:`reingest_shard`."""
        k = int(shard)
        if not 0 <= k < self.n_shards:
            raise ValueError(f"shard {k} out of range [0, {self.n_shards})")
        with self._rw.write():  # the engine swap must not race a flush
            self.failed_shards.add(k)
            self.engines[k] = self._build_shard_engine(k, np.zeros((0, 3), dtype=np.int64))
            self.invalidate(k)

    def reingest_shard(self, shard: int, triples) -> int:
        """Restore a failed shard from re-ingested rows; returns how many
        rows it now holds (those the plan routes to it). Compresses them
        into a fresh engine, clears the failure and invalidates the shard's
        and the merged namespaces."""
        k = int(shard)
        if k not in self.failed_shards:
            raise ValueError(f"shard {k} is not marked failed")
        rows = _host_rows(triples)
        with self._rw.write():
            mine = rows[self.plan.route_triples(rows) == k] if len(rows) else rows
            self.engines[k] = self._build_shard_engine(k, mine)
            self.failed_shards.discard(k)
            self.invalidate(k)
        return len(mine)

    def _build_shard_engine(self, k: int, rows: np.ndarray) -> TripleQueryEngine:
        """Compress `rows` into a fresh engine on the tier's device, wired to
        shard `k`'s cache view (the build's recipe, for degrade and
        reingest)."""
        table = LabelTable.terminals([2] * self.plan.n_preds, device=self.device)
        graph = Hypergraph.from_triples(rows, self.plan.n_nodes, device=self.device)
        grammar, _ = compress(graph, table, self.config)
        engine = TripleQueryEngine(
            grammar, cache=self.cache.shard_view(self._cache_ns[k])
            if self.cache is not None else None, config=self.config)
        engine._base_edges = len(rows)
        return engine

    # -- maintenance, introspection -------------------------------------
    def invalidate(self, shard: int | None = None) -> None:
        """Invalidate cached results by a generation bump of the shared
        tier: one shard's, or every shard's when `shard` is None; the merged
        namespace always, since its entries depend on every shard."""
        if self.cache is None:
            return
        shards = range(self.n_shards) if shard is None else [shard]
        for k in shards:
            self.cache.bump_generation(self._cache_ns[k])
        self.cache.bump_generation(self._merged_ns)

    def cache_stats(self):
        """The shared tier's counters (None without a cache)."""
        return self.cache.stats if self.cache is not None else None

    def shard_sizes(self) -> list[int]:
        """Start-graph edges a shard (partition balance)."""
        return [int(e.grammar.start.n_edges) for e in self.engines]
