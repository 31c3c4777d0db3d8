"""Micro-batched triple-query serving on the compressed grammar, the twin of
``repro.serve.triple_service``.

Traffic arrives as independent (S, P, O) lookups; answering them one at a
time wastes the engine's batch path. :class:`TripleQueryService` gathers
submitted patterns into a pending micro-batch and runs the whole batch as
one ``query_batch_view`` (one frontier on the card, or the scalar worklist
for a tiny selective batch), so the per-request host overhead is paid once
a flush. Results come back as a
:class:`~repro_torch.core.query.QueryResultView`, one entry a unique
pattern with duplicate tickets sharing it (``flush_view``); ``flush`` reads
the view to the host in one copy and builds one tuple an entry.
``query_many`` is the synchronous form (submit all, then flush).

With the engine's result cache the dedup streams across flushes, so the
stats separate *submitted* queries from *executed* unique patterns and
*cache hits*.

Thread safety: the pending queue is locked, and every synchronous entry
(``query`` / ``query_many`` / ``flush``) takes its tickets atomically, so
two threads calling ``query()`` never read each other's results. What runs
after the take depends on the subclass: :class:`~repro_torch.serve.sharded.ShardedTripleService`
executes under a reader lock and is safe from any number of threads;
:class:`TripleQueryService` fronts one engine (one frontier arena) and must
not be flushed from two threads at once.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.query import QueryResultView, TripleQueryEngine


@dataclass
class ServiceStats:
    """Rolling serving counters.

    `queries` counts submitted patterns; `executed` the unique patterns that
    ran on the engine (frontier or worklist); `cache_hits` the unique
    patterns answered from the cross-request result cache. Duplicates
    within a flush are neither, so ``executed + cache_hits <= queries``.
    """

    queries: int = 0
    batches: int = 0
    results: int = 0
    executed: int = 0
    cache_hits: int = 0
    inserted: int = 0   # triples actually added through the mutation API
    deleted: int = 0    # triples actually removed
    rebuilds: int = 0   # grammar recompressions (automatic and explicit)
    total_s: float = 0.0
    last_batch_qps: float = 0.0

    @property
    def qps(self) -> float:
        return self.queries / self.total_s if self.total_s > 0 else 0.0

    @property
    def cache_hit_rate(self) -> float:
        n = self.executed + self.cache_hits
        return self.cache_hits / n if n else 0.0


@dataclass
class _Pending:
    s: list = field(default_factory=list)
    p: list = field(default_factory=list)
    o: list = field(default_factory=list)


class MicroBatchService:
    """The request plane shared by the micro-batching services.

    The pending queue (`submit` gives a ticket; ``None`` is an unbound slot,
    kept as -1), the view-backed `flush` (a tuple an entry, shared by
    duplicate tickets: treat results as read-only) and the synchronous
    `query` / `query_many`. Subclasses implement :meth:`_flush_columns`,
    which executes aligned int64 host columns and returns the view.

    `query` takes its own ticket together with everything already pending
    (flushing those alongside); `query_many` takes the whole queue but
    returns only its own patterns' results. The raw `submit` / `flush`
    split is single-caller by nature: a ticket indexes whichever flush runs
    next.
    """

    device = torch.device("cpu")  # where an empty flush's view lives

    def __init__(self):
        self._pending = _Pending()
        self._pending_lock = threading.Lock()

    def _submit_locked(self, s: int | None, p: int | None, o: int | None) -> int:
        ticket = len(self._pending.s)
        self._pending.s.append(-1 if s is None else int(s))
        self._pending.p.append(-1 if p is None else int(p))
        self._pending.o.append(-1 if o is None else int(o))
        return ticket

    def submit(self, s: int | None, p: int | None, o: int | None) -> int:
        """Queue one (S, P, O) pattern; returns its ticket in the next flush."""
        with self._pending_lock:
            return self._submit_locked(s, p, o)

    @property
    def pending(self) -> int:
        return len(self._pending.s)

    def _take_pending_locked(self):
        batch, self._pending = self._pending, _Pending()
        if not batch.s:
            return None
        return (np.asarray(batch.s, dtype=np.int64),
                np.asarray(batch.p, dtype=np.int64),
                np.asarray(batch.o, dtype=np.int64))

    def _take_pending(self):
        with self._pending_lock:
            return self._take_pending_locked()

    def _flush_columns(self, s, p, o) -> QueryResultView:
        """Execute one taken batch (aligned int64 host columns, -1 unbound).

        The subclass owns timing, stats and execution. It must be safe to
        call without the pending lock: the sharded service runs it under its
        reader lock from many threads at once."""
        raise NotImplementedError

    def flush_view(self) -> QueryResultView:
        """Execute every pending query; the results as a view indexed by
        ticket, duplicates sharing an entry. An empty flush is a no-op: no
        batch counted, no time accrued."""
        cols = self._take_pending()
        if cols is None:
            return QueryResultView.empty(self.device)
        return self._flush_columns(*cols)

    def flush(self) -> list[tuple]:
        """Execute every pending query; per ticket, its (label, nodes)
        pairs as a tuple shared by duplicate tickets."""
        return self.flush_view().tuple_lists()

    def query(self, s: int | None, p: int | None, o: int | None) -> tuple:
        """One synchronous query: submit and flush, returning THIS pattern's
        results (anything already pending is flushed alongside, its tickets
        still its submitters'). The take is atomic, so concurrent callers
        get disjoint batches."""
        with self._pending_lock:
            ticket = self._submit_locked(s, p, o)
            cols = self._take_pending_locked()
        return self._flush_columns(*cols).tuple_lists()[ticket]

    def query_many(self, patterns) -> list[tuple]:
        """`patterns`: iterable of (s, p, o), ``None`` unbound. One result
        tuple a pattern, in order; tickets other callers had pending are
        flushed alongside but not returned here."""
        with self._pending_lock:
            base = len(self._pending.s)
            for s, p, o in patterns:
                self._submit_locked(s, p, o)
            cols = self._take_pending_locked()
        if cols is None:
            return []
        return self._flush_columns(*cols).tuple_lists()[base:]


class TripleQueryService(MicroBatchService):
    """Micro-batching front end over one
    :class:`~repro_torch.core.query.TripleQueryEngine`.

    `max_batch` bounds one frontier's width: a larger pending set runs in
    chunks, so memory stays flat under unselective patterns.
    """

    def __init__(self, engine: TripleQueryEngine, max_batch: int = 1024):
        super().__init__()
        self.engine = engine
        self.device = engine.device
        self.max_batch = int(max_batch)
        self.stats = ServiceStats()

    def _flush_columns(self, s, p, o) -> QueryResultView:
        """Execute one taken batch on the engine, in chunks of `max_batch`.
        Not safe from two threads at once: the engine reuses one frontier
        arena. The sharded service locks each engine for concurrent
        callers."""
        n = len(s)
        cache = self.engine.cache
        before = cache.stats.snapshot() if cache is not None else None
        views: list[QueryResultView] = []
        t0 = time.perf_counter()
        executed_uncached = 0
        for lo in range(0, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            chunk = self.engine.query_batch_view(s[lo:hi], p[lo:hi], o[lo:hi])
            views.append(chunk)
            self.stats.batches += 1
            if before is None:  # no cache: in-batch dedup still collapses
                executed_uncached += chunk.n_entries
        view = QueryResultView.concat(views)
        dt = time.perf_counter() - t0
        self.stats.queries += n
        self.stats.results += view.total_results()
        self.stats.total_s += dt
        self.stats.last_batch_qps = n / dt if dt > 0 else 0.0
        if before is not None:
            # the cache's counters move once a unique pattern: hits were
            # served from it, misses executed
            self.stats.cache_hits += cache.stats.hits - before.hits
            self.stats.executed += cache.stats.misses - before.misses
        else:
            self.stats.executed += executed_uncached
        return view

    # -- mutation ---------------------------------------------------------
    def insert_triples(self, triples) -> int:
        """Insert (s, p, o) rows into the engine's overlay; returns how many
        were new. Later flushes see them (the engine bumps its cache and
        rebuilds past its delta budget)."""
        before = self.engine.rebuild_count
        n = self.engine.insert_triples(triples)
        self.stats.inserted += n
        self.stats.rebuilds += self.engine.rebuild_count - before
        return n

    def delete_triples(self, triples) -> int:
        """Delete (s, p, o) rows; returns how many were present."""
        before = self.engine.rebuild_count
        n = self.engine.delete_triples(triples)
        self.stats.deleted += n
        self.stats.rebuilds += self.engine.rebuild_count - before
        return n

    def rebuild(self, config=None) -> bool:
        """Recompress base and overlay now, whatever the budget; True if the
        overlay was not empty and a rebuild ran."""
        rebuilt = self.engine.rebuild(config)
        self.stats.rebuilds += rebuilt
        return rebuilt
