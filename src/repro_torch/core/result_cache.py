"""Cross-request result cache for triple-pattern queries.

Serving traffic repeats patterns across batches, not just within one: the
same hot entities are looked up by many requests, and dashboards re-issue
the same ``?P?`` scans every refresh. The engine deduplicates within a
batch; this cache makes the dedup streaming: an LRU keyed by the (S, P, O)
pattern keeps each pattern's result tensors, so a repeat anywhere in the
engine's lifetime is a lookup, not a frontier traversal.

Two segments share the accounting but evict independently:

* **general**: every pattern with S or O bound, and the open ``???``;
* **predicate**: patterns binding only P. ``?P?`` scans enumerate a large
  slice of the graph, so a burst of selective lookups must not evict
  exactly the entries that are most expensive to rebuild.

Entries are ``(labels, nodes_flat, offsets)`` on the engine's device, the
ragged layout of one query's results, owning their storage (a view into a
batch's buffer would keep the whole batch alive and defeat the edge
budgets). The engine stores each as a :class:`PackedEntry`: the three in
one buffer of the entry's own size, viewed only when read. Torch has no
read-only flag: an entry returned to a caller must not be written.

Keys are ``(generation, shard, S, P, O)``, so one instance can back many
per-partition engines (:meth:`QueryResultCache.shard_view`), and
:meth:`QueryResultCache.bump_generation` is the invalidation hook of the
mutation path: every applied insert or delete, and every rebuild, bumps the
mutated shard's generation, which makes its entries unreachable (and purges
them at once, so they stop counting against the budgets) while every other
shard's entries survive. Segment routing depends on the pattern alone, never
on the shard or generation.

The cache is thread-safe: every operation runs under one lock, since an LRU
lookup reorders entries and so even reads mutate.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import torch


class PackedEntry:
    """One pattern's results in one buffer of its own size, laid out
    ``[labels | nodes_flat | offsets]`` (offsets one longer than the labels,
    from 0). It reads as the tuple ``(labels, nodes_flat, offsets)``, three
    views made when asked for: a cached batch makes an entry a miss and
    reads a hit's buffer whole, so it never pays for views it does not
    read."""

    __slots__ = ("buf", "n_edges", "n_nodes")

    def __init__(self, buf: torch.Tensor, n_edges: int, n_nodes: int):
        self.buf = buf
        self.n_edges = int(n_edges)
        self.n_nodes = int(n_nodes)

    def parts(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.buf.split((self.n_edges, self.n_nodes, self.n_edges + 1))

    def __len__(self) -> int:
        return 3

    def __getitem__(self, i):
        return self.parts()[i]

    def __iter__(self):
        return iter(self.parts())


# one cached pattern: (labels, nodes_flat, offsets), offsets one longer
CacheEntry = tuple[torch.Tensor, torch.Tensor, torch.Tensor] | PackedEntry


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserts: int = 0
    oversize_skips: int = 0
    predicate_hits: int = 0  # the part of `hits` served by the ?P? segment

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    def snapshot(self) -> "CacheStats":
        return CacheStats(self.hits, self.misses, self.evictions,
                          self.inserts, self.oversize_skips, self.predicate_hits)


def _edges(entry: CacheEntry) -> int:
    return entry.n_edges if isinstance(entry, PackedEntry) else int(entry[0].numel())


class _LruSegment:
    """One LRU, bounded by its entry count and its total cached result edges."""

    def __init__(self, max_entries: int, max_edges: int):
        self.max_entries = int(max_entries)
        self.max_edges = int(max_edges)
        self.entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self.edges = 0  # total result edges held

    def get(self, key: tuple) -> CacheEntry | None:
        val = self.entries.get(key)
        if val is not None:
            self.entries.move_to_end(key)
        return val

    def put(self, key: tuple, value: CacheEntry, n_edges: int) -> int:
        """Insert an entry of `n_edges` result edges (replacing a stale
        entry); returns the evictions made."""
        old = self.entries.pop(key, None)
        if old is not None:
            self.edges -= _edges(old)
        self.entries[key] = value
        self.edges += n_edges
        evicted = 0
        while len(self.entries) > self.max_entries or \
                (self.edges > self.max_edges and len(self.entries) > 1):
            _, dropped = self.entries.popitem(last=False)
            self.edges -= _edges(dropped)
            evicted += 1
        return evicted

    def clear(self) -> None:
        self.entries.clear()
        self.edges = 0


@dataclass
class QueryResultCache:
    """LRU over (S, P, O) -> result tensors, with a ``?P?`` segment.

    ``max_edges`` bounds each segment's memory in result edges; one result
    larger than ``max_entry_edges`` is never cached, so one ``???`` cannot
    flush the whole cache.
    """

    max_entries: int = 4096
    max_edges: int = 1 << 20
    predicate_entries: int = 512
    predicate_edges: int = 1 << 20
    max_entry_edges: int = 1 << 18
    stats: CacheStats = field(default_factory=CacheStats)

    def __post_init__(self):
        self._general = _LruSegment(self.max_entries, self.max_edges)
        self._predicate = _LruSegment(self.predicate_entries, self.predicate_edges)
        self._generations: dict[int, int] = {}  # shard -> current generation
        self._lock = threading.RLock()

    # -- routing ---------------------------------------------------------
    def _segment_key(self, s: int, p: int, o: int, shard: int):
        # the pattern alone picks the segment: a shard-qualified ?P? entry
        # still lands in the predicate segment
        is_pred = s < 0 and o < 0 and p >= 0
        gen = self._generations.get(shard, 0)
        return is_pred, (gen, int(shard), int(s), int(p), int(o))

    def _segment(self, is_pred: bool) -> _LruSegment:
        return self._predicate if is_pred else self._general

    # -- engine API ------------------------------------------------------
    def lookup(self, s: int, p: int, o: int, shard: int = -1) -> CacheEntry | None:
        with self._lock:
            is_pred, key = self._segment_key(s, p, o, shard)
            val = self._segment(is_pred).get(key)
            if val is None:
                self.stats.misses += 1
            else:
                self.stats.hits += 1
                if is_pred:
                    self.stats.predicate_hits += 1
            return val

    def insert(self, s: int, p: int, o: int, value: CacheEntry, shard: int = -1) -> None:
        n_edges = _edges(value)
        with self._lock:
            if n_edges > self.max_entry_edges:
                self.stats.oversize_skips += 1
                return
            is_pred, key = self._segment_key(s, p, o, shard)
            self.stats.evictions += self._segment(is_pred).put(key, value, n_edges)
            self.stats.inserts += 1

    # -- shared-tier API -------------------------------------------------
    def shard_view(self, shard: int) -> "ShardCacheView":
        """A shard-bound adapter over this cache: per-partition engines share
        its budgets and stats without key collisions."""
        return ShardCacheView(self, shard)

    def generation(self, shard: int = -1) -> int:
        with self._lock:
            return self._generations.get(shard, 0)

    def bump_generation(self, shard: int = -1) -> int:
        """Invalidate one shard's entries: its generation is incremented, so
        its old entries are unreachable, and they are purged at once. Other
        shards' entries are untouched. Returns the new generation."""
        with self._lock:
            gen = self._generations.get(shard, 0) + 1
            self._generations[shard] = gen
            for seg in (self._general, self._predicate):
                stale = [k for k in seg.entries if k[1] == shard and k[0] < gen]
                for k in stale:
                    seg.edges -= _edges(seg.entries.pop(k))
            return gen

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._general.entries) + len(self._predicate.entries)

    @property
    def cached_edges(self) -> int:
        with self._lock:
            return self._general.edges + self._predicate.edges

    def clear(self) -> None:
        """Drop every entry (the stats stay; assign `stats` to reset them)."""
        with self._lock:
            self._general.clear()
            self._predicate.clear()


class ShardCacheView:
    """The engine-facing view of a shared :class:`QueryResultCache`, bound
    to one shard id: ``lookup`` / ``insert`` / ``stats`` / ``clear`` with the
    shard folded into every key."""

    __slots__ = ("cache", "shard")

    def __init__(self, cache: QueryResultCache, shard: int):
        self.cache = cache
        self.shard = int(shard)

    @property
    def stats(self) -> CacheStats:
        return self.cache.stats  # shared across all views

    def lookup(self, s: int, p: int, o: int) -> CacheEntry | None:
        return self.cache.lookup(s, p, o, shard=self.shard)

    def insert(self, s: int, p: int, o: int, value: CacheEntry) -> None:
        self.cache.insert(s, p, o, value, shard=self.shard)

    def generation(self) -> int:
        """This shard's current generation."""
        return self.cache.generation(self.shard)

    def bump_generation(self) -> int:
        return self.cache.bump_generation(self.shard)

    def clear(self) -> None:
        """Clears the WHOLE shared cache; :meth:`bump_generation` invalidates
        this shard alone."""
        self.cache.clear()

    def __len__(self) -> int:
        return len(self.cache)
