"""Replicated reads: snapshot-seeded, WAL-tailing replica groups on the
card; the twin of ``repro.serve.replication``.

Shards spread the graph; replicas multiply read capacity over it. A
*replica group* is one more consistent copy of the whole sharded tier: every
shard's engine opened from the newest service snapshot
(:mod:`repro_torch.persist.snapshot`) and kept fresh by tailing the
primary's write-ahead log (:class:`repro_torch.persist.wal.WalCursor`),
applying each record through the switch recovery replay uses
(:func:`repro_torch.persist.service.apply_wal_record`). Mutations only go
to the primary; acknowledged WAL records define each group's place in
history, so a group is always *some* exact past state of the tier, never a
mix.

Unlike the reference, whose groups share one page-cache copy of each
shard's files through ``mmap``, a group here is a second copy on the card:
opening copies every array onto the device, so a group costs its shards'
device bytes again. Groups share the card's stream and the interpreter
lock with the primary.

Groups are whole-tier copies rather than per-shard engine pools: WAL
records interleave per-shard mutations with cross-shard migration batches
and plan swaps, and a per-shard tail could not apply a migration (two
shards change in one record) or answer a scattered pattern at one instant.
Dispatching a *whole flush* to one group keeps every merged result of one
generation. :class:`ReplicaSet` is the per-shard view over the groups.

**Dispatch** (:meth:`ReplicationManager.acquire`): a flush goes to a group
only when it is *dispatchable*: the primary's log incarnation
(``WriteAheadLog.resets``), lag within ``max_lag`` records, routing state in
agreement (equal plans, both or neither mid-migration with equal successor
plans), healthy. Among those, ``round_robin`` rotates and ``least_loaded``
picks the fewest in-flight flushes. Anything else, including a flush issued
by a thread that holds the primary's write lock, serves from the primary.

**Cache generations**: each group takes its own block of negative
namespaces of the shared result tier (group ``g`` from ``_NS_BASE -
g·(P+1)`` down) through the router's ``_cache_ns`` / ``_merged_ns``, so a
lagging group serves warm results of its own generation; primary
invalidations never purge them, and a group's catch-up bumps only its own.

**Failover**: a group whose catch-up fails (an apply error, or a log
compacted under its cursor) is dropped and reseeded from the newest
snapshot, never replayed from offset 0.

Every knob is an argument: :func:`resolve_replicas`,
:func:`resolve_replica_dispatch` and :func:`resolve_replica_max_lag` read
nothing from the environment.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from repro_torch.core.query import TripleQueryEngine
from repro_torch.distributed.partition import plan_from_dict, plans_equal
from repro_torch.distributed.rebalance import RebalancePlan, migration_moves
from repro_torch.persist.wal import WalCursor, WriteAheadLog
from repro_torch.serve.sharded import ShardedTripleService

# replica cache namespaces sit below the reserved ids (-1 a lone engine,
# -2 the primary's merged results): group g owns the contiguous block
# [_NS_BASE - g*(n_shards+1) - n_shards, _NS_BASE - g*(n_shards+1)]
_NS_BASE = -3

DEFAULT_MAX_LAG = 1024

DISPATCH_POLICIES = ("round_robin", "least_loaded")


def resolve_replicas(value=None) -> int:
    """Replica groups a tier: ``value`` as an int; ``None`` (the default),
    ``0``, negatives, ``off`` / ``none`` / ``never`` and unparsable text
    mean no replication."""
    text = "" if value is None else str(value).strip().lower()
    if not text or text in ("off", "none", "never"):
        return 0
    try:
        return max(0, int(text))
    except ValueError:
        return 0


def resolve_replica_dispatch(value=None) -> str:
    """Dispatch policy: ``value`` if it is one of
    :data:`DISPATCH_POLICIES` (any case), else ``round_robin``."""
    text = "" if value is None else str(value).strip().lower()
    return text if text in DISPATCH_POLICIES else "round_robin"


def resolve_replica_max_lag(value=None) -> int | None:
    """Dispatch lag bound in WAL records: ``None`` (or empty or unparsable
    text) gives :data:`DEFAULT_MAX_LAG`; ``off`` / ``none`` / ``unbounded``
    and negatives mean unbounded (``None``: any group serves, and callers
    quiesce with an explicit sync)."""
    text = "" if value is None else str(value).strip().lower()
    if not text:
        return DEFAULT_MAX_LAG
    if text in ("off", "none", "unbounded"):
        return None
    try:
        n = int(text)
    except ValueError:
        return DEFAULT_MAX_LAG
    return None if n < 0 else n


@dataclass
class ShardReplica:
    """One shard's read-only engine inside one replica group."""

    shard: int
    group: int
    engine: TripleQueryEngine
    cache_ns: int          # the group-private namespace its entries live in
    lag_records: int | None  # group lag (None: another log incarnation)


class ReplicaSet:
    """Per-shard view over the replica groups: shard ``k``'s N read-only
    engines, one a group, each at its group's place in history."""

    def __init__(self, shard: int, replicas: list[ShardReplica]):
        self.shard = int(shard)
        self.replicas = replicas

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    @property
    def max_lag_records(self) -> int:
        """Worst lag across this shard's replicas (0 when empty; -1 when one
        is on a dead log incarnation, pending reseed)."""
        worst = 0
        for r in self.replicas:
            if r.lag_records is None:
                return -1
            worst = max(worst, r.lag_records)
        return worst


class ReplicaGroup:
    """One whole-tier read replica: a snapshot-seeded service and the WAL
    cursor that keeps it fresh. The manager's sync and reseed paths hold
    ``_lock`` while touching it."""

    def __init__(self, index: int, service: ShardedTripleService, cursor: WalCursor,
                 seeded_resets: int):
        self.index = index
        self.service = service
        self.cursor = cursor
        #: WriteAheadLog.resets at seed time: the log incarnation this
        #: cursor's offsets are valid against
        self.seeded_resets = seeded_resets
        self.healthy = True     # False: catch-up failed, reseed pending
        self.in_flight = 0      # flushes running on this group now
        self.flushes = 0        # flushes served (lifetime)
        self.reseeds = 0        # snapshot reseeds (failover events)
        self._lock = threading.Lock()  # serialises sync / reseed a group

    @property
    def records(self) -> int:
        """WAL records applied since the seed (the group's generation)."""
        return self.cursor.records


class ReplicationManager:
    """Owns the replica groups of one durable sharded tier.

    Made (and attached to the primary router) by
    :meth:`repro_torch.persist.service.DurableShardedService.enable_replication`.
    The router calls :meth:`acquire` / :meth:`release` a flush; :meth:`sync`
    drains the WAL tail into every group (the quiesce step).
    """

    def __init__(self, primary: ShardedTripleService, wal: WriteAheadLog, root: str,
                 n_replicas: int, dispatch=None, max_lag=None, *, mmap: bool = True,
                 verify: bool = True, auto_sync: bool = True):
        self.primary = primary
        self.wal = wal
        self.root = os.fspath(root)
        self.dispatch = resolve_replica_dispatch(dispatch)
        self.max_lag = resolve_replica_max_lag(max_lag)
        self.mmap = bool(mmap)
        self.verify = bool(verify)
        #: tail-sync one group when none is dispatchable at acquire time
        #: (self-healing without a thread)
        self.auto_sync = bool(auto_sync)
        self.closed = False
        self._dispatch_lock = threading.Lock()
        self._rr = 0
        self._plan_memo: dict = {}  # (id, id) -> (plan, plan, equal)
        self.groups = [ReplicaGroup(g, *self._seed(g)) for g in range(int(n_replicas))]

    # -- seeding / failover ------------------------------------------------
    def _seed(self, index: int):
        """Open group `index` from the newest snapshot onto the primary's
        device: returns (service, cursor, seeded_resets). Runs under the
        primary's read lock, so no snapshot, compaction or mutation moves
        the (snapshot, WAL incarnation) pair being captured."""
        from repro_torch.persist.service import (
            TERM_DICT_DIR,
            _newest_snapshot,
            _read_service_manifest,
        )
        from repro_torch.persist.snapshot import load_snapshot, load_term_dict

        primary = self.primary
        with primary._rw.read():
            resets = self.wal.resets
            _, snap = _newest_snapshot(self.root)
            manifest = _read_service_manifest(snap)
            plan = plan_from_dict(manifest["plan"])
            cache = primary.cache
            base = _NS_BASE - index * (plan.n_shards + 1)
            engines = []
            for k in range(plan.n_shards):
                view = cache.shard_view(base - 1 - k) if cache is not None else None
                engines.append(load_snapshot(os.path.join(snap, f"shard_{k}"), cache=view,
                                             mmap=self.mmap, verify=self.verify,
                                             device=primary.device))
            svc = ShardedTripleService(
                engines, plan, cache, max_batch=primary.max_batch, config=primary.config,
                rebalance_skew=None, serve_threads=primary.serve_threads,
                bgp_cache=primary.bgp_cache)
            svc._merged_ns = base
            svc._cache_ns = [base - 1 - k for k in range(plan.n_shards)]
            if manifest.get("term_dict"):
                # the group's own dictionary, caught up by the same WAL term
                # records, so it answers string queries in the same id space
                svc.term_dict = load_term_dict(os.path.join(snap, TERM_DICT_DIR),
                                               verify=self.verify)
            mig = manifest.get("migration_plan")
            if mig is not None:
                new_plan = plan_from_dict(mig)
                svc._migration = RebalancePlan(plan, new_plan,
                                               migration_moves(new_plan, svc.engines))
            # every record in the current log postdates the newest snapshot
            # (snapshot() resets the WAL in the same exclusive section), so a
            # fresh cursor from the header resumes exactly from the seed
            return svc, WalCursor(self.wal.path), resets

    def _reseed_locked(self, group: ReplicaGroup) -> None:
        """Failover: drop the group's state and reseed it from the newest
        snapshot. The old service's namespaces are invalidated (a
        half-applied record may have left entries no later state matches)
        and its pool drained; in-flight flushes finish on the old engines."""
        old = group.service
        group.service, group.cursor, group.seeded_resets = self._seed(group.index)
        group.healthy = True
        group.reseeds += 1
        old.invalidate()
        old.close()

    # -- catch-up ----------------------------------------------------------
    def sync(self) -> list[int]:
        """Tail the WAL into every group (reseeding any group the log was
        compacted under); returns the records applied a group. After a sync
        with no concurrent mutation, every group is at the primary's state."""
        return [self._sync_group(g, allow_reseed=True) for g in self.groups]

    def _sync_group(self, group: ReplicaGroup, allow_reseed: bool) -> int:
        with group._lock:
            return self._sync_group_locked(group, allow_reseed)

    def _sync_group_locked(self, group: ReplicaGroup, allow_reseed: bool) -> int:
        from repro_torch.persist.service import apply_wal_record

        applied = 0
        # two passes: the first may find the group needs a reseed (a stale
        # incarnation, truncation, an apply failure); the second tails the
        # fresh log onto the reseeded state
        for _ in range(2):
            if self.closed:
                break
            stale = (not group.healthy or group.seeded_resets != self.wal.resets
                     or group.cursor.offset > self.wal.offset)
            if stale:
                if not allow_reseed:
                    break
                self._reseed_locked(group)
            recs, report = group.cursor.tail()
            if report.truncated:
                # compacted between the staleness check and the read
                group.healthy = False
                continue
            try:
                if recs:
                    # exclusive on the GROUP only: flushes on other groups and
                    # on the primary keep flowing
                    with group.service._rw.write():
                        for payload in recs:
                            apply_wal_record(group.service, payload)
            except Exception:
                group.healthy = False  # a failed catch-up: drop and reseed
                continue
            applied += len(recs)
            break
        return applied

    # -- dispatch ----------------------------------------------------------
    def _plans_match(self, a, b) -> bool:
        # memoised by identity pair (plans do not change once routing); the
        # memo's strong references keep the ids stable
        if a is b:
            return True
        key = (id(a), id(b))
        hit = self._plan_memo.get(key)
        if hit is not None and hit[0] is a and hit[1] is b:
            return hit[2]
        ok = plans_equal(a, b)
        if len(self._plan_memo) > 64:
            self._plan_memo.clear()
        self._plan_memo[key] = (a, b, ok)
        return ok

    def _dispatchable(self, group: ReplicaGroup) -> bool:
        """May a flush run on this group now? The same log incarnation, lag
        in bound, agreeing routing state, healthy."""
        if not group.healthy or group.seeded_resets != self.wal.resets:
            return False
        if self.max_lag is not None and self.wal.n_records - group.records > self.max_lag:
            return False
        ps, gs = self.primary, group.service
        if gs.failed_shards:
            return False
        if (ps._migration is None) != (gs._migration is None):
            return False
        if not self._plans_match(ps.plan, gs.plan):
            return False
        if ps._migration is not None and not self._plans_match(
                ps._migration.new_plan, gs._migration.new_plan):
            return False
        return True

    def acquire(self) -> ReplicaGroup | None:
        """Pick a group for one flush (None: serve from the primary). Pair
        every group returned with :meth:`release`."""
        if self.closed or not self.groups or self.primary.failed_shards:
            return None
        cand = [g for g in self.groups if self._dispatchable(g)]
        if not cand and self.auto_sync:
            self._opportunistic_sync()
            cand = [g for g in self.groups if self._dispatchable(g)]
        if not cand:
            return None
        with self._dispatch_lock:
            if self.dispatch == "least_loaded":
                group = min(cand, key=lambda g: (g.in_flight, g.index))
            else:
                group = cand[self._rr % len(cand)]
                self._rr += 1
            group.in_flight += 1
        return group

    def release(self, group: ReplicaGroup) -> None:
        with self._dispatch_lock:
            group.in_flight -= 1
            group.flushes += 1

    def _opportunistic_sync(self) -> None:
        """No group was dispatchable: try a non-blocking tail-sync of the
        most lagged group (reseeds are left to the explicit sync: they load
        engines from disk and do not belong on a query)."""
        for group in sorted(self.groups, key=lambda g: g.records):
            if group._lock.acquire(blocking=False):
                try:
                    self._sync_group_locked(group, allow_reseed=False)
                finally:
                    group._lock.release()
                return

    # -- introspection -----------------------------------------------------
    def _group_lag(self, group: ReplicaGroup) -> int | None:
        """Lag in WAL records (None: the cursor belongs to a dead log
        incarnation and cannot be compared; reseed pending)."""
        if not group.healthy or group.seeded_resets != self.wal.resets:
            return None
        return max(0, self.wal.n_records - group.records)

    def replica_set(self, shard: int) -> ReplicaSet:
        """Shard `shard`'s replicas, one a group."""
        k = int(shard)
        if not 0 <= k < self.primary.n_shards:
            raise ValueError(f"shard {k} out of range [0, {self.primary.n_shards})")
        return ReplicaSet(k, [
            ShardReplica(shard=k, group=g.index,
                         engine=g.service.engines[k] if k < len(g.service.engines) else None,
                         cache_ns=g.service._cache_ns[k] if k < len(g.service._cache_ns)
                         else 0,
                         lag_records=self._group_lag(g))
            for g in self.groups])

    def stats(self) -> dict:
        """Lag accounting and dispatch counters, JSON-shaped. The headline
        ``max_lag_records`` is the worst comparable group lag (stale
        incarnations pending reseed are counted apart)."""
        lags = [self._group_lag(g) for g in self.groups]
        comparable = [v for v in lags if v is not None]
        return {
            "n_replicas": len(self.groups),
            "dispatch": self.dispatch,
            "max_lag": self.max_lag,
            "primary_records": self.wal.n_records,
            "max_lag_records": max(comparable, default=0),
            "stale_groups": sum(1 for v in lags if v is None),
            "groups": [{
                "replica": g.index,
                "records": g.records,
                "offset": g.cursor.offset,
                "lag_records": lag,
                "flushes": g.flushes,
                "in_flight": g.in_flight,
                "reseeds": g.reseeds,
                "dispatchable": self._dispatchable(g),
            } for g, lag in zip(self.groups, lags)],
        }

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Shut the replica tier down: no further dispatch, every group
        service's pool drained. Idempotent."""
        if self.closed:
            return
        self.closed = True
        for group in self.groups:
            with group._lock:
                group.service.close()
