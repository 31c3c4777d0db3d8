"""Durable sharded serving: snapshots, a write-ahead log and replay recovery;
the twin of ``repro.persist.service``, in its on-disk format.

:class:`DurableShardedService` wraps a
:class:`~repro_torch.serve.sharded.ShardedTripleService` with the two
on-disk structures that make it survive a kill at any instant:

* **Versioned service snapshots**: ``snap_NNNNNN/`` directories under the
  service root, each holding one engine snapshot a shard
  (:mod:`repro_torch.persist.snapshot`) and a ``service.json`` with the
  routing plan (and, when taken mid-migration, the successor plan). The
  manifest is written last and the directory is published by one
  ``os.rename``, so the newest *complete* directory is always a consistent
  state; older directories are removed only after the rename.
* **A write-ahead log** (:mod:`repro_torch.persist.wal`): every mutation
  and every rebalance state change appends a record BEFORE it applies on
  the card. Recovery loads the newest snapshot and replays the log over it.

The directory is the reference's, file for file: either package opens what
the other wrote. A write's rows are canonicalised on the host (the batch is
copied there once when it is a tensor), packed as little-endian int64 and
fsynced before any row reaches an engine; a migration batch (rows on the
card) is copied to the host once to be logged, before it applies. Replay
copies each logged batch onto the engines' device once.

Recovery invariants the crash oracle enforces at every injection point:

* an operation whose record predates the crash is fully recovered; one
  whose record never reached the disk never happened; a torn final record
  is dropped by the tolerant reader, so there is no third state;
* replay is idempotent: a crash *between* the snapshot's commit and the
  WAL's truncation replays the whole old log onto the new snapshot, a no-op
  by construction (mutations are set operations; migration batches apply
  through a probe of the source, ``ShardedTripleService
  ._apply_migration_batch``);
* an in-flight migration needs no row lists on disk: the snapshot (or the
  ``rebalance_begin`` record) pins the successor plan, and the rows still to
  move are the diff between where rows sit and where that plan routes them
  (:func:`repro_torch.distributed.rebalance.migration_moves`);
* a shard whose snapshot is corrupt degrades instead of killing the tier:
  the service serves the surviving shards, refuses writes to the hole, and
  :meth:`ShardedTripleService.reingest_shard` restores it.

Crash points are ``BaseException`` s raised between card operations; after
one fires, the live instance is abandoned and recovery reads only the disk.
Every knob is an argument: ``root`` is required, ``fsync`` defaults to on.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.result_cache import QueryResultCache
from repro_torch.device import resolve_device
from repro_torch.distributed.partition import plan_from_dict, plan_to_dict
from repro_torch.distributed.rebalance import RebalancePlan, migration_moves
from repro_torch.persist.crash import crash_point
from repro_torch.persist.snapshot import (
    SnapshotError,
    load_snapshot,
    load_term_dict,
    save_snapshot,
    save_term_dict,
)
from repro_torch.persist.wal import (
    OP_DELETE,
    OP_INSERT,
    OP_MIGRATE,
    OP_NODE_TERMS,
    OP_PLAN_SWAP,
    OP_PRED_TERMS,
    OP_REBALANCE_BEGIN,
    WriteAheadLog,
    read_wal_records,
)
from repro_torch.serve.sharded import (
    _DEFAULT_CACHE,
    _DEFAULT_SKEW,
    ShardedTripleService,
    _host_rows,
)

SERVICE_MANIFEST = "service.json"
WAL_FILE = "wal.log"
TERM_DICT_DIR = "term_dict"

_SNAP_RE = re.compile(r"^snap_(\d{6})$")

_MIGRATE_HDR = struct.Struct("<ii")  # src shard, dst shard


def resolve_snapshot_dir(root) -> str:
    """The service root: `root`, which is required (``None`` raises
    ``ValueError``; nothing is read from the environment)."""
    if root is None:
        raise ValueError("no snapshot root: pass root=")
    return os.fspath(root)


@dataclass
class RecoveryReport:
    """What :meth:`DurableShardedService.open` found and did."""

    snapshot_dir: str = ""
    snapshot_step: int = 0
    replayed_records: int = 0
    skipped_rows: int = 0        # mutation rows dropped (failed shards)
    skipped_batches: int = 0     # migration batches dropped (failed shards)
    torn_tail: bool = False      # WAL ended in a dropped partial record
    torn_reason: str = ""
    migration_resumed: bool = False
    failed_shards: list = field(default_factory=list)


# -- record packing --------------------------------------------------------

def _le_rows(rows) -> bytes:
    """(n, 3) rows as little-endian int64 bytes (a tensor is copied to the
    host once)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.ascontiguousarray(rows, dtype="<i8").tobytes()


def _pack_rows(op: int, rows) -> bytes:
    return bytes([op]) + _le_rows(rows)


def _unpack_rows(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype="<i8").astype(np.int64).reshape(-1, 3)


def _pack_plan(op: int, plan) -> bytes:
    return bytes([op]) + json.dumps(plan_to_dict(plan)).encode()


def _pack_migrate(src: int, dst: int, rows) -> bytes:
    return bytes([OP_MIGRATE]) + _MIGRATE_HDR.pack(src, dst) + _le_rows(rows)


def _pack_terms(op: int, terms) -> bytes:
    # terms may hold any character, so each is length-prefixed (u32 byte
    # length + utf-8 bytes) rather than delimiter-joined
    parts = [bytes([op])]
    for t in terms:
        enc = t.encode("utf-8")
        parts.append(struct.pack("<I", len(enc)))
        parts.append(enc)
    return b"".join(parts)


def _unpack_terms(payload: bytes) -> list[str]:
    terms, off = [], 0
    while off < len(payload):
        (ln,) = struct.unpack_from("<I", payload, off)
        off += 4
        terms.append(payload[off:off + ln].decode("utf-8"))
        off += ln
    return terms


class DurableShardedService:
    """A sharded triple service on the card whose state survives ``kill -9``.

    Build fresh with :meth:`build` (compress, then the initial snapshot) or
    recover with :meth:`open` (the newest snapshot, then WAL replay). The
    query plane and maintenance surface delegate to the wrapped
    :class:`~repro_torch.serve.sharded.ShardedTripleService`; the mutation
    surface (``insert_triples`` / ``delete_triples`` and the term mints)
    writes ahead to the log, and rebalance state changes journal themselves
    through the service's ``_journal`` hook. :meth:`snapshot` persists the
    current state and compacts the log.
    """

    def __init__(self, service: ShardedTripleService, root: str, wal: WriteAheadLog,
                 recovery: RecoveryReport | None = None):
        self.service = service
        self.root = os.fspath(root)
        self.wal = wal
        #: report of the recovery that made this instance (None when built)
        self.last_recovery = recovery

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, triples, n_nodes: int, n_preds: int, root=None, fsync: bool | None = None,
              replicas=None, replica_dispatch=None, replica_max_lag=None, device=None,
              **kwargs) -> "DurableShardedService":
        """Compress and shard `triples` on `device` (every
        :meth:`ShardedTripleService.build` keyword passes through; ``None``
        means CUDA, and raises without a GPU unless the caller asks for
        ``"cpu"``), then make the result durable: the initial snapshot
        under `root` and the WAL. `replicas` > 0 also seeds that many read
        replica groups from the fresh snapshot (:meth:`enable_replication`)."""
        root = resolve_snapshot_dir(root)
        service = ShardedTripleService.build(triples, n_nodes, n_preds, device=device,
                                             **kwargs)
        os.makedirs(root, exist_ok=True)
        wal = WriteAheadLog(os.path.join(root, WAL_FILE), fsync=fsync)
        self = cls(service, root, wal)
        self.snapshot()
        self._attach()
        self.enable_replication(replicas, replica_dispatch, replica_max_lag)
        return self

    @classmethod
    def open(cls, root=None, *, fsync: bool | None = None, mmap: bool = True,
             verify: bool = True, max_batch: int = 1024, config=None,
             rebalance_skew=_DEFAULT_SKEW, cache=_DEFAULT_CACHE,
             serve_threads: int | None = None, replicas=None, replica_dispatch=None,
             replica_max_lag=None, device=None) -> "DurableShardedService":
        """Recover a service from disk onto `device` (``None`` means CUDA):
        the newest complete snapshot, then replay.

        Shards whose snapshot fails to load degrade (served as holes)
        instead of failing the open; the log replays with journaling and
        auto-rebalance off, dropping only records that touch failed shards.
        The instance carries a :class:`RecoveryReport` as ``last_recovery``.
        """
        root = resolve_snapshot_dir(root)
        dev = resolve_device(device)
        step, snap = _newest_snapshot(root)
        manifest = _read_service_manifest(snap)
        plan = plan_from_dict(manifest["plan"])
        report = RecoveryReport(snapshot_dir=snap, snapshot_step=step)
        if cache is _DEFAULT_CACHE:
            cache = QueryResultCache()

        engines: list = []
        failed: list[int] = []
        for k in range(plan.n_shards):
            shard_view = cache.shard_view(k) if cache is not None else None
            try:
                engines.append(load_snapshot(os.path.join(snap, f"shard_{k}"), cache=shard_view,
                                             mmap=mmap, verify=verify, device=dev))
            except SnapshotError:
                engines.append(None)  # a placeholder, replaced by mark_shard_failed
                failed.append(k)
        if config is None:
            config = next((e.config for e in engines if e is not None), None)
        svc = ShardedTripleService(engines, plan, cache, max_batch, config=config,
                                   rebalance_skew=rebalance_skew, serve_threads=serve_threads,
                                   device=dev)
        for k in failed:
            svc.mark_shard_failed(k)
        report.failed_shards = failed
        if manifest.get("term_dict"):
            svc.term_dict = load_term_dict(os.path.join(snap, TERM_DICT_DIR), verify=verify)

        mig_plan = manifest.get("migration_plan")
        if mig_plan is not None:
            new_plan = plan_from_dict(mig_plan)
            svc._migration = RebalancePlan(plan, new_plan, migration_moves(new_plan, svc.engines))
            report.migration_resumed = True

        wal = WriteAheadLog(os.path.join(root, WAL_FILE), fsync=fsync)
        self = cls(svc, root, wal, recovery=report)
        self._replay(report)
        self._attach()
        if not failed:  # a degraded tier serves from the primary until restored
            self.enable_replication(replicas, replica_dispatch, replica_max_lag,
                                    mmap=mmap, verify=verify)
        return self

    def _attach(self) -> None:
        self.service._journal = self._on_journal

    # -- read replication --------------------------------------------------
    def enable_replication(self, n_replicas=None, dispatch=None, max_lag=None, *,
                           mmap: bool = True, verify: bool = True, auto_sync: bool = True):
        """Seed `n_replicas` read replica groups (``None`` or 0: none) from
        the newest snapshot onto the tier's device, attach them to the
        router's dispatch and catch them up to the live WAL. Replaces (and
        closes) any replica tier there was; returns the
        :class:`~repro_torch.serve.replication.ReplicationManager`, or None
        for zero groups."""
        from repro_torch.serve.replication import ReplicationManager, resolve_replicas

        svc = self.service
        n = resolve_replicas(n_replicas)
        old, svc._replicas = svc._replicas, None
        if old is not None:
            old.close()
        if n <= 0:
            return None
        if svc.failed_shards:
            raise RuntimeError(
                f"cannot seed replicas with failed shards {sorted(svc.failed_shards)}: the "
                "snapshot they seed from must cover every shard; restore with "
                "reingest_shard() and snapshot() first")
        manager = ReplicationManager(svc, self.wal, self.root, n, dispatch, max_lag, mmap=mmap,
                                     verify=verify, auto_sync=auto_sync)
        manager.sync()  # groups start at the primary's state, lag 0
        svc._replicas = manager
        return manager

    @property
    def replicas(self):
        """The live ReplicationManager (None when replication is off)."""
        return self.service._replicas

    def sync_replicas(self) -> list[int]:
        """Drain the WAL tail into every replica group (quiesce); returns the
        records applied a group ([] when replication is off)."""
        manager = self.service._replicas
        return manager.sync() if manager is not None else []

    def replica_stats(self) -> dict | None:
        """Replica lag accounting and dispatch counters (None when off)."""
        manager = self.service._replicas
        return manager.stats() if manager is not None else None

    # -- mutation (write-ahead) --------------------------------------------
    def insert_triples(self, triples) -> int:
        """Durably insert (s, p, o) rows: logged before applied."""
        return self._mutate(triples, OP_INSERT)

    def delete_triples(self, triples) -> int:
        """Durably delete (s, p, o) rows: logged before applied."""
        return self._mutate(triples, OP_DELETE)

    def _mutate(self, triples, op: int) -> int:
        svc = self.service
        # canonicalised on the host once (a tensor is copied there once);
        # the log and the tier both get these rows
        rows = _host_rows(triples)
        if len(rows) == 0:
            return 0
        # one exclusive section for validate + append + apply: WAL order must
        # equal apply order, and the routing state validated against must be
        # the one applied under. The tier's mutation re-takes write: the lock
        # is writer-reentrant for this nesting.
        with svc._rw.write():
            # validate BEFORE the append: a record that cannot apply must
            # never reach the log, or replay would trip over it
            if int(rows[:, 1].max()) >= svc.plan.n_preds:
                raise ValueError(f"predicate ids must be < {svc.plan.n_preds}; "
                                 f"got {int(rows[:, 1].max())}")
            if svc.failed_shards:
                bad = sorted(svc.failed_shards)
                hits = np.isin(svc.plan.route_triples(rows), bad)
                if svc._migration is not None:
                    hits |= np.isin(svc._migration.new_plan.route_triples(rows), bad)
                if hits.any():
                    raise RuntimeError(f"cannot mutate failed shards {bad}; "
                                       "restore them with reingest_shard() first")
            self.wal.append(_pack_rows(op, rows))
            return svc.insert_triples(rows) if op == OP_INSERT else svc.delete_triples(rows)

    # -- term minting (WAL-covered) ----------------------------------------
    def add_node_terms(self, terms) -> torch.Tensor:
        """Durably mint node-term ids: the genuinely new terms are logged (in
        first-seen order) BEFORE the dictionary learns them, so replay and
        WAL-tailing replicas rebuild the identical id space."""
        return self._mint_terms(terms, OP_NODE_TERMS)

    def add_pred_terms(self, terms) -> torch.Tensor:
        """Durably mint predicate-term ids (see :meth:`add_node_terms`);
        raises before logging anything if the mint would pass the tier's
        fixed predicate capacity."""
        return self._mint_terms(terms, OP_PRED_TERMS)

    def _mint_terms(self, terms, op: int) -> torch.Tensor:
        svc = self.service
        terms = list(terms)
        # as _mutate: validate + append + apply in one exclusive section, so
        # WAL order equals mint order (ids follow arrival order)
        with svc._rw.write():
            td = svc._require_term_dict()
            lookup = td.node_id if op == OP_NODE_TERMS else td.pred_id
            fresh = [t for t in dict.fromkeys(terms) if lookup(t) is None]
            if op == OP_PRED_TERMS and td.n_preds + len(fresh) > svc.plan.n_preds:
                raise ValueError(
                    f"predicate capacity exhausted: tier was built with "
                    f"n_preds={svc.plan.n_preds}, dictionary holds {td.n_preds}, cannot mint "
                    f"{len(fresh)} more; rebuild the tier with a larger predicate capacity")
            if fresh:
                self.wal.append(_pack_terms(op, fresh))
            return svc.add_node_terms(terms) if op == OP_NODE_TERMS \
                else svc.add_pred_terms(terms)

    # -- journaling hook (rebalance state changes) -------------------------
    def _on_journal(self, kind: str, payload) -> None:
        if kind == "migrate":
            # the batch's rows are on the card: one copy to the host, which
            # completes before the batch applies
            src, dst, batch = payload
            self.wal.append(_pack_migrate(int(src), int(dst), batch))
        elif kind == "rebalance_begin":
            self.wal.append(_pack_plan(OP_REBALANCE_BEGIN, payload))
        elif kind == "plan_swap":
            self.wal.append(_pack_plan(OP_PLAN_SWAP, payload))
        else:  # a silent drop would corrupt recovery
            raise ValueError(f"unknown journal event {kind!r}")

    # -- snapshot / compaction ---------------------------------------------
    def snapshot(self, keep: int = 2) -> str:
        """Persist the current state as a new versioned snapshot, then
        compact: older snapshots are removed and the WAL truncated. Safe at
        every step: a kill before the commit rename leaves the previous
        snapshot authoritative; one after it but before the truncation
        replays the (now redundant) log onto the new snapshot, which is
        idempotent."""
        svc = self.service
        # exclusive for the whole capture + commit + WAL reset: the snapshot
        # is one instant of the tier, and a mutation appended between the
        # rename and the truncation would be erased by the reset
        with svc._rw.write():
            if svc.failed_shards:
                raise RuntimeError(
                    f"cannot snapshot with failed shards {sorted(svc.failed_shards)}: the hole "
                    "would become permanent; restore them with reingest_shard() first")
            steps = _snapshot_steps(self.root)
            step = (steps[-1] if steps else 0) + 1
            final = os.path.join(self.root, f"snap_{step:06d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for k, engine in enumerate(svc.engines):
                save_snapshot(engine, os.path.join(tmp, f"shard_{k}"), atomic=False)
            if svc.term_dict is not None:
                save_term_dict(svc.term_dict, os.path.join(tmp, TERM_DICT_DIR))
            manifest = {
                "format": 1,
                "plan": plan_to_dict(svc.plan),
                "migration_plan": None if svc._migration is None
                else plan_to_dict(svc._migration.new_plan),
                "term_dict": svc.term_dict is not None,
            }
            # the service manifest last: the directory's commit marker
            with open(os.path.join(tmp, SERVICE_MANIFEST), "w") as f:
                json.dump(manifest, f)
            crash_point("snapshot.pre_commit")
            os.rename(tmp, final)
            crash_point("snapshot.post_commit")
            # remove old ones only AFTER the commit: at no instant is there
            # no complete snapshot on disk
            for old in steps[:len(steps) - keep + 1]:
                shutil.rmtree(os.path.join(self.root, f"snap_{old:06d}"), ignore_errors=True)
            self.wal.reset()
            return final

    # -- replay ------------------------------------------------------------
    def _replay(self, report: RecoveryReport) -> None:
        """Apply every intact WAL record to the freshly loaded service.

        Journaling is detached (nothing re-logs) and the auto-rebalance
        trigger is off for the duration, so replay applies exactly the
        logged history: no new plans, no new migrations. Records touching
        failed shards are dropped (and counted)."""
        svc = self.service
        records, wal_report = read_wal_records(self.wal.path)
        # the WAL truncated any torn tail when it opened; report from its
        # open-time scan, where the tear was still visible
        scan = self.wal.recovery or wal_report
        report.torn_tail = scan.torn_tail
        report.torn_reason = scan.torn_reason
        svc._journal = None
        saved_skew = svc.rebalance_skew
        svc.rebalance_skew = None  # no auto-rebalance mid-replay
        try:
            for payload in records:
                apply_wal_record(svc, payload, report)
                report.replayed_records += 1
        finally:
            svc.rebalance_skew = saved_skew

    # -- lifecycle / delegation --------------------------------------------
    def close(self) -> None:
        """Shut the hierarchy down: journal detached, the replica tier (if
        any) and the fan-out pools drained, WAL closed. Idempotent."""
        self.service._journal = None
        self.service.close()  # drains the replica tier and the fan-out pool
        self.wal.close()

    def __enter__(self) -> "DurableShardedService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getattr__(self, name: str):
        # the query plane and maintenance surface of the wrapped tier
        # (submit / flush / query / rebalance / rebuild / stats / ...);
        # mutations are intercepted above so they reach the log first
        return getattr(self.service, name)


# -- record application ------------------------------------------------------

def apply_wal_record(svc: ShardedTripleService, payload: bytes,
                     report: RecoveryReport | None = None) -> None:
    """Apply one WAL payload to `svc`: the one replay switch.

    Recovery replay (:meth:`DurableShardedService.open`, with its `report`,
    so rows and migration batches touching failed shards are dropped and
    counted) and replica catch-up (:mod:`repro_torch.serve.replication`, no
    report: groups are seeded whole and any failure raises into the
    group's reseed path) both go through it, so a replica that tailed the
    log and a service that replayed it land on the same state."""
    if report is None:
        report = RecoveryReport()
    op = payload[0]
    if op in (OP_INSERT, OP_DELETE):
        rows = _drop_failed(svc, _unpack_rows(payload[1:]), report)
        if len(rows) == 0:
            return
        if op == OP_INSERT:
            svc.insert_triples(rows)
        else:
            svc.delete_triples(rows)
    elif op == OP_MIGRATE:
        src, dst = _MIGRATE_HDR.unpack_from(payload, 1)
        rows = _unpack_rows(payload[1 + _MIGRATE_HDR.size:])
        if src in svc.failed_shards or dst in svc.failed_shards:
            report.skipped_batches += 1
            return
        batch = torch.from_numpy(rows).to(svc.device)  # one copy onto the card
        if svc._migration is not None:
            svc._migration.discard(batch)
        moved = svc._apply_migration_batch(src, dst, batch)
        svc.stats.migrated_rows += moved
    elif op == OP_REBALANCE_BEGIN:
        new_plan = plan_from_dict(json.loads(payload[1:].decode()))
        svc._migration = RebalancePlan(svc.plan, new_plan, migration_moves(new_plan, svc.engines))
        report.migration_resumed = not svc._migration.done
    elif op == OP_PLAN_SWAP:
        svc.plan = plan_from_dict(json.loads(payload[1:].decode()))
        svc._migration = None
        report.migration_resumed = False
    elif op in (OP_NODE_TERMS, OP_PRED_TERMS):
        # records hold only new terms in first-seen order, so appending them
        # in log order rebuilds the exact id sequence (a term already there
        # keeps its id)
        terms = _unpack_terms(payload[1:])
        td = svc.term_dict
        if td is None:
            from repro_torch.core.term_dict import TermDict

            td = TermDict.empty()
            svc.term_dict = td
        if op == OP_NODE_TERMS:
            td.add_node_terms(terms)
        else:
            td.add_pred_terms(terms)
    else:
        raise SnapshotError(f"unknown WAL op code {op}")


def _drop_failed(svc: ShardedTripleService, rows: np.ndarray,
                 report: RecoveryReport) -> np.ndarray:
    if not svc.failed_shards or len(rows) == 0:
        return rows
    bad = sorted(svc.failed_shards)
    keep = ~np.isin(svc.plan.route_triples(rows), bad)
    if svc._migration is not None:
        keep &= ~np.isin(svc._migration.new_plan.route_triples(rows), bad)
    report.skipped_rows += int((~keep).sum())
    return rows[keep]


# -- snapshot directory scanning -------------------------------------------

def _snapshot_steps(root: str) -> list[int]:
    """Ascending steps of COMPLETE snapshot directories (the service
    manifest present: an aborted ``.tmp`` or manifest-less one never
    counts)."""
    steps = []
    for entry in os.listdir(root):
        m = _SNAP_RE.match(entry)
        if m and os.path.exists(os.path.join(root, entry, SERVICE_MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _newest_snapshot(root: str) -> tuple[int, str]:
    if not os.path.isdir(root):
        raise SnapshotError(f"no snapshot root at {root}")
    steps = _snapshot_steps(root)
    if not steps:
        raise SnapshotError(f"no complete snapshot under {root}")
    return steps[-1], os.path.join(root, f"snap_{steps[-1]:06d}")


def _read_service_manifest(snap: str) -> dict:
    try:
        with open(os.path.join(snap, SERVICE_MANIFEST)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise SnapshotError(f"unreadable service manifest in {snap}: {exc}") from exc
