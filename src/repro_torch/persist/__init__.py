"""Durability of the port: engine snapshots, the mutation write-ahead log,
the durable sharded service and crash injection.

* :mod:`repro_torch.persist.crash`: :func:`crash_point` hooks and the
  :class:`CrashInjector` test harness (imports nothing else of the package).
* :mod:`repro_torch.persist.snapshot`: versioned, checksummed, mmap-able
  engine snapshots (``save_snapshot`` / ``load_snapshot``) and term
  dictionary directories (``save_term_dict`` / ``load_term_dict``) in the
  reference's format, so either package opens what the other wrote.
* :mod:`repro_torch.persist.wal`: the framed, fsync-controlled write-ahead
  log with its truncation-tolerant readers, the reference's bytes.
* :mod:`repro_torch.persist.service`: :class:`DurableShardedService`, the
  sharded tier on the card wrapped with snapshots, the WAL and replay
  recovery, in the reference's directory format.

Everything but the crash hooks loads lazily (PEP 562):
``repro_torch.core.query`` and ``repro_torch.serve.sharded`` import the
crash hooks, and an eager import of the snapshot or service module (which
import those same modules) would be circular.
"""
from __future__ import annotations

from repro_torch.persist.crash import (  # noqa: F401  (dependency-free, safe eager)
    CrashInjector,
    CrashPoint,
    crash_point,
    inject_crashes,
)

_LAZY = {
    "save_snapshot": "repro_torch.persist.snapshot",
    "load_snapshot": "repro_torch.persist.snapshot",
    "SnapshotError": "repro_torch.persist.snapshot",
    "save_term_dict": "repro_torch.persist.snapshot",
    "load_term_dict": "repro_torch.persist.snapshot",
    "WriteAheadLog": "repro_torch.persist.wal",
    "WalCursor": "repro_torch.persist.wal",
    "read_wal_records": "repro_torch.persist.wal",
    "tail_wal_records": "repro_torch.persist.wal",
    "resolve_wal_fsync": "repro_torch.persist.wal",
    "DurableShardedService": "repro_torch.persist.service",
    "RecoveryReport": "repro_torch.persist.service",
    "apply_wal_record": "repro_torch.persist.service",
    "resolve_snapshot_dir": "repro_torch.persist.service",
}

__all__ = ["CrashInjector", "CrashPoint", "crash_point", "inject_crashes", *_LAZY]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
