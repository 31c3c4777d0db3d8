"""Durability of the port: engine snapshots and crash injection.

* :mod:`repro_torch.persist.crash`: :func:`crash_point` hooks and the
  :class:`CrashInjector` test harness (imports nothing else of the package).
* :mod:`repro_torch.persist.snapshot`: versioned, checksummed, mmap-able
  engine snapshots (``save_snapshot`` / ``load_snapshot``) and term
  dictionary directories (``save_term_dict`` / ``load_term_dict``) in the
  reference's format, so either package opens what the other wrote.

Snapshot names load lazily (PEP 562): ``repro_torch.core.query`` imports
the crash hooks, and an eager import of the snapshot module (which imports
the engine) would be circular.
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
}

__all__ = ["CrashInjector", "CrashPoint", "crash_point", "inject_crashes", *_LAZY]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
