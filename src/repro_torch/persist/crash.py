"""Crash-point injection for durability testing.

A kill -9 cannot be produced inside the test process, so the durability
paths (the snapshot write, the engine's rebuild) are instrumented with
named :func:`crash_point` calls, and tests arm a :class:`CrashInjector`
with a schedule ``{point_name: hit_number}``. When an armed point reaches
its scheduled hit it raises :class:`CrashPoint`, which models the process
dying at that instant: everything in memory is garbage, only what already
reached disk matters.

`CrashPoint` subclasses ``BaseException`` on purpose: code that
defensively catches ``Exception`` must not "survive" a simulated kill.

An injector is armed only through :func:`inject_crashes`; nothing reads
the environment. Disarmed, a point costs one global read and a ``None``
check, so the hooks stay in production paths.

This module imports nothing else of the package, so any layer can call
:func:`crash_point` without an import cycle.
"""
from __future__ import annotations

from contextlib import contextmanager


class CrashPoint(BaseException):
    """A simulated kill at a named injection point (not an ``Exception``:
    broad handlers must not swallow a crash)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.name = name


class CrashInjector:
    """Deterministic crash schedule: ``{point_name: hit_number}`` raises
    :class:`CrashPoint` the `hit_number`-th (1-based) time that point is
    visited. `hits` keeps per-point visit counts for assertions."""

    def __init__(self, schedule: dict[str, int] | None = None):
        self.schedule = {str(k): int(v) for k, v in (schedule or {}).items()}
        self.hits: dict[str, int] = {}

    def visit(self, name: str) -> None:
        n = self.hits.get(name, 0) + 1
        self.hits[name] = n
        if self.schedule.get(name) == n:
            raise CrashPoint(name)


# the armed injector (None = disarmed); module-global so every layer's
# crash_point() calls see one schedule without threading state through APIs
_ACTIVE: CrashInjector | None = None


def crash_point(name: str) -> None:
    """Visit the named injection point; raises :class:`CrashPoint` when the
    armed schedule says this visit is the crash."""
    if _ACTIVE is not None:
        _ACTIVE.visit(name)


def active_injector() -> CrashInjector | None:
    return _ACTIVE


@contextmanager
def inject_crashes(schedule: dict[str, int]):
    """Arm a crash schedule for the duration of the block; yields the
    :class:`CrashInjector` (its `hits` survive the block for assertions).
    Nested arming restores the previous injector on exit."""
    global _ACTIVE
    injector = CrashInjector(schedule)
    prev = _ACTIVE
    _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = prev


def parse_crash_points(spec: str) -> dict[str, int]:
    """Parse a crash schedule spec: comma-separated ``name:hit`` entries
    (hit defaults to 1). Malformed entries raise: a typo'd crash drill
    silently testing nothing is worse than an error."""
    schedule: dict[str, int] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, hit = entry.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"bad crash point entry {entry!r}: empty point name")
        try:
            schedule[name] = int(hit) if hit.strip() else 1
        except ValueError:
            raise ValueError(
                f"bad crash point entry {entry!r}: hit count must be an integer") from None
    return schedule
