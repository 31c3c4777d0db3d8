"""Concurrency primitives of the sharded serving tier
(:mod:`repro_torch.serve.sharded`), the twin of ``repro.serve.concurrency``.

* :class:`RWLock`: the reader-writer lock behind the tier's discipline.
  Queries are *readers*: any number of flushes run at once, each seeing one
  consistent (plan, migration, engines) state for its whole duration.
  Mutations, rebuilds, rebalance steps and failure handling are *writers*,
  fully exclusive, so every invariant the single-threaded tests pin
  (migration-safe routing, disjoint partitions) holds under any
  interleaving.

  The lock is **write-preferring** (a waiting writer blocks new readers, so
  a write waits for the flushes in flight, not for a steady stream of
  readers) and **writer-reentrant**: the thread holding write may take
  write again and may take read (a write-locked step that probes through
  the query path). Upgrading read to write raises ``RuntimeError``: two
  readers upgrading at once would deadlock.

* :func:`resolve_serve_threads`: how many threads one sharded flush may fan
  its per-shard work out across. It takes an argument only; the default is
  the host's core count.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager


class RWLock:
    """Write-preferring reader-writer lock with a reentrant writer.

    * ``read()``: shared, many threads at once; reentrant per thread;
      granted at once to the thread holding write.
    * ``write()``: exclusive; waits for every reader to leave and blocks
      new ones while it waits; reentrant in the owning thread.
    * an upgrade from read to write raises ``RuntimeError``.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers: dict[int, int] = {}   # thread ident -> read depth
        self._writer: int | None = None      # ident of the write holder
        self._write_depth = 0
        self._waiting_writers = 0

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()

    def acquire_read(self):
        me = threading.get_ident()
        with self._cond:
            # the write owner and readers already admitted pass the
            # writer-preference barrier: blocking them would deadlock
            if self._writer == me or me in self._readers:
                self._readers[me] = self._readers.get(me, 0) + 1
                return
            while self._writer is not None or self._waiting_writers:
                self._cond.wait()
            self._readers[me] = 1

    def release_read(self):
        me = threading.get_ident()
        with self._cond:
            depth = self._readers.get(me)
            if depth is None:
                raise RuntimeError("release_read without acquire_read")
            if depth > 1:
                self._readers[me] = depth - 1
            else:
                del self._readers[me]
                self._cond.notify_all()

    def acquire_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._write_depth += 1
                return
            if me in self._readers:
                raise RuntimeError(
                    "read->write upgrade would deadlock; release the read "
                    "lock (or take the write lock first)")
            self._waiting_writers += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._waiting_writers -= 1
            self._writer = me
            self._write_depth = 1

    def release_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer != me:
                raise RuntimeError("release_write by a non-owner thread")
            self._write_depth -= 1
            if self._write_depth == 0:
                self._writer = None
                self._cond.notify_all()

    # -- introspection (tests, diagnostics) ---------------------------------
    @property
    def write_held(self) -> bool:
        return self._writer is not None

    @property
    def active_readers(self) -> int:
        return len(self._readers)


def resolve_serve_threads(value=None) -> int:
    """The scatter-gather fan-out width: threads one sharded flush may use
    to query shard engines in parallel; ``1`` is the sequential fan-out.

    * ``None`` (or an empty or unparsable value) gives ``os.cpu_count()``;
    * ``off`` / ``none`` / ``never`` (any case), ``0``, ``1`` or a
      negative value give ``1``;
    * a larger integer is itself (the service caps the pool at its shard
      count).
    """
    text = "" if value is None else str(value).strip().lower()
    default = os.cpu_count() or 1
    if not text:
        return default
    if text in ("off", "none", "never"):
        return 1
    try:
        n = int(text)
    except ValueError:
        return default
    return max(1, n)
