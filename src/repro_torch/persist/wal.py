"""Mutation write-ahead log: framed, checksummed, truncation-tolerant; the
twin of ``repro.persist.wal``, byte for byte.

The delta overlay (:mod:`repro_torch.core.delta`) makes the sharded tier
*mutable*; this log makes the mutations *durable*. Every state change the
snapshot does not yet cover (triple inserts and deletes, rebalance plan
decisions, migration batches) is appended here BEFORE it applies on the
card (write-ahead order), so a crash at any instant loses at most work that
was never acknowledged:

* crash before the append    -> the operation never happened;
* crash during the append    -> a torn tail record, dropped by the reader;
* crash any time after       -> replay over the snapshot reproduces it.

Record framing is byte-exact and self-delimiting::

    header:  MAGIC (8 bytes, includes the format version)
    record:  u32 payload length | u32 crc32(payload) | payload

The reader walks frames until the file ends mid-frame or a CRC mismatch;
both are the torn tail of the final, unacknowledged append (the only place
a crashed but fsynced log can be damaged) and are reported, not raised.
Payloads are opaque here; :mod:`repro_torch.persist.service` packs them
(little-endian int64 row blocks, JSON plan blobs) and owns the op codes
below.

The same tolerant scan serves *incremental* consumers:
:func:`tail_wal_records` / :class:`WalCursor` read only the records
appended since a byte offset (the feed that keeps read replicas,
:mod:`repro_torch.serve.replication`, fresh) and flag a log compacted
underneath the cursor (``truncated``), so the consumer reseeds from a
snapshot instead of silently replaying from offset 0.

This module is host code: files, ``struct`` and ``zlib``; it needs no
torch. Durability is an argument only: ``fsync`` (default on) controls
fsync-per-append. Off trades the crash durability of the last few records
for append throughput; replay correctness is unaffected, only the loss
window.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass, field

from repro_torch.persist.crash import crash_point

MAGIC = b"ITRWAL01"

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)

# op codes for service-level payloads (first byte of every payload)
OP_INSERT = 1          # triple rows inserted
OP_DELETE = 2          # triple rows deleted
OP_MIGRATE = 3         # one rebalance migration batch (src, dst, rows)
OP_REBALANCE_BEGIN = 4  # successor plan decided; migration starts
OP_PLAN_SWAP = 5       # successor plan adopted as THE routing plan
OP_NODE_TERMS = 6      # node terms minted into the term dictionary
OP_PRED_TERMS = 7      # predicate terms minted into the term dictionary


def resolve_wal_fsync(value=None) -> bool:
    """fsync-per-append policy: ``bool(value)``; ``None`` keeps the durable
    default (on). Nothing is read from the environment."""
    return True if value is None else bool(value)


@dataclass
class WalReadReport:
    """What the tolerant reader saw: clean records, plus whether (and
    where) it stopped at a damaged tail."""

    n_records: int = 0
    valid_bytes: int = 0    # offset of the first byte NOT covered by a record
    torn_tail: bool = False  # file continued past valid_bytes with garbage
    torn_reason: str = ""
    #: tail-only signal: the log is now SHORTER than the requested start
    #: offset; it was compacted (``reset()``) underneath the cursor, and
    #: nothing read from the current file can continue the old position
    truncated: bool = False
    errors: list = field(default_factory=list)


class WriteAheadLog:
    """Append-only mutation log over one file.

    `append` is the whole write surface: frame the payload, write, flush,
    fsync (unless disabled). Crash points ``wal.append`` (before any
    bytes), ``wal.torn`` (half the frame written and flushed: the
    torn-write simulation) and ``wal.post_append`` (bytes durable,
    acknowledgement not yet returned) let the crash oracle kill the process
    at every interesting instant.
    """

    def __init__(self, path, fsync: bool | None = None):
        self.path = os.fspath(path)
        self.fsync = resolve_wal_fsync(fsync)
        # appends are already serialised by the durable service's exclusive
        # write lock; this inner lock keeps two frames from interleaving even
        # if a caller appends outside that discipline
        self._lock = threading.Lock()
        fresh = not os.path.exists(self.path) or os.path.getsize(self.path) < len(MAGIC)
        #: tolerant scan of the pre-existing log (None when created fresh)
        self.recovery: WalReadReport | None = None
        # unbuffered: every write() reaches the OS at once, so an abandoned
        # handle (a simulated kill) can never flush half-written frames
        # AFTER recovery has read the file
        self._f = open(self.path, "ab" if not fresh else "wb", buffering=0)
        #: compactions (`reset()`) since this handle opened: a tail cursor
        #: seeded against one incarnation of the log is invalid as soon as
        #: this counter moves, even if the file has regrown past its offset
        self.resets = 0
        if fresh:
            self._f.write(MAGIC)
            self._flush()
            self._offset = len(MAGIC)
            self.n_records = 0
        else:
            _, self.recovery = read_wal_records(self.path)
            if self.recovery.torn_tail:
                # drop the torn tail NOW: appending after garbage would make
                # every later record unreadable to the next recovery
                self._f.truncate(self.recovery.valid_bytes)
                self._flush()
            self._offset = self.recovery.valid_bytes
            self.n_records = self.recovery.n_records

    # -- writing -----------------------------------------------------------
    def append(self, payload: bytes) -> None:
        """Durably append one record; returns only once the record is as
        durable as the fsync policy promises."""
        crash_point("wal.append")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        half = len(frame) // 2
        with self._lock:
            self._f.write(frame[:half])
            self._f.flush()
            # a kill here leaves half a frame on disk: the torn tail the
            # reader must drop without failing recovery
            crash_point("wal.torn")
            self._f.write(frame[half:])
            self._flush()
            self._offset += len(frame)
            self.n_records += 1
        crash_point("wal.post_append")

    def _flush(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def reset(self) -> None:
        """Truncate to an empty log (after a snapshot makes the records
        redundant: log compaction). Bumps ``resets`` so tail cursors know
        their offsets died with the old incarnation."""
        with self._lock:
            self._f.truncate(len(MAGIC))
            self._f.seek(len(MAGIC))
            self._flush()
            self._offset = len(MAGIC)
            self.n_records = 0
            self.resets += 1

    @property
    def offset(self) -> int:
        """Byte offset one past the last acknowledged record (where a fully
        caught-up tail cursor sits)."""
        return self._offset

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_wal_records(path) -> tuple[list[bytes], WalReadReport]:
    """Read every intact record; tolerate a torn tail.

    Damage that can only be the final, unacknowledged append (a frame
    running past EOF, or a CRC mismatch on the last bytes) stops the scan
    and is *reported* (``report.torn_tail``), never raised: dropping an
    operation nobody was told succeeded is correct recovery. A missing file
    reads as an empty log; a bad magic header raises ``ValueError`` (that
    is corruption of acknowledged state, not a tail).
    """
    report = WalReadReport()
    records: list[bytes] = []
    if not os.path.exists(path):
        return records, report
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(MAGIC):
        # even the header did not finish: an empty log mid-creation
        report.torn_tail = len(data) > 0
        report.torn_reason = "short header" if data else ""
        return records, report
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: bad WAL magic {data[:len(MAGIC)]!r} (expected {MAGIC!r})")
    _scan_frames(data, len(MAGIC), records, report)
    return records, report


def _scan_frames(data: bytes, pos: int, records: list, report: WalReadReport) -> None:
    """Walk frames from byte `pos`, filling `records` / `report`: the one
    tolerant scan both full replay and incremental tailing go through."""
    report.valid_bytes = pos
    while pos < len(data):
        if pos + _FRAME.size > len(data):
            report.torn_tail = True
            report.torn_reason = f"short frame header at byte {pos}"
            break
        length, crc = _FRAME.unpack_from(data, pos)
        start = pos + _FRAME.size
        if start + length > len(data):
            report.torn_tail = True
            report.torn_reason = f"short payload at byte {pos}"
            break
        payload = data[start:start + length]
        if zlib.crc32(payload) != crc:
            report.torn_tail = True
            report.torn_reason = f"crc mismatch at byte {pos}"
            break
        records.append(payload)
        pos = start + length
        report.n_records += 1
        report.valid_bytes = pos
    else:
        report.valid_bytes = pos
    if report.torn_tail:
        report.errors.append(report.torn_reason)


def tail_wal_records(path, from_offset: int) -> tuple[list[bytes], WalReadReport]:
    """Incremental tolerant read: intact records from byte `from_offset` on.

    The torn-tail rules are exactly :func:`read_wal_records`': a frame
    running past EOF or failing its CRC stops the scan and is reported, not
    raised, and ``report.valid_bytes`` is where the NEXT tail should start
    (so a cursor parked on a torn final record resumes cleanly once the
    append completes). Two more contracts for cursors:

    * ``report.truncated`` is set when the file is now shorter than
      `from_offset` (or gone while the cursor was mid-log): the log was
      compacted underneath the cursor, and the caller must reseed from a
      snapshot; rescanning from offset 0 would replay history the cursor
      already consumed onto state that already has it.
    * `from_offset` must be a frame boundary of the SAME log incarnation (a
      compaction followed by regrowth past the old offset is undetectable
      here: track :attr:`WriteAheadLog.resets` for that case).
    """
    report = WalReadReport()
    records: list[bytes] = []
    from_offset = max(int(from_offset), len(MAGIC))
    if not os.path.exists(path):
        report.truncated = from_offset > len(MAGIC)
        return records, report
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(MAGIC):
        report.truncated = from_offset > len(MAGIC)
        report.torn_tail = len(data) > 0
        report.torn_reason = "short header" if data else ""
        return records, report
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: bad WAL magic {data[:len(MAGIC)]!r} (expected {MAGIC!r})")
    if from_offset > len(data):
        report.truncated = True
        report.valid_bytes = from_offset  # nothing here continues the cursor
        return records, report
    _scan_frames(data, from_offset, records, report)
    return records, report


@dataclass
class WalCursor:
    """A resumable tail position over one WAL file.

    ``tail()`` drains every record appended since the last call and
    advances; on a torn tail it stops at the damage and resumes past it on
    a later call (once the append completes). On truncation the cursor does
    NOT advance: the report's ``truncated`` flag tells the owner to reseed
    from a snapshot and start a fresh cursor.
    """

    path: str
    offset: int = len(MAGIC)
    records: int = 0   # records consumed since the cursor was seeded

    def tail(self) -> tuple[list[bytes], WalReadReport]:
        recs, report = tail_wal_records(self.path, self.offset)
        if not report.truncated:
            self.offset = report.valid_bytes
            self.records += len(recs)
        return recs, report
