"""The port's write-ahead log against the reference's, on the CPU.

The log is host code in both packages and must be the same bytes: the same
payloads appended (with resets and reopens between them) give the
reference's file byte for byte, and each package's readers read the other's
file, torn at every byte offset, with equal reports. The reference's own
``TestWal`` (``tests/test_persist.py``) and its WAL-tail cases
(``tests/test_replication.py``) run on the port by patching their module's
names with the port's. The fsync policy takes its argument only.
"""
import dataclasses

import pytest

import repro.persist.wal as R_wal
import repro_torch.persist.crash as P_crash
import repro_torch.persist.wal as P_wal
from tests import test_persist as ref_persist
from tests import test_replication as ref_repl
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PAYLOADS = [b"alpha", b"", b"x" * 1000, bytes(range(256)), b"\x01" + b"\xff" * 24,
            "terms é中".encode(), b"\x00" * 7]


def _write(mod, path, payloads, *, reset_after=None, reopen_after=None):
    wal = mod.WriteAheadLog(path, fsync=False)
    for i, p in enumerate(payloads):
        wal.append(p)
        if i == reset_after:
            wal.reset()
        if i == reopen_after:
            wal.close()
            wal = mod.WriteAheadLog(path, fsync=False)
    state = (wal.offset, wal.n_records, wal.resets)
    wal.close()
    return state


def _report(rep) -> dict:
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("reset_after, reopen_after", [(None, None), (2, None), (None, 3),
                                                       (1, 4)])
def test_the_same_payloads_give_the_reference_file(tmp_path, reset_after, reopen_after):
    ref_path, port_path = tmp_path / "ref.log", tmp_path / "port.log"
    want = _write(R_wal, ref_path, PAYLOADS, reset_after=reset_after, reopen_after=reopen_after)
    got = _write(P_wal, port_path, PAYLOADS, reset_after=reset_after, reopen_after=reopen_after)
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert got == want
    assert P_wal.MAGIC == R_wal.MAGIC
    assert [getattr(P_wal, op) for op in dir(R_wal) if op.startswith("OP_")] == \
        [getattr(R_wal, op) for op in dir(R_wal) if op.startswith("OP_")]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_reader_reads_the_other_file_torn_at_every_offset(tmp_path, writer):
    path = tmp_path / "wal.log"
    _write(R_wal if writer == "reference" else P_wal, path, PAYLOADS[:4])
    full = path.read_bytes()
    mid = len(R_wal.MAGIC) + 8 + len(PAYLOADS[0])  # a frame boundary
    for cut in range(len(full) + 1):
        path.write_bytes(full[:cut])
        for start in (0, len(R_wal.MAGIC), mid, len(full) + 4):
            want = R_wal.tail_wal_records(str(path), start)
            got = P_wal.tail_wal_records(str(path), start)
            assert got[0] == want[0] and _report(got[1]) == _report(want[1]), (cut, start)
        want = R_wal.read_wal_records(str(path))
        got = P_wal.read_wal_records(str(path))
        assert got[0] == want[0] and _report(got[1]) == _report(want[1]), cut
    # a CRC flip in the last payload: both readers drop that record alike
    bad = bytearray(full)
    bad[-1] ^= 0x5A
    path.write_bytes(bytes(bad))
    want, got = R_wal.read_wal_records(str(path)), P_wal.read_wal_records(str(path))
    assert got[0] == want[0] == PAYLOADS[:3] and _report(got[1]) == _report(want[1])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_reopening_the_other_torn_file_truncates_alike(tmp_path, writer):
    """Each package's WriteAheadLog opens a torn file the other wrote, cuts
    the tear and appends: the two results are the same bytes."""
    src = tmp_path / "src.log"
    _write(R_wal if writer == "reference" else P_wal, src, PAYLOADS[:3])
    torn = src.read_bytes()[:-2]
    out = {}
    for name, mod in (("reference", R_wal), ("port", P_wal)):
        path = tmp_path / f"{name}.log"
        path.write_bytes(torn)
        wal = mod.WriteAheadLog(path, fsync=False)
        out[name] = (_report(wal.recovery), wal.offset, wal.n_records)
        wal.append(b"after the tear")
        wal.close()
    assert out["port"] == out["reference"]
    assert (tmp_path / "port.log").read_bytes() == (tmp_path / "reference.log").read_bytes()


def test_cursors_agree_on_the_other_file(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = R_wal.WriteAheadLog(path, fsync=False)
    rc, pc = R_wal.WalCursor(path), P_wal.WalCursor(path)
    for i, p in enumerate(PAYLOADS):
        wal.append(p)
        if i % 2:
            a, b = rc.tail(), pc.tail()
            assert b[0] == a[0] and _report(b[1]) == _report(a[1])
            assert (pc.offset, pc.records) == (rc.offset, rc.records)
    wal.reset()
    a, b = rc.tail(), pc.tail()
    assert b[0] == a[0] == [] and a[1].truncated and _report(b[1]) == _report(a[1])
    wal.close()


def test_the_fsync_policy_takes_its_argument_only(monkeypatch):
    monkeypatch.setenv("ITR_WAL_FSYNC", "0")  # the reference's knob: the port reads none
    assert P_wal.resolve_wal_fsync() is True
    assert P_wal.resolve_wal_fsync(None) is True
    assert P_wal.resolve_wal_fsync(False) is False
    assert P_wal.resolve_wal_fsync(0) is False
    assert P_wal.resolve_wal_fsync(True) is True
    assert P_wal.WriteAheadLog.__init__.__defaults__ == (None,)


@pytest.fixture
def port_names(monkeypatch):
    """The reference suites' module names, pointed at the port's."""
    for mod in (ref_persist, ref_repl):
        for name in ("WriteAheadLog", "read_wal_records", "tail_wal_records", "WalCursor",
                     "MAGIC", "_FRAME"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, getattr(P_wal, name))
        for name in ("CrashPoint", "inject_crashes"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, getattr(P_crash, name))


@pytest.mark.parametrize("case", [
    "test_roundtrip",
    "test_append_survives_reopen",
    "test_reset_compacts",
    "test_missing_file_is_empty_log",
    "test_bad_magic_raises",
    "test_torn_tail_every_byte_offset",
    "test_corrupt_tail_crc_dropped",
    "test_reopen_truncates_torn_tail_before_appending",
    "test_torn_crash_point_leaves_recoverable_tail",
])
def test_the_reference_wal_suite_on_the_port(case, tmp_path, port_names):
    getattr(ref_persist.TestWal(), case)(tmp_path)


@pytest.mark.parametrize("case", [
    "test_tail_wal_records_incremental",
    "test_wal_cursor_resumes_across_appends",
    "test_tail_stops_cleanly_at_torn_final_record",
    "test_tail_across_reset_detects_truncation",
    "test_wal_bookkeeping_survives_reopen",
])
def test_the_reference_tail_cases_on_the_port(case, tmp_path, port_names):
    getattr(ref_repl, case)(tmp_path)


def test_the_crash_points_fire_in_the_port_injector(tmp_path):
    """wal.append, wal.torn and wal.post_append: the file after each kill
    holds nothing, a torn half, or the whole record."""
    path = tmp_path / "wal.log"
    wal = P_wal.WriteAheadLog(path, fsync=False)
    wal.append(b"kept")
    size = path.stat().st_size
    for point, grows in (("wal.append", False), ("wal.torn", True),
                         ("wal.post_append", True)):
        with pytest.raises(P_crash.CrashPoint), P_crash.inject_crashes({point: 1}):
            wal.append(b"the record in flight")
        records, report = P_wal.read_wal_records(path)
        assert (path.stat().st_size > size) == grows
        assert records[0] == b"kept"
        assert report.torn_tail == (point == "wal.torn")
        wal.close()
        wal = P_wal.WriteAheadLog(path, fsync=False)  # cuts a torn tail
        size = path.stat().st_size
    wal.close()
    assert P_wal.read_wal_records(path)[0] == [b"kept", b"the record in flight"]
