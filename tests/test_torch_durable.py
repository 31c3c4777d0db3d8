"""The port's durable sharded service against the reference, on the CPU.

A seeded op sequence (writes, deletes, node and predicate term mints, a
forced rebalance drained in bounded batches, explicit and budget-driven
rebuilds, snapshots) runs on a reference service and a port service built
from the same triples, at P = 1, 2 and 4 on both strategies: after every
step ``wal.log`` is the same bytes, every ``snap_NNNNNN/`` directory is the
same files byte for byte, and every return value agrees. Each package then
opens the other's directory (answers compared as lists, the recovery
reports field by field) and the two logs they append to stay equal.

The reference's own durability suites run on the port by patching their
module's ``DurableShardedService`` (and crash, snapshot and tier names)
with the port's, built with ``device="cpu"``: ``TestDurableService``
(``tests/test_persist.py``), the crash oracle's nine-point sweep and its
kill-anywhere state machine at the tier-1 budget
(``tests/test_crash_oracle.py``). ``save_snapshot(atomic=False)`` writes in
place.
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

import repro.core.term_dict as R_terms
import repro.persist.service as R_svc
import repro_torch.core.term_dict as P_terms
import repro_torch.distributed as P_dist
import repro_torch.distributed.partition as P_part
import repro_torch.persist.crash as P_crash
import repro_torch.persist.service as P_svc
import repro_torch.persist.snapshot as P_snap
import repro_torch.persist.wal as P_wal
import repro_torch.serve as P_serve
from tests import test_crash_oracle as ref_crash
from tests import test_persist as ref_persist
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERN_NAMES = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]
N_NODES, N_PREDS = 24, 4


@pytest.fixture(autouse=True)
def _no_reference_knobs(monkeypatch):
    """The reference reads no environment knob in these tests."""
    for k in [k for k in os.environ if k.startswith("ITR_")]:
        monkeypatch.delenv(k)


def _rows(rng, k, n_nodes=N_NODES, n_preds=N_PREDS):
    return np.stack([rng.integers(0, n_nodes, k), rng.integers(0, n_preds, k),
                     rng.integers(0, n_nodes, k)], axis=1)


def _bind(pattern, s, p, o):
    return (s if pattern[0] == "s" else None, p if pattern[1] == "p" else None,
            o if pattern[2] == "o" else None)


def _answers(svc, probe):
    return [sorted(svc.query(*_bind(pat, *probe))) for pat in PATTERN_NAMES]


def _tree_diff(a: str, b: str) -> list:
    """Files that differ (or exist on one side only) between two trees,
    compared byte for byte."""
    cmp = filecmp.dircmp(a, b)
    out = [os.path.join(a, f) for f in cmp.left_only + cmp.right_only]
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    out += [os.path.join(a, f) for f in mismatch + errors]
    for sub in cmp.common_dirs:
        out += _tree_diff(os.path.join(a, sub), os.path.join(b, sub))
    return out


def _same_dirs(ref_root: str, port_root: str) -> None:
    names = sorted(os.listdir(ref_root))
    assert sorted(os.listdir(port_root)) == names
    for name in names:
        a, b = os.path.join(ref_root, name), os.path.join(port_root, name)
        if os.path.isdir(a):
            assert _tree_diff(a, b) == [], name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def _report(rep) -> dict:
    d = dataclasses.asdict(rep)
    d["snapshot_dir"] = os.path.basename(d["snapshot_dir"])
    return d


def _ids(x) -> list:
    return [int(v) for v in (x.tolist() if hasattr(x, "tolist") else x)]


def _op_sequence(seed: int, strategy: str, n_shards: int, tmp_path):
    """Run one seeded op sequence on both packages, holding the directories
    equal after every step; returns (ref service, port service, live set)."""
    rng = np.random.default_rng(seed)
    base = np.unique(_rows(rng, 70), axis=0)
    live = {tuple(r) for r in base.tolist()}
    kw = dict(n_shards=n_shards, strategy=strategy, crossover=2, delta_budget=12,
              rebalance_skew=None, serve_threads=1, fsync=False)
    ref = R_svc.DurableShardedService.build(base, N_NODES, N_PREDS, root=str(tmp_path / "r"),
                                            **kw)
    port = P_svc.DurableShardedService.build(base, N_NODES, N_PREDS,
                                             root=str(tmp_path / "p"), device="cpu", **kw)
    ref.attach_term_dict(R_terms.TermDict.empty())
    port.attach_term_dict(P_terms.TermDict.empty())
    words = [f"<http://example.org/n/{i}>" for i in range(30)] + ["é\"x\"", "", "a b"]
    ops = ["insert", "delete", "insert", "nodes", "preds", "rebalance", "snapshot", "delete",
           "rebuild", "insert", "nodes", "rebalance", "snapshot", "query", "rebuild", "insert",
           "delete", "preds", "rebalance", "nodes", "query"]
    for step, op in enumerate(ops):
        if op == "insert":
            rows = _rows(rng, int(rng.integers(4, 16)))
            if step == 9:  # hot subjects: a node_range re-cut must move rows
                rows = np.array([[0, p, o] for p in range(N_PREDS) for o in range(6)])
            assert port.insert_triples(rows) == ref.insert_triples(rows)
            live |= {tuple(r) for r in rows.tolist()}
        elif op == "delete":
            pool = sorted(live)
            picks = [pool[int(i)] for i in rng.integers(0, len(pool), 6)]
            rows = np.asarray(picks + _rows(rng, 2).tolist(), dtype=np.int64)
            assert port.delete_triples(rows) == ref.delete_triples(rows)
            live -= {tuple(r) for r in rows.tolist()}
        elif op == "nodes":
            picks = [words[int(i)] for i in rng.integers(0, len(words), 9)]
            assert _ids(port.add_node_terms(picks)) == _ids(ref.add_node_terms(picks))
        elif op == "preds":
            picks = [f"<p{int(i)}>" for i in rng.integers(0, N_PREDS, 5)]
            assert _ids(port.add_pred_terms(picks)) == _ids(ref.add_pred_terms(picks))
        elif op == "rebalance":
            cap = int(rng.integers(2, 6))
            assert port.rebalance(force=True, max_moves=cap) == \
                ref.rebalance(force=True, max_moves=cap)
            assert port.migration_active == ref.migration_active
        elif op == "snapshot":
            assert os.path.basename(port.snapshot()) == os.path.basename(ref.snapshot())
        elif op == "rebuild":
            assert port.rebuild(force=True) == ref.rebuild(force=True)
        else:
            probe = sorted(live)[int(rng.integers(0, len(live)))]
            assert _answers(port, probe) == [_oracle(live, *_bind(p, *probe))
                                             for p in PATTERN_NAMES]
        _same_dirs(ref.root, port.root)
    assert port.stats.rebalances == ref.stats.rebalances
    assert port.stats.migrated_rows == ref.stats.migrated_rows
    assert port.stats.rebuilds == ref.stats.rebuilds
    return ref, port, live


def _oracle(live: set, s, p, o) -> list:
    return sorted((tp, (ts, to)) for ts, tp, to in live
                  if (s is None or ts == s) and (p is None or tp == p) and (o is None or to == o))


@pytest.mark.parametrize("strategy", ["predicate_hash", "node_range"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_the_same_ops_write_the_same_directory_and_cross_open(strategy, n_shards, tmp_path):
    ref, port, live = _op_sequence(100 * n_shards + len(strategy), strategy, n_shards,
                                   tmp_path)
    if strategy == "node_range" and n_shards > 1:
        assert ref.stats.rebalances and ref.stats.migrated_rows
    ref_root, port_root = ref.root, port.root
    ref.close()
    port.close()
    # each package opens the other's directory
    r_on_p = R_svc.DurableShardedService.open(port_root, fsync=False, rebalance_skew=None)
    p_on_r = P_svc.DurableShardedService.open(ref_root, fsync=False, rebalance_skew=None,
                                              device="cpu")
    want = _report(r_on_p.last_recovery)
    assert _report(p_on_r.last_recovery) == want
    assert want["replayed_records"] > 0 and want["failed_shards"] == []
    assert p_on_r.migration_active == r_on_p.migration_active
    rng = np.random.default_rng(n_shards)
    probes = [sorted(live)[int(i)] for i in rng.integers(0, len(live), 3)] + [(N_NODES + 1, 0, 0)]
    for probe in probes:
        assert _answers(p_on_r, probe) == _answers(r_on_p, probe)
        assert _answers(p_on_r, probe) == [_oracle(live, *_bind(p, *probe))
                                           for p in PATTERN_NAMES]
    td_p, td_r = p_on_r.term_dict, r_on_p.term_dict
    assert td_p.nodes.terms_in_id_order() == td_r.nodes.terms_in_id_order()
    assert td_p.preds.terms_in_id_order() == td_r.preds.terms_in_id_order()
    # both append the same records to the logs they opened, and drain alike
    rows = _rows(rng, 8)
    assert p_on_r.insert_triples(rows) == r_on_p.insert_triples(rows)
    assert p_on_r.rebalance() == r_on_p.rebalance()
    assert _ids(p_on_r.add_node_terms(["<fresh>", "<n/1>"])) == \
        _ids(r_on_p.add_node_terms(["<fresh>", "<n/1>"]))
    with open(os.path.join(ref_root, "wal.log"), "rb") as a, \
            open(os.path.join(port_root, "wal.log"), "rb") as b:
        assert a.read() == b.read()
    p_on_r.close()
    r_on_p.close()


def test_a_card_tensor_batch_logs_the_reference_record(tmp_path):
    """A batch given as a tensor (unsorted, with duplicates) is logged as the
    reference logs the same rows given as numpy: deduplicated, sorted,
    little-endian int64."""
    import torch

    rng = np.random.default_rng(3)
    base = np.unique(_rows(rng, 40), axis=0)
    kw = dict(n_shards=2, crossover=1, rebalance_skew=None, serve_threads=1, fsync=False)
    ref = R_svc.DurableShardedService.build(base, N_NODES, N_PREDS, root=str(tmp_path / "r"),
                                            **kw)
    port = P_svc.DurableShardedService.build(base, N_NODES, N_PREDS,
                                             root=str(tmp_path / "p"), device="cpu", **kw)
    rows = _rows(rng, 12)
    rows = np.concatenate([rows, rows[:4]])[::-1].copy()
    assert port.insert_triples(torch.from_numpy(rows)) == ref.insert_triples(rows)
    assert port.delete_triples(torch.from_numpy(rows[:5])) == ref.delete_triples(rows[:5])
    records, _ = P_wal.read_wal_records(os.path.join(port.root, "wal.log"))
    assert records[0] == P_svc._pack_rows(P_wal.OP_INSERT, np.unique(rows, axis=0))
    _same_dirs(ref.root, port.root)
    ref.close()
    port.close()


def test_save_snapshot_in_place_writes_no_tmp(tmp_path):
    import repro_torch.core as P

    rows = np.unique(_rows(np.random.default_rng(4), 60), axis=0)
    graph = P.Hypergraph.from_triples(rows, N_NODES, device="cpu")
    grammar, _ = P.compress(graph, P.LabelTable.terminals([2] * N_PREDS, device="cpu"))
    engine = P.TripleQueryEngine(grammar, crossover=1)
    engine.insert_triples(np.array([[1, 2, 3]]))
    atomic, in_place = str(tmp_path / "atomic"), str(tmp_path / "in_place")
    P_snap.save_snapshot(engine, atomic)
    with P_crash.inject_crashes({}) as injector:
        assert P_snap.save_snapshot(engine, in_place, atomic=False) == in_place
    assert "snapshot.pre_commit" not in injector.hits  # no rename step
    assert injector.hits["snapshot.write_arrays"] == len(os.listdir(in_place)) - 1
    assert not os.path.exists(in_place + ".tmp")
    assert _tree_diff(atomic, in_place) == []
    # in place over an existing directory: it is rewritten file by file
    engine.insert_triples(np.array([[4, 1, 5]]))
    P_snap.save_snapshot(engine, in_place, atomic=False)
    assert P_snap.load_snapshot(in_place, device="cpu").contains_triples(
        np.array([[4, 1, 5]])).tolist() == [True]


def test_the_snapshot_root_takes_its_argument_only(tmp_path, monkeypatch):
    monkeypatch.setenv("ITR_SNAPSHOT_DIR", str(tmp_path / "via-env"))
    with pytest.raises(ValueError, match="no snapshot root") as exc:
        P_svc.resolve_snapshot_dir(None)
    assert "ITR_" not in str(exc.value)
    assert P_svc.resolve_snapshot_dir(tmp_path / "arg") == str(tmp_path / "arg")
    with pytest.raises(ValueError):
        P_svc.DurableShardedService.build(np.zeros((0, 3), np.int64), 2, 1, device="cpu")
    with pytest.raises(ValueError):
        P_svc.DurableShardedService.open(device="cpu")


# -- the reference's suites on the port ----------------------------------------

class _PortDurable:
    """The port's durable service under the reference suites' name, on the
    CPU."""

    @staticmethod
    def build(*args, **kwargs):
        return P_svc.DurableShardedService.build(*args, device="cpu", **kwargs)

    @staticmethod
    def open(*args, **kwargs):
        return P_svc.DurableShardedService.open(*args, device="cpu", **kwargs)


class _PortTier:
    @staticmethod
    def build(*args, **kwargs):
        return P_serve.ShardedTripleService.build(*args, device="cpu", **kwargs)


@pytest.fixture
def port_suites(monkeypatch):
    for mod in (ref_persist, ref_crash):
        monkeypatch.setattr(mod, "DurableShardedService", _PortDurable)
        monkeypatch.setattr(mod, "CrashPoint", P_crash.CrashPoint)
        monkeypatch.setattr(mod, "inject_crashes", P_crash.inject_crashes)
    monkeypatch.setattr(ref_persist, "ShardedTripleService", _PortTier)
    monkeypatch.setattr(ref_persist, "plan_rebalance", P_dist.plan_rebalance)
    monkeypatch.setattr(ref_persist, "read_wal_records", P_wal.read_wal_records)
    monkeypatch.setattr(ref_persist, "SnapshotError", P_snap.SnapshotError)
    monkeypatch.setattr(ref_persist, "RecoveryReport", P_svc.RecoveryReport)


@pytest.mark.parametrize("case", [
    "test_recover_replays_mutations",
    "test_snapshot_compacts_wal_and_gc",
    "test_crash_between_commit_and_truncate_is_idempotent",
    "test_mid_migration_snapshot_resumes",
    "test_migration_batch_replay_is_idempotent",
    "test_degraded_shard_serves_and_reingests",
    "test_open_without_snapshot_raises",
])
def test_the_reference_durable_service_suite_on_the_port(case, tmp_path, port_suites):
    getattr(ref_persist.TestDurableService(), case)(tmp_path)


@pytest.mark.parametrize("point", ref_crash.CRASH_POINTS)
def test_the_reference_crash_sweep_on_the_port(point, tmp_path, port_suites):
    ref_crash.test_every_injection_point_recovers(point, tmp_path)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_reference_crash_state_machine_on_the_port(seed, port_suites):
    """The kill-anywhere machine at the tier-1 budget: two examples, each on
    both strategies at P = 1, 2, 4."""
    rng = np.random.default_rng(10_000 + seed)
    for strategy in P_part.STRATEGIES:
        for n_shards in (1, 2, 4):
            ref_crash._run_crash_machine(int(rng.integers(0, 2**31)), strategy, n_shards)


def test_a_real_kill_of_the_durable_writer(tmp_path):
    """``python -m repro_torch.launch.itr_durable`` on the CPU, killed with
    SIGKILL once it has acknowledged a few batches: every acknowledged batch
    is recovered, the one in flight wholly or not at all, none after it."""
    import signal
    import subprocess
    import sys

    rng = np.random.default_rng(9)
    base = np.unique(_rows(rng, 60), axis=0)
    root = str(tmp_path / "svc")
    P_svc.DurableShardedService.build(base, N_NODES, N_PREDS, root=root, n_shards=2,
                                      crossover=1, rebalance_skew=None, device="cpu").close()
    n, m = 40, 6
    taken = {tuple(r) for r in base.tolist()}
    fresh = []
    while len(fresh) < n * m:
        row = (int(rng.integers(N_NODES, 4 * N_NODES)), int(rng.integers(0, N_PREDS)),
               int(rng.integers(0, N_NODES)))
        if row not in taken:
            taken.add(row)
            fresh.append(row)
    rows = np.array(fresh, dtype=np.int64).reshape(n, m, 3)
    kinds = np.zeros(n, dtype=np.int64)
    kinds[1::2] = 1
    rows[1::2] = rows[0::2]  # each odd batch deletes what the batch before it inserted
    np.savez(tmp_path / "batches.npz", rows=rows, kinds=kinds)
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src"),
           "OMP_NUM_THREADS": "1"}
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.itr_durable", "--root", root,
         "--batches", str(tmp_path / "batches.npz"), "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, env=env)
    acked = -1
    try:
        for line in child.stdout:
            if line.startswith("acked"):
                acked = int(line.split()[1])
                if acked >= 4:
                    child.send_signal(signal.SIGKILL)
                    break
    finally:
        child.kill()
        rest = child.stdout.read()
        child.wait(60)
    acked = max([acked] + [int(w.split()[1]) for w in rest.splitlines() if w.startswith("acked")])
    assert 4 <= acked < n - 1, acked
    svc = P_svc.DurableShardedService.open(root, rebalance_skew=None, device="cpu")
    try:
        live = {tuple(r) for r in base.tolist()}
        for i in range(acked + 1):  # every acknowledged batch, applied
            batch = {tuple(r) for r in rows[i].tolist()}
            live = live | batch if kinds[i] == 0 else live - batch
        flight = acked + 1
        got = svc.contains_triples(rows[flight]).tolist()
        assert len(set(got)) == 1, got  # the batch in flight: all or nothing
        if got[0] == (kinds[flight] == 0):  # it landed
            batch = {tuple(r) for r in rows[flight].tolist()}
            live = live | batch if kinds[flight] == 0 else live - batch
        everything = sorted(svc.query(None, None, None))
        assert everything == _oracle(live, None, None, None)
    finally:
        svc.close()
