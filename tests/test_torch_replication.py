"""The port's read replica groups against the reference, on the CPU.

The reference's replication suite (``tests/test_replication.py``: parity
after a quiesce on both strategies, the reseed after a snapshot compacts
the log under lagging groups, seeding at ``open``, the lag gate, both
dispatch policies, group-private cache generations, a rebalance carried by
the WAL feed, ``replica_set`` and ``stats`` shapes, idempotent close, and
its churn run for a short budget) runs on the port by patching its
module's ``DurableShardedService`` with the port's, built with
``device="cpu"``. Its environment-knob tests are replaced here by tests
that the resolvers take arguments only. A differential run holds the
port's replica stats and dispatch against the reference's for the same
ops, and a group whose cursor skipped a record must answer differently
from the primary.
"""
import os

import numpy as np
import pytest

import repro.persist.service as R_svc
import repro_torch.persist.service as P_svc
import repro_torch.serve.replication as P_repl
from tests import test_replication as ref_repl
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_reference_knobs(monkeypatch):
    for k in [k for k in os.environ if k.startswith("ITR_")]:
        monkeypatch.delenv(k)


class _PortDurable:
    """The port's durable service under the reference suite's name, on the
    CPU."""

    @staticmethod
    def build(*args, **kwargs):
        return P_svc.DurableShardedService.build(*args, device="cpu", **kwargs)

    @staticmethod
    def open(*args, **kwargs):
        return P_svc.DurableShardedService.open(*args, device="cpu", **kwargs)


@pytest.fixture
def port_suite(monkeypatch):
    monkeypatch.setattr(ref_repl, "DurableShardedService", _PortDurable)


@pytest.mark.parametrize("case", [
    "test_replica_parity_after_quiesce[predicate_hash]",
    "test_replica_parity_after_quiesce[node_range]",
    "test_forced_lag_reseed_parity[predicate_hash]",
    "test_forced_lag_reseed_parity[node_range]",
    "test_open_seeds_replicas_from_disk",
    "test_lag_bound_gates_dispatch",
    "test_round_robin_rotates_groups",
    "test_least_loaded_avoids_busy_group",
    "test_replica_serves_its_own_generation",
    "test_rebalance_propagates_through_wal_feed",
    "test_replica_set_and_stats_shapes",
    "test_close_is_idempotent_across_hierarchy",
])
def test_the_reference_replication_suite_on_the_port(case, tmp_path, port_suite):
    name, _, param = case.partition("[")
    fn = getattr(ref_repl, name)
    if param:
        fn(tmp_path, param.rstrip("]"))
    else:
        fn(tmp_path)


def test_the_reference_churn_run_on_the_port(tmp_path, port_suite, monkeypatch):
    """The reference's churn oracle (a mutator, three dispatched readers,
    syncs and snapshots that force reseeds, then parity), for 2 s."""
    monkeypatch.setenv("ITR_CHURN_SECONDS", "2")
    ref_repl.test_replica_churn_under_concurrent_mutations(tmp_path)


def test_the_resolvers_take_arguments_only(monkeypatch):
    monkeypatch.setenv("ITR_REPLICAS", "2")
    monkeypatch.setenv("ITR_REPLICA_DISPATCH", "least_loaded")
    monkeypatch.setenv("ITR_REPLICA_MAX_LAG", "64")
    assert P_repl.resolve_replicas() == 0
    assert P_repl.resolve_replica_dispatch() == "round_robin"
    assert P_repl.resolve_replica_max_lag() == P_repl.DEFAULT_MAX_LAG == 1024
    for value, want in ((3, 3), (0, 0), (-2, 0), ("off", 0), ("banana", 0), ("2", 2)):
        assert P_repl.resolve_replicas(value) == want
    for value, want in (("least_loaded", "least_loaded"), ("ROUND_ROBIN", "round_robin"),
                        ("sideways", "round_robin")):
        assert P_repl.resolve_replica_dispatch(value) == want
    for value, want in ((0, 0), (7, 7), (-1, None), ("off", None), ("unbounded", None),
                        ("x", 1024)):
        assert P_repl.resolve_replica_max_lag(value) == want


def test_group_namespaces_follow_the_reference(tmp_path):
    """Group g takes _NS_BASE - g(P+1) for its merged results and the P
    namespaces below it for its shards."""
    svc, _, _ = _build_pair(tmp_path, "port", n_shards=3, replicas=2)
    try:
        for g in svc.replicas.groups:
            base = P_repl._NS_BASE - g.index * 4
            assert g.service._merged_ns == base
            assert g.service._cache_ns == [base - 1, base - 2, base - 3]
    finally:
        svc.close()


def _build_pair(tmp_path, which, **kwargs):
    rng = np.random.default_rng(5)
    base = np.unique(ref_repl._rand_rows(rng, 60), axis=0)
    oracle = {tuple(map(int, r)) for r in base}
    kw = dict(n_shards=3, strategy="predicate_hash", fsync=False, rebalance_skew=None,
              serve_threads=1, crossover=1)
    kw.update(kwargs)
    root = str(tmp_path / which)
    if which == "port":
        return P_svc.DurableShardedService.build(base, ref_repl.N_NODES, ref_repl.N_PREDS,
                                                 root=root, device="cpu", **kw), oracle, rng
    return R_svc.DurableShardedService.build(base, ref_repl.N_NODES, ref_repl.N_PREDS,
                                             root=root, **kw), oracle, rng


@pytest.mark.parametrize("dispatch", ["round_robin", "least_loaded"])
def test_the_same_ops_give_the_reference_replica_stats(tmp_path, dispatch):
    kw = dict(replicas=2, replica_dispatch=dispatch, replica_max_lag=2)
    ref, oracle, rng_r = _build_pair(tmp_path, "ref", **kw)
    port, _, rng_p = _build_pair(tmp_path, "port", **kw)
    try:
        for step in range(6):
            for svc, rng in ((ref, rng_r), (port, rng_p)):
                ref_repl._mutate(svc, set(oracle), rng, n_ins=3, n_del=1)
                for p in range(ref_repl.N_PREDS):
                    svc.query(None, p, None)
                if step == 3:
                    svc.snapshot()
                if step % 2:
                    svc.sync_replicas()
            assert port.replica_stats() == ref.replica_stats(), step
            assert port.service.stats.replica_flushes == ref.service.stats.replica_flushes
        assert port.service.stats.replica_flushes > 0
        assert [g.reseeds for g in port.replicas.groups] == \
            [g.reseeds for g in ref.replicas.groups]
    finally:
        ref.close()
        port.close()


def test_a_group_whose_cursor_skipped_a_record_answers_differently(tmp_path):
    """The control: one record skipped by a group's cursor leaves its
    answers unequal to the primary's (and the other group's equal)."""
    svc, oracle, rng = _build_pair(tmp_path, "port", replicas=2, replica_max_lag="off")
    try:
        mgr = svc.replicas
        skipped = np.array([[ref_repl.N_NODES - 1, 0, 0], [ref_repl.N_NODES - 1, 1, 0]])
        svc.insert_triples(skipped)
        oracle |= {tuple(map(int, r)) for r in skipped}
        bad = mgr.groups[1]
        recs, _ = bad.cursor.tail()  # consume the record without applying it
        assert len(recs) == 1
        svc.sync_replicas()
        probe = (ref_repl.N_NODES - 1, 0, 0)
        ref_repl._check_all_patterns(mgr.groups[0].service, oracle, probe, ctx="group 0")
        with pytest.raises(AssertionError):
            ref_repl._check_all_patterns(bad.service, oracle, probe, ctx="skipped")
        assert mgr.stats()["max_lag_records"] == 0  # the skip is invisible to lag
    finally:
        svc.close()


def test_a_group_holds_its_own_copy_of_every_array(tmp_path):
    """A deliberate divergence: the reference's groups share the snapshot's
    pages through mmap; the port's open every array into memory of their
    own (on the card, a second copy), so no group tensor aliases the
    primary's or the files: rewriting the snapshot leaves the group as it
    was."""
    import torch

    from repro_torch.persist.service import _newest_snapshot

    svc, oracle, rng = _build_pair(tmp_path, "port", replicas=1)
    try:
        group = svc.replicas.groups[0]
        for prim, eng in zip(svc.service.engines, group.service.engines):
            ours = {t.untyped_storage().data_ptr() for t in _arrays(prim)}
            for t in _arrays(eng):
                assert t.untyped_storage().data_ptr() not in ours
        _, snap = _newest_snapshot(svc.root)
        words = [f for f in os.listdir(os.path.join(snap, "shard_0")) if f.startswith("k2_level")]
        before = [t.clone() for t in _arrays(group.service.engines[0])]
        for f in words:  # zero the files the group was opened from
            path = os.path.join(snap, "shard_0", f)
            arr = np.load(path)
            np.save(path, np.zeros_like(arr))
        after = _arrays(group.service.engines[0])
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        probe = sorted(oracle)[0]
        ref_repl._check_all_patterns(group.service, oracle, probe, ctx="after the rewrite")
    finally:
        svc.close()


def _arrays(engine) -> list:
    enc = engine.encoded
    return [enc.fn_stream[0], enc.rule_stream[0], engine.flat.params,
            *(lv.words for lv in enc.incidence.levels)]
