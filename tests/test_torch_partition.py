"""The port's partition plans and rebalancing helpers
(``repro_torch.distributed``) against the reference, on the CPU.

Plans, routing and placement equal the reference's on seeded triples for
both strategies (``plan_to_dict``, ``triple_shards``, ``route_batch``,
``route_triples``, ``partition_triples``, ``pred_assignment``), including
predicate ids at and above 2**31, subjects past the last boundary, empty
batches of any shape and more shards than nodes. The trigger and fan-out
knobs take arguments only. ``measure_skew``, ``balance_predicates``,
``RebalancePlan.take`` / ``discard``, ``plan_rebalance`` and
``migration_moves`` (on engines built from the same triples) equal the
reference's.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as R
import repro.distributed.partition as R_part
import repro.distributed.rebalance as R_reb
import repro.serve.concurrency as R_conc
import repro_torch.core as P
import repro_torch.distributed as P_dist
import repro_torch.distributed.partition as P_part
import repro_torch.distributed.rebalance as P_reb
import repro_torch.serve.concurrency as P_conc
from tests.test_torch_build import port_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_NODES, N_PREDS = 24, 5


@pytest.fixture(autouse=True)
def _no_reference_knobs(monkeypatch):
    """The reference reads no environment knob in these tests."""
    for k in [k for k in os.environ if k.startswith("ITR_")]:
        monkeypatch.delenv(k)


def _triples(seed, n_edges=90, n_nodes=N_NODES, n_preds=N_PREDS):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.integers(0, n_nodes, n_edges),
                  rng.integers(0, n_preds, n_edges),
                  rng.integers(0, n_nodes, n_edges)], axis=1)
    return np.unique(t, axis=0)


def _plans(strategy, n_shards, n_nodes, n_preds, triples):
    return (R_part.make_plan(strategy, n_shards, n_nodes, n_preds, triples=triples),
            P_part.make_plan(strategy, n_shards, n_nodes, n_preds, triples=triples))


@pytest.mark.parametrize("strategy", P_part.STRATEGIES)
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_plans_route_and_place_as_the_reference(strategy, n_shards, seed):
    t = _triples(seed)
    ref, port = _plans(strategy, n_shards, N_NODES, N_PREDS, t)
    assert P_part.plan_to_dict(port) == R_part.plan_to_dict(ref)
    assert np.array_equal(port.triple_shards(t), ref.triple_shards(t))
    assert np.array_equal(port.route_triples(t), ref.route_triples(t))
    rng = np.random.default_rng(seed + 10)
    cols = [np.where(rng.random(64) < 0.4, -1, rng.integers(0, hi, 64))
            for hi in (N_NODES + 6, N_PREDS, N_NODES + 6)]
    assert np.array_equal(port.route_batch(*cols), ref.route_batch(*cols))
    for s, p, o in zip(*(c[:16].tolist() for c in cols)):
        assert port.route(s, p, o) == ref.route(s, p, o)
    for a, b in zip(P_part.partition_triples(t, port), R_part.partition_triples(t, ref)):
        assert np.array_equal(a, b)
    if strategy == "predicate_hash":
        assert np.array_equal(port.pred_assignment(), ref.pred_assignment())
    # the plan survives its wire form, on both sides
    back = P_part.plan_from_dict(R_part.plan_to_dict(ref))
    assert P_part.plans_equal(back, port) and R_part.plans_equal(R_part.plan_from_dict(
        P_part.plan_to_dict(port)), ref)


@pytest.mark.parametrize("pred_assign", [None, [2, 0, 1, 1, 0]])
def test_predicate_ids_at_and_above_two_to_the_31(pred_assign):
    kw = {} if pred_assign is None else {"pred_assign": np.array(pred_assign)}
    ref = R_part.PartitionPlan("predicate_hash", 3, N_NODES, N_PREDS, **kw)
    port = P_part.PartitionPlan("predicate_hash", 3, N_NODES, N_PREDS, **kw)
    preds = np.array([2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1, 2**32, 2**40 + 3, 0, 4],
                     dtype=np.int64)
    rows = np.stack([np.arange(len(preds)), preds, np.arange(len(preds))], 1)
    assert np.array_equal(port.triple_shards(rows), ref.triple_shards(rows))
    assert np.array_equal(port.route_triples(rows), ref.route_triples(rows))
    minus = np.full(len(preds), -1)
    assert np.array_equal(port.route_batch(minus, preds, minus),
                          ref.route_batch(minus, preds, minus))


def test_subjects_past_the_last_boundary_and_more_shards_than_nodes():
    t = _triples(4, n_nodes=6)
    for n_shards, n_nodes in ((3, 6), (9, 6), (5, 2)):
        ref, port = _plans("node_range", n_shards, n_nodes, N_PREDS, t)
        assert P_part.plan_to_dict(port) == R_part.plan_to_dict(ref)
        far = np.array([[0, 0, 0], [5, 1, 2], [6, 0, 1], [7, 2, 2], [10**9, 1, 0],
                        [2**40, 3, 1]])
        assert np.array_equal(port.route_triples(far), ref.route_triples(far))
        s = far[:, 0]
        assert np.array_equal(port.route_batch(s, -np.ones_like(s), -np.ones_like(s)),
                              ref.route_batch(s, -np.ones_like(s), -np.ones_like(s)))
    # even cuts without triples
    ref, port = _plans("node_range", 4, 10, 2, None)
    assert P_part.plan_to_dict(port) == R_part.plan_to_dict(ref)


@pytest.mark.parametrize("empty", [[], np.zeros((0, 3)), np.zeros((0,)), np.zeros((0, 5)),
                                   np.zeros((3, 0))], ids=["list", "0x3", "0", "0x5", "3x0"])
def test_zero_row_batches_of_any_shape(empty):
    for strategy in P_part.STRATEGIES:
        ref, port = _plans(strategy, 3, N_NODES, N_PREDS, _triples(2))
        got, want = port.route_triples(empty), ref.route_triples(empty)
        assert got.dtype == want.dtype and got.shape == want.shape == (0,)
    assert P_part.diff_plans(port, port, np.zeros((0, 3))).shape == (0,)
    z = np.zeros(0, dtype=np.int64)
    assert port.route_batch(z, z, z).shape == ref.route_batch(z, z, z).shape == (0,)
    assert [len(x) for x in P_part.partition_triples(np.zeros((0, 3)), port)] == [0, 0, 0]


def test_plans_refuse_what_the_reference_refuses():
    bad = [("nope", 2, None, None), ("node_range", 0, None, None),
           ("node_range", 3, np.array([0, 5]), None),
           ("node_range", 2, np.array([0, 9, 3]), None),
           ("node_range", 2, np.array([0, 3, 9]), np.array([0, 1, 0, 1, 1])),
           ("predicate_hash", 2, None, np.array([0, 1])),
           ("predicate_hash", 2, None, np.array([0, 1, 2, 0, 1]))]
    for strategy, n, b, pa in bad:
        with pytest.raises(ValueError) as want:
            R_part.PartitionPlan(strategy, n, 9, N_PREDS, boundaries=b, pred_assign=pa)
        with pytest.raises(ValueError) as got:
            P_part.PartitionPlan(strategy, n, 9, N_PREDS, boundaries=b, pred_assign=pa)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n, 3"):
        P_part.make_plan("node_range", 2, 9, 2).route_triples(np.zeros((2, 2)))


@pytest.mark.parametrize("seed", range(4))
def test_quantile_boundaries_and_diff_plans(seed):
    rng = np.random.default_rng(seed)
    subjects = rng.integers(0, 50, int(rng.integers(0, 40)))
    for n_shards in (1, 2, 5):
        assert np.array_equal(P_part.subject_quantile_boundaries(subjects, n_shards, 60),
                              R_part.subject_quantile_boundaries(subjects, n_shards, 60))
    t = _triples(seed)
    a = P_part.make_plan("node_range", 3, N_NODES, N_PREDS, triples=t)
    b = P_part.make_plan("node_range", 3, N_NODES, N_PREDS)
    ra = R_part.make_plan("node_range", 3, N_NODES, N_PREDS, triples=t)
    rb = R_part.make_plan("node_range", 3, N_NODES, N_PREDS)
    assert np.array_equal(P_part.diff_plans(a, b, t), R_part.diff_plans(ra, rb, t))


# -- the knobs take arguments only ----------------------------------------------
@pytest.mark.parametrize("value", [None, 0, -2, 0.5, 1, 1.5, 4, "2.5", "-1"])
def test_resolve_rebalance_skew_takes_arguments_only(value, monkeypatch):
    # the reference's trigger knob, set to something the port must not read
    monkeypatch.setenv("ITR_REBALANCE_SKEW", "off")
    got = P_reb.resolve_rebalance_skew(value)
    if value is None:
        assert got == P_reb.DEFAULT_REBALANCE_SKEW == R_reb.DEFAULT_REBALANCE_SKEW == 4.0
        assert R_reb.resolve_rebalance_skew() is None  # the reference reads it
    else:
        assert got == R_reb.resolve_rebalance_skew(value)


@pytest.mark.parametrize("value", [None, 4, 1, 0, -3, "off", "OFF", "none", "never", "", " 3 ",
                                   "nonsense"])
def test_resolve_serve_threads_takes_arguments_only(value, monkeypatch):
    monkeypatch.setenv("ITR_SERVE_THREADS", "2")
    got = P_conc.resolve_serve_threads(value)
    if value is None or value == "":
        assert got == (os.cpu_count() or 1)
    else:
        assert got == R_conc.resolve_serve_threads(value)


# -- skew, LPT and the migration bookkeeping --------------------------------------
def test_measure_skew_and_balance_predicates():
    for counts in ([], [5], [0, 0, 0], [3, 3, 3], [9, 1, 2], [0, 12, 0, 0]):
        assert P_reb.measure_skew(counts) == R_reb.measure_skew(counts)
    rng = np.random.default_rng(7)
    for _ in range(40):
        n_preds, n_shards = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        counts = rng.integers(0, 30, n_preds) * (rng.random(n_preds) < 0.8)
        prior = rng.integers(0, n_shards, n_preds)
        assert np.array_equal(P_reb.balance_predicates(counts, n_shards, prior),
                              R_reb.balance_predicates(counts, n_shards, prior))
    with pytest.raises(ValueError, match="prior assignment shape"):
        P_reb.balance_predicates([1, 2], 2, [0])


def _moves(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 3)), int(rng.integers(0, 3)),
             np.unique(rng.integers(0, 6, (int(rng.integers(0, 9)), 3)), axis=0))
            for _ in range(5)]


def _same_moves(port_moves, ref_moves):
    assert [(s, d) for s, d, _ in port_moves] == [(s, d) for s, d, _ in ref_moves]
    for (_, _, a), (_, _, b) in zip(port_moves, ref_moves):
        assert isinstance(a, torch.Tensor)
        assert np.array_equal(a.cpu().numpy().reshape(-1, 3), np.asarray(b).reshape(-1, 3))


@pytest.mark.parametrize("seed", range(5))
def test_rebalance_plan_take_and_discard(seed):
    plan = R_part.make_plan("node_range", 3, 6, 6)
    port_plan = P_part.make_plan("node_range", 3, 6, 6)
    moves = _moves(seed)
    ref = R_reb.RebalancePlan(plan, plan, moves)
    port = P_reb.RebalancePlan(port_plan, port_plan, moves)
    assert port.total_rows == ref.total_rows
    rng = np.random.default_rng(seed + 100)
    while not ref.done:
        assert port.pending_rows == ref.pending_rows and not port.done
        _same_moves(port.pending_moves(), ref.pending_moves())
        if rng.random() < 0.4:
            gone = rng.integers(0, 6, (int(rng.integers(0, 6)), 3))
            assert port.discard(gone) == ref.discard(gone)
        else:
            cap = None if rng.random() < 0.1 else int(rng.integers(0, 7))
            _same_moves(port.take(cap), ref.take(cap))
    assert port.done and port.pending_rows == 0
    assert port.discard(np.zeros((0, 3))) == 0 and port.take() == []


def _engines(t, plan, n_nodes=N_NODES, n_preds=N_PREDS):
    """Reference and port engines over each shard of `plan`, built from the
    same rows, with the same overlay mutations applied."""
    ref, port = [], []
    for sub in R_part.partition_triples(t, plan):
        g = R.Hypergraph.from_triples(sub, n_nodes)
        table = R.LabelTable.terminals([2] * n_preds)
        ref.append(R.TripleQueryEngine(R.compress(g, table)[0], cache=None, crossover=0,
                                       delta_budget=None))
        port.append(P.TripleQueryEngine(P.compress(*port_hypergraph(g, table))[0], cache=None,
                                        crossover=0, delta_budget=None))
    return ref, port


@pytest.mark.parametrize("strategy", P_part.STRATEGIES)
@pytest.mark.parametrize("seed", [0, 3])
def test_plan_rebalance_and_migration_moves(strategy, seed):
    t = _triples(seed)
    ref_plan, port_plan = _plans(strategy, 3, N_NODES, N_PREDS, t)
    ref_e, port_e = _engines(t, ref_plan)
    # skew one shard: inserts past the node universe on a hot subject range
    rng = np.random.default_rng(seed)
    hot = np.stack([rng.integers(N_NODES, N_NODES + 8, 40), np.zeros(40, np.int64),
                    rng.integers(0, N_NODES, 40)], 1)
    k = int(ref_plan.route_triples(hot[:1])[0])
    ref_e[k].insert_triples(hot)
    port_e[k].insert_triples(hot)
    ref_e[0].delete_triples(t[:5])
    port_e[0].delete_triples(t[:5])
    assert np.array_equal(P_reb.live_shard_edges(port_e), R_reb.live_shard_edges(ref_e))
    ref = R_reb.plan_rebalance(ref_plan, ref_e)
    port = P_reb.plan_rebalance(port_plan, port_e)
    assert P_part.plan_to_dict(port.new_plan) == R_part.plan_to_dict(ref.new_plan)
    assert port.total_rows == ref.total_rows > 0
    _same_moves(port.pending_moves(), ref.pending_moves())
    _same_moves(P_reb.migration_moves(port.new_plan, port_e),
                R_reb.migration_moves(ref.new_plan, ref_e))
    assert P_dist.plan_rebalance is P_reb.plan_rebalance


def test_plan_rebalance_raises_on_engines_without_a_grammar(tmp_path):
    """Engines made by from_numpy_state cannot list their triples, so a
    re-cut over them raises (as their current_triples does)."""
    from tests.test_torch_query import _load_reference_state

    t = _triples(5)
    plan = P_part.make_plan("node_range", 2, N_NODES, N_PREDS, triples=t)
    engines = []
    for k, sub in enumerate(R_part.partition_triples(t, plan)):
        g = R.Hypergraph.from_triples(sub, N_NODES)
        eng = R.TripleQueryEngine(R.compress(g, R.LabelTable.terminals([2] * N_PREDS))[0],
                                  cache=None, crossover=0, delta_budget=None)
        (tmp_path / str(k)).mkdir()
        arrays, meta = _load_reference_state(eng, tmp_path / str(k))
        engines.append(P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu",
                                                            cache=None))
    with pytest.raises(NotImplementedError, match="from_numpy_state"):
        P_reb.plan_rebalance(plan, engines)
    with pytest.raises(NotImplementedError, match="from_numpy_state"):
        P_reb.migration_moves(plan, engines)
