"""The port's online rebalancing through the sharded tier, against the
reference, on the CPU.

A seeded differential state machine drives a reference tier and a port tier
built from the same triples through the same random interleaving of inserts
(ids past the node universe included), deletes, ``rebuild`` (one shard, all
over budget, forced), partial and full ``rebalance``, the mutation path's
auto trigger and query batches, and compares after
every step: answers (as lists), applied counts, the plan dicts, the
migration state and its pending rows, ``live_edges``, ``skew``,
``delta_sizes`` and every stats and cache counter. The reference's own
set-oracle machine (``tests/test_rebalance_oracle.py``) and its service
scenarios (``tests/test_rebalance.py``) also run on the port's tier.
"""
import os

import numpy as np
import pytest

import repro.core as R
import repro.distributed.partition as R_part
import repro.serve as R_serve
import repro_torch.core as P
import repro_torch.distributed as P_dist
import repro_torch.distributed.partition as P_part
import repro_torch.serve as P_serve
from tests import test_rebalance as ref_rebalance
from tests import test_rebalance_oracle as ref_oracle
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERN_NAMES = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]
TIME_FIELDS = ("total_s", "last_flush_qps")


@pytest.fixture(autouse=True)
def _no_reference_knobs(monkeypatch):
    """The reference reads no environment knob in these tests."""
    for k in [k for k in os.environ if k.startswith("ITR_")]:
        monkeypatch.delenv(k)


class _PortTier:
    """The port's tier under the reference suites' name, built on the CPU."""

    @staticmethod
    def build(*args, **kwargs):
        return P_serve.ShardedTripleService.build(*args, device="cpu", **kwargs)


def _rows(rng, k, n_nodes, n_preds, lo=0):
    return np.stack([rng.integers(lo, n_nodes, k), rng.integers(0, n_preds, k),
                     rng.integers(0, n_nodes, k)], axis=1)


def _bind(pattern, s, p, o):
    return (s if pattern[0] == "s" else None,
            p if pattern[1] == "p" else None,
            o if pattern[2] == "o" else None)


def _same_state(ref, port):
    assert P_part.plan_to_dict(port.plan) == R_part.plan_to_dict(ref.plan)
    assert port.migration_active == ref.migration_active
    if ref.migration_active:
        assert port._migration.pending_rows == ref._migration.pending_rows
        assert P_part.plan_to_dict(port._migration.new_plan) == \
            R_part.plan_to_dict(ref._migration.new_plan)
        for (ps, pd, pr), (rs, rd, rr) in zip(port._migration.pending_moves(),
                                              ref._migration.pending_moves()):
            assert (ps, pd) == (rs, rd) and np.array_equal(pr.numpy(), rr)
    assert port.live_edges() == ref.live_edges()
    assert port.skew() == ref.skew()
    assert port.delta_sizes() == ref.delta_sizes()
    assert port._futile_total == ref._futile_total
    assert {k: v for k, v in vars(port.stats).items() if k not in TIME_FIELDS} == \
        {k: v for k, v in vars(ref.stats).items() if k not in TIME_FIELDS}
    assert vars(port.cache.stats) == vars(ref.cache.stats)


def _machine(seed: int, strategy: str, n_shards: int, *, n_ops: int, auto: bool):
    rng = np.random.default_rng(seed)
    n_nodes, n_preds = int(rng.integers(8, 24)), int(rng.integers(1, 5))
    base = np.unique(_rows(rng, int(rng.integers(10, 70)), n_nodes, n_preds), axis=0)
    budget = None if rng.integers(0, 2) else int(rng.integers(3, 12))
    kw = dict(n_shards=n_shards, strategy=strategy, crossover=int(rng.integers(0, 3)),
              delta_budget=budget, rebalance_skew=float(rng.choice([1.0, 1.3])) if auto
              else None, serve_threads=1)
    ref = R_serve.ShardedTripleService.build(base, n_nodes, n_preds,
                                             cache=R.QueryResultCache(max_entries=40), **kw)
    port = P_serve.ShardedTripleService.build(base, n_nodes, n_preds, device="cpu",
                                              cache=P.QueryResultCache(max_entries=40), **kw)
    live = [tuple(r) for r in base.tolist()]
    for _ in range(n_ops):
        op = int(rng.integers(0, 100))
        if op < 25:  # inserts, some past the node universe (they clip onto a shard)
            rows = _rows(rng, int(rng.integers(1, 9)), n_nodes + 6 * int(rng.integers(0, 2)),
                         n_preds)
            assert port.insert_triples(rows) == ref.insert_triples(rows)
            live = sorted(set(live) | {tuple(r) for r in rows.tolist()})
        elif op < 45:  # deletes: live rows and absent ones
            k = int(rng.integers(1, 7))
            picks = [live[int(i)] for i in rng.integers(0, len(live), k)] if live else []
            rows = np.asarray(picks + _rows(rng, 2, n_nodes, n_preds).tolist(), dtype=np.int64)
            assert port.delete_triples(rows) == ref.delete_triples(rows)
            live = sorted(set(live) - {tuple(r) for r in rows.tolist()})
        elif op < 65:  # a query batch over all eight patterns
            probe = live[int(rng.integers(0, len(live)))] if live else (0, 0, 0)
            pats = [_bind(pat, *probe) for pat in PATTERN_NAMES] + [(n_nodes + 3, None, None)]
            assert port.query_many(pats) == ref.query_many(pats)
        elif op < 85:  # rebalance: explicit, partial or to the end, forced or not
            force = bool(rng.integers(0, 4))
            cap = None if rng.integers(0, 3) == 0 else int(rng.integers(1, 10))
            assert port.rebalance(force=force, max_moves=cap) == \
                ref.rebalance(force=force, max_moves=cap)
        else:
            which = [None, int(rng.integers(0, n_shards))][int(rng.integers(0, 2))]
            force = bool(rng.integers(0, 2))
            assert port.rebuild(shard=which, force=force) == ref.rebuild(shard=which,
                                                                         force=force)
        _same_state(ref, port)
    if port.migration_active:
        assert port.rebalance() == ref.rebalance()
    _same_state(ref, port)
    for k, eng in enumerate(port.engines):
        rows = eng.current_triples().numpy()
        assert {tuple(r) for r in rows.tolist()} == \
            {tuple(r) for r in ref.engines[k].current_triples().tolist()}
        if len(rows):
            assert (port.plan.triple_shards(rows) == k).all()
    assert sum(port.live_edges()) == len(live)
    # membership (one flush: a recorded divergence in its counters, so last)
    probe = np.concatenate([np.asarray(live[:5], dtype=np.int64).reshape(-1, 3),
                            _rows(rng, 5, n_nodes, n_preds)])
    assert port.contains_triples(probe).tolist() == [tuple(r) in set(live)
                                                     for r in probe.tolist()]


@pytest.mark.parametrize("strategy", P_part.STRATEGIES)
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_machine(seed, strategy, n_shards):
    _machine(1000 * seed + 10 * n_shards + len(strategy), strategy, n_shards, n_ops=16,
             auto=False)


@pytest.mark.parametrize("strategy", P_part.STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_differential_machine_with_the_auto_trigger(seed, strategy):
    _machine(77 + seed, strategy, 3, n_ops=14, auto=True)


def test_the_auto_trigger_drains_in_bounded_chunks_and_backs_off(monkeypatch):
    """A growing graph on node_range trips the trigger and the migration
    drains a bounded chunk a write; on predicate_hash with as many shards as
    predicates the re-cut moves nothing and the backoff holds."""
    import repro.serve.sharded as R_sh
    import repro_torch.serve.sharded as P_sh

    monkeypatch.setattr(R_sh, "_AUTO_MOVES_PER_CALL", 7)
    monkeypatch.setattr(P_sh, "_AUTO_MOVES_PER_CALL", 7)
    rng = np.random.default_rng(5)
    base = np.unique(_rows(rng, 80, 20, 4), axis=0)
    base[:60, 1] = 0  # one heavy predicate: each of the 4 hashes to a shard of its own
    base = np.unique(base, axis=0)
    for strategy in P_part.STRATEGIES:
        kw = dict(n_shards=4, strategy=strategy, crossover=0, delta_budget=None,
                  rebalance_skew=1.5, serve_threads=1)
        ref = R_serve.ShardedTripleService.build(base, 20, 4, cache=R.QueryResultCache(), **kw)
        port = P_serve.ShardedTripleService.build(base, 20, 4, cache=P.QueryResultCache(),
                                                  device="cpu", **kw)
        for i in range(12):
            grow = _rows(rng, 10, 40 + 10 * i, 4, lo=30 + 10 * i)
            grow[:7, 1] = 0
            assert port.insert_triples(grow) == ref.insert_triples(grow)
            _same_state(ref, port)
            if port.migration_active:
                assert port._migration.pending_rows > 0
        if strategy == "node_range":
            assert port.stats.rebalances >= 1 and port.stats.migrated_rows > 0
        else:
            assert port.stats.rebalances == 0 and port._futile_total is not None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_reference_set_oracle_machine_on_the_port(seed, monkeypatch):
    monkeypatch.setattr(ref_oracle, "ShardedTripleService", _PortTier)
    rng = np.random.default_rng(seed)
    for strategy in P_part.STRATEGIES:
        for n_shards in (1, 2, 4):
            ref_oracle._run_machine(int(rng.integers(0, 2**31)), strategy, n_shards)
        ref_oracle._run_machine(int(rng.integers(0, 2**31)), strategy, 2, n_ops=6, auto=True)


@pytest.mark.parametrize("scenario", [
    "test_explicit_rebalance_reduces_skew_and_stays_exact",
    "test_rebalance_below_threshold_is_a_noop",
    "test_migration_bumps_only_touched_shards",
    "test_inflight_migration_serves_and_mutates_exactly",
    "test_auto_rebalance_triggers_from_mutation_path",
    "test_auto_rebalance_futility_backoff",
    "test_empty_shard_serves_rebuilds_and_receives_rows_node_range",
    "test_empty_shard_serves_and_rebalances_predicate_hash",
])
def test_the_reference_service_scenarios_on_the_port(scenario, monkeypatch):
    monkeypatch.setattr(ref_rebalance, "ShardedTripleService", _PortTier)
    monkeypatch.setattr(ref_rebalance, "plan_rebalance", P_dist.plan_rebalance)
    getattr(ref_rebalance, scenario)()
