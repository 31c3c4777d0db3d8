"""The port's serving concurrency (``repro_torch.serve.concurrency`` and the
sharded tier's threads) and the thread-safe kernel launch counter, on the
CPU.

The reference's ``RWLock`` cases (``tests/test_concurrency.py``) run
against the port's class. Threaded flushes give views equal tensor for
tensor to sequential ones. The reference's request-plane cases and its
mutate / query / rebalance stress machine (a short run) run on the port's
tier. The launch counter loses no count under many threads.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import repro_torch.serve as P_serve
from repro_torch.kernels import _build
from tests import test_concurrency as ref_conc
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_reference_knobs(monkeypatch):
    """The reference reads no environment knob in these tests."""
    for k in [k for k in os.environ if k.startswith("ITR_")]:
        monkeypatch.delenv(k)


class _PortTier:
    """The port's tier under the reference suite's name, built on the CPU."""

    @staticmethod
    def build(*args, **kwargs):
        return P_serve.ShardedTripleService.build(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("case", [
    "test_rwlock_readers_share",
    "test_rwlock_writer_excludes_readers_and_writers",
    "test_rwlock_write_preferring",
    "test_rwlock_writer_reentrant_and_read_under_write",
    "test_rwlock_read_reentrant",
    "test_rwlock_upgrade_refused",
    "test_rwlock_release_errors",
])
def test_the_reference_rwlock_cases_on_the_port(case, monkeypatch):
    monkeypatch.setattr(ref_conc, "RWLock", P_serve.RWLock)
    getattr(ref_conc, case)()


@pytest.mark.parametrize("case", [
    "test_set_serve_threads_swaps_pool",
    "test_concurrent_query_threads_get_their_own_results",
    "test_query_many_skips_foreign_pending_tickets",
])
def test_the_reference_request_plane_cases_on_the_port(case, monkeypatch):
    monkeypatch.setattr(ref_conc, "ShardedTripleService", _PortTier)
    getattr(ref_conc, case)()


def _same_view(a, b):
    for name in ("labels", "nodes", "offsets", "entry_bounds", "qid_entry"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("strategy", ["predicate_hash", "node_range"])
@pytest.mark.parametrize("max_batch", [1024, 3])
def test_threaded_flushes_equal_sequential_ones(strategy, max_batch):
    rng = np.random.default_rng(3)
    t = np.unique(np.stack([rng.integers(0, 40, 300), rng.integers(0, 6, 300),
                            rng.integers(0, 40, 300)], 1), axis=0)
    kw = dict(n_shards=4, strategy=strategy, crossover=0, rebalance_skew=None,
              max_batch=max_batch, device="cpu")
    seq = P_serve.ShardedTripleService.build(t, 40, 6, serve_threads=1, **kw)
    par = P_serve.ShardedTripleService.build(t, 40, 6, serve_threads=4, **kw)
    pats = [(None, 2, None), (None, None, None), (5, None, None), (None, None, 3),
            (None, 1, 7), (2, 0, None), (5, None, None), (None, 2, None)] + \
        [(int(s), None, None) for s in t[::17, 0]] + [(None, None, int(o)) for o in t[::13, 2]]
    for _ in range(2):  # cold, then warm
        for svc in (seq, par):
            for s, p, o in pats:
                svc.submit(s, p, o)
        _same_view(par.flush_view(), seq.flush_view())
    rows = t[:20] + np.array([1, 0, 0])
    assert par.insert_triples(rows) == seq.insert_triples(rows)
    assert par.query_many(pats) == seq.query_many(pats)
    assert par.stats.shard_batches == seq.stats.shard_batches
    assert par._pool is not None and seq._pool is None
    par.close()
    par.close()  # idempotent


@pytest.mark.parametrize("strategy", ["predicate_hash", "node_range"])
def test_the_reference_stress_machine_on_the_port(strategy, monkeypatch):
    monkeypatch.setattr(ref_conc, "ShardedTripleService", _PortTier)
    ref_conc._stress_machine(strategy, seconds=1.0, n_query_threads=3,
                             seed=len(strategy), serve_threads=2)


def test_the_launch_counter_loses_nothing_under_threads():
    """``launch_counts[k] += 1`` is a read-modify-write; under many threads
    and a short switch interval an unlocked counter drops counts."""
    per_thread, n_threads = 4000, 16
    start = threading.Barrier(n_threads, timeout=30)

    def launcher():
        start.wait()
        for _ in range(per_thread):
            _build.count_launch("k2_lines_count")

    saved = dict(_build.launch_counts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launch_counts()
        threads = [threading.Thread(target=launcher) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert _build.launch_counts["k2_lines_count"] == per_thread * n_threads
        assert sum(_build.launch_counts.values()) == per_thread * n_threads
    finally:
        sys.setswitchinterval(interval)
        _build.launch_counts.update(saved)
