"""The port's serving tier (``repro_torch.serve``: ``MicroBatchService``,
``TripleQueryService``, ``ShardedTripleService``) and the view helpers it
needs, against the reference, on the CPU.

Both tiers are built from the same seeded numpy triples with the same
explicit cache, crossover, delta budget, trigger and fan-out. Every answer
must equal the reference's as a list (order included), and every stats
field but the clocks, and the shared cache's counters, must be equal: all
eight patterns on both strategies at P = 1, 2, 4, cold and warm; duplicate
tickets, chunked flushes, the empty flush, ``query`` with other tickets
pending; warm merged hits and a one-shard invalidate; ``TripleQueryService``;
degraded serving and reingest; BGPs (against ``tests/_bgp_oracle.py`` too)
and the string surfaces (``tests/fixtures/small.nt`` through the reference
suite's own checker) through the tier, and ingestion into an empty tier. A
port tier assembled from a reference tier's plan dict and shard snapshots
answers as the reference tier does. A flush's own host reads do not grow
with its patterns. One deliberate divergence is pinned: the tier's
``contains_triples`` answers its rows as one flush.
"""
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import repro.core as R
import repro.distributed.partition as R_part
import repro.serve as R_serve
import repro_torch.core as P
import repro_torch.distributed.partition as P_part
import repro_torch.serve as P_serve
from _bgp_oracle import oracle_bgp
from repro.data import ingest as R_ing
from repro.persist.snapshot import save_snapshot as ref_save_snapshot
from repro_torch.data import ingest as P_ing
from repro_torch.persist.snapshot import load_snapshot
from tests import test_ingest_strings as ref_strings
from tests.test_torch_build import port_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERN_NAMES = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]
N_NODES, N_PREDS = 28, 4
TIME_FIELDS = ("total_s", "last_flush_qps", "last_batch_qps")


@pytest.fixture(autouse=True)
def _no_reference_knobs(monkeypatch):
    """The reference reads no environment knob in these tests."""
    for k in [k for k in os.environ if k.startswith("ITR_")]:
        monkeypatch.delenv(k)


def _bind(pattern, s, p, o):
    return (s if pattern[0] == "s" else None,
            p if pattern[1] == "p" else None,
            o if pattern[2] == "o" else None)


def _triples(seed, n_edges=110, n_nodes=N_NODES, n_preds=N_PREDS):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.integers(0, n_nodes, n_edges),
                  rng.integers(0, n_preds, n_edges),
                  rng.integers(0, n_nodes, n_edges)], axis=1)
    return np.unique(t, axis=0)


def _tiers(triples, n_nodes=N_NODES, n_preds=N_PREDS, *, cache=True, crossover=0,
           delta_budget=None, rebalance_skew=None, serve_threads=1, **kw):
    """Reference and port tiers over the same rows, every knob explicit."""
    args = dict(crossover=crossover, delta_budget=delta_budget,
                rebalance_skew=rebalance_skew, serve_threads=serve_threads, **kw)
    ref = R_serve.ShardedTripleService.build(
        triples, n_nodes, n_preds, cache=R.QueryResultCache() if cache else None, **args)
    port = P_serve.ShardedTripleService.build(
        triples, n_nodes, n_preds, cache=P.QueryResultCache() if cache else None,
        device="cpu", **args)
    return ref, port


def _fields(stats) -> dict:
    return {k: v for k, v in vars(stats).items() if k not in TIME_FIELDS}


def _same_state(ref, port):
    assert _fields(port.stats) == _fields(ref.stats)
    if ref.cache is None:
        assert port.cache is None
    else:
        assert vars(port.cache.stats) == vars(ref.cache.stats)
        assert len(port.cache) == len(ref.cache)


def _patterns(triples, seed, n_nodes=N_NODES, n_preds=N_PREDS):
    rng = np.random.default_rng(seed)
    rows = [tuple(int(v) for v in triples[rng.integers(0, len(triples))]) for _ in range(3)]
    rows.append((n_nodes - 1, n_preds - 1, 0))  # bindings that may match nothing
    return [_bind(pat, *r) for r in rows for pat in PATTERN_NAMES]


@pytest.mark.parametrize("strategy", ["predicate_hash", "node_range"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("cache", [True, False])
def test_every_pattern_as_the_reference(strategy, n_shards, cache):
    t = _triples(n_shards)
    ref, port = _tiers(t, n_shards=n_shards, strategy=strategy, cache=cache)
    pats = _patterns(t, n_shards)
    for _ in range(2):  # cold, then warm from the shared tier
        assert port.query_many(pats) == ref.query_many(pats)
        _same_state(ref, port)
    for s, p, o in pats[:10]:
        assert port.query(s, p, o) == ref.query(s, p, o)
    for s, p, o in pats[::3]:
        assert port.submit(s, p, o) == ref.submit(s, p, o)
    assert port.flush() == ref.flush()
    _same_state(ref, port)
    assert port.shard_sizes() == ref.shard_sizes()
    assert port.live_edges() == ref.live_edges() and port.skew() == ref.skew()


def test_duplicate_tickets_share_one_entry():
    t = _triples(3)
    ref, port = _tiers(t, n_shards=3, strategy="node_range")
    p0 = int(t[0, 1])
    for svc in (ref, port):
        for _ in range(3):
            svc.submit(None, p0, None)  # scattered, duplicated
    view, want = port.flush_view(), ref.flush_view()
    assert view.n_queries == 3 and view.n_entries == 1
    assert view.qid_entry.tolist() == [0, 0, 0]
    assert view.tuple_lists() == want.tuple_lists()
    for svc in (ref, port):
        for _ in range(3):
            svc.submit(None, p0, None)
    out = port.flush()
    assert out == ref.flush()
    assert out[0] is out[1] is out[2] and isinstance(out[0], tuple)
    _same_state(ref, port)


@pytest.mark.parametrize("serve_threads", [1, 3])
def test_chunked_flush_counts_batches_as_the_reference(serve_threads):
    t = _triples(4)
    ref, port = _tiers(t, n_shards=2, max_batch=2, serve_threads=serve_threads)
    pats = [(int(s), None, None) for s in t[:5, 0]] + [(None, None, int(t[0, 2]))]
    assert port.query_many(pats) == ref.query_many(pats)
    assert port.stats.shard_batches >= 2 and port.stats.flushes == 1
    _same_state(ref, port)
    port.close()
    ref.close()


def test_the_empty_flush_and_a_query_with_tickets_pending():
    t = _triples(5)
    ref, port = _tiers(t, n_shards=2)
    assert port.flush() == [] == ref.flush()
    view = port.flush_view()
    assert view.n_queries == 0 and view.n_entries == 0 and view.total_results() == 0
    assert port.query_many([]) == []
    assert port.stats.flushes == port.stats.queries == 0
    s0, s1 = int(t[0, 0]), int(t[1, 0])
    for svc in (ref, port):
        svc.submit(s0, None, None)  # someone else's pending ticket
    assert port.query(s1, None, None) == ref.query(s1, None, None)
    assert port.pending == 0
    for svc in (ref, port):
        svc.submit(None, None, None)
    assert port.query_many([(None, 1, None), (s0, None, None)]) == \
        ref.query_many([(None, 1, None), (s0, None, None)])
    _same_state(ref, port)


def test_warm_merged_hits_and_a_one_shard_invalidate():
    t = _triples(15)
    ref, port = _tiers(t, n_shards=3, strategy="node_range")
    p0 = int(t[0, 1])
    assert port.query(None, p0, None) == ref.query(None, p0, None)  # cold: fans out
    sb = port.stats.shard_batches
    assert port.query(None, p0, None) == ref.query(None, p0, None)  # warm: one lookup
    assert port.stats.shard_batches == sb and port.stats.merged_hits == 1
    _same_state(ref, port)
    for svc in (ref, port):
        svc.invalidate(1)  # also drops the merged entry
    assert port.query(None, p0, None) == ref.query(None, p0, None)
    assert port.stats.shard_batches > sb
    s0 = int(t[0, 0])
    assert port.query(s0, None, None) == ref.query(s0, None, None)
    for svc in (ref, port):
        svc.invalidate()
    assert port.query(s0, None, None) == ref.query(s0, None, None)
    _same_state(ref, port)
    assert port.cache_stats() is port.cache.stats


def _engine_pair(t, cache):
    g = R.Hypergraph.from_triples(t, N_NODES)
    table = R.LabelTable.terminals([2] * N_PREDS)
    ref = R.TripleQueryEngine(R.compress(g, table)[0], cache=R.QueryResultCache() if cache
                              else None, crossover=0, delta_budget=3)
    port = P.TripleQueryEngine(P.compress(*port_hypergraph(g, table))[0],
                               cache=P.QueryResultCache() if cache else None, crossover=0,
                               delta_budget=3)
    return ref, port


@pytest.mark.parametrize("cache", [True, False])
def test_triple_query_service_counts_as_the_reference(cache):
    t = _triples(6)
    r_eng, p_eng = _engine_pair(t, cache)
    ref = R_serve.TripleQueryService(r_eng, max_batch=5)
    port = P_serve.TripleQueryService(p_eng, max_batch=5)
    pats = _patterns(t, 6)
    for _ in range(2):
        assert port.query_many(pats) == ref.query_many(pats)
        assert _fields(port.stats) == _fields(ref.stats)
    rows = t[:4] + np.array([0, 0, 1])
    assert port.insert_triples(rows) == ref.insert_triples(rows)
    assert port.delete_triples(t[4:9]) == ref.delete_triples(t[4:9])
    assert port.query_many(pats) == ref.query_many(pats)
    assert port.rebuild() == ref.rebuild()
    assert port.query(*pats[0]) == ref.query(*pats[0])
    assert _fields(port.stats) == _fields(ref.stats)
    assert port.stats.cache_hit_rate == ref.stats.cache_hit_rate and port.stats.qps > 0
    assert port.flush_view().n_queries == 0 and port.flush() == []


def test_view_helpers_as_the_reference():
    t = _triples(9)
    r_eng, p_eng = _engine_pair(t, cache=True)
    s0, p0 = int(t[0, 0]), int(t[0, 1])
    cols = ([s0, None, s0, None, -1], [None, p0, None, p0, 2], [None, None, None, None, 7])
    views = [(r_eng.query_batch_view(*cols), p_eng.query_batch_view(*cols)),
             (r_eng.query_batch_view([s0], None, None), p_eng.query_batch_view([s0], None, None)),
             (R.QueryResultView.empty(), P.QueryResultView.empty())]
    for ref, port in views:
        assert port.tuple_lists() == ref.tuple_lists()
        for q in range(ref.n_queries):
            assert port.tuples(q) == ref.tuples(q)
        for e in range(len(ref.entries)):
            assert port.entry_tuples(e) == ref.entry_tuples(e)
    ref = R.QueryResultView.concat([r for r, _ in views])
    port = P.QueryResultView.concat([p for _, p in views])
    assert port.n_queries == ref.n_queries and port.n_entries == len(ref.entries)
    assert port.tuple_lists() == ref.tuple_lists()
    assert port.total_results() == ref.total_results()
    assert torch.equal(port.result_counts(), torch.from_numpy(ref.result_counts()))
    out = port.tuple_lists()
    assert out[0] is out[2] and isinstance(out[0], tuple)  # duplicates share a tuple
    empty = P.QueryResultView.concat([])
    assert empty.n_queries == 0 and empty.tuple_lists() == []


def test_degraded_serving_and_reingest():
    t = _triples(11)
    ref, port = _tiers(t, n_shards=3, strategy="predicate_hash", crossover=None)
    k = 1
    for svc in (ref, port):
        svc.mark_shard_failed(k)
    pats = _patterns(t, 11)
    # the rebuilt engines measure their crossover, so compare as sets
    assert [sorted(r) for r in port.query_many(pats)] == \
        [sorted(r) for r in ref.query_many(pats)]
    assert port.stats.degraded_patterns == ref.stats.degraded_patterns > 0
    on_k = t[port.plan.triple_shards(t) == k][:2]
    with pytest.raises(RuntimeError, match="failed shards"):
        port.insert_triples(on_k + np.array([0, 0, 1]))
    with pytest.raises(RuntimeError, match="failed shards"):
        port.rebalance(force=True)
    with pytest.raises(ValueError, match="not marked failed"):
        port.reingest_shard(0, t)
    with pytest.raises(ValueError, match="out of range"):
        port.mark_shard_failed(3)
    assert port.reingest_shard(k, t) == ref.reingest_shard(k, t)
    assert port.failed_shards == set()
    assert [sorted(r) for r in port.query_many(pats)] == \
        [sorted(r) for r in ref.query_many(pats)]
    assert _fields(port.stats) == _fields(ref.stats)


BGPS = ["?x 0 ?y . ?y 1 ?z", "?h 0 ?a . ?h 1 ?b", "?a ?p ?b . ?b 3 ?c", "?a 0 ?b . ?b 0 ?a",
        "7 ?p ?o . ?o ?q ?r", "?x 0 ?y . ?y 3 27", [(1, 0, 2), ("?x", 0, "?y")]]


@pytest.mark.parametrize("strategy", ["predicate_hash", "node_range"])
def test_bgps_through_the_tier(strategy):
    t = _triples(12)
    ref, port = _tiers(t, n_shards=3, strategy=strategy)
    logical = [tuple(r) for r in t.tolist()]
    for bgp in BGPS:
        got, want = port.query_bgp(bgp), ref.query_bgp(bgp)
        assert got.vars == want.vars
        assert np.array_equal(got.rows.numpy().reshape(want.rows.shape), want.rows)
        o_vars, o_rows = oracle_bgp(logical, bgp)
        assert list(got.vars) == list(o_vars) and got.tuples() == o_rows
        hits = port.stats.bgp_cache_hits
        again = port.query_bgp(bgp)  # warm: the merged cache, no flush
        assert port.stats.bgp_cache_hits == hits + 1 and torch.equal(again.rows, got.rows)
        ref.query_bgp(bgp)
    _same_state(ref, port)
    # a write invalidates every cached join
    rows = np.array([[7, 0, 27], [27, 3, 27], [3, 0, 7]])
    assert port.insert_triples(rows) == ref.insert_triples(rows)
    logical = sorted(set(logical) | {tuple(r) for r in rows.tolist()})
    for bgp in BGPS:
        got = port.query_bgp(bgp)
        assert got.tuples() == oracle_bgp(logical, bgp)[1]
        assert np.array_equal(got.rows.numpy().reshape(-1), ref.query_bgp(bgp).rows.reshape(-1))
    _same_state(ref, port)
    # with the whole-BGP cache off, joins still run through the tier's cache
    off = P_serve.ShardedTripleService.build(t, N_NODES, N_PREDS, n_shards=3, strategy=strategy,
                                             crossover=0, rebalance_skew=None, bgp_cache=False,
                                             device="cpu")
    off.query_bgp(BGPS[0])
    off.query_bgp(BGPS[0])
    assert off.stats.bgp_cache_hits == 0 and off.stats.bgp_queries == 2


def _empty_tiers(n_preds=8, n_shards=2, **kw):
    empty = np.zeros((0, 3), dtype=np.int64)
    return (R_serve.ShardedTripleService.build(empty, 1, n_preds, n_shards=n_shards, cache=None,
                                               **kw),
            P_serve.ShardedTripleService.build(empty, 1, n_preds, n_shards=n_shards, cache=None,
                                               device="cpu", **kw))


def test_ingestion_and_strings_through_an_empty_tier():
    ref, port = _empty_tiers(crossover=0, rebalance_skew=None, serve_threads=1)
    want = R_ing.ingest_file(ref, ref_strings.FIXTURE, batch_size=5)
    got = P_ing.ingest_file(port, ref_strings.FIXTURE, batch_size=5)
    a, b = want.as_dict(), got.as_dict()
    for d in (a, b):
        d.pop("seconds"), d.pop("rows_per_s")
    assert b == a and got.batches == 3 and got.inserted == 13
    oracle = ref_strings._oracle()
    ref_strings._assert_string_parity(port.query_strings, oracle)
    for s, p, o in sorted(oracle)[:4]:
        for pat in PATTERN_NAMES:
            q = _bind(pat, s, p, o)
            assert port.query_strings(*q) == ref.query_strings(*q)
    knows = "<http://ex.org/knows>"
    for bgp in ([("?x", knows, "?y"), ("?y", knows, "?z")],
                [("<http://ex.org/alice>", "?p", "?o")]):
        assert port.query_bgp_strings(bgp) == ref.query_bgp_strings(bgp)
    flushes = port.stats.flushes
    assert port.query_strings("<http://ex.org/nobody>", None, None) == []
    assert port.query_bgp_strings([("?x", "<http://no.such/pred>", "?y")]) == []
    assert port.stats.flushes == flushes and port.stats.unknown_term_empties == 2
    again = P_ing.ingest_file(port, ref_strings.FIXTURE)
    assert again.inserted == 0 and again.new_nodes == 0
    _, small = _empty_tiers(n_preds=2)
    with pytest.raises(ValueError, match="predicate capacity"):
        P_ing.ingest_file(small, ref_strings.FIXTURE)
    with pytest.raises(ValueError, match="no term dictionary"):
        _empty_tiers()[1].query_strings(None, None, None)


def test_a_port_tier_carries_a_reference_tiers_state(tmp_path):
    """Plan through its wire form, each shard through its snapshot files:
    the port tier answers as the reference tier it came from."""
    t = _triples(13)
    ref = R_serve.ShardedTripleService.build(t, N_NODES, N_PREDS, n_shards=3,
                                             strategy="node_range", cache=R.QueryResultCache(),
                                             crossover=0, delta_budget=None,
                                             rebalance_skew=None, serve_threads=1)
    ref.insert_triples(np.array([[1, 2, 27], [30, 1, 4], [3, 3, 3]]))
    ref.delete_triples(t[::7])
    cache = P.QueryResultCache()
    engines = []
    for k, eng in enumerate(ref.engines):
        ref_save_snapshot(eng, tmp_path / f"shard{k}")
        engines.append(load_snapshot(tmp_path / f"shard{k}", cache=cache.shard_view(k),
                                     device="cpu"))
    plan = P_part.plan_from_dict(R_part.plan_to_dict(ref.plan))
    port = P_serve.ShardedTripleService(engines, plan, cache, rebalance_skew=None,
                                        serve_threads=1)
    pats = _patterns(t, 13) + [(30, None, None), (None, None, 27)]
    assert port.query_many(pats) == ref.query_many(pats)
    assert port.live_edges() == ref.live_edges()
    assert port.contains_triples(t[:9]).tolist() == ref.contains_triples(t[:9]).tolist()
    with pytest.raises(ValueError, match="engines for"):
        P_serve.ShardedTripleService(engines[:2], plan, cache)


def test_contains_triples_is_one_flush():
    """Deliberate divergence: the reference answers each row with its own
    ``query`` (a flush a row); the port answers the rows as one flush of
    fully bound patterns. The answers are equal."""
    t = _triples(14)
    ref, port = _tiers(t, n_shards=2, strategy="node_range")
    rows = np.concatenate([t[:6], np.array([[0, 0, 0], [27, 3, 1], [-1, 1, -1]])])
    got = port.contains_triples(rows)
    assert got.dtype == torch.bool and got.tolist() == ref.contains_triples(rows).tolist()
    assert (port.stats.flushes, port.stats.queries) == (1, len(rows))
    assert (ref.stats.flushes, ref.stats.queries) == (len(rows), len(rows))
    assert port.contains_triples(np.zeros((0, 3))).shape == (0,)
    port.submit(0, None, None)
    port.contains_triples(t[:2])
    assert port.pending == 1  # another caller's ticket is not flushed away


_READS = ("tolist", "item", "__int__", "__bool__", "__float__", "__index__", "cpu", "numpy",
          "nonzero")


@contextmanager
def _counting_reads(monkeypatch, tier):
    """Count the tensor reads that wait for the device (on the card, a host
    sync each), outside the engines' own batches."""
    count, inside = [0], [0]
    for name in _READS:
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, _real=real, **kw):
            if not inside[0]:
                count[0] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    for fn in ("nonzero", "unique"):
        real = getattr(torch, fn)

        def wrapped_fn(*a, _real=real, **kw):
            if not inside[0]:
                count[0] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(torch, fn, wrapped_fn)
    for eng in tier.engines:
        real = eng.query_batch_view

        def batch(*a, _real=real):
            inside[0] += 1
            try:
                return _real(*a)
            finally:
                inside[0] -= 1
        monkeypatch.setattr(eng, "query_batch_view", batch)
    yield count
    monkeypatch.undo()


@pytest.mark.parametrize("strategy", ["predicate_hash", "node_range"])
def test_a_flushs_own_host_reads_do_not_grow_with_its_patterns(strategy, monkeypatch):
    t = _triples(16, n_edges=200, n_nodes=60)
    port = P_serve.ShardedTripleService.build(t, 60, N_PREDS, n_shards=4, strategy=strategy,
                                              crossover=0, delta_budget=None,
                                              rebalance_skew=None, serve_threads=1,
                                              cache=P.QueryResultCache(), device="cpu")
    reads = []
    for lo, n, preds in ((0, 4, (0, 1)), (4, 56, (2, 3))):  # cold: distinct patterns
        pats = [(None, None, o) for o in range(lo, lo + n)] + \
            [(s, None, None) for s in range(lo, lo + n)] + [(None, p, None) for p in preds]
        with _counting_reads(monkeypatch, port) as count:
            out = port.query_many(pats)
        assert len(out) == len(pats)
        reads.append(count[0])
    assert port.stats.scattered >= 60 and port.stats.owned >= 4
    assert reads[0] == reads[1] <= 8, reads
