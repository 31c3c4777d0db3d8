"""The port's result cache and the engine's cached paths against the
reference, on the CPU.

The reference's cache scenarios (LRU eviction and stats, the isolated
``?P?`` segment, the edge budget and the oversize skip, cached parity on
random hypergraphs with hit / miss mixes and duplicates, entries that own
their storage, the cache-disabled engine) run on both packages with the
same operations and seeded inputs: answers equal the oracle and the
reference, and the stats agree. The read-only checks of the reference do
not carry over: torch has no read-only flag (ROADMAP C).
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from tests.test_itr_core import random_hypergraph
from tests.test_torch_build import port_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _canon(results):
    return sorted((int(lbl), tuple(int(v) for v in nodes)) for lbl, nodes in results)


def _entry(pkg, labels, nodes, offsets):
    if pkg is R:
        return np.asarray(labels), np.asarray(nodes), np.asarray(offsets)
    return tuple(torch.as_tensor(np.asarray(a)) for a in (labels, nodes, offsets))


def _triple_engines(seed=0, n_nodes=15, n_preds=3, n_edges=80, cache=True, **kwargs):
    rng = np.random.default_rng(seed)
    triples = np.stack([rng.integers(0, n_nodes, n_edges), rng.integers(0, n_preds, n_edges),
                        rng.integers(0, n_nodes, n_edges)], axis=1)
    g = R.Hypergraph.from_triples(triples, n_nodes)
    table = R.LabelTable.terminals([2] * n_preds)
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(*port_hypergraph(g, table))
    ref = R.TripleQueryEngine(ref_g, cache=R.QueryResultCache() if cache else None, **kwargs)
    port = P.TripleQueryEngine(port_g, cache=P.QueryResultCache() if cache else None, **kwargs)
    return ref, port, g, triples


# ---------------------------------------------------------------- cache unit
@pytest.mark.parametrize("pkg", [R, P], ids=["reference", "port"])
def test_result_cache_lru_eviction_and_stats(pkg):
    cache = pkg.QueryResultCache(max_entries=2, max_edges=1 << 20)
    e = _entry(pkg, [1], [0, 1], [0, 2])
    assert cache.lookup(1, -1, -1) is None
    cache.insert(1, -1, -1, e)
    cache.insert(2, -1, -1, e)
    assert cache.lookup(1, -1, -1) is not None  # refresh 1 -> 2 becomes LRU
    cache.insert(3, -1, -1, e)                  # evicts 2
    assert cache.lookup(2, -1, -1) is None
    assert cache.lookup(3, -1, -1) is not None
    st = cache.stats
    assert st.evictions == 1 and st.inserts == 3
    assert st.hits == 2 and st.misses == 2
    assert st.hit_rate == pytest.approx(0.5) and st.lookups == 4
    assert vars(st.snapshot()) == vars(st)


@pytest.mark.parametrize("pkg", [R, P], ids=["reference", "port"])
def test_result_cache_predicate_segment_is_isolated(pkg):
    cache = pkg.QueryResultCache(max_entries=1, predicate_entries=4)
    e = _entry(pkg, [1], [0, 1], [0, 2])
    cache.insert(-1, 0, -1, e)  # ?P? -> the predicate segment
    cache.insert(-1, 1, -1, e)
    for s in range(5):          # a burst of selective inserts thrashes the general segment
        cache.insert(s, -1, -1, e)
    assert cache.lookup(-1, 0, -1) is not None
    assert cache.lookup(-1, 1, -1) is not None
    assert cache.stats.predicate_hits == 2
    assert len(cache) == 3


@pytest.mark.parametrize("pkg", [R, P], ids=["reference", "port"])
def test_result_cache_edge_budget_and_oversize(pkg):
    big = _entry(pkg, np.arange(10), np.arange(20), np.arange(0, 22, 2))
    cache = pkg.QueryResultCache(max_entries=100, max_edges=25, max_entry_edges=15)
    for s in range(4):
        cache.insert(s, -1, -1, big)  # 10 edges each; budget 25 -> evictions
    assert cache.cached_edges <= 25
    assert cache.stats.evictions >= 1
    huge = _entry(pkg, np.arange(16), np.arange(32), np.arange(0, 34, 2))
    cache.insert(9, -1, -1, huge)  # > max_entry_edges: skipped
    assert cache.lookup(9, -1, -1) is None
    assert cache.stats.oversize_skips == 1


def test_cache_units_agree_step_for_step():
    """The same random operations on both caches: the same hits, stats,
    sizes and edge counts after every step."""
    rng = np.random.default_rng(5)
    caches = {pkg: pkg.QueryResultCache(max_entries=6, max_edges=40, predicate_entries=3,
                                        predicate_edges=30, max_entry_edges=12) for pkg in (R, P)}
    for _ in range(300):
        s, p, o = (int(rng.integers(-1, 4)) for _ in range(3))
        n = int(rng.integers(0, 15))
        op = rng.choice(["lookup", "insert", "bump", "clear"], p=[0.5, 0.44, 0.05, 0.01])
        seen = {}
        for pkg, cache in caches.items():
            if op == "lookup":
                seen[pkg] = cache.lookup(s, p, o) is None
            elif op == "insert":
                cache.insert(s, p, o, _entry(pkg, np.arange(n), np.arange(2 * n),
                                             np.arange(0, 2 * n + 1, 2)))
            elif op == "bump":
                seen[pkg] = cache.bump_generation()
            else:
                cache.clear()
        assert seen.get(R) == seen.get(P)
        r, q = caches[R], caches[P]
        assert vars(r.stats) == vars(q.stats)
        assert (len(r), r.cached_edges, r.generation()) == (len(q), q.cached_edges, q.generation())


def test_shard_views_share_one_cache_and_bump_alone():
    for pkg in (R, P):
        cache = pkg.QueryResultCache()
        a, b = cache.shard_view(0), cache.shard_view(1)
        e = _entry(pkg, [1], [0, 1], [0, 2])
        a.insert(1, -1, -1, e)
        b.insert(1, -1, -1, e)
        a.insert(-1, 0, -1, e)  # routed by the pattern: the predicate segment
        assert len(cache) == 3 and len(a) == 3
        assert a.lookup(1, -1, -1) is not None and b.lookup(1, -1, -1) is not None
        assert a.bump_generation() == 1 and a.generation() == 1 and b.generation() == 0
        assert a.lookup(1, -1, -1) is None and a.lookup(-1, 0, -1) is None  # purged
        assert b.lookup(1, -1, -1) is not None                              # survives
        assert len(cache) == 1 and cache.cached_edges == 1
        assert a.stats is cache.stats and cache.stats.hits == 3
        b.clear()
        assert len(cache) == 0


# ---------------------------------------------------------------- engine + cache
def test_cached_queries_match_oracle_and_count_hits():
    ref, port, g, triples = _triple_engines(seed=2, crossover=0)
    s0, p0 = int(triples[0, 0]), int(triples[0, 1])
    want_s = _canon(R.query_oracle(g, s0, None, None))
    want_p = _canon(R.query_oracle(g, None, p0, None))
    assert _canon(port.query(s0, None, None)) == want_s
    assert _canon(port.query(None, p0, None)) == want_p
    miss0 = port.cache.stats.misses
    # repeats are hits and still exact
    assert _canon(port.query(s0, None, None)) == want_s
    assert _canon(port.query(None, p0, None)) == want_p
    assert port.cache.stats.hits >= 2 and port.cache.stats.misses == miss0
    assert port.cache.stats.predicate_hits >= 1
    for q in ((s0, None, None), (None, p0, None), (s0, None, None), (None, p0, None)):
        ref.query(*q)
    assert vars(port.cache.stats) == vars(ref.cache.stats)


@pytest.mark.parametrize("seed", range(10))
def test_cache_parity_random_hypergraph_batches(seed):
    """Batches re-run against a warm cache equal the oracle and the
    reference exactly, mixed hit / miss batches with duplicates included."""
    rng = np.random.default_rng(seed)
    g, table = random_hypergraph(rng, n_nodes=14, n_edges=50)
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(*port_hypergraph(g, table))
    ref = R.TripleQueryEngine(ref_g, cache=R.QueryResultCache(), crossover=0)
    port = P.TripleQueryEngine(port_g, cache=P.QueryResultCache(), crossover=0)
    s = int(rng.integers(0, 14))
    p = int(rng.integers(0, 3))
    patterns = [(s, None, None), (None, p, None), (s, None, None),
                (None, None, s), (None, None, None)]
    ss, pp, oo = (list(c) for c in zip(*patterns))
    first = port.query_batch(ss, pp, oo)
    second = port.query_batch(ss, pp, oo)  # all hits
    patterns3 = patterns + [(None, None, int(rng.integers(0, 14)))]
    s3, p3, o3 = (list(c) for c in zip(*patterns3))
    third = port.query_batch(s3, p3, o3)   # half warm, half fresh
    for i, q in enumerate(patterns3):
        want = _canon(R.query_oracle(g, *q))
        if i < len(patterns):
            assert _canon(first[i]) == want and _canon(second[i]) == want
        assert _canon(third[i]) == want
    for c in ((ss, pp, oo), (ss, pp, oo), (s3, p3, o3)):
        ref.query_batch(*c)
    assert port.cache.stats.hits > 0
    assert vars(port.cache.stats) == vars(ref.cache.stats)


def _view_rows(view):
    owner = torch.repeat_interleave(torch.arange(view.n_entries), view.entry_counts())
    return P.result_rows(owner, view.labels, view.nodes, view.offsets)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warm_views_equal_cold_views(seed):
    """A view assembled from cached entries (all hits, or hits and misses)
    equals the cache-less engine's view of the same batch, entry for entry."""
    ref, port, g, triples = _triple_engines(seed=seed, crossover=0)
    _, bare, _, _ = _triple_engines(seed=seed, crossover=0, cache=False)
    rng = np.random.default_rng(seed)
    pick = triples[rng.integers(0, len(triples), 24)]
    cols = [pick[:, 0], np.full(24, -1), np.where(rng.random(24) < 0.5, pick[:, 2], -1)]
    half = [c[:12] for c in cols]
    port.query_batch_view(*half)                       # warm half of them
    for c in (cols, cols):                             # mixed, then all hits
        got, want = port.query_batch_view(*c), bare.query_batch_view(*c)
        assert torch.equal(got.qid_entry, want.qid_entry)
        assert torch.equal(got.entry_bounds, want.entry_bounds)
        assert torch.equal(_view_rows(got), _view_rows(want))
        for a, b in zip(got.materialize(), want.materialize()):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(got.result_counts().numpy(),
                                      ref.query_batch_view(*c).result_counts())


def test_single_query_aliases_its_cached_entry():
    _, port, _, triples = _triple_engines(seed=11, crossover=0)
    s0 = int(triples[0, 0])
    _, labels, nodes, offsets = port.query_batch_arrays([s0], None, None)
    entry = next(iter(port.cache._general.entries.values()))
    assert labels.data_ptr() == entry[0].data_ptr() and nodes.data_ptr() == entry[1].data_ptr()
    again = port.query_batch_arrays([s0], None, None)  # a hit: the same storage
    assert again[2].data_ptr() == nodes.data_ptr()
    assert port.cache.stats.hits == 1


def _owns_its_storage(entry) -> bool:
    """The entry's three tensors are the whole of one storage, in order."""
    labels, nodes, offsets = entry
    storage = labels.untyped_storage()
    size = labels.numel() + nodes.numel() + offsets.numel()
    return storage.nbytes() == 8 * size and all(
        t.untyped_storage().data_ptr() == storage.data_ptr() for t in entry) and \
        (labels.storage_offset(), nodes.storage_offset(), offsets.storage_offset()) == \
        (0, labels.numel(), labels.numel() + nodes.numel())


@pytest.mark.parametrize("crossover", [0, 8])
def test_cache_entries_do_not_pin_batch_buffers(crossover):
    """Entries split from a miss batch own their storage: a slice of the
    batch's buffer would keep the whole batch alive, defeating the edge
    budget. Each entry's storage is its own size."""
    _, port, _, triples = _triple_engines(seed=12, crossover=crossover)
    s0, s1 = int(triples[0, 0]), int(triples[1, 0])
    p0 = int(triples[0, 1])
    port.query_batch_arrays([s0, s1, -1], [-1, -1, p0], [-1, -1, -1])
    port.query(int(triples[2, 0]), None, int(triples[2, 2]))  # the one-query path
    entries = list(port.cache._general.entries.values()) + \
        list(port.cache._predicate.entries.values())
    assert len(entries) == 4
    for entry in entries:
        assert _owns_its_storage(entry)
        assert int(entry[2][0]) == 0 and int(entry[2][-1]) == entry[1].numel()


def test_cache_disabled_engine_still_exact():
    ref, port, g, triples = _triple_engines(seed=3, cache=False)
    s0 = int(triples[0, 0])
    want = _canon(R.query_oracle(g, s0, None, None))
    assert _canon(port.query(s0, None, None)) == want == _canon(ref.query(s0, None, None))
    assert port.cache is None


def test_default_engine_has_a_cache_and_a_budget():
    _, port, _, triples = _triple_engines(seed=4, crossover=0, cache=False)
    rng = np.random.default_rng(4)
    g = R.Hypergraph.from_triples(triples, 15)
    port_g, _ = P.compress(*port_hypergraph(g, R.LabelTable.terminals([2] * 3)))
    default = P.TripleQueryEngine(port_g, crossover=0)
    assert isinstance(default.cache, P.QueryResultCache) and default.delta_budget == 4096
    s = int(triples[rng.integers(0, len(triples)), 0])
    assert _canon(default.query(s, None, None)) == _canon(port.query(s, None, None))
    assert default.cache.stats.inserts == 1


def test_neighbours_through_the_cache_match_reference():
    ref, port, _, triples = _triple_engines(seed=9, crossover=0)
    vs = [int(v) for v in triples[:6, 0]] + [int(triples[0, 0]), -1, 15, 99]
    for _ in range(2):  # cold, then warm
        for got, want in ((port.neighbors_out_batch(vs), ref.neighbors_out_batch(vs)),
                          (port.neighbors_in_batch(vs), ref.neighbors_in_batch(vs))):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)
    assert vars(port.cache.stats) == vars(ref.cache.stats)


def test_engines_share_one_cache_through_shard_views():
    """Two engines on one cache, each through its shard's view: a mutation
    bumps its own shard alone, and the other engine's entry survives."""
    _, a, _, triples = _triple_engines(seed=7, crossover=0, cache=False)
    _, b, _, _ = _triple_engines(seed=7, crossover=0, cache=False)
    shared = P.QueryResultCache()
    a.cache, b.cache = shared.shard_view(0), shared.shard_view(1)
    s0 = int(triples[0, 0])
    assert _canon(a.query(s0, None, None)) == _canon(b.query(s0, None, None))
    assert len(shared) == 2
    assert a.insert_triples(np.array([[s0, 0, 20]])) == 1
    assert (shared.generation(0), shared.generation(1), len(shared)) == (1, 0, 1)
    assert (0, (s0, 20)) in a.query(s0, None, None)
    assert (0, (s0, 20)) not in b.query(s0, None, None)
    assert shared.stats.hits == 1  # b's second query


def test_a_callers_tuple_entry_is_served_like_the_engines():
    """A cache shared with other code may hold plain (labels, nodes,
    offsets) tuples; the engine serves them as its own entries."""
    _, port, _, triples = _triple_engines(seed=8, crossover=0)
    s0, s1 = int(triples[0, 0]), int(triples[1, 0])
    want = _canon(port.query(s0, None, None))
    parts = tuple(t.clone() for t in port.cache.lookup(s0, -1, -1))
    port.cache.clear()
    port.cache.insert(s0, -1, -1, parts)
    assert _canon(port.query(s0, None, None)) == want
    got = port.query_batch([s0, s1, s0], None, None)
    assert _canon(got[0]) == _canon(got[2]) == want
