"""The port's mutation overlay and its engine surface against the reference,
on the CPU.

Each scenario of the reference's mutation tests (the overlay's set
semantics, base duplicates, batch validation, overlay parity and rebuild,
node-universe growth, auto-rebuild at budgets 0 and 2, a rebuild reusing
the build's config, the worklist fast path under the overlay, neighbours
with the overlay, the cache's generation bump) runs on both packages from
the same seeded numpy triples: ``applied`` counts, sorted answers, the
logical triple sets and ``rebuild_count`` must be equal, and the grammar a
rebuild makes must equal the reference's bit for bit. A seeded random
interleaving of inserts, deletes, queries and rebuilds, on triple graphs
and on hypergraphs of ranks 1-3, is compared after every step. One
deliberate divergence is pinned: a negative node id has no neighbours in
the port, whatever the overlay holds.
"""
import inspect
import re

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.delta as R_delta
import repro_torch.core as P
import repro_torch.core.delta as P_delta
from tests.test_torch_build import assert_same_grammar, port_hypergraph
from tests.test_torch_query import _load_reference_state
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERN_NAMES = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]

N_NODES, N_PREDS = 15, 3


def _bind(pattern, s, p, o):
    return (s if pattern[0] == "s" else None,
            p if pattern[1] == "p" else None,
            o if pattern[2] == "o" else None)


def _unique_triples(seed, n_edges=60, n_nodes=N_NODES, n_preds=N_PREDS):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.integers(0, n_nodes, n_edges),
                  rng.integers(0, n_preds, n_edges),
                  rng.integers(0, n_nodes, n_edges)], axis=1)
    return np.unique(t, axis=0)


def _canon(results):
    return sorted((int(lbl), tuple(int(v) for v in nodes)) for lbl, nodes in results)


def _rows(a) -> set:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return {tuple(map(int, r)) for r in a.reshape(-1, 3)}


def _pair_from_graph(g, table, *, cache=False, config=None, port_config=None, **kwargs):
    """Reference and port engines over one reference hypergraph; `cache`
    gives each side a cache of its own."""
    kwargs.setdefault("crossover", 0)
    kwargs.setdefault("delta_budget", None)
    ref_g, _ = R.compress(g, table, config)
    port_g, _ = P.compress(*port_hypergraph(g, table), port_config)
    ref = R.TripleQueryEngine(ref_g, cache=R.QueryResultCache() if cache else None,
                              config=config, **kwargs)
    port = P.TripleQueryEngine(port_g, cache=P.QueryResultCache() if cache else None,
                               config=port_config, **kwargs)
    return ref, port


def _pair(triples, n_nodes=N_NODES, n_preds=N_PREDS, **kwargs):
    return _pair_from_graph(R.Hypergraph.from_triples(triples, n_nodes),
                            R.LabelTable.terminals([2] * n_preds), **kwargs)


def _oracle(logical, n_nodes=N_NODES, n_preds=N_PREDS):
    """A from-scratch reference engine over the logical triple set."""
    g, _ = R.compress(R.Hypergraph.from_triples(logical, n_nodes),
                      R.LabelTable.terminals([2] * n_preds))
    return R.TripleQueryEngine(g, cache=None, crossover=0, delta_budget=None)


def _assert_parity(ref, port, oracle, probe_rows):
    """Every pattern bound from every probe row: the port's answers equal
    the reference engine's and the from-scratch oracle's."""
    for row in probe_rows:
        s, p, o = map(int, row)
        for pattern in PATTERN_NAMES:
            q = _bind(pattern, s, p, o)
            want = _canon(oracle.query_scalar(*q))
            assert _canon(ref.query(*q)) == want, (pattern, q)
            assert _canon(port.query(*q)) == want, (pattern, q)


def _same_overlay(ref, port):
    np.testing.assert_array_equal(port.delta.inserts.numpy(), ref.delta.inserts)
    np.testing.assert_array_equal(port.delta.tombstones.numpy(), ref.delta.tombstones)
    assert port.rebuild_count == ref.rebuild_count


def _mutate_both(ref, port, base):
    """The reference test's fixed insert/delete interleaving on both
    engines; `applied` equal on both and to the count kept in plain Python.
    Returns (logical rows, probe rows)."""
    logical = {tuple(map(int, r)) for r in base}
    ins1 = np.array([[1, 0, 14], [2, 1, 3], [13, 2, 0], [0, 0, 0]])
    del1 = base[:5]
    ins2 = np.concatenate([del1[:2], ins1[:1]])  # resurrect 2, re-insert 1
    del2 = ins1[1:2]                             # un-buffer one overlay insert
    for rows, op in ((ins1, "i"), (del1, "d"), (ins2, "i"), (del2, "d")):
        want = {tuple(map(int, r)) for r in rows}
        expected = len(want - logical) if op == "i" else len(want & logical)
        name = "insert_triples" if op == "i" else "delete_triples"
        assert getattr(port, name)(rows) == getattr(ref, name)(rows) == expected
        _same_overlay(ref, port)
        logical = logical | want if op == "i" else logical - want
    probes = np.concatenate([base[5:7], ins1[:2], del1[:2], del2])
    return np.array(sorted(logical)), probes


# ------------------------------------------------------------- delta unit
def test_delta_overlay_set_semantics():
    ref, port = R.DeltaOverlay(), P.DeltaOverlay("cpu")
    rows = np.array([[1, 0, 2], [3, 1, 4]])
    base_row = np.array([[9, 2, 9]])
    # deleting an overlay insert un-buffers it, deleting a base row
    # tombstones it, re-inserting a tombstoned row resurrects it
    steps = [("insert_rows", rows, 2, 0), ("delete_rows", rows[:1], 1, 0),
             ("delete_rows", base_row, 1, 1), ("insert_rows", base_row, 1, 0)]
    assert port.is_empty and port.size == 0
    for name, r, n_ins, n_tomb in steps:
        assert getattr(port, name)(torch.from_numpy(r)) == getattr(ref, name)(r)
        assert (port.n_inserts, port.n_tombstones) == (ref.n_inserts, ref.n_tombstones)
        assert (port.n_inserts, port.n_tombstones) == (n_ins, n_tomb)
        np.testing.assert_array_equal(port.inserts.numpy(), ref.inserts)
        np.testing.assert_array_equal(port.tombstones.numpy(), ref.tombstones)
    assert port.size == ref.size == 1
    port.clear()
    assert port.is_empty and port.inserts.shape == (0, 3)


def test_delta_apply_keeps_base_duplicates():
    ref, port = R.DeltaOverlay(), P.DeltaOverlay("cpu")
    base = np.array([[1, 0, 2], [1, 0, 2], [3, 0, 4]])
    for d, t in ((ref, np.asarray), (port, torch.from_numpy)):
        d.insert_rows(t(np.array([[5, 1, 6]])))
        d.delete_rows(t(np.array([[3, 0, 4]])))
    got = port.apply(torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), ref.apply(base))
    assert _rows(got) == {(1, 0, 2), (5, 1, 6)}
    assert got.shape[0] == 3  # both copies of a surviving base row are kept


def test_delta_load_rows_adopts_rows():
    port = P.DeltaOverlay("cpu")
    port.load_rows(np.array([[1, 0, 2]]), np.zeros((0, 3), np.int64))
    assert port.n_inserts == 1 and port.inserts.dtype == torch.int64
    assert port.apply(torch.zeros((0, 3), dtype=torch.int64)).tolist() == [[1, 0, 2]]


@pytest.mark.parametrize("value,want", [(None, 4096), (0, 0), (7, 7), (128, 128), (-1, None),
                                        (-5, None)])
def test_resolve_delta_budget_values(value, want):
    assert P.resolve_delta_budget(value) == want
    if value is not None:  # explicit values: the reference's rule
        assert R.resolve_delta_budget(value) == want
    assert P_delta.DEFAULT_DELTA_BUDGET == R_delta.DEFAULT_DELTA_BUDGET


def test_resolve_delta_budget_ignores_the_reference_knob(monkeypatch):
    # the reference's budget environment knob, named as its source names it
    knob = re.search(r"[A-Z]+_DELTA_BUDGET", inspect.getsource(R_delta)).group(0)
    monkeypatch.setenv(knob, "off")
    assert R.resolve_delta_budget() is None
    assert P.resolve_delta_budget() == 4096
    _, port = _pair(_unique_triples(0), delta_budget=7)
    assert port.delta_budget == 7


def test_delta_rows_helpers_match_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, (40, 3))
    b = rng.integers(0, 4, (25, 3))
    np.testing.assert_array_equal(P_delta.rows_in(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  R_delta.rows_in(a, b))
    np.testing.assert_array_equal(P_delta.as_triple_rows(a, "cpu").numpy(),
                                  R_delta.as_triple_rows(a))
    assert P_delta.rows_in(torch.from_numpy(a), torch.zeros((0, 3), dtype=torch.int64)).sum() == 0


# ------------------------------------------------------- batch validation
@pytest.mark.parametrize("bad", [np.array([[1, 2]]), np.array([[-1, 0, 2]]),
                                 np.array([[1, N_PREDS, 2]]), np.array([1, 0, 2])])
def test_mutation_batch_validation(bad):
    ref, port = _pair(_unique_triples(0))
    for eng in (ref, port):
        with pytest.raises(ValueError):
            eng.insert_triples(bad)
    assert port.insert_triples(np.zeros((0, 3), dtype=np.int64)) == 0
    assert port.delete_triples(np.zeros((0, 3), dtype=np.int64)) == 0
    assert port.delta.is_empty


def test_mutation_rejects_node_label_predicates():
    # a rank-1 terminal (an ITR+ node label) is not a triple predicate
    g = R.Hypergraph.from_triples(_unique_triples(0), N_NODES)
    ref, port = _pair_from_graph(g, R.LabelTable.terminals([2] * N_PREDS + [1]))
    for eng in (ref, port):
        with pytest.raises(ValueError):
            eng.insert_triples(np.array([[1, N_PREDS, 2]]))
    assert port.insert_triples(np.array([[1, 0, 2]])) == ref.insert_triples(np.array([[1, 0, 2]]))


def test_insert_keeps_tensors_on_the_engines_device():
    _, port = _pair(_unique_triples(0))
    rows = torch.tensor([[1, 0, 20], [1, 0, 20], [0, 2, 21]])  # past the base's nodes
    assert port.insert_triples(rows) == 2
    assert port.delta.inserts.device == port.device
    got = port.contains_triples(rows)
    assert got.dtype == torch.bool and got.tolist() == [True, True, True]


# ------------------------------------------------------------ engine level
@pytest.mark.parametrize("seed", [1, 8, 9])
def test_engine_overlay_parity_and_rebuild(seed):
    base = _unique_triples(seed)
    ref, port = _pair(base)
    logical, probes = _mutate_both(ref, port, base)
    assert not port.delta.is_empty
    np.testing.assert_array_equal(port.current_triples().numpy(), ref.current_triples())
    assert _rows(port.current_triples()) == _rows(logical)
    oracle = _oracle(logical)
    _assert_parity(ref, port, oracle, probes)
    # rebuild recompresses base + delta; answers must not change, and the
    # grammar must equal the reference's rebuilt grammar bit for bit
    assert port.rebuild() is True and ref.rebuild() is True
    assert port.delta.is_empty and port.rebuild_count == ref.rebuild_count == 1
    assert_same_grammar(ref.grammar, port.grammar)
    assert port.base_edges == ref.base_edges == len(logical)
    assert port.rebuild() is False  # empty overlay: nothing to do
    _assert_parity(ref, port, oracle, probes)


def test_engine_insert_grows_node_universe_on_rebuild():
    base = _unique_triples(2)
    ref, port = _pair(base)
    for eng in (ref, port):
        assert eng.insert_triples(np.array([[1, 0, 99]])) == 1
        assert (0, (1, 99)) in eng.query(1, 0, None)   # the overlay answers
        assert eng.query(99, None, None) == []          # 99 has no out-edges
        eng.rebuild()
        assert eng.grammar.start.n_nodes >= 100
        assert (0, (1, 99)) in eng.query(1, 0, None)   # the grammar answers
    assert port.grammar.start.n_nodes == ref.grammar.start.n_nodes
    assert_same_grammar(ref.grammar, port.grammar)


def test_engine_auto_rebuild_at_budget_zero():
    base = _unique_triples(3)
    ref, port = _pair(base, delta_budget=0)  # recompress after every mutation
    assert port.insert_triples(np.array([[2, 1, 5]])) == ref.insert_triples(np.array([[2, 1, 5]]))
    assert port.delta.is_empty and ref.delta.is_empty  # a no-op or rebuilt at once
    assert port.rebuild_count == ref.rebuild_count
    assert_same_grammar(ref.grammar, port.grammar)


def test_engine_auto_rebuild_at_budget_two():
    base = _unique_triples(3)
    ref, port = _pair(base, delta_budget=2)
    new_rows = np.array([[0, 0, 14], [14, 1, 0], [7, 2, 8]])
    new_rows = new_rows[~np.array([tuple(r) in _rows(base) for r in new_rows.tolist()])]
    assert len(new_rows) == 3
    for eng in (ref, port):
        eng.insert_triples(new_rows[:1])
        assert eng.rebuild_count == 0                 # within budget
        eng.insert_triples(new_rows[1:])
        assert eng.rebuild_count == 1 and eng.delta.is_empty
    assert_same_grammar(ref.grammar, port.grammar)
    assert _rows(port.base_triples()) == _rows(base) | _rows(new_rows)


def test_rebuild_reuses_build_config():
    """An automatic rebuild compresses with the config the engine was
    built with (``max_iters=0``: no rules at all), not the defaults."""
    base = _unique_triples(13)
    ref, port = _pair(base, config=R.RepairConfig(max_iters=0),
                      port_config=P.RepairConfig(max_iters=0), delta_budget=0)
    cfg = port.config
    rows = np.array([[0, 1, 14], [14, 0, 0]])
    rows = rows[~np.array([tuple(r) in _rows(base) for r in rows.tolist()])]
    assert port.insert_triples(rows) == ref.insert_triples(rows) == len(rows)
    for eng in (ref, port):
        assert eng.delta.is_empty and eng.rebuild_count == 1
        assert len(eng.grammar.rules) == 0  # the max_iters=0 config survived
    assert port.config is cfg
    assert_same_grammar(ref.grammar, port.grammar)


def test_rebuild_takes_a_config_argument():
    base = _unique_triples(14)
    ref, port = _pair(base)
    for eng in (ref, port):
        assert eng.insert_triples(np.array([[0, 0, 20]])) == 1
    assert port.rebuild(P.RepairConfig(max_iters=1)) and ref.rebuild(R.RepairConfig(max_iters=1))
    assert len(port.grammar.rules) == 1
    assert port.config.max_iters == ref.config.max_iters == 1  # later rebuilds reuse it
    assert_same_grammar(ref.grammar, port.grammar)


def test_query_fast_path_includes_overlay():
    """The cache-less selective fast path must not bypass the overlay."""
    base = _unique_triples(4)
    ref, port = _pair(base, crossover=4)  # fast path active (crossover >= 1)
    s, p, o = map(int, base[0])
    for eng in (ref, port):
        assert eng.cache is None
        eng.insert_triples(np.array([[1, 0, 13]]))
        assert (0, (1, 13)) in eng.query(1, None, None)
        eng.delete_triples(base[:1])
        assert (p, (s, o)) not in eng.query(s, p, o)
    for q in ((1, None, None), (s, None, None), (None, None, o), (s, p, o)):
        assert _canon(port.query(*q)) == _canon(ref.query(*q))


def test_query_takes_the_worklist_only_without_cache_and_overlay(monkeypatch):
    base = _unique_triples(4)
    _, port = _pair(base, crossover=4)
    calls = []
    real = port.query_scalar
    monkeypatch.setattr(port, "query_scalar", lambda *q: calls.append(q) or real(*q))
    s = int(base[0, 0])
    port.query(s, None, None)
    assert len(calls) == 1                 # no cache, empty overlay: the worklist
    port.insert_triples(np.array([[1, 0, 13]]))  # its membership probe: one worklist query
    del calls[:]
    port.query(s, None, None)
    assert calls == [(s, None, None)]      # the batch of one takes it, inside the dispatch
    port.delta.clear()
    port.cache = P.QueryResultCache()
    port.query(s, None, None)
    port.query(s, None, None)              # a cache hit runs nothing
    assert len(calls) == 2


def test_neighbors_include_overlay():
    base = _unique_triples(5)
    ref, port = _pair(base)
    for eng in (ref, port):
        eng.insert_triples(np.array([[3, 1, 11]]))
        assert 11 in eng.neighbors_out(3).tolist()
        assert 3 in eng.neighbors_in(11).tolist()
    vs = list(range(N_NODES + 2)) + [3, 3]
    for got, want in ((port.neighbors_out_batch(vs), ref.neighbors_out_batch(vs)),
                      (port.neighbors_in_batch(vs), ref.neighbors_in_batch(vs))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("cached", [False, True])
def test_negative_ids_have_no_neighbours_whatever_the_overlay_holds(cached):
    """Deliberate divergence (ROADMAP C): the reference maps a negative id
    to row ``n_rows``, so an insert at that row leaks into its answer; in
    the port a negative id has no neighbours."""
    base = _unique_triples(0)
    ref, port = _pair(base, cache=cached)
    assert ref.encoded.incidence.n_rows == port.incidence.n_rows == N_NODES
    rows = np.array([[N_NODES, 0, 3], [4, 1, N_NODES]])
    assert port.insert_triples(rows) == ref.insert_triples(rows) == 2
    assert ref.neighbors_out(-1).tolist() == [3]   # the reference's answer
    assert ref.neighbors_in(-1).tolist() == [4]
    assert port.neighbors_out(-1).tolist() == []   # the port's
    assert port.neighbors_in(-1).tolist() == []
    # the real node n_rows keeps its neighbours on both
    assert port.neighbors_out(N_NODES).tolist() == ref.neighbors_out(N_NODES).tolist() == [3]
    assert port.neighbors_in(N_NODES).tolist() == ref.neighbors_in(N_NODES).tolist() == [4]
    outs = port.neighbors_out_batch([-1, N_NODES, -7, 4])
    assert [t.tolist() for t in outs] == [[], [3], [], port.neighbors_out(4).tolist()]
    assert outs[0] is outs[2]


def test_mutation_bumps_engine_cache_generation():
    base = _unique_triples(6)
    ref, port = _pair(base, cache=True)
    s = int(base[0][0])
    for eng in (ref, port):
        warm = eng.query(s, None, None)
        assert eng.query(s, None, None) == warm  # the cache-hit path
        gen = eng.cache.generation()
        eng.insert_triples(np.array([[s, 0, 12], [s, 0, 13]]))
        assert eng.cache.generation() > gen
        got = eng.query(s, None, None)
        assert (0, (s, 12)) in got and (0, (s, 13)) in got  # no stale entry
    assert vars(port.cache.stats) == vars(ref.cache.stats)
    assert port.cache.generation() == ref.cache.generation()


def test_a_no_op_mutation_keeps_the_cache_warm():
    base = _unique_triples(6)
    ref, port = _pair(base, cache=True)
    absent = np.array([[r, 2, c] for r in range(N_NODES) for c in range(N_NODES)
                       if (r, 2, c) not in _rows(base)][:3])
    for eng in (ref, port):
        eng.query(int(base[0, 0]), None, None)
        gen = eng.cache.generation()
        assert eng.insert_triples(base[:3]) == 0    # all visible already
        assert eng.delete_triples(absent) == 0      # none present
        assert eng.cache.generation() == gen and len(eng.cache) == 1
    assert vars(port.cache.stats) == vars(ref.cache.stats)


def test_contains_triples_matches_reference():
    base = _unique_triples(7)
    ref, port = _pair(base, cache=True)
    for eng in (ref, port):
        eng.insert_triples(np.array([[0, 0, 14], [14, 2, 1]]))
        eng.delete_triples(base[:3])
    probe = np.concatenate([base[:6], [[0, 0, 14], [14, 2, 1], [14, 2, 1], [99, 0, 0]]])
    np.testing.assert_array_equal(port.contains_triples(probe).numpy(),
                                  ref.contains_triples(probe))
    assert port.contains_triples(np.zeros((0, 3), np.int64)).numel() == 0
    with pytest.raises(ValueError):
        port.contains_triples(np.array([[1, 2]]))
    assert len(port.cache) == 0 and port.cache.stats.lookups == 0  # the probe is cache-detached


# ------------------------------------------------- from_numpy_state engines
def test_from_numpy_state_engine_mutates_but_cannot_rebuild(tmp_path):
    base = _unique_triples(10)
    ref, _ = _pair(base)
    arrays, meta = _load_reference_state(ref, tmp_path)
    port = P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu")
    assert isinstance(port.cache, P.QueryResultCache) and port.delta_budget is None
    rows = np.array([[0, 0, 14], [20, 1, 3]])
    assert port.insert_triples(rows) == ref.insert_triples(rows)
    assert port.delete_triples(base[:2]) == ref.delete_triples(base[:2])
    with pytest.raises(ValueError):
        port.insert_triples(np.array([[1, N_PREDS, 2]]))   # checked against table_ranks
    for q in ((0, None, None), (None, None, 3), (None, 1, None), (20, 1, 3)):
        assert _canon(port.query(*q)) == _canon(ref.query(*q))
    for what in ("base_triples", "current_triples", "rebuild"):
        with pytest.raises(NotImplementedError, match="load_snapshot"):
            getattr(port, what)()
    with pytest.raises(ValueError):
        P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu", delta_budget=8)


# ----------------------------------------------- random interleavings
def _random_step_rows(rng, n, n_nodes, preds, visible):
    """n rows, half drawn from the visible set (when it has any), half new."""
    out = []
    vis = sorted(visible)
    for _ in range(n):
        if vis and rng.random() < 0.5:
            out.append(vis[int(rng.integers(0, len(vis)))])
        else:
            out.append((int(rng.integers(0, n_nodes + 3)), int(rng.choice(preds)),
                        int(rng.integers(0, n_nodes + 3))))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _compare_queries(rng, ref, port, n_nodes, n_labels):
    qs = []
    for _ in range(6):
        s, p, o = (int(rng.integers(0, n_nodes + 3)), int(rng.integers(0, n_labels)),
                   int(rng.integers(0, n_nodes + 3)))
        qs.append(_bind(PATTERN_NAMES[int(rng.integers(0, 8))], s, p, o))
    for q in qs:
        assert _canon(port.query(*q)) == _canon(ref.query(*q)), q
    got, want = port.query_batch(*zip(*qs)), ref.query_batch(*zip(*qs))
    assert [_canon(a) for a in got] == [_canon(a) for a in want]
    vs = rng.integers(0, n_nodes + 3, 4).tolist()
    for g, w in zip(port.neighbors_out_batch(vs), ref.neighbors_out_batch(vs)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_random_interleaving_on_triple_graphs(seed, cached):
    rng = np.random.default_rng(100 + seed)
    base = _unique_triples(200 + seed, n_edges=50)
    ref, port = _pair(base, cache=cached, crossover=int(rng.integers(0, 3)),
                      delta_budget=int(rng.integers(3, 12)))
    logical = _rows(base)
    for _ in range(14):
        op = rng.choice(["insert", "delete", "query", "rebuild"], p=[0.35, 0.3, 0.25, 0.1])
        if op in ("insert", "delete"):
            rows = _random_step_rows(rng, int(rng.integers(1, 5)), N_NODES, range(N_PREDS), logical)
            want = _rows(rows)
            expected = len(want - logical) if op == "insert" else len(want & logical)
            name = f"{op}_triples"
            assert getattr(port, name)(rows) == getattr(ref, name)(rows) == expected
            logical = logical | want if op == "insert" else logical - want
        elif op == "rebuild":
            assert port.rebuild() == ref.rebuild()
        else:
            _compare_queries(rng, ref, port, N_NODES, N_PREDS)
        _same_overlay(ref, port)
        assert _rows(port.current_triples()) == _rows(ref.current_triples()) == logical
        assert_same_grammar(ref.grammar, port.grammar)
    _compare_queries(rng, ref, port, N_NODES, N_PREDS)


@pytest.mark.parametrize("seed", range(6))
def test_random_interleaving_on_hypergraphs_of_ranks_1_to_3(seed):
    """Ranks 1-3 as the base: triple mutations on the rank-2 labels, every
    pattern queried, and a rebuild refused alike (not a triple set)."""
    rng = np.random.default_rng(300 + seed)
    ranks = [2, 2, 1, 3]
    table = R.LabelTable.terminals(ranks)
    edges = []
    for _ in range(40):
        lbl = int(rng.integers(0, len(ranks)))
        edges.append((lbl, rng.integers(0, 12, ranks[lbl]).tolist()))
    ref, port = _pair_from_graph(R.Hypergraph.from_edges(12, edges), table,
                                 cache=bool(seed % 2), crossover=int(rng.integers(0, 3)))
    visible = {(nd[0], lbl, nd[1]) for lbl, nd in edges if len(nd) == 2}
    for _ in range(10):
        op = rng.choice(["insert", "delete", "query", "rebuild"], p=[0.35, 0.3, 0.25, 0.1])
        if op in ("insert", "delete"):
            rows = _random_step_rows(rng, int(rng.integers(1, 5)), 12, [0, 1], visible)
            want = _rows(rows)
            expected = len(want - visible) if op == "insert" else len(want & visible)
            name = f"{op}_triples"
            assert getattr(port, name)(rows) == getattr(ref, name)(rows) == expected
            visible = visible | want if op == "insert" else visible - want
        elif op == "rebuild" and not ref.delta.is_empty:
            for eng in (ref, port):
                with pytest.raises(ValueError):
                    eng.rebuild()
        else:
            _compare_queries(rng, ref, port, 12, len(ranks))
        _same_overlay(ref, port)
    _compare_queries(rng, ref, port, 12, len(ranks))
