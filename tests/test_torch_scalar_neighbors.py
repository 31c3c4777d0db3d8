"""The port's scalar worklist, crossover dispatch and neighbourhood queries
against the reference, on the CPU.

``K2Tree.row`` / ``col``, ``query_scalar``, ``query``, ``query_batch``, the
crossover dispatch, ``from_numpy_state(..., crossover)`` and the four
neighbourhood entry points of ``repro_torch`` are held against
``repro.core`` on the same inputs: per-query result multisets equal (sorted),
neighbour arrays equal element for element. The oracles are the
reference's own (``query_oracle``, ``query_scalar``, the neighbour tests'
graphs and settings), called through the port's API.
"""
import inspect
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro_torch.core as P
from repro.core.succinct import K2Tree as RK2Tree
from repro_torch.core.succinct import K2Tree as PK2Tree
from tests.test_itr_core import random_hypergraph
from tests.test_torch_build import DATASETS, both_graphs, port_hypergraph
from tests.test_torch_query import _load_reference_state
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERNS = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]
SELECTIVE = [p for p in PATTERNS if p[0] != "?" or p[2] != "?"]


def _canon(results):
    return sorted((int(lbl), tuple(int(v) for v in nodes)) for lbl, nodes in results)


def _queries(ds, pattern, n=12, seed=0):
    """n (s, p, o) queries of `pattern` from the triples, None where
    unbound, with out-of-range ids mixed in."""
    rng = np.random.default_rng(seed)
    pick = ds.triples[rng.integers(0, len(ds.triples), n)].tolist()
    pick[-1] = [ds.n_nodes + 3, ds.n_preds + 2, ds.n_nodes + 9]
    pick[-2] = [ds.n_nodes, 0, 0]
    return [tuple(q[i] if pattern[i] != "?" else None for i in range(3)) for q in pick]


# ------------------------------------------------------------- K2Tree rows
@pytest.mark.parametrize("k,n_rows,n_cols,n_pts", [
    (2, 31, 31, 60), (3, 40, 17, 100), (4, 9, 50, 40), (2, 70, 300, 500), (3, 5, 5, 0)])
def test_k2tree_row_and_col_match_reference(k, n_rows, n_cols, n_pts):
    rng = np.random.default_rng(7 * k + n_pts)
    r, c = rng.integers(0, n_rows, n_pts), rng.integers(0, n_cols, n_pts)
    ref = RK2Tree(r, c, n_rows, n_cols, k=k)
    port = PK2Tree(torch.from_numpy(r), torch.from_numpy(c), n_rows, n_cols, k=k, device="cpu")
    for i in range(-2, n_rows + 3):
        np.testing.assert_array_equal(port.row(i).numpy(), ref.row(i))
    for j in range(-2, n_cols + 3):
        np.testing.assert_array_equal(port.col(j).numpy(), ref.col(j))


# ------------------------------------------------- engines on the datasets
def _engines(name, crossover=8):
    ds = DATASETS[name]()
    (rg, rt), (pg, pt) = both_graphs(ds)
    ref_g, _ = R.compress(rg, rt)
    port_g, _ = P.compress(pg, pt)
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=0, delta_budget=None)
    return ds, rg, ref, P.TripleQueryEngine(port_g, cache=None, crossover=crossover, delta_budget=None)


@pytest.fixture(scope="module", params=sorted(DATASETS))
def engines(request):
    return _engines(request.param)


def _port_answers(port, entry, queries):
    if entry == "query_scalar":
        return [port.query_scalar(*q) for q in queries]
    if entry == "query":
        return [port.query(*q) for q in queries]
    return port.query_batch(*zip(*queries))


@pytest.mark.parametrize("entry", ["query_scalar", "query", "query_batch"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_scalar_entries_match_reference(engines, entry, pattern):
    ds, graph, ref, port = engines
    queries = _queries(ds, pattern, n=4 if pattern == "???" else 12)
    got = _port_answers(port, entry, queries)
    assert len(got) == len(queries)
    for q, answer in zip(queries, got):
        want = _canon(ref.query_scalar(*q))
        assert _canon(answer) == want, q
        assert want == _canon(R.query_oracle(graph, *q)), q


@pytest.mark.parametrize("crossover", [0, 8])
def test_query_batch_matches_reference_at_either_crossover(engines, crossover):
    ds, graph, ref, port = engines
    port.crossover = crossover
    try:
        queries = [q for pat in SELECTIVE for q in _queries(ds, pat, n=3, seed=4)]
        for w in (1, 2, len(queries)):  # under, at and past the crossover
            batch = queries[:w]
            got = port.query_batch(*zip(*batch))
            want = ref.query_batch(*zip(*batch))
            assert [_canon(a) for a in got] == [_canon(a) for a in want]
    finally:
        port.crossover = 8


def test_nt_rows_fill_every_rule_once(engines, monkeypatch):
    ds, _, ref, port = engines
    assert port.nt_k2 is not None  # every dataset's grammar has rules
    port._nt_rows = None
    calls = []
    real = port.nt_k2.rows_many
    monkeypatch.setattr(port.nt_k2, "rows_many", lambda rs: calls.append(rs) or real(rs))
    for q in _queries(ds, "?p?") + _queries(ds, "?po"):
        port.query_scalar(*q)
    assert len(calls) == 1
    assert sorted(port._nt_rows) == sorted(ref._rules)
    for lbl in ref._rules:
        assert port._nt_rows[lbl] == set(ref.nt_k2.row(lbl - ref.T).tolist())


def test_host_structures_equal_the_reference(engines):
    _, _, ref, port = engines
    assert port._rules.keys() == ref._rules.keys()
    for lbl, body in ref._rules.items():
        assert port._rules[lbl] == [(c, tuple(int(v) for v in prm)) for c, prm in body]
    assert port._edge_cache == [(lbl, tuple(int(v) for v in nd)) for lbl, nd in ref._edge_cache]


# ------------------------------------------------- random grammars, rank 1-3
def _random_pair(seed, n_nodes, n_edges):
    rng = np.random.default_rng(seed)
    g, table = random_hypergraph(rng, n_nodes=n_nodes, n_edges=n_edges)
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(*port_hypergraph(g, table))
    return rng, g, ref_g, port_g


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_crossover_dispatch_parity_random_grammars(seed):
    rng, g, ref_g, port_g = _random_pair(seed, 12, 40)
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=0, delta_budget=None)
    port = P.TripleQueryEngine(port_g, cache=None, crossover=8, delta_budget=None)
    s = int(rng.integers(0, 12))
    p = int(rng.integers(0, 3))
    queries = [(s, None, None), (None, None, s), (s, p, None), (None, p, s),
               (None, p, None), (None, None, None), (s, p, s), (s, None, s)]
    for q in queries:
        want = _canon(R.query_oracle(g, *q))
        assert _canon(port.query(*q)) == want, q
        assert _canon(port.query_scalar(*q)) == _canon(ref.query_scalar(*q)) == want, q
    for w in (1, 4, len(queries)):
        got = port.query_batch(*zip(*queries[:w]))
        assert [_canon(a) for a in got] == [_canon(R.query_oracle(g, *q)) for q in queries[:w]]


def _ref_scalar_neighbors(ref, v: int, slot: int) -> np.ndarray:
    """The reference's neighbour oracle: distinct nodes in tuple position
    `slot` of the edges matching (v ? ?) / (? ? v), by its worklist."""
    res = ref.query_scalar(v if slot == 1 else None, None, v if slot == 0 else None)
    return np.array(sorted({int(nd[slot]) for _, nd in res if len(nd) > slot}), dtype=np.int64)


@pytest.mark.parametrize("crossover", [0, 8])
@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_neighbors_batch_parity_random_grammars(crossover, seed):
    rng, _, ref_g, port_g = _random_pair(seed, 13, 45)
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=0, delta_budget=None)
    port = P.TripleQueryEngine(port_g, cache=None, crossover=crossover, delta_budget=None)
    vs = rng.integers(0, 13, 6).tolist() + [0, 0]  # duplicates exercise dedup
    outs, ins = port.neighbors_out_batch(vs), port.neighbors_in_batch(vs)
    assert len(outs) == len(vs) and len(ins) == len(vs)
    ref_outs, ref_ins = ref.neighbors_out_batch(vs), ref.neighbors_in_batch(vs)
    for v, got_out, got_in, want_out, want_in in zip(vs, outs, ins, ref_outs, ref_ins):
        np.testing.assert_array_equal(got_out.numpy(), want_out)
        np.testing.assert_array_equal(got_in.numpy(), want_in)
        np.testing.assert_array_equal(got_out.numpy(), _ref_scalar_neighbors(ref, v, 1))
        np.testing.assert_array_equal(got_in.numpy(), _ref_scalar_neighbors(ref, v, 0))
        np.testing.assert_array_equal(port.neighbors_out(v).numpy(), ref.neighbors_out(v))
        np.testing.assert_array_equal(port.neighbors_in(v).numpy(), ref.neighbors_in(v))
    assert outs[-1] is outs[-2] and ins[-1] is ins[-2]  # duplicates share one tensor


def _tiny_engines(crossover):
    triples = np.array([[0, 0, 1], [0, 1, 2], [3, 0, 0], [2, 1, 0]])
    ref_g, _ = R.compress(R.Hypergraph.from_triples(triples, 4), R.LabelTable.terminals([2, 2]))
    port_g, _ = P.compress(P.Hypergraph.from_triples(triples, 4, device="cpu"),
                           P.LabelTable.terminals([2, 2], device="cpu"))
    return R.TripleQueryEngine(ref_g), P.TripleQueryEngine(port_g, cache=None, crossover=crossover, delta_budget=None)


@pytest.mark.parametrize("crossover", [None, 0, 8])
def test_neighborhood_queries_tiny_graph(crossover):
    ref, port = _tiny_engines(crossover)
    assert port.neighbors_out(0).tolist() == [1, 2] == ref.neighbors_out(0).tolist()
    assert port.neighbors_in(0).tolist() == [2, 3] == ref.neighbors_in(0).tolist()
    for v in range(4):
        np.testing.assert_array_equal(port.neighbors_out(v).numpy(), ref.neighbors_out(v))
        np.testing.assert_array_equal(port.neighbors_in(v).numpy(), ref.neighbors_in(v))


@pytest.mark.parametrize("crossover", [0, 8])
def test_neighbors_negative_out_of_range_and_duplicates(engines, crossover):
    ds, _, ref, port = engines
    port.crossover = crossover
    try:
        big = port.incidence.n_rows + 7
        v0 = int(ds.triples[0, 0])
        vs = [-1, big, v0, -3, v0, ds.n_nodes, v0]
        for got, want in ((port.neighbors_out_batch(vs), ref.neighbors_out_batch(vs)),
                          (port.neighbors_in_batch(vs), ref.neighbors_in_batch(vs))):
            assert len(got) == len(vs)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
                assert g.dtype == torch.int64
            for i in (0, 1, 3, 5):
                assert got[i].numel() == 0
            assert got[2] is got[4] is got[6]
        assert port.neighbors_out(-1).numel() == 0 and port.neighbors_in(big).numel() == 0
        assert port.neighbors_out_batch([]) == []
    finally:
        port.crossover = 8


# ------------------------------------------------------------- crossover
def test_crossover_none_is_measured_within_bounds():
    _, _, _, port = _engines("version_graph", crossover=None)
    assert 0 <= port.crossover <= 8
    assert set(port.calibration) == {"scalar_s", "frontier_s"}
    assert all(t > 0 for t in port.calibration.values())


@pytest.mark.parametrize("given_width,expected", [(0, 0), (-3, 0), (5, 5), (20, 20)])
def test_crossover_as_given_and_negative_clamps(given_width, expected):
    _, _, _, port = _engines("version_graph", crossover=given_width)
    assert port.crossover == expected and port.calibration is None


def test_crossover_zero_never_enters_the_worklist(monkeypatch):
    ds, graph, _, port = _engines("web_graph", crossover=0)

    def refuse(*a):
        raise AssertionError("the worklist ran at crossover 0")

    monkeypatch.setattr(port, "_run_scalar_batch", refuse)
    v = int(ds.triples[0, 0])
    q = (v, None, None)
    assert _canon(port.query(*q)) == _canon(R.query_oracle(graph, *q))
    port.query_batch([v], [None], [None])
    port.query_batch_view([v], [None], [None])
    port.query_batch_arrays([v], None, None)
    port.neighbors_out(v)
    port.neighbors_in_batch([v, v])


def test_crossover_takes_the_worklist_only_for_selective_narrow_batches(monkeypatch):
    ds, _, _, port = _engines("web_graph", crossover=2)
    widths = []
    real = port._run_scalar_batch
    monkeypatch.setattr(port, "_run_scalar_batch", lambda s, p, o: widths.append(s.numel())
                        or real(s, p, o))
    a, b, c = (int(x) for x in np.unique(ds.triples[:, 0])[:3])  # distinct subjects
    port.query_batch_view([a], None, None)               # 1 <= 2, selective
    port.query_batch_view([a, b], None, [None, None])    # 2 <= 2
    port.query_batch_view([a, b, c], None, None)         # 3 > 2: frontier
    port.query_batch_view([a, None], [None, 0], None)    # ?p? inside: frontier
    port.query_batch_view(None, [0], None)               # only P bound: frontier
    assert widths == [1, 2]


def test_crossover_ignores_the_reference_knob(monkeypatch):
    # the reference's crossover environment knob, named as its source names it
    src = inspect.getsource(R.TripleQueryEngine._calibrate_crossover)
    knob = re.search(r"[A-Z]+_QUERY_CROSSOVER", src).group(0)
    monkeypatch.setenv(knob, "5")
    for width in (0, 3):
        assert _engines("version_graph", crossover=width)[3].crossover == width
    assert _engines("version_graph", crossover=None)[3].crossover <= 8


# ------------------------------------------------------- from_numpy_state
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_from_numpy_state_takes_the_manifest_crossover(name, tmp_path):
    ds = DATASETS[name]()
    (rg, rt), _ = both_graphs(ds)
    ref_g, _ = R.compress(rg, rt)
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=5, delta_budget=None)
    arrays, meta = _load_reference_state(ref, tmp_path)
    assert meta["crossover"] == 5
    port = P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu", cache=None)
    assert port.crossover == 5 and port.encoded is None
    assert P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu",
                                                crossover=0, cache=None).crossover == 0
    for pattern in PATTERNS:
        for q in _queries(ds, pattern, n=4 if pattern == "???" else 8, seed=2):
            want = _canon(ref.query_scalar(*q))
            assert _canon(port.query_scalar(*q)) == want, (pattern, q)
            assert _canon(port.query(*q)) == want, (pattern, q)
