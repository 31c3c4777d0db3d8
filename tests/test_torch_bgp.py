"""The port's BGP join layer (``repro_torch.core.bgp`` and the engine's
``selectivity`` / ``query_bgp``) against the reference, on the CPU.

Parsing, the canonical form and ``bgp_cache_key`` equal the reference's.
``SelectivityStats`` equal the reference's exactly on random graphs, the
synthetic datasets, an ITR+ grammar, an opened snapshot and a
``from_numpy_state`` engine, and so does ``plan_bgp``. ``query_bgp`` gives
the reference's rows bit for bit and the brute-force oracle's
(``tests/_bgp_oracle.py``), in both join modes (``_BIND_FANOUT`` patched to
0 forces scan + hash joins, as the reference's tests do), over the
frontier and the worklist, on chains, stars, cycles, cartesian products,
repeated variables, constants-only patterns, empty intermediates and
zero-row tables; under the overlay and the cache and after a rebuild.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.bgp as R_bgp
import repro.core.itr_plus as R_plus
import repro_torch.core as P
import repro_torch.core.bgp as P_bgp
from _bgp_oracle import oracle_bgp
from repro.data.synthetic import version_graph
from repro.persist.snapshot import save_snapshot as ref_save_snapshot
from repro_torch.persist.snapshot import load_snapshot
from tests.test_bgp import _rows as fixed_rows
from tests.test_itr_core import random_hypergraph
from tests.test_torch_build import DATASETS, port_hypergraph
from tests.test_torch_query import _load_reference_state
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_NODES, N_PREDS = 16, 4

SHAPES = {
    "single": "?x 1 ?y",
    "chain2": "?x 0 ?y . ?y 1 ?z",
    "chain3": "?x 0 ?y . ?y 1 ?z . ?z 2 ?w",
    "chain3_same_pred": "?a 0 ?b . ?b 0 ?c . ?c 0 ?d",
    "star2": "?h 0 ?a . ?h 1 ?b",
    "star3": "?h 0 ?a . ?h 1 ?b . ?h 2 ?c",
    "star2_same_pred": "?h 0 ?a . ?h 0 ?b",
    "cycle2": "?a 0 ?b . ?b 0 ?a",
    "cycle3": "?x 0 ?y . ?y 0 ?z . ?z 0 ?x",
    "cartesian": "?a 3 ?b . ?c 2 ?d",
    "pred_var": "?a ?p ?b . ?b 3 ?c",
    "all_var_step": "?s ?p ?o . ?o 1 ?w",
    "two_pred_vars": "?x ?p ?y . ?y ?q ?z",
    "self_loop": "?x 0 ?x",
    "repeated_pred_slot": "?x ?p ?x",
    "var_in_s_and_p": [("?x", "?x", "?y")],
    "bound_const_object": "?x 0 ?y . ?y 1 3",
    "const_subject": "7 ?p ?o . ?o ?q ?r",
    "unsatisfiable": "?x 0 ?y . ?y 3 15",
    "absent_constant": [(0, 3, 0)],
    "constants_present": [(1, 0, 2), ("?x", 0, "?y")],
    "constants_absent": [(15, 3, 15), ("?x", 0, "?y")],
    "constants_only_later": [("?x", 0, "?y"), (1, 0, 2)],
}


def _triple_set(rows):
    return [tuple(map(int, r)) for r in np.asarray(rows).reshape(-1, 3)]


def _pair_of(rows, n_nodes=N_NODES, n_preds=N_PREDS, **kwargs):
    """Reference and port (CPU) engines over the same triples."""
    kwargs.setdefault("cache", False)
    kwargs.setdefault("crossover", 0)
    kwargs.setdefault("delta_budget", None)
    cache = kwargs.pop("cache")
    g = R.Hypergraph.from_triples(rows, n_nodes)
    table = R.LabelTable.terminals([2] * n_preds)
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(*port_hypergraph(g, table))
    ref = R.TripleQueryEngine(ref_g, cache=R.QueryResultCache() if cache else None, **kwargs)
    port = P.TripleQueryEngine(port_g, cache=P.QueryResultCache() if cache else None, **kwargs)
    return ref, port


def _same_stats(ref_stats, port_stats):
    assert port_stats.total == ref_stats.total
    assert port_stats.pred_card.tolist() == np.asarray(ref_stats.pred_card).tolist()
    assert port_stats.pred_card.device.type == "cpu"
    assert (port_stats.n_subjects, port_stats.n_objects) == \
        (ref_stats.n_subjects, ref_stats.n_objects)


def _same_result(ref_res, port_res):
    """The port's BGPResult equals the reference's bit for bit."""
    assert port_res.vars == ref_res.vars
    assert port_res.rows.dtype == torch.int64
    assert tuple(port_res.rows.shape) == ref_res.rows.shape
    np.testing.assert_array_equal(port_res.rows.cpu().numpy(), ref_res.rows)


def _assert_oracle(port_res, triples, bgp):
    want_vars, want_rows = oracle_bgp(triples, bgp)
    assert list(port_res.vars) == list(want_vars)
    assert port_res.tuples() == want_rows


@pytest.fixture(scope="module")
def rows():
    return fixed_rows(extra_seed=3)


@pytest.fixture(scope="module")
def pair(rows):
    return _pair_of(rows)


@pytest.fixture(scope="module")
def worklist_pair(rows):
    return _pair_of(rows, crossover=8)


# -- parsing -----------------------------------------------------------------

PARSE_CASES = [
    "?x 0 ?y . ?y 1 17",
    "?s 0 ?t . ?t 1 17",
    "?x 0 ?y . ?x 1 17",
    " ?a ?p ?b .. ?b 3 ?c . ",
    [("?x", 0, "?y"), ("?y", np.int64(1), 17)],
    [("?x", "2", "?x")],
    "?b 0 ?a . ?c 1 ?a . ?a 2 ?d",
    "1 2 3",
]


@pytest.mark.parametrize("bgp", PARSE_CASES, ids=range(len(PARSE_CASES)))
def test_parse_canonical_and_cache_key_equal_reference(bgp):
    ref, port = R_bgp.parse_bgp(bgp), P_bgp.parse_bgp(bgp)
    assert [p.terms for p in port] == [p.terms for p in ref]
    assert [str(p) for p in port] == [str(p) for p in ref]
    assert P_bgp.bgp_variables(port) == R_bgp.bgp_variables(ref)
    assert P_bgp.canonical_bgp(port) == R_bgp.canonical_bgp(ref)
    assert P_bgp.bgp_cache_key(port) == R_bgp.bgp_cache_key(ref)
    assert all(k <= -2 for k in P_bgp.bgp_cache_key(port))
    assert P_bgp.parse_bgp(port[0]) == [port[0]]


BAD_BGPS = ["", "?x 0", "? 0 1", [("worksFor", 0, 1)], [(-1, 0, 1)], [(None, 0, 1)],
            [(1.5, 0, 1)], [("?x", 0)]]


@pytest.mark.parametrize("bgp", BAD_BGPS, ids=range(len(BAD_BGPS)))
def test_parse_rejects_what_the_reference_rejects(bgp):
    with pytest.raises((ValueError, TypeError)) as ref_exc:
        R_bgp.parse_bgp(bgp)
    with pytest.raises(ref_exc.type):
        P_bgp.parse_bgp(bgp)


# -- selectivity statistics and plans ----------------------------------------

def _random_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    rows = np.stack([rng.integers(0, 12, n), rng.integers(0, 3, n), rng.integers(0, 12, n)], 1)
    return R.Hypergraph.from_triples(rows, 12), R.LabelTable.terminals([2] * 3)


def _dataset_case(name):
    ds = DATASETS[name]()
    return (R.Hypergraph.from_triples(ds.triples, ds.n_nodes),
            R.LabelTable.terminals(np.full(ds.n_preds, 2)))


def _itr_plus_case():
    ds = version_graph(20, 9, 3, seed=2)
    g, t, _ = R_plus.attach_node_labels(R.Hypergraph.from_triples(ds.triples, ds.n_nodes),
                                        R.LabelTable.terminals(np.full(ds.n_preds, 2)),
                                        ds.node_labels)
    return g, t


def _hyper_case(seed):
    return random_hypergraph(np.random.default_rng(seed), n_nodes=14, n_edges=50)


STATS_CASES = {
    **{f"random{s}": (lambda s=s: _random_case(s)) for s in range(5)},
    **{name: (lambda name=name: _dataset_case(name)) for name in sorted(DATASETS)},
    "itr_plus": _itr_plus_case,
    **{f"hyper{s}": (lambda s=s: _hyper_case(s)) for s in range(3)},
    "empty": lambda: (R.Hypergraph.from_triples(np.zeros((0, 3), np.int64), 1),
                      R.LabelTable.terminals([2] * 2)),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_selectivity_equals_reference(case):
    g, table = STATS_CASES[case]()
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(*port_hypergraph(g, table))
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=0, delta_budget=None)
    port = P.TripleQueryEngine(port_g, cache=None, crossover=0, delta_budget=None)
    _same_stats(ref.selectivity(), port.selectivity())
    assert port.selectivity() is port.selectivity()  # computed once


@pytest.mark.parametrize("opened", ["snapshot", "from_numpy_state"])
def test_selectivity_of_opened_engines(opened, rows, tmp_path):
    ref, _ = _pair_of(rows)
    if opened == "snapshot":
        port = load_snapshot(ref_save_snapshot(ref, tmp_path / "snap"), device="cpu")
    else:
        arrays, meta = _load_reference_state(ref, tmp_path)
        port = P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu", cache=None)
    assert port._select_stats is None and port.term_dict is None
    _same_stats(ref.selectivity(), port.selectivity())
    for name in ("chain2", "star3", "pred_var"):
        _same_result(ref.query_bgp(SHAPES[name]), port.query_bgp(SHAPES[name]))


def test_selectivity_rejects_a_body_referencing_a_later_rule(pair):
    _, port = pair
    T = port.T
    rules = {T: [(0, (0, 1)), (T + 1, (1, 0))], T + 1: [(1, (0, 1))]}
    with pytest.raises(ValueError, match="earlier rules"):
        P_bgp.SelectivityStats.from_csr(port._sorted_labels, port._sorted_ranks,
                                        port._sorted_nodes, port._sorted_offsets, port.flat, T,
                                        rules=rules)


def _random_stats(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 6))
    card = rng.integers(0, 50, T)
    args = (int(card.sum()), int(rng.integers(1, 30)), int(rng.integers(1, 30)))
    return (R_bgp.SelectivityStats(args[0], card, args[1], args[2]),
            P_bgp.SelectivityStats(args[0], torch.from_numpy(card), args[1], args[2]))


PLAN_BGPS = ["?a 0 ?b . ?b 2 ?c", "?a 2 ?b . ?b 0 ?c . ?c 1 ?d",
             "?x ?p ?y . ?y 1 ?z . ?z ?p ?w", "?a 3 ?b . ?c 2 ?d . ?b 1 ?c",
             "?s ?p ?o . 4 ?p ?o . ?o 0 7", "1 2 3 . ?x 0 ?y . ?y 9 ?z"]


@pytest.mark.parametrize("seed", range(6))
def test_plan_and_costs_equal_reference(seed):
    ref_stats, port_stats = _random_stats(seed)
    for bgp in PLAN_BGPS:
        ref_pats, port_pats = R_bgp.parse_bgp(bgp), P_bgp.parse_bgp(bgp)
        for stats in ((ref_stats, port_stats), (None, None)):
            assert P_bgp.plan_bgp(port_pats, stats[1]) == R_bgp.plan_bgp(ref_pats, stats[0])
            for bound in (frozenset(), {"?a", "?b", "?y", "?p"}):
                for rp, pp in zip(ref_pats, port_pats):
                    assert P_bgp.pattern_cost(pp, bound, stats[1]) == \
                        R_bgp.pattern_cost(rp, bound, stats[0])
    for p in (None, 0, 3, 9, -1):
        for s_b in (False, True):
            assert port_stats.estimate(s_b, p, not s_b) == ref_stats.estimate(s_b, p, not s_b)


def test_merge_equals_reference():
    parts = [_random_stats(s) for s in range(4)]
    ref = R_bgp.SelectivityStats.merge([r for r, _ in parts])
    port = P_bgp.SelectivityStats.merge([p for _, p in parts])
    _same_stats(ref, port)
    _same_stats(R_bgp.SelectivityStats.merge([]), P_bgp.SelectivityStats.merge([]))


# -- execution ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bind", "scan", "worklist"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_query_bgp_equals_reference_and_oracle(shape, mode, rows, pair, worklist_pair,
                                               monkeypatch):
    bgp = SHAPES[shape]
    # with crossover 8, sub-batches of up to 8 S/O-bound patterns take the worklist
    ref, port = worklist_pair if mode == "worklist" else pair
    if mode == "scan":
        monkeypatch.setattr(R_bgp, "_BIND_FANOUT", 0)
        monkeypatch.setattr(P_bgp, "_BIND_FANOUT", 0)
    got = port.query_bgp(bgp)
    _same_result(ref.query_bgp(bgp), got)
    _assert_oracle(got, _triple_set(rows), bgp)


@pytest.mark.parametrize("seed", range(4))
def test_query_bgp_on_random_graphs_in_both_modes(seed, monkeypatch):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(20, 120))
    rows = np.unique(np.stack([rng.integers(0, N_NODES, n), rng.integers(0, 3, n),
                               rng.integers(0, N_NODES, n)], 1), axis=0)
    ref, port = _pair_of(rows)
    bgps = ["?x 0 ?y . ?y 1 ?z", "?h 0 ?a . ?h 1 ?b . ?h 2 ?c", "?x ?p ?y . ?y ?p ?z",
            "?a 0 ?b . ?b 0 ?a", "?x ?p ?x . ?x 1 ?y"]
    for fanout in (64, 0):
        monkeypatch.setattr(R_bgp, "_BIND_FANOUT", fanout)
        monkeypatch.setattr(P_bgp, "_BIND_FANOUT", fanout)
        for bgp in bgps:
            got = port.query_bgp(bgp)
            _same_result(ref.query_bgp(bgp), got)
            _assert_oracle(got, _triple_set(rows), bgp)


@pytest.mark.parametrize("order", [[0, 1, 2], [2, 1, 0], [1, 0, 2], [2, 0, 1]])
def test_forced_join_orders(order, pair, rows):
    ref, port = pair
    bgp = "?x 0 ?y . ?y 1 ?z . ?z 2 ?w"
    got = P_bgp.execute_bgp(bgp, port.query_batch_view, port.selectivity(), order=order)
    _same_result(R_bgp.execute_bgp(bgp, ref.query_batch_view, ref.selectivity(), order=order),
                 got)
    _assert_oracle(got, _triple_set(rows), bgp)


def test_execute_rejects_bad_order(pair):
    _, port = pair
    with pytest.raises(ValueError):
        P_bgp.execute_bgp("?x 0 ?y . ?y 1 ?z", port.query_batch_view, order=[0, 0])


def test_empty_intermediate_short_circuits(pair):
    _, port = pair
    calls = []

    def counting(s, p, o):
        calls.append(len(s))
        return port.query_batch_view(s, p, o)

    res = P_bgp.execute_bgp("?x 3 15 . ?x 0 ?y . ?y 1 ?z", counting, order=[0, 1, 2])
    assert len(res) == 0 and res.vars == ("?x", "?y", "?z")
    assert tuple(res.rows.shape) == (0, 3)
    assert calls == [1]


def test_zero_row_engine():
    ref, port = _pair_of(np.zeros((0, 3), dtype=np.int64), n_nodes=1)
    for bgp in ("?s ?p ?o . ?s 0 ?y", "?s 0 ?o", [(0, 0, 0)], "?x 1 ?y . ?y 1 ?x"):
        got = port.query_bgp(bgp)
        _same_result(ref.query_bgp(bgp), got)
        assert len(got) == 0
    _same_stats(ref.selectivity(), port.selectivity())


@pytest.mark.parametrize("fanout", [64, 0])
def test_under_overlay_cache_and_rebuild(fanout, rows, monkeypatch):
    monkeypatch.setattr(R_bgp, "_BIND_FANOUT", fanout)
    monkeypatch.setattr(P_bgp, "_BIND_FANOUT", fanout)
    ref, port = _pair_of(rows, cache=True)
    bgps = ["?x 0 ?y . ?y ?p ?z", "?h 0 ?a . ?h 1 ?b", "?x 0 ?y . ?y 0 ?z . ?z 0 ?x"]

    def check():
        logical = _triple_set(port.current_triples().numpy())
        assert sorted(logical) == sorted(_triple_set(ref.current_triples()))
        for bgp in bgps:
            for _ in range(2):  # cold, then warm through the cache
                got = port.query_bgp(bgp)
                _same_result(ref.query_bgp(bgp), got)
                _assert_oracle(got, logical, bgp)

    check()
    stats = port.selectivity()
    new = np.array([[0, 0, 13], [13, 2, 14], [13, 3, 1], [14, 0, 0], [5, 0, 5]])
    assert port.insert_triples(torch.from_numpy(new)) == ref.insert_triples(new)
    assert port.delete_triples(torch.from_numpy(rows[:5])) == ref.delete_triples(rows[:5])
    check()
    assert port.selectivity() is stats  # the overlay does not change the stats
    td = P.TermDict.empty()
    port.attach_term_dict(td)
    assert port.rebuild() and ref.rebuild()
    assert port.term_dict is td and port._select_stats is None
    _same_stats(ref.selectivity(), port.selectivity())
    check()


def test_rank1_edges_of_an_itr_plus_engine_are_excluded():
    g, table = _itr_plus_case()
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(*port_hypergraph(g, table))
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=0, delta_budget=None)
    port = P.TripleQueryEngine(port_g, cache=None, crossover=0, delta_budget=None)
    label = table.n_terminals - 1  # a node-label terminal: its edges are rank 1
    rank2 = [(int(a), int(lbl), int(b)) for lbl, (a, b) in
             ((lbl, nodes) for lbl, nodes in R.Hypergraph.edge_tuples(g) if len(nodes) == 2)]
    for bgp in ("?c 0 ?x . ?c 1 ?y", f"?x {label} ?y", "?c ?p ?x . ?x ?q ?y",
                f"?c 0 ?x . ?x {label} ?y"):
        got = port.query_bgp(bgp)
        _same_result(ref.query_bgp(bgp), got)
        _assert_oracle(got, rank2, bgp)


# -- the machinery -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_join_indices_against_brute_force(seed):
    rng = np.random.default_rng(5 + seed)
    k = 1 + seed % 3
    left = rng.integers(0, 4, size=(int(rng.integers(1, 40)), k))
    right = rng.integers(0, 4, size=(int(rng.integers(0, 30)), k))
    keep = rng.random(len(right)) < 0.7
    li, ri = P_bgp._join_indices(torch.from_numpy(left), torch.from_numpy(right),
                                 torch.from_numpy(keep))
    got = list(zip(li.tolist(), ri.tolist()))
    want = [(i, j) for i in range(len(left)) for j in range(len(right))
            if keep[j] and (left[i] == right[j]).all()]
    assert got == want  # grouped by left row, right rows in position order
    if len(right):
        rli, rri = R_bgp._join_indices(left, right)
        li, ri = P_bgp._join_indices(torch.from_numpy(left), torch.from_numpy(right))
        assert list(zip(li.tolist(), ri.tolist())) == list(zip(rli.tolist(), rri.tolist()))


def test_result_entry_roundtrip():
    rows = torch.tensor([[3, 1], [0, 2]])
    res = P_bgp.BGPResult(("?a", "?b"), rows)
    labels, nodes, offsets = P_bgp.encode_result_entry(res)
    ref = R_bgp.encode_result_entry(R_bgp.BGPResult(res.vars, rows.numpy()))
    for got, want in zip((labels, nodes, offsets), ref):
        np.testing.assert_array_equal(got.numpy(), want)
    back = P_bgp.decode_result_entry((labels, nodes, offsets), res.vars)
    assert back.vars == res.vars and back.tuples() == res.tuples()
    for r in (P_bgp.BGPResult(("?a",), torch.zeros((0, 1), dtype=torch.int64)),
              P_bgp.BGPResult((), torch.zeros((1, 0), dtype=torch.int64))):
        back = P_bgp.decode_result_entry(P_bgp.encode_result_entry(r), r.vars)
        assert back.tuples() == r.tuples() and tuple(back.rows.shape) == tuple(r.rows.shape)


def test_bgp_result_api(pair):
    _, port = pair
    res = port.query_bgp("?y 1 ?x")
    assert res.vars == ("?y", "?x")
    rows = res.tuples()
    assert rows == sorted(rows) and len(res) == len(rows) > 0
    assert res.bindings()[0] == dict(zip(res.vars, rows[0]))
    assert res.rows.device == port.device and res.rows.is_contiguous()
    # a tensor has no read-only flag (the reference's array is read-only):
    # the rows are the caller's to keep, not to write
    assert isinstance(res.rows, torch.Tensor) and not hasattr(res.rows, "flags")
    assert "n=" in repr(res)
