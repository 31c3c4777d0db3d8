"""The port's ``EncodedGrammar.decode``, ``validate`` helpers, succinct loose
ends and ITR+ against the reference, on the CPU.

``decode`` must give the reference's grammar bit for bit on every test
graph (random hypergraphs of ranks 1-3, the synthetic datasets, loop
edges, the empty grammar, ITR+ grammars, an opened snapshot's encoding),
reading the start graph's node tuples through one batched column
expansion of the incidence tree. ``validate`` must pass or raise
``AssertionError`` on the same inputs as the reference's, also under
``python -O``. ``EliasFano.from_parts`` / ``to_tensor`` / ``rank_leq`` and
the gamma codes agree bit for bit. ITR+: attaching and stripping node
labels, compressing the labelled graph (the reference's
``test_itr_plus_*`` cases and a node-labelled version graph), the
dictionary costs and the eight patterns on the ITR+ engine, rank-1 edges
included, equal the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.itr_plus as R_plus
import repro_torch.core as P
import repro_torch.core.itr_plus as P_plus
from repro.core import succinct as R_succ
from repro.data.synthetic import version_graph
from repro_torch.core import succinct as P_succ
from repro_torch.kernels import ops
from tests.test_itr_core import fig1_graph, random_hypergraph
from tests.test_torch_build import DATASETS, assert_same_grammar, assert_same_graph, \
    both_graphs, port_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _np(t):
    return t.cpu().numpy()


def _port_grammar(g):
    """A reference Grammar as the port's, on the CPU."""
    table = P.LabelTable(torch.from_numpy(np.asarray(g.table.ranks, dtype=np.int64)),
                         g.table.n_terminals, g.table.names)
    return P.Grammar(table, port_hypergraph(g.start, g.table)[0],
                     {lbl: P.Rule(r.label, r.rank, port_hypergraph(r.rhs, g.table)[0])
                      for lbl, r in g.rules.items()})


# -- decode ------------------------------------------------------------------

def _random_case(seed):
    return lambda: random_hypergraph(np.random.default_rng(seed), n_nodes=14, n_edges=50)


def _dataset_case(name):
    def make():
        ds = DATASETS[name]()
        return (R.Hypergraph.from_triples(ds.triples, ds.n_nodes),
                R.LabelTable.terminals(np.full(ds.n_preds, 2)))
    return make


def _itr_plus_case():
    ds = version_graph(20, 9, 3, seed=2)
    g, t, _ = R_plus.attach_node_labels(R.Hypergraph.from_triples(ds.triples, ds.n_nodes),
                                        R.LabelTable.terminals(np.full(ds.n_preds, 2)),
                                        ds.node_labels)
    return g, t


DECODE_CASES = {
    **{f"random{s}": _random_case(s) for s in range(6)},
    **{name: _dataset_case(name) for name in sorted(DATASETS)},
    "fig1": fig1_graph,
    "loop": lambda: (R.Hypergraph.from_edges(12, [(0, [10, 10, 11])]), R.LabelTable.terminals([3])),
    "itr_plus": _itr_plus_case,
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_equals_the_reference(case, monkeypatch):
    g, table = DECODE_CASES[case]()
    ref_g, _ = R.compress(g, table)
    pg, pt = port_hypergraph(g, table)
    pt.names = table.names
    port_g, _ = P.compress(pg, pt)
    enc = P.encode(port_g)
    calls = []
    real = ops.k2_lines
    monkeypatch.setattr(ops, "k2_lines", lambda *a: calls.append(a[2]) or real(*a))
    got = enc.decode()
    assert calls == [1]  # one column expansion over every edge
    want = R.encode(ref_g).decode()
    assert_same_grammar(want, got)
    assert got.table.names == want.table.names
    got.validate()
    assert sorted(got.decompress().edge_tuples()) == sorted(g.edge_tuples())


def test_decode_of_the_empty_grammar():
    table = R.LabelTable.terminals([2, 2])
    empty = R.Grammar(table, R.Hypergraph.from_edges(3, []), {})
    want = R.encode(empty).decode()
    got = P.encode(_port_grammar(empty)).decode()
    assert_same_grammar(want, got)
    assert got.start.n_edges == 0 and not got.rules


def test_decode_of_an_opened_snapshot(tmp_path):
    from repro_torch.persist.snapshot import load_snapshot, save_snapshot

    ds = DATASETS["rdf_like"]()
    _, (pg, pt) = both_graphs(ds)
    grammar, _ = P.compress(pg, pt)
    engine = P.TripleQueryEngine(grammar, cache=None, crossover=0, delta_budget=None)
    save_snapshot(engine, tmp_path / "snap")
    opened = load_snapshot(tmp_path / "snap", device="cpu")
    dec = opened.encoded.decode()
    assert_same_grammar(opened.grammar, dec)  # label-sorted start, every rule
    dec.validate()


# -- validate -------------------------------------------------------------------

def _graph(n_nodes, labels, flat, offsets):
    return R.Hypergraph(n_nodes, np.array(labels, dtype=np.int64),
                        np.array(flat, dtype=np.int64), np.array(offsets, dtype=np.int64))


def _port_graph(g):
    return P.Hypergraph(g.n_nodes, torch.from_numpy(g.labels), torch.from_numpy(g.nodes_flat),
                        torch.from_numpy(g.offsets))


TABLE = R.LabelTable(np.array([2, 1, 3, 2], dtype=np.int64), 2)  # 2 terminals, 2 nonterminals

GRAPH_CASES = {
    "good": (_graph(5, [0, 1, 0], [0, 1, 2, 3, 4], [0, 2, 3, 5]), TABLE),
    "good_no_table": (_graph(5, [0, 1, 0], [0, 1, 2, 3, 4], [0, 2, 3, 5]), None),
    "empty": (_graph(0, [], [], [0]), TABLE),
    "no_node_bound": (_graph(0, [0], [7, 9], [0, 2]), TABLE),
    "offsets_too_short": (_graph(5, [0, 1], [0, 1, 2], [0, 2]), None),
    "offsets_not_at_0": (_graph(5, [0], [0, 1, 2], [1, 3]), None),
    "offsets_past_nodes": (_graph(5, [0], [0, 1], [0, 3]), None),
    "node_too_large": (_graph(5, [0, 1], [0, 5, 2], [0, 2, 3]), None),
    "negative_node": (_graph(5, [0, 1], [0, -1, 2], [0, 2, 3]), None),
    "arity_mismatch": (_graph(5, [0, 1], [0, 1, 2, 3], [0, 2, 4]), TABLE),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_hypergraph_validate_as_the_reference(case):
    g, table = GRAPH_CASES[case]
    p_table = None if table is None else P.LabelTable(torch.from_numpy(table.ranks),
                                                      table.n_terminals)
    outcome = []
    for run in (lambda: g.validate(table), lambda: _port_graph(g).validate(p_table)):
        try:
            run()
            outcome.append("ok")
        except AssertionError:
            outcome.append("fails")
    assert outcome[0] == outcome[1], outcome
    assert outcome[0] == ("ok" if case.startswith(("good", "empty", "no_node")) else "fails")


def _rule(label, rank, labels, flat, offsets):
    return R.Rule(label, rank, _graph(rank, labels, flat, offsets))


START = _graph(6, [2, 3, 0], [0, 1, 2, 3, 4, 5, 0], [0, 3, 5, 7])
GOOD_RULES = {2: _rule(2, 3, [0, 1, 3], [0, 1, 2, 1, 2], [0, 2, 3, 5]),
              3: _rule(3, 2, [0, 0], [0, 1, 1, 0], [0, 2, 4])}

GRAMMAR_CASES = {
    "good": GOOD_RULES,
    "no_rules_used": {},
    "rank_mismatch": {**GOOD_RULES, 3: _rule(3, 3, [0, 0], [0, 1, 1, 2], [0, 2, 4])},
    "parameter_missing": {**GOOD_RULES, 3: _rule(3, 2, [0], [0, 0], [0, 2])},
    "keyed_wrongly": {2: GOOD_RULES[3], 3: GOOD_RULES[3]},
    "terminal_rule": {**GOOD_RULES, 0: _rule(0, 2, [1], [0], [0, 1])},
    "recursive": {2: GOOD_RULES[2], 3: _rule(3, 2, [0, 3], [0, 1, 1, 0], [0, 2, 4])},
    "bad_body_node": {**GOOD_RULES, 3: _rule(3, 2, [0, 0], [0, 1, 1, 2], [0, 2, 4])},
}


@pytest.mark.parametrize("case", sorted(GRAMMAR_CASES))
def test_grammar_validate_as_the_reference(case):
    ref = R.Grammar(TABLE, START, GRAMMAR_CASES[case])
    port = _port_grammar(ref)
    outcome = []
    for g in (ref, port):
        try:
            g.validate()
            outcome.append("ok")
        except AssertionError:
            outcome.append("fails")
    assert outcome[0] == outcome[1], outcome
    assert outcome[0] == ("ok" if case in ("good", "no_rules_used") else "fails")


@pytest.mark.parametrize("label", [2, 3])
def test_rule_validate_as_the_reference(label):
    rule = GOOD_RULES[label]
    bad = R.LabelTable(np.array([2, 1, 2, 3], dtype=np.int64), 2)  # both ranks swapped
    for table, want in ((TABLE, True), (bad, False)):
        p_table = P.LabelTable(torch.from_numpy(table.ranks), 2)
        p_rule = P.Rule(rule.label, rule.rank, _port_graph(rule.rhs))
        results = []
        for run in (lambda: rule.validate(table), lambda: p_rule.validate(p_table)):
            try:
                run()
                results.append(True)
            except AssertionError:
                results.append(False)
        assert results == [want, want]


def test_validate_raises_under_python_O():
    code = ("import torch\nfrom repro_torch.core import Hypergraph\n"
            "g = Hypergraph(3, torch.tensor([0]), torch.tensor([0, 7]), torch.tensor([0, 2]))\n"
            "try:\n    g.validate()\nexcept AssertionError:\n    print('raised')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-O", "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.stdout.strip() == "raised", proc.stderr


# -- succinct loose ends -------------------------------------------------------

@pytest.mark.parametrize("n,universe,maxv", [
    (0, None, 0), (1, None, 0), (10, None, 5), (100, 10_000, 9_999), (257, None, 1 << 20),
    (50, 1 << 40, (1 << 40) - 1)])
def test_elias_fano_parts_tensor_and_rank_leq(n, universe, maxv):
    rng = np.random.default_rng(n + 7)
    vals = np.sort(rng.integers(0, maxv + 1, n))
    ref = R_succ.EliasFano(vals, universe=universe)
    i64 = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    port = P_succ.EliasFano.from_parts(
        ref.n, ref.universe, ref.l, i64(ref._lows), i64(ref._upper.words), ref._upper.n,
        i64(ref._low_words), ref._low_bits)
    built = P_succ.EliasFano(torch.from_numpy(vals), universe=universe)
    for ef in (port, built):
        assert (ef.n, ef.universe, ef.l, ef._low_bits) == (ref.n, ref.universe, ref.l,
                                                           ref._low_bits)
        np.testing.assert_array_equal(_np(ef._lows), ref._lows.astype(np.int64))
        np.testing.assert_array_equal(_np(ef._low_words), ref._low_words.astype(np.int64))
        np.testing.assert_array_equal(_np(ef._upper.words), ref._upper.words.astype(np.int64))
        np.testing.assert_array_equal(_np(ef.to_tensor()), ref.to_numpy())
        probes = [-1, 0, maxv, maxv + 1, *(int(v) for v in vals[:5]), *(int(v) - 1 for v in vals[-3:])]
        assert [ef.rank_leq(x) for x in probes] == [ref.rank_leq(x) for x in probes]
        assert ef.size_in_bytes() == ref.size_in_bytes()


@pytest.mark.parametrize("maxv", [1, 2, 17, 1000, 1 << 30])
def test_gamma_codes_match_reference(maxv):
    rng = np.random.default_rng(maxv)
    vals = rng.integers(1, maxv + 1, 300)
    vals[:3] = [1, maxv, 1]
    w_ref, b_ref = R_succ.gamma_encode(vals.astype(np.uint64))
    w_port, b_port = P_succ.gamma_encode(torch.from_numpy(vals))
    assert b_port == b_ref
    np.testing.assert_array_equal(_np(w_port), w_ref.astype(np.int64))
    np.testing.assert_array_equal(_np(P_succ.gamma_decode(w_port, b_port, len(vals))),
                                  R_succ.gamma_decode(w_ref, b_ref, len(vals)).astype(np.int64))


def test_gamma_codes_edges():
    with pytest.raises(ValueError):
        R_succ.gamma_encode(np.array([0, 3], dtype=np.uint64))
    with pytest.raises(ValueError):
        P_succ.gamma_encode(torch.tensor([0, 3]))
    with pytest.raises(ValueError):
        P_succ.gamma_encode(torch.tensor([1 << 40]))  # a code over 63 bits
    words, bits = P_succ.gamma_encode(torch.zeros(0, dtype=torch.int64))
    w_ref, b_ref = R_succ.gamma_encode(np.zeros(0, dtype=np.uint64))
    assert bits == b_ref == 0 and words.numel() == len(w_ref) == 0
    assert P_succ.gamma_decode(words, 0, 0).numel() == 0


# -- ITR+ ----------------------------------------------------------------------

def _labelled_cases():
    rng = np.random.default_rng(3)
    n = 60
    triples = np.stack([rng.integers(0, n, 150), rng.integers(0, 2, 150),
                        rng.integers(0, n, 150)], axis=1)
    random_case = (R.Hypergraph.from_triples(triples, n), R.LabelTable.terminals([2, 2]),
                   rng.integers(0, 3, n), None)
    star = (R.Hypergraph.from_edges(50, [(0, [i, 0]) for i in range(1, 50)]),
            R.LabelTable.terminals([2]), np.zeros(50, dtype=np.int64), R.RepairConfig(cap=None))
    ds = version_graph(40, 9, 3, seed=1)
    version = (R.Hypergraph.from_triples(ds.triples, ds.n_nodes),
               R.LabelTable.terminals(np.full(ds.n_preds, 2)), ds.node_labels, None)
    unlabelled = (R.Hypergraph.from_triples(ds.triples, ds.n_nodes),
                  R.LabelTable.terminals(np.full(ds.n_preds, 2)),
                  np.full(ds.n_nodes, -1, dtype=np.int64), None)
    return {"random": random_case, "star": star, "version_graph": version,
            "unlabelled": unlabelled}


LABELLED = _labelled_cases()


def _port_config(cfg):
    return None if cfg is None else P.RepairConfig(**vars(cfg))


@pytest.mark.parametrize("case", sorted(LABELLED))
def test_itr_plus_attach_compress_strip_as_the_reference(case):
    g, table, labels, cfg = LABELLED[case]
    n_kinds = int(labels.max()) + 1 if (labels >= 0).any() else 0
    r_g, r_t, r_base = R_plus.attach_node_labels(g, table, labels)
    pg, pt = port_hypergraph(g, table)
    p_g, p_t, p_base = P_plus.attach_node_labels(pg, pt, torch.from_numpy(labels))
    assert p_base == r_base and p_t.n_terminals == r_t.n_terminals
    np.testing.assert_array_equal(_np(p_t.ranks), r_t.ranks)
    assert_same_graph(r_g, p_g)
    r_gram, r_stats = R.compress(r_g, r_t, cfg)
    p_gram, p_stats = P.compress(p_g, p_t, _port_config(cfg))
    assert_same_grammar(r_gram, p_gram)
    assert vars(p_stats) == vars(r_stats)
    if case == "star":  # a rule holds the rank-1 label edge
        assert r_stats.replaced_occurrences > 0
        assert any(bool((r.rhs.ranks() == 1).any()) for r in p_gram.rules.values())
    r_strip, r_back = R_plus.strip_node_labels(r_gram.decompress(), r_base, n_kinds)
    p_strip, p_back = P_plus.strip_node_labels(p_gram.decompress(), p_base, n_kinds)
    np.testing.assert_array_equal(_np(p_back), r_back)
    np.testing.assert_array_equal(r_back, labels)
    assert_same_graph(r_strip, p_strip)
    assert sorted(p_strip.edge_tuples()) == sorted(g.edge_tuples())


def test_itr_plus_attach_refuses_what_the_reference_refuses():
    g, table, labels, _ = LABELLED["random"]
    pg, pt = port_hypergraph(g, table)
    with pytest.raises(AssertionError):
        R_plus.attach_node_labels(g, table, labels[:-1])
    with pytest.raises(AssertionError):
        P_plus.attach_node_labels(pg, pt, torch.from_numpy(labels[:-1]))
    r_table = R.LabelTable(np.array([2, 2, 3], dtype=np.int64), 2)  # after compression
    with pytest.raises(AssertionError):
        R_plus.attach_node_labels(g, r_table, labels)
    with pytest.raises(AssertionError):
        P_plus.attach_node_labels(pg, P.LabelTable(torch.tensor([2, 2, 3]), 2),
                                  torch.from_numpy(labels))


@pytest.mark.parametrize("strings,n_labelled", [([], 0), (["lab0", "lab1", "lab2"], 540),
                                                (["x", "o", "b"], 7), (["a" * 40], 1)])
def test_dictionary_costs_as_the_reference(strings, n_labelled):
    assert P.dictionary_cost_itr(strings, n_labelled) == \
        R_plus.dictionary_cost_itr(strings, n_labelled)
    assert P.dictionary_cost_itr(strings, n_labelled, 16) == \
        R_plus.dictionary_cost_itr(strings, n_labelled, 16)
    assert P.dictionary_cost_itr_plus(strings) == R_plus.dictionary_cost_itr_plus(strings)


PATTERNS = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]


def _edge_rows(labels, nodes, offsets):
    """(label, first node, second node or -2) per edge."""
    ranks = offsets[1:] - offsets[:-1]
    first = nodes[offsets[:-1]]
    second = np.where(ranks > 1, nodes[np.minimum(offsets[:-1] + 1, len(nodes) - 1)], -2)
    return np.stack([labels, first, second], 1) if len(labels) else np.zeros((0, 3), np.int64)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_itr_plus_engine_answers_as_the_reference(pattern):
    g, table, labels, _ = LABELLED["version_graph"]
    r_g, r_t, _ = R_plus.attach_node_labels(g, table, labels)
    pg, pt = port_hypergraph(g, table)
    p_g, p_t, _ = P_plus.attach_node_labels(pg, pt, torch.from_numpy(labels))
    ref = R.TripleQueryEngine(R.compress(r_g, r_t)[0], cache=None, crossover=0,
                              delta_budget=None)
    port = P.TripleQueryEngine(P.compress(p_g, p_t)[0], cache=None, crossover=0,
                               delta_budget=None)
    rng = np.random.default_rng(len(pattern) + PATTERNS.index(pattern))
    rows = _edge_rows(r_g.labels, r_g.nodes_flat, r_g.offsets)
    pick = rows[rng.integers(0, len(rows), 60)]
    pick[:, 2] = np.where(pick[:, 2] < 0, rng.integers(0, g.n_nodes, 60), pick[:, 2])
    cols = [pick[:, 1], pick[:, 0], pick[:, 2]]  # s, p, o
    cols = [c if pattern[i] != "?" else np.full(60, -1, np.int64) for i, c in enumerate(cols)]
    n = 3 if pattern == "???" else 60
    cols = [c[:n] for c in cols]
    want = ref.query_batch_view(*cols)
    got = port.query_batch_view(*(torch.from_numpy(c) for c in cols))
    assert got.n_queries == want.n_queries
    n_rank1 = 0
    for q in range(n):
        w_l, w_n, w_o = want.entry(q)
        g_l, g_n, g_o = got.entry(q)
        w_rows, g_rows = _edge_rows(w_l, w_n, w_o), _edge_rows(_np(g_l), _np(g_n), _np(g_o))
        assert sorted(map(tuple, g_rows.tolist())) == sorted(map(tuple, w_rows.tolist()))
        # the plain scan over the ITR+ hypergraph, rank-1 edges included
        scan = [tuple(r) for r in rows.tolist() if
                (cols[1][q] < 0 or r[0] == cols[1][q]) and (cols[0][q] < 0 or r[1] == cols[0][q])
                and (cols[2][q] < 0 or r[2] == cols[2][q])]
        assert sorted(map(tuple, g_rows.tolist())) == sorted(scan)
        n_rank1 += int((g_rows[:, 2] == -2).sum())
    if pattern in ("s??", "???"):
        assert n_rank1 > 0  # the label edges are answered
