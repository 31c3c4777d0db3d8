"""The port's build side against the reference, on the CPU.

Counting, RePair ``compress``, ``encode`` and ``FlatGrammar`` of
``repro_torch`` must give exactly what ``repro.core`` gives on the same
graphs: the same table ranks, start graph and rules, the same k² level
words, Elias–Fano arrays and δ streams, and the same CSR arrays.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.digram import node_it_counts as ref_node_it_counts
from repro.data.synthetic import rdf_like, version_graph, web_graph
from repro_torch.core.digram import digram_counts, node_it_counts
from tests.test_itr_core import random_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATASETS = {
    "rdf_like": lambda: rdf_like(300, 1000, 5, seed=3),
    "web_graph": lambda: web_graph(200, 800, seed=2),
    "version_graph": lambda: version_graph(30, 9, 3, seed=1),
}


def _np(t):
    return t.cpu().numpy()


def both_graphs(ds):
    """The same triples as a reference and a port (CPU) hypergraph + table."""
    ranks = np.full(ds.n_preds, 2)
    return ((R.Hypergraph.from_triples(ds.triples, ds.n_nodes), R.LabelTable.terminals(ranks)),
            (P.Hypergraph.from_triples(ds.triples, ds.n_nodes, device="cpu"),
             P.LabelTable.terminals(ranks, device="cpu")))


def port_hypergraph(g, table):
    """A reference Hypergraph / LabelTable as the port's, on the CPU."""
    return (P.Hypergraph(g.n_nodes, torch.from_numpy(g.labels), torch.from_numpy(g.nodes_flat),
                         torch.from_numpy(g.offsets)),
            P.LabelTable.terminals(table.ranks, device="cpu"))


def assert_same_graph(ref, port):
    assert ref.n_nodes == port.n_nodes
    np.testing.assert_array_equal(_np(port.labels), ref.labels)
    np.testing.assert_array_equal(_np(port.nodes_flat), ref.nodes_flat)
    np.testing.assert_array_equal(_np(port.offsets), ref.offsets)


def assert_same_grammar(ref, port):
    np.testing.assert_array_equal(_np(port.table.ranks), ref.table.ranks)
    assert port.table.n_terminals == ref.table.n_terminals
    assert_same_graph(ref.start, port.start)
    assert sorted(port.rules) == sorted(ref.rules)
    for lbl, rule in ref.rules.items():
        assert port.rules[lbl].rank == rule.rank
        assert_same_graph(rule.rhs, port.rules[lbl].rhs)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap", [None, 64, 2])
def test_counts_match_reference(seed, cap):
    rng = np.random.default_rng(seed)
    g, table = random_hypergraph(rng, n_nodes=25, n_labels=4, n_edges=120, max_rank=3)
    pg, pt = port_hypergraph(g, table)
    for want, got in zip(ref_node_it_counts(g, table), node_it_counts(pg, pt)):
        np.testing.assert_array_equal(_np(got), want)
    wk, wc = R.digram_counts(g, table, cap=cap)
    gk, gc = digram_counts(pg, pt, cap=cap)
    np.testing.assert_array_equal(_np(gk), wk)
    np.testing.assert_array_equal(_np(gc), wc)


def test_counter_matches_reference_counter():
    rng = np.random.default_rng(4)
    g, table = random_hypergraph(rng, n_nodes=20, n_labels=3, n_edges=80)
    pg, pt = port_hypergraph(g, table)
    ref = R.DigramCounter(g, table, cap=64)
    port = P.DigramCounter(pg, pt, cap=64)
    wk, wc = ref.as_arrays()
    gk, gc = port.as_tensors("cpu")
    np.testing.assert_array_equal(_np(gk), wk)
    np.testing.assert_array_equal(_np(gc), wc)
    assert port.pop_best() == ref.pop_best()


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_compress_encode_flatten_match_reference(name):
    ds = DATASETS[name]()
    (rg, rt), (pg, pt) = both_graphs(ds)
    ref, rstats = R.compress(rg, rt)
    port, pstats = P.compress(pg, pt)
    assert vars(pstats) == vars(rstats)
    assert_same_grammar(ref, port)

    renc, penc = R.encode(ref), P.encode(port)
    assert penc.size_in_bytes() == renc.size_in_bytes()
    assert (penc.n_nodes, penc.n_edges, penc.n_fns, penc.n_rules, penc.rule_symbol_count) == \
        (renc.n_nodes, renc.n_edges, renc.n_fns, renc.n_rules, renc.rule_symbol_count)
    for lp, lr in zip(penc.incidence.levels, renc.incidence.levels, strict=True):
        np.testing.assert_array_equal(_np(lp.words), lr.words.astype(np.int64))
    ef_p, ef_r = penc.label_ef, renc.label_ef
    assert (ef_p.l, ef_p.universe, ef_p._low_bits) == (ef_r.l, ef_r.universe, ef_r._low_bits)
    np.testing.assert_array_equal(_np(ef_p._upper.words), ef_r._upper.words.astype(np.int64))
    np.testing.assert_array_equal(_np(ef_p._low_words), ef_r._low_words.astype(np.int64))
    for stream in ("fn_stream", "edge_fn_stream", "rule_stream"):
        (wp, bp), (wr, br) = getattr(penc, stream), getattr(renc, stream)
        assert bp == br, stream
        np.testing.assert_array_equal(_np(wp), wr.astype(np.int64))
    np.testing.assert_array_equal(_np(penc.fn_lengths), renc.fn_lengths)

    fp, fr = P.FlatGrammar.from_grammar(port), R.FlatGrammar.from_grammar(ref)
    for field in R.FlatGrammar._ARRAY_FIELDS:
        np.testing.assert_array_equal(_np(getattr(fp, field)), getattr(fr, field), err_msg=field)
    assert port.decompress().edge_tuples() == ref.decompress().edge_tuples()


@pytest.mark.parametrize("config", [
    dict(selection="savings"), dict(cap=None), dict(max_rank=3), dict(min_count=3),
    dict(max_iters=3, prune=False), dict(cap=1)], ids=str)
def test_compress_options_match_reference(config):
    rng = np.random.default_rng(11)
    g, table = random_hypergraph(rng, n_nodes=15, n_labels=3, n_edges=90, max_rank=3)
    pg, pt = port_hypergraph(g, table)
    ref, rstats = R.compress(g, table, R.RepairConfig(**config))
    port, pstats = P.compress(pg, pt, P.RepairConfig(**config))
    assert vars(pstats) == vars(rstats)
    assert_same_grammar(ref, port)
    np.testing.assert_array_equal(_np(port.nt_generates()), ref.nt_generates())
    assert R.encode(ref.prune() if not config.get("prune", True) else ref).size_in_bytes() == \
        P.encode(port.prune() if not config.get("prune", True) else port).size_in_bytes()


def test_index_functions_keep_first_seen_order():
    """Loops and repeated nodes: π per edge and ids in order of first use."""
    from repro_torch.core.encode import index_functions

    nodes = torch.tensor([5, 5, 3, 7, 3, 1, 1, 1, 2, 9, 9, 2, 4])
    offsets = torch.tensor([0, 2, 4, 6, 8, 11, 11, 13])
    pi, per_edge, fn_first, fn_len = index_functions(nodes, offsets)
    # edges: (5,5) (3,7) (3,1) (1,1) (2,9,9) () (2,4)
    assert pi.tolist() == [0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 1]
    assert per_edge.tolist() == [0, 1, 2, 0, 3, 4, 1]
    assert fn_first.tolist() == [0, 1, 2, 4, 5]
    assert fn_len.tolist() == [2, 2, 2, 3, 0]
