"""The port's loop ablation (``repro_torch.core.ablations``) against the JAX
package's, on the CPU.

The same graph is compressed by both packages (their grammars are equal,
as ``tests/test_torch_build.py`` holds), then transformed: start labels,
nodes, ranks and every rule must be equal array for array (new labels in
order of first occurrence), and so must the decompressed edges and the
encoded bytes. Exact: the transform is integer work.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.ablations import loop_rule_transform as ref_transform
from repro_torch.core.ablations import loop_rule_transform
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_build import assert_same_grammar, port_hypergraph


def _loop_heavy(seed, ranks, n_nodes=8, n_edges=60):
    """Edges over few nodes, so many repeat a node."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(n_edges):
        lbl = int(rng.integers(0, len(ranks)))
        edges.append((lbl, rng.integers(0, n_nodes, ranks[lbl]).tolist()))
    return R.Hypergraph.from_edges(n_nodes, edges), R.LabelTable.terminals(list(ranks))


def _no_loop(seed):
    rng = np.random.default_rng(seed)
    edges = [(int(rng.integers(0, 2)), rng.choice(40, 2, replace=False).tolist())
             for _ in range(120)]
    return R.Hypergraph.from_edges(40, edges), R.LabelTable.terminals([2, 2])


GRAPHS = {
    "test_itr_core_loops": lambda: _loop_heavy(11, (2, 3)),
    "ranks2_seed0": lambda: _loop_heavy(0, (2,), n_nodes=6, n_edges=50),
    "ranks3_seed1": lambda: _loop_heavy(1, (3, 2), n_nodes=7),
    "ranks4_seed2": lambda: _loop_heavy(2, (4, 3, 2), n_nodes=9, n_edges=80),
    "ranks4_seed3": lambda: _loop_heavy(3, (4,), n_nodes=5, n_edges=40),
    "no_loop_input": lambda: _no_loop(4),
}


def _both(name):
    g, table = GRAPHS[name]()
    ref, _ = R.compress(g, table)
    port, _ = P.compress(*port_hypergraph(g, table))
    assert_same_grammar(ref, port)
    return g, ref, port


@pytest.mark.parametrize("name", list(GRAPHS))
def test_transform_equals_the_reference(name):
    g, ref, port = _both(name)
    want, got = ref_transform(ref), loop_rule_transform(port)
    assert_same_grammar(want, got)
    got.validate()
    assert sorted(got.decompress().edge_tuples()) == sorted(g.edge_tuples())
    assert P.encode(got).size_in_bytes() == R.encode(want).size_in_bytes()


@pytest.mark.parametrize("name", [n for n in GRAPHS if n != "no_loop_input"])
def test_no_loop_edge_remains(name):
    _, _, port = _both(name)
    start = port.start
    had = any(len(set(nodes)) < len(nodes) for _, nodes in start.edge_tuples())
    out = loop_rule_transform(port)
    assert had and len(out.rules) > len(port.rules)
    assert all(len(set(nodes)) == len(nodes) for _, nodes in out.start.edge_tuples())


def test_no_loop_returns_a_copy():
    g, table = _no_loop(4)
    port = P.Grammar(*reversed(port_hypergraph(g, table)), {})
    out = loop_rule_transform(port)
    assert_same_grammar(ref_transform(R.Grammar(table, g, {})), out)
    assert out.start is not port.start and out.table is not port.table
    assert out.rules.keys() == port.rules.keys()
    assert all(out.rules[k] is r for k, r in port.rules.items())
    assert out.start.edge_tuples() == port.start.edge_tuples()
    assert torch.equal(out.table.ranks, port.table.ranks)


def test_new_labels_follow_first_occurrence():
    """Two loop shapes whose (label, pi) keys sort the other way round from
    their order in the start graph: the first seen takes the first label."""
    table = P.LabelTable.terminals([2, 3], device="cpu")
    g = P.Hypergraph.from_edges(4, [(1, [2, 2, 3]), (0, [1, 1]), (1, [0, 0, 1]), (0, [0, 1])],
                                device="cpu")
    out = loop_rule_transform(P.Grammar(table, g, {}))
    rhs = {lbl: r.rhs.edge_tuples() for lbl, r in out.rules.items()}
    assert rhs == {2: [(1, (0, 0, 1))], 3: [(0, (0, 0))]}
    assert out.start.edge_tuples() == [(0, (0, 1)), (2, (2, 3)), (3, (1,)), (2, (0, 1))]
