"""ITR+: frequent node labels become terminal hyperedges of rank 1.

``x(v)`` states that node v carries label x: the dictionary stores one
entry per distinct label instead of one RDF representation per labelled
node, and rank-1 edges take part in digram replacement, so repeated
(node label x edge label) subgraphs compress into single nonterminals
(paper §ITR+). The same functions as the reference's, over tensors on the
graph's device.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.device import as_i64


def attach_node_labels(graph: Hypergraph, table: LabelTable,
                       node_labels) -> tuple[Hypergraph, LabelTable, int]:
    """Append a rank-1 edge ``x(v)`` for every labelled node.

    `node_labels`: int64[n_nodes], -1 = unlabelled; values index a
    node-label alphabet appended to the terminal labels. Returns (graph+,
    table+, first node-label id).
    """
    dev = graph.device
    node_labels = as_i64(node_labels, dev).reshape(-1)
    if node_labels.numel() != graph.n_nodes:
        raise AssertionError("one node label (or -1) a node")
    labelled = torch.nonzero(node_labels >= 0).reshape(-1)
    n_label_kinds = int(node_labels.max()) + 1 if labelled.numel() else 0
    base = table.n_terminals
    if base != table.n_labels:
        raise AssertionError("attach node labels before compression")
    new_ranks = torch.cat([table.ranks[:base], torch.ones(n_label_kinds, dtype=I64, device=dev),
                           table.ranks[base:]])
    new_table = LabelTable(new_ranks, base + n_label_kinds, table.names)
    new_graph = graph.concat_edges(base + node_labels[labelled], labelled,
                                   torch.ones(labelled.numel(), dtype=I64, device=dev))
    return new_graph, new_table, base


def strip_node_labels(graph: Hypergraph, first_label_id: int,
                      n_label_kinds: int) -> tuple[Hypergraph, torch.Tensor]:
    """Inverse of :func:`attach_node_labels`: split the rank-1 label edges
    back into per-node labels (-1 = unlabelled)."""
    is_label_edge = (graph.labels >= first_label_id) \
        & (graph.labels < first_label_id + n_label_kinds) & (graph.ranks() == 1)
    node_labels = torch.full((graph.n_nodes,), -1, dtype=I64, device=graph.device)
    lab = graph.select(is_label_edge)
    node_labels[lab.nodes_flat] = lab.labels - first_label_id
    return graph.select(~is_label_edge), node_labels


def dictionary_cost_itr(node_label_strings: list[str], n_labeled_nodes: int,
                        avg_node_repr: int = 24) -> int:
    """ITR stores one RDF representation per labelled node (paper: |V|
    entries)."""
    return n_labeled_nodes * avg_node_repr


def dictionary_cost_itr_plus(node_label_strings: list[str]) -> int:
    """ITR+ stores only the distinct label strings."""
    return sum(len(s) + 1 for s in node_label_strings)
