"""Ablations of ITR design decisions (paper §Handling loops): the twin of
``repro.core.ablations``.

`loop_rule_transform` implements the alternative the paper REJECTS: every
loop edge (duplicate nodes, e.g. B(10,10,11)) is replaced by a fresh rule
``C -> B(0,0,1)`` over deduplicated parameters (Figure 1 (c)/(e)). The
paper keeps loops and lets the index-function absorb the duplicates.

Port decision: where the reference walks the start graph's edges in
Python, the detection here is one pass over the node list on the device:
each edge's nodes sorted inside its segment, neighbours compared (a loop
has two equal ones), ``zeta`` the first of each run of equal nodes and
``pi`` each node's run index within its edge. The (label, pi) keys group
with ``torch.unique``, and new labels go to the groups in order of first
occurrence, the reference's dict insertion order, so ``_renumber`` gives
its grammar bit for bit. Two host reads: the loop count and the groups'
keys, which make the rules.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64, offsets_from_counts
from repro_torch.core.grammar import Grammar, Rule
from repro_torch.core.hypergraph import Hypergraph


def loop_rule_transform(grammar: Grammar) -> Grammar:
    """Replace every loop edge in the start graph by a loop-eliminating rule.

    Loop edges sharing (label, index-function signature) share one rule.
    Returns a new grammar whose start graph has no duplicate-node edges.
    """
    table = grammar.table.copy()
    start = grammar.start
    rules = dict(grammar.rules)
    dev = start.device
    n_e = start.n_edges
    ranks = start.ranks()
    flat = start.nodes_flat
    edge_of = torch.repeat_interleave(torch.arange(n_e, dtype=I64, device=dev), ranks,
                                      output_size=flat.numel())
    # each edge's nodes sorted inside its segment: by node, then stably by edge
    order = torch.sort(flat, stable=True).indices
    order = order[torch.sort(edge_of[order], stable=True).indices]
    sorted_nodes = flat[order]
    first = torch.ones(flat.numel(), dtype=torch.bool, device=dev)  # a new distinct node
    first[1:] = (sorted_nodes[1:] != sorted_nodes[:-1]) | (edge_of[1:] != edge_of[:-1])
    n_zeta = torch.zeros(n_e, dtype=I64, device=dev).index_add_(0, edge_of, first.to(I64))
    is_loop = n_zeta < ranks
    n_loops = int(is_loop.sum())
    if n_loops == 0:
        return Grammar(table, start.copy(), rules)

    # pi: each node's index in its edge's zeta, back in the edge's own order
    run = torch.cumsum(first.to(I64), 0) - 1
    run_base = offsets_from_counts(n_zeta)[:-1]
    pi = torch.empty_like(flat)
    pi[order] = run - run_base[edge_of]

    loops = torch.nonzero(is_loop).reshape(-1)
    r_max = int(ranks.max())
    slot = torch.arange(r_max, device=dev)
    inside = slot[None, :] < ranks[loops][:, None]
    take = (start.offsets[loops][:, None] + slot[None, :]).clamp(max=max(flat.numel() - 1, 0))
    keys = torch.cat([start.labels[loops][:, None], ranks[loops][:, None],
                      torch.where(inside, pi[take], -1)], 1)
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    first_seen = torch.full((uniq.shape[0],), n_loops, dtype=I64, device=dev).scatter_reduce_(
        0, inverse, torch.arange(n_loops, device=dev), "amin")
    by_first = torch.argsort(first_seen)
    new_id = torch.empty_like(by_first)
    new_id[by_first] = torch.arange(by_first.numel(), device=dev)
    group_zeta = n_zeta[loops][first_seen[by_first]]
    base = table.n_labels
    for (label, rank, *pi_row), n_z in zip(uniq[by_first].tolist(), group_zeta.tolist()):
        lbl = table.add_label(n_z)
        params = torch.tensor(pi_row[:rank], dtype=I64, device=dev)
        rhs = Hypergraph(n_z, torch.tensor([label], dtype=I64, device=dev), params,
                         torch.tensor([0, rank], dtype=I64, device=dev))
        rules[lbl] = Rule(lbl, n_z, rhs)

    kept = start.select(~is_loop)
    new_start = kept.concat_edges(base + new_id[inverse], sorted_nodes[first & is_loop[edge_of]],
                                  n_zeta[loops])
    return Grammar(table, new_start, rules)._renumber()
