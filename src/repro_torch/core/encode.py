"""Succinct encoding of an SL-HR grammar (paper §Succinct Encoding).

Same encoding as the reference, bit for bit. Start graph: edges sorted by
label; the monotone label sequence is Elias–Fano coded; the node x edge
incidence matrix (deduplicated) is a k²-tree; per-edge index functions
(π_e maps connection-type m to the position of e[m] in the sorted
duplicate-free node list of e) are deduplicated, δ-coded once each, and
referenced by δ-coded per-edge ids. Rules: right-hand sides in label order,
each as δ(#edges) then per edge δ(label+1) δ(node+1)*rank.

The reference computes the index functions in a Python loop over edges;
here one segmented computation does all edges at once and keeps the
reference's first-seen id order, so the δ streams match.

:meth:`EncodedGrammar.decode` inverts it: the start graph's node tuples
come from one batched column expansion of the incidence tree over all
edges (on the card one ``k2_lines`` count and one write launch) and ragged
gathers through the index functions; the δ streams are read on the host
by :func:`~repro_torch.core.succinct.delta_code.delta_decode`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core._arrays import I64, lexsort, offsets_from_counts
from repro_torch.core.grammar import Grammar, Rule
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.core.succinct import EliasFano, K2Tree, delta_decode, delta_encode


@dataclass
class EncodedGrammar:
    n_nodes: int
    n_edges: int
    n_terminals: int
    terminal_ranks: torch.Tensor
    label_ef: EliasFano                     # sorted per-edge label ids
    incidence: K2Tree                       # rows = nodes, cols = edges (sorted order)
    fn_stream: tuple[torch.Tensor, int]     # δ stream of unique index functions
    fn_lengths: torch.Tensor                # rank of each unique index function
    n_fns: int
    edge_fn_stream: tuple[torch.Tensor, int]  # δ stream of per-edge fn ids (+1)
    rule_stream: tuple[torch.Tensor, int]     # δ stream of all rule bodies
    rule_symbol_count: int
    n_rules: int
    names: list[str] | None = None

    def size_in_bytes(self) -> int:
        total = 8 * 4  # header counts
        total += (self.terminal_ranks.numel() * 2 + 7) // 8 or 1
        total += self.label_ef.size_in_bytes()
        total += self.incidence.size_in_bytes()
        total += (self.fn_stream[1] + 7) // 8
        total += (self.edge_fn_stream[1] + 7) // 8
        total += (self.rule_stream[1] + 7) // 8
        return total

    def decode(self) -> Grammar:
        """The grammar back from its encoding: the label-sorted start graph
        and every rule, on the incidence tree's device."""
        dev = self.incidence.device
        labels = self.label_ef.to_tensor()
        fn_lens = self.fn_lengths
        # unique index functions: each is its rank, then pi + 1 for each slot
        fn_vals = delta_decode(*self.fn_stream, int(fn_lens.sum()) + self.n_fns)
        is_head = torch.zeros(fn_vals.numel(), dtype=torch.bool, device=dev)
        is_head[offsets_from_counts(fn_lens + 1)[:-1]] = True
        fn_flat = fn_vals[~is_head] - 1
        fn_starts = offsets_from_counts(fn_lens)[:-1]
        fn_ids = delta_decode(*self.edge_fn_stream, self.n_edges) - 1
        # each edge's sorted distinct nodes from ONE batched column expansion
        # of the incidence tree, then nodes = zeta[pi] as one ragged gather
        eidx, zeta_flat = self.incidence.cols_many(
            torch.arange(self.n_edges, dtype=I64, device=dev))
        zeta_starts = offsets_from_counts(torch.bincount(eidx, minlength=self.n_edges))[:-1]
        ranks = fn_lens[fn_ids]
        edge, slot = _ragged_slots(ranks)
        pi_vals = fn_flat[fn_starts[fn_ids][edge] + slot]
        start = Hypergraph(self.n_nodes, labels, zeta_flat[zeta_starts[edge] + pi_vals],
                           offsets_from_counts(ranks))
        table, rules = _decode_rules(self, dev)
        return Grammar(table, start, rules)


def index_functions(nodes_flat: torch.Tensor, offsets: torch.Tensor):
    """All edges' index functions at once.

    Returns (pi_flat, per_edge, fn_first, fn_lengths): pi_flat[offsets[e] + m]
    is the position of node m of edge e among the edge's sorted distinct
    nodes; per_edge[e] is the id of e's function, ids numbered in order of
    first appearance; fn_first[f] is the first edge with function f.
    """
    dev = nodes_flat.device
    ranks = offsets[1:] - offsets[:-1]
    E, total = ranks.numel(), nodes_flat.numel()
    seg = torch.repeat_interleave(torch.arange(E, dtype=I64, device=dev), ranks,
                                  output_size=total)
    order = lexsort((nodes_flat, seg))  # by edge, then node
    s_nodes, s_seg = nodes_flat[order], seg[order]
    distinct = torch.ones(total, dtype=I64, device=dev)
    if total:
        distinct[1:] = ((s_seg[1:] != s_seg[:-1]) | (s_nodes[1:] != s_nodes[:-1])).to(I64)
    cum = torch.cumsum(distinct, 0) - 1
    first = torch.repeat_interleave(cum[offsets[:-1].clamp(max=max(total - 1, 0))],
                                    ranks, output_size=total)
    pi_flat = torch.empty(total, dtype=I64, device=dev)
    pi_flat[order] = cum - first

    # dedup the pi tuples per rank; a function's id is its first edge's order
    firsts, groups = [], []
    for r in torch.unique(ranks).tolist():
        edges_r = torch.nonzero(ranks == r).reshape(-1)
        if r == 0:
            inv = torch.zeros(edges_r.numel(), dtype=I64, device=dev)
            n_u = 1
        else:
            mat = pi_flat[offsets[edges_r][:, None] + torch.arange(r, device=dev)[None, :]]
            uniq, inv = torch.unique(mat, dim=0, return_inverse=True)
            n_u = uniq.shape[0]
        first_edge = torch.full((n_u,), E, dtype=I64, device=dev).scatter_reduce_(
            0, inv, edges_r, reduce="amin")
        groups.append((edges_r, inv, sum(f.numel() for f in firsts)))
        firsts.append(first_edge)
    if not firsts:
        z = torch.zeros(0, dtype=I64, device=dev)
        return pi_flat, z, z, z
    all_first = torch.cat(firsts)
    perm = torch.sort(all_first).indices
    fn_id = torch.empty_like(perm)
    fn_id[perm] = torch.arange(perm.numel(), dtype=I64, device=dev)
    per_edge = torch.empty(E, dtype=I64, device=dev)
    for edges_r, inv, base in groups:
        per_edge[edges_r] = fn_id[base + inv]
    fn_first = all_first[perm]
    return pi_flat, per_edge, fn_first, ranks[fn_first]


def _ragged_slots(lengths: torch.Tensor):
    """(owner, slot) for each position of a ragged layout with `lengths`."""
    total = int(lengths.sum()) if lengths.numel() else 0
    dev = lengths.device
    owner = torch.repeat_interleave(torch.arange(lengths.numel(), device=dev), lengths,
                                    output_size=total)
    slot = torch.arange(total, dtype=I64, device=dev) \
        - offsets_from_counts(lengths)[:-1][owner]
    return owner, slot


def _decode_rules(enc: EncodedGrammar, dev) -> tuple[LabelTable, dict[int, Rule]]:
    """The rule stream read on the host, rule by rule as the reference reads
    it (a rule's rank is its largest parameter + 1), then every body copied
    to the device in one go and sliced per rule."""
    vals = delta_decode(enc.rule_stream[0].cpu(), enc.rule_stream[1],
                        enc.rule_symbol_count).tolist()
    ranks = enc.terminal_ranks.tolist()
    labels, nodes, offsets, spans = [], [], [], []
    pos = 0
    for _ in range(enc.n_rules):
        n_e = vals[pos]
        pos += 1
        e0, n0, o0 = len(labels), len(nodes), len(offsets)
        offsets.append(0)
        for _ in range(n_e):
            el = vals[pos] - 1
            r = ranks[el]
            labels.append(el)
            nodes.extend(v - 1 for v in vals[pos + 1:pos + 1 + r])
            offsets.append(offsets[-1] + r)
            pos += 1 + r
        ranks.append(max(nodes[n0:]) + 1)
        spans.append((e0, len(labels), n0, len(nodes), o0, len(offsets)))
    lab_t, node_t, off_t = torch.split(torch.tensor(labels + nodes + offsets, dtype=I64).to(dev),
                                       [len(labels), len(nodes), len(offsets)])
    rules = {}
    for i, (e0, e1, n0, n1, o0, o1) in enumerate(spans):
        lbl = enc.n_terminals + i
        rank = ranks[lbl]
        rules[lbl] = Rule(lbl, rank, Hypergraph(rank, lab_t[e0:e1], node_t[n0:n1],
                                                off_t[o0:o1]))
    table = LabelTable(torch.tensor(ranks, dtype=I64).to(dev), enc.n_terminals, enc.names)
    return table, rules


def _fn_symbols(pi_flat, offsets, fn_first, fn_lengths) -> torch.Tensor:
    """Per function in id order: its rank, then pi + 1 for each slot."""
    f, slot = _ragged_slots(fn_lengths + 1)
    starts = offsets[fn_first][f]
    vals = pi_flat[(starts + slot - 1).clamp(min=0)] + 1 if pi_flat.numel() \
        else torch.zeros_like(slot)
    return torch.where(slot == 0, fn_lengths[f], vals)


def _rule_symbols(grammar: Grammar) -> torch.Tensor:
    """Rule bodies in label order: #edges, then per edge label+1, nodes+1."""
    rule_labels, edge_offsets, edge_labels, edge_ranks, params = grammar.rule_csr()
    dev = rule_labels.device
    R, n_e = rule_labels.numel(), edge_labels.numel()
    if R == 0:
        return torch.zeros(0, dtype=I64, device=dev)
    # blocks in stream order: header of rule i, then its edges
    rule_of_edge = torch.repeat_interleave(
        torch.arange(R, device=dev), edge_offsets[1:] - edge_offsets[:-1], output_size=n_e)
    hdr_pos = torch.arange(R, device=dev) + edge_offsets[:-1]
    edge_pos = rule_of_edge + 1 + torch.arange(n_e, device=dev)
    block_len = torch.empty(R + n_e, dtype=I64, device=dev)
    block_len[hdr_pos] = 1
    block_len[edge_pos] = 1 + edge_ranks
    block_start = offsets_from_counts(block_len)
    out = torch.empty(int(block_start[-1]), dtype=I64, device=dev)
    out[block_start[hdr_pos]] = edge_offsets[1:] - edge_offsets[:-1]
    out[block_start[edge_pos]] = edge_labels + 1
    e, slot = _ragged_slots(edge_ranks)
    out[block_start[edge_pos][e] + 1 + slot] = params + 1
    return out


def encode(grammar: Grammar) -> EncodedGrammar:
    g = grammar
    table = g.table
    dev = g.device
    start = g.start.gather_edges(torch.sort(g.start.labels, stable=True).indices)

    # incidence matrix points (deduplicated by the k2 builder)
    ranks = start.ranks()
    edge_ids = torch.repeat_interleave(torch.arange(start.n_edges, dtype=I64, device=dev),
                                       ranks, output_size=start.nodes_flat.numel())
    incidence = K2Tree(start.nodes_flat, edge_ids, max(start.n_nodes, 1),
                       max(start.n_edges, 1))

    pi_flat, per_edge, fn_first, fn_lengths = index_functions(start.nodes_flat,
                                                              start.offsets)
    fn_stream = delta_encode(_fn_symbols(pi_flat, start.offsets, fn_first, fn_lengths))
    edge_fn_stream = delta_encode(per_edge + 1)

    rule_labels = sorted(g.rules)
    assert rule_labels == list(range(table.n_terminals, table.n_terminals + len(rule_labels)))
    symbols = _rule_symbols(g)
    rule_stream = delta_encode(symbols)

    return EncodedGrammar(
        n_nodes=start.n_nodes,
        n_edges=start.n_edges,
        n_terminals=table.n_terminals,
        terminal_ranks=table.ranks[: table.n_terminals].clone(),
        label_ef=EliasFano(start.labels, universe=int(table.n_labels)),
        incidence=incidence,
        fn_stream=fn_stream,
        fn_lengths=fn_lengths,
        n_fns=int(fn_lengths.numel()),
        edge_fn_stream=edge_fn_stream,
        rule_stream=rule_stream,
        rule_symbol_count=int(symbols.numel()),
        n_rules=len(rule_labels),
        names=table.names,
    )
