"""The ITR RePair loop on the device: count -> replace mfd -> update count -> prune.

A line-for-line port of the reference's vectorized replacement: per node,
candidate edges are classed by which digram side(s) they can serve, paired
greedily, and cross-node conflicts are resolved by pair priority over a few
rounds. Every sort whose order matters is stable, and each ``np.lexsort`` is
a chain of stable sorts, so the grammar comes out identical to the
reference's. The Count, the Update Count and the selection of the most
frequent digram run on the device (:class:`repro_torch.core.digram.DigramCounter`:
the ``digram_pair_accum`` and ``digram_select`` kernels).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core._arrays import I64, empty, group_starts, lexsort, offsets_from_counts
from repro_torch.core.digram import DigramCounter, incidences, split_digram, split_it
from repro_torch.core.grammar import Grammar, Rule
from repro_torch.core.hypergraph import Hypergraph, LabelTable


@dataclass
class RepairConfig:
    max_rank: int = 32          # bound on new nonterminal rank
    cap: int | None = 64        # per-node distinct incidence-type cap (None = exact)
    selection: str = "count"    # "count" = paper's mfd; "savings" = beyond-paper
    max_iters: int | None = None
    prune: bool = True
    min_count: int | None = None  # if set, replace while count >= min_count


@dataclass
class RepairStats:
    iterations: int = 0
    replaced_occurrences: int = 0
    rules_created: int = 0
    initial_size_units: int = 0
    final_size_units: int = 0


def compress(graph: Hypergraph, table: LabelTable,
             config: RepairConfig | None = None) -> tuple[Grammar, RepairStats]:
    """Run ITR compression on the graph's device; returns (grammar, stats)."""
    config = config or RepairConfig()
    table = table.copy()
    graph = graph.copy()
    stats = RepairStats(initial_size_units=graph.size_units())
    counter = DigramCounter(graph, table, cap=config.cap)
    ranks = table.ranks.tolist()  # host copies for scalar lookups
    it_offsets = _offsets(ranks)   # stable under label append
    rules: dict[int, Rule] = {}
    skip: set[int] = set()

    while config.max_iters is None or stats.iterations < config.max_iters:
        picked = _select_digram(counter, ranks, it_offsets, skip, config)
        if picked is None:
            break
        key, _count = picked
        it1, it2 = split_digram(key)
        a1, m1 = split_it(it1, it_offsets)
        a2, m2 = split_it(it2, it_offsets)
        r1, r2 = ranks[a1], ranks[a2]

        e1s, e2s = _find_occurrences(graph, a1, m1, a2, m2, it1 == it2)
        if e1s.numel() == 0:
            skip.add(key)  # count is positive but only self-pairs exist
            continue

        new_label = table.add_label(r1 + r2 - 1)
        ranks.append(r1 + r2 - 1)
        it_offsets.append(it_offsets[-1] + r1 + r2 - 1)
        rules[new_label] = _make_rule(new_label, a1, m1, r1, a2, m2, r2, graph.device)
        graph, removed_inc, added_inc = _replace(
            graph, table, e1s, e2s, a1, m1, r1, a2, m2, r2, new_label)
        counter.apply_delta(removed_inc, added_inc)
        stats.iterations += 1
        stats.replaced_occurrences += int(e1s.numel())
        stats.rules_created += 1

    grammar = Grammar(table, graph, rules)
    if config.prune:
        grammar = grammar.prune()
    stats.final_size_units = grammar.size_units()
    return grammar, stats


# ----------------------------------------------------------------------
def _offsets(ranks: list[int]) -> list[int]:
    out = [0]
    for r in ranks:
        out.append(out[-1] + r)
    return out


def _savings(count: int, r1: int, r2: int) -> int:
    # each occurrence trades (1+r1)+(1+r2) units for 1+r1+r2-1; the rule
    # costs 3 + r1 + r2 units
    return 2 * count - (3 + r1 + r2)


def _digram_ranks(key, ranks, it_offsets):
    it1, it2 = split_digram(key)
    a1, _ = split_it(it1, it_offsets)
    a2, _ = split_it(it2, it_offsets)
    return ranks[a1], ranks[a2]


def _select_digram(counter, ranks, it_offsets, skip, config):
    """Pick the next digram per config.selection; None = stop."""
    if config.selection == "count":
        while True:
            best = counter.pop_best(skip)
            if best is None:
                return None
            key, cnt = best
            r1, r2 = _digram_ranks(key, ranks, it_offsets)
            if r1 + r2 - 1 > config.max_rank:
                skip.add(key)
                continue
            if config.min_count is not None:
                if cnt < config.min_count:
                    return None
            elif _savings(cnt, r1, r2) <= 0:
                return None  # paper: stop when the mfd no longer shrinks the grammar
            return key, cnt
    elif config.selection == "savings":
        popped = []
        best_key, best_score, best_cnt = None, 0, 0
        while True:
            item = counter.peek_pop(skip)
            if item is None:
                break
            key, cnt = item
            popped.append(item)
            if 2 * cnt - 5 <= best_score:
                break
            r1, r2 = _digram_ranks(key, ranks, it_offsets)
            if r1 + r2 - 1 > config.max_rank:
                skip.add(key)
                continue
            score = _savings(cnt, r1, r2)
            if score > best_score:
                best_key, best_score, best_cnt = key, score, cnt
        for key, cnt in popped:
            counter.push_back(key, cnt)
        if best_key is None or best_score <= 0:
            return None
        return best_key, best_cnt
    raise ValueError(f"unknown selection {config.selection}")


# ----------------------------------------------------------------------
def _find_occurrences(graph, a1, m1, a2, m2, same_it):
    """Greedy maximal set of non-overlapping occurrences; returns (e1s, e2s)."""
    dev = graph.device
    labels = graph.labels
    starts = graph.offsets[:-1]
    if same_it:
        cand = torch.nonzero(labels == a1).reshape(-1)
        v = graph.nodes_flat[starts[cand] + m1]
        order = lexsort((cand, v))
        cand, v = cand[order], v[order]
        n = v.numel()
        # pair consecutive edges within each node group
        ar = torch.arange(n, dtype=I64, device=dev)
        grp_start = torch.ones(n, dtype=torch.bool, device=dev)
        grp_start[1:] = v[1:] != v[:-1]
        if n:
            first_of_grp = torch.cummax(torch.where(grp_start, ar, 0), 0).values
        else:
            first_of_grp = ar
        idx_in_grp = ar - first_of_grp
        is_first = (idx_in_grp % 2 == 0) & (ar + 1 < n)
        partner_same_node = torch.zeros(n, dtype=torch.bool, device=dev)
        partner_same_node[:-1] = v[:-1] == v[1:]
        take = torch.nonzero(is_first & partner_same_node).reshape(-1)
        return cand[take], cand[take + 1]

    avail = torch.ones(graph.n_edges, dtype=torch.bool, device=dev)
    out1, out2 = [], []
    for _round in range(64):
        c1 = torch.nonzero((labels == a1) & avail).reshape(-1)
        c2 = torch.nonzero((labels == a2) & avail).reshape(-1)
        if c1.numel() == 0 or c2.numel() == 0:
            break
        v1 = graph.nodes_flat[starts[c1] + m1]
        v2 = graph.nodes_flat[starts[c2] + m2]
        p1, p2 = _propose_pairs(c1, v1, c2, v2)
        if p1.numel() == 0:
            break
        # cross-node conflict resolution: keep the lowest-priority pair per edge
        pid = torch.arange(p1.numel(), dtype=I64, device=dev)
        min_pid = torch.full((graph.n_edges,), p1.numel(), dtype=I64, device=dev)
        min_pid.scatter_reduce_(0, p1, pid, reduce="amin")
        min_pid.scatter_reduce_(0, p2, pid, reduce="amin")
        keep = (min_pid[p1] == pid) & (min_pid[p2] == pid)
        kept = torch.nonzero(keep).reshape(-1)
        if kept.numel() == 0:
            break
        kept1, kept2 = p1[kept], p2[kept]
        out1.append(kept1)
        out2.append(kept2)
        avail[kept1] = False
        avail[kept2] = False
        if kept.numel() == keep.numel():
            break  # nothing was dropped; no edge left to retry
    if not out1:
        return empty(dev), empty(dev)
    return torch.cat(out1), torch.cat(out2)


def _propose_pairs(c1, v1, c2, v2):
    """Per-node greedy pairing of side-0 (c1@v1) and side-1 (c2@v2) candidates."""
    dev = c1.device
    nodes = torch.cat([v1, v2])
    edges = torch.cat([c1, c2])
    bits = torch.cat([torch.ones(c1.numel(), dtype=I64, device=dev),
                      torch.full((c2.numel(),), 2, dtype=I64, device=dev)])
    base = int(edges.max()) + 1
    uk, inv = torch.unique(nodes * base + edges, return_inverse=True)
    # a (node, edge) key occurs at most once per side, so the reference's
    # scatter-OR of the side bits is an exact scatter-add
    flag = torch.zeros(uk.numel(), dtype=I64, device=dev).index_add_(0, inv, bits)
    u_nodes = uk // base
    u_edges = uk % base
    # class: A=1 (side0 only), C=2 (side1 only), B=3 (both); sort (node, class, edge)
    order = lexsort((u_edges, flag, u_nodes))
    u_nodes, u_edges, flag = u_nodes[order], u_edges[order], flag[order]

    grp_start = group_starts(u_nodes)
    grp_end = torch.cat([grp_start[1:], torch.tensor([u_nodes.numel()], device=dev)])
    n_grp = grp_start.numel()
    gidx = torch.repeat_interleave(torch.arange(n_grp, device=dev), grp_end - grp_start)

    def class_count(c):
        return torch.zeros(n_grp, dtype=I64, device=dev).index_add_(
            0, gidx, (flag == c).to(I64))

    a_cnt, c_cnt, b_cnt = class_count(1), class_count(2), class_count(3)
    a_off = grp_start
    c_off = grp_start + a_cnt
    b_off = c_off + c_cnt

    p_ac = torch.minimum(a_cnt, c_cnt)
    rem_a = a_cnt - p_ac
    rem_c = c_cnt - p_ac
    p_ab = torch.minimum(rem_a, b_cnt)
    p_bc = torch.minimum(rem_c, b_cnt - p_ab)
    p_bb = torch.div(b_cnt - p_ab - p_bc, 2, rounding_mode="floor")

    def ragged(offsets_l, counts, offsets_r, stride_l=1, stride_r=1, base_r=0):
        tot = int(counts.sum())
        if tot == 0:
            return empty(dev), empty(dev)
        i = torch.arange(tot, dtype=I64, device=dev) - torch.repeat_interleave(
            offsets_from_counts(counts)[:-1], counts, output_size=tot)
        left = torch.repeat_interleave(offsets_l, counts, output_size=tot) + stride_l * i
        right = torch.repeat_interleave(offsets_r, counts, output_size=tot) \
            + stride_r * i + base_r
        return left, right

    l_ac, r_ac = ragged(a_off, p_ac, c_off)
    l_ab, r_ab = ragged(a_off + p_ac, p_ab, b_off)   # A leftover x B (as side 1)
    l_bc, r_bc = ragged(b_off, p_bc, c_off + p_ac)   # B (as side 0) x C leftover
    bb_start = b_off + p_ab + p_bc
    l_bb, r_bb = ragged(bb_start, p_bb, bb_start, stride_l=2, stride_r=2, base_r=1)

    left = torch.cat([l_ac, l_ab, l_bc, l_bb])
    right = torch.cat([r_ac, r_ab, r_bc, r_bb])
    return u_edges[left], u_edges[right]


# ----------------------------------------------------------------------
def _others(rank: int, m: int) -> list[int]:
    return [x for x in range(rank) if x != m]


def _make_rule(new_label, a1, m1, r1, a2, m2, r2, device) -> Rule:
    """B -> { a1(params), a2(params) } with shared node = parameter 0."""
    new_rank = r1 + r2 - 1
    p1 = [0] * r1
    for x, val in zip(_others(r1, m1), range(1, r1)):
        p1[x] = val
    p2 = [0] * r2
    for x, val in zip(_others(r2, m2), range(r1, r1 + r2 - 1)):
        p2[x] = val
    rhs = Hypergraph.from_edges(new_rank, [(a1, p1), (a2, p2)], device=device)
    return Rule(new_label, new_rank, rhs)


def _replace(graph, table, e1s, e2s, a1, m1, r1, a2, m2, r2, new_label):
    """Swap matched edge pairs for new_label hyperedges; return incidence deltas."""
    dev = graph.device
    starts = graph.offsets[:-1]
    mat1 = graph.nodes_flat[starts[e1s][:, None] + torch.arange(r1, device=dev)[None, :]]
    mat2 = graph.nodes_flat[starts[e2s][:, None] + torch.arange(r2, device=dev)[None, :]]
    others1 = torch.tensor(_others(r1, m1), dtype=I64, device=dev)
    others2 = torch.tensor(_others(r2, m2), dtype=I64, device=dev)
    new_mat = torch.cat([mat1[:, m1:m1 + 1], mat1[:, others1], mat2[:, others2]], dim=1)

    removed = torch.zeros(graph.n_edges, dtype=torch.bool, device=dev)
    removed[e1s] = True
    removed[e2s] = True
    rem_inc = incidences(graph.select(removed), table)

    new_rank = r1 + r2 - 1
    n_new = int(e1s.numel())
    add_nodes = new_mat.reshape(-1)
    out = graph.select(~removed).concat_edges(
        torch.full((n_new,), new_label, dtype=I64, device=dev), add_nodes,
        torch.full((n_new,), new_rank, dtype=I64, device=dev))
    it0 = int(table.it_offsets()[new_label])  # one sync per replacement
    add_its = (it0 + torch.arange(new_rank, dtype=I64, device=dev)).repeat(n_new)
    return out, rem_inc, (add_nodes, add_its)
