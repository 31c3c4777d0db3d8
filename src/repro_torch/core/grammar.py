"""Straight-line hyperedge-replacement (SL-HR) grammars and expansion.

A rule ``A -> G_A`` has a right-hand side whose nodes ``0..rank(A)-1`` are
its parameters; expanding an edge ``A(v0..vk)`` maps RHS node ``j`` to
``vj``. Rules live in a host dict keyed by label, each RHS a small
:class:`Hypergraph` on the grammar's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core._arrays import I64, offsets_from_counts
from repro_torch.core.hypergraph import Hypergraph, LabelTable, _check


@dataclass
class Rule:
    label: int
    rank: int
    rhs: Hypergraph  # n_nodes == rank; all nodes are parameters

    def validate(self, table: LabelTable) -> None:
        """Raise ``AssertionError`` unless the rule agrees with `table` and
        every parameter occurs in its body (``decode`` relies on it)."""
        _check(0 <= self.label < table.n_labels and int(table.ranks[self.label]) == self.rank,
               "rule rank != label rank")
        _check(self.rhs.n_nodes == self.rank, "a rule body has rank many nodes")
        self.rhs.validate(table)
        if self.rhs.n_edges:
            _check(torch.equal(torch.unique(self.rhs.nodes_flat),
                               torch.arange(self.rank, device=self.rhs.device)),
                   "every parameter must occur in the rule body")


@dataclass
class Grammar:
    table: LabelTable
    start: Hypergraph
    rules: dict[int, Rule] = field(default_factory=dict)  # label -> rule

    @property
    def device(self) -> torch.device:
        return self.start.device

    def validate(self) -> None:
        """Raise ``AssertionError`` unless the start graph and every rule
        are consistent with the table and the rules are non-recursive."""
        self.start.validate(self.table)
        for lbl, rule in self.rules.items():
            _check(lbl == rule.label and lbl >= self.table.n_terminals,
                   "rules are keyed by their nonterminal label")
            rule.validate(self.table)
        _check(self._topological_order() is not None, "grammar must be non-recursive")

    def _rule_label_sets(self) -> dict[int, list[int]]:
        """label -> distinct labels of its RHS (one host transfer)."""
        if not self.rules:
            return {}
        lbls = list(self.rules)
        counts = [self.rules[lbl].rhs.n_edges for lbl in lbls]
        flat = torch.cat([self.rules[lbl].rhs.labels for lbl in lbls]).tolist()
        out, pos = {}, 0
        for lbl, c in zip(lbls, counts):
            out[lbl] = sorted(set(flat[pos:pos + c]))
            pos += c
        return out

    def _topological_order(self, rhs_labels=None) -> list[int] | None:
        """Rule labels in dependency order (used rules first); None if cyclic."""
        rhs_labels = self._rule_label_sets() if rhs_labels is None else rhs_labels
        deps = {lbl: {x for x in xs if x in self.rules} for lbl, xs in rhs_labels.items()}
        order, done = [], set()
        while len(order) < len(deps):
            progress = False
            for lbl, ds in deps.items():
                if lbl not in done and ds <= done:
                    order.append(lbl)
                    done.add(lbl)
                    progress = True
            if not progress:
                return None
        return order

    # ------------------------------------------------------------------
    def expand_once(self, graph: Hypergraph) -> tuple[Hypergraph, bool]:
        """Replace every nonterminal edge by its instantiated RHS (one level)."""
        dev = graph.device
        if not self.rules:
            return graph, False
        rule_labels = torch.tensor(sorted(self.rules), dtype=I64, device=dev)
        is_nt = torch.isin(graph.labels, rule_labels)
        if not bool(is_nt.any()):
            return graph, False
        keep = graph.select(~is_nt)
        nt_graph = graph.select(is_nt)
        starts = nt_graph.offsets[:-1]
        new_labels, new_flat, new_ranks = [], [], []
        for lbl in torch.unique(nt_graph.labels).tolist():
            rule = self.rules[lbl]
            sel = torch.nonzero(nt_graph.labels == lbl).reshape(-1)
            n_sel = int(sel.numel())
            node_mat = nt_graph.nodes_flat[
                starts[sel][:, None] + torch.arange(rule.rank, device=dev)[None, :]]
            rhs = rule.rhs
            r_labels = rhs.labels.tolist()
            r_off = rhs.offsets.tolist()
            for j in range(rhs.n_edges):
                params = rhs.nodes_flat[r_off[j]:r_off[j + 1]]
                new_labels.append(torch.full((n_sel,), r_labels[j], dtype=I64, device=dev))
                new_flat.append(node_mat[:, params].reshape(-1))
                new_ranks.append(torch.full((n_sel,), r_off[j + 1] - r_off[j],
                                            dtype=I64, device=dev))
        out = keep.concat_edges(torch.cat(new_labels), torch.cat(new_flat),
                                torch.cat(new_ranks))
        return out, True

    def decompress(self) -> Hypergraph:
        g = self.start
        changed = True
        guard = 0
        while changed:
            g, changed = self.expand_once(g)
            guard += 1
            assert guard <= len(self.rules) + 2, "expansion did not terminate"
        return g

    def rule_csr(self):
        """Rule bodies in label order as CSR tensors: (rule_labels,
        edge_offsets, edge_labels, edge_ranks, params)."""
        dev = self.device
        lbls = sorted(self.rules)
        rhs = [self.rules[lbl].rhs for lbl in lbls]
        rule_labels = torch.tensor(lbls, dtype=I64, device=dev)
        counts = torch.tensor([g.n_edges for g in rhs], dtype=I64, device=dev)
        if not rhs:
            z = torch.zeros(0, dtype=I64, device=dev)
            return rule_labels, torch.zeros(1, dtype=I64, device=dev), z, z, z
        return (rule_labels, offsets_from_counts(counts),
                torch.cat([g.labels for g in rhs]),
                torch.cat([g.ranks() for g in rhs]),
                torch.cat([g.nodes_flat for g in rhs]))

    # ------------------------------------------------------------------
    def size_units(self) -> int:
        """Integer-unit grammar size (drives the RePair stop condition)."""
        total = self.start.size_units()
        for r in self.rules.values():
            total += 1 + r.rhs.size_units()
        return total

    def nt_generates(self) -> torch.Tensor:
        """bool[n_rule_labels, n_terminals]: A (transitively) emits label t.
        Rows indexed by (label - n_terminals)."""
        T = self.table.n_terminals
        n_nt = (max(self.rules) - T + 1) if self.rules else 0
        gen = torch.zeros((n_nt, T), dtype=torch.bool, device=self.device)
        rhs_labels = self._rule_label_sets()
        order = self._topological_order(rhs_labels)
        assert order is not None
        for lbl in order:
            row = gen[lbl - T]
            terms = [x for x in rhs_labels[lbl] if x < T]
            if terms:
                row[torch.tensor(terms, dtype=I64, device=self.device)] = True
            for x in rhs_labels[lbl]:
                if x >= T:
                    row |= gen[x - T]
        return gen

    # ------------------------------------------------------------------
    def prune(self) -> "Grammar":
        """Inline rules used once, drop unused rules, renumber nonterminals
        in topological order."""
        g = self
        while True:
            usage = g._usage_counts()
            once = [lbl for lbl, c in usage.items() if c == 1]
            unused = [lbl for lbl, c in usage.items() if c == 0]
            if not once and not unused:
                break
            g = g._inline_and_drop(set(once), set(unused))
        return g._renumber()

    def _usage_counts(self) -> dict[int, int]:
        usage = {lbl: 0 for lbl in self.rules}
        if not usage:
            return usage
        labels = torch.cat([self.start.labels] + [r.rhs.labels for r in self.rules.values()])
        counts = torch.bincount(labels, minlength=self.table.n_labels).tolist()
        for lbl in usage:
            usage[lbl] = counts[lbl]
        return usage

    def _inline_and_drop(self, once: set, unused: set) -> "Grammar":
        sub = Grammar(self.table, self.start,
                      {lbl: r for lbl, r in self.rules.items() if lbl not in unused})

        def inline(graph: Hypergraph) -> Hypergraph:
            if not once:
                return graph
            # once-rules may nest: expand to a fixpoint
            partial = Grammar(self.table, graph,
                              {lbl: self.rules[lbl] for lbl in once if lbl in self.rules})
            changed = True
            while changed and partial.rules:
                graph, changed = partial.expand_once(graph)
            return graph

        new_start = inline(sub.start)
        new_rules = {}
        for lbl, r in sub.rules.items():
            if lbl in once:
                continue
            new_rules[lbl] = Rule(lbl, r.rank, inline(r.rhs))
        return Grammar(self.table, new_start, new_rules)

    def _renumber(self) -> "Grammar":
        T = self.table.n_terminals
        order = self._topological_order()
        assert order is not None
        dev = self.device
        mapping = {lbl: T + i for i, lbl in enumerate(order)}
        lut = torch.arange(self.table.n_labels, dtype=I64, device=dev)
        if mapping:
            lut[torch.tensor(list(mapping), dtype=I64, device=dev)] = torch.tensor(
                list(mapping.values()), dtype=I64, device=dev)

        def remap(graph: Hypergraph) -> Hypergraph:
            labels = lut[graph.labels] if graph.n_edges else graph.labels.clone()
            return Hypergraph(graph.n_nodes, labels, graph.nodes_flat.clone(),
                              graph.offsets.clone())

        new_ranks = torch.cat([self.table.ranks[:T], torch.tensor(
            [self.rules[lbl].rank for lbl in order], dtype=I64, device=dev)])
        table = LabelTable(new_ranks, T, self.table.names)
        rules = {mapping[lbl]: Rule(mapping[lbl], self.rules[lbl].rank,
                                    remap(self.rules[lbl].rhs)) for lbl in order}
        return Grammar(table, remap(self.start), rules)
