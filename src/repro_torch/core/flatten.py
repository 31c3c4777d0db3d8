"""Flattened (array-native) view of an SL-HR grammar for batch queries.

The rule bodies become CSR tensors on the device, so that expanding every
nonterminal edge of a frontier is a handful of gathers:

  rule_index[label]          -> dense rule slot (-1 for terminals)
  edge_offsets[r:r+2]        -> slice of rule r's RHS edges
  edge_labels[j]             -> child label of RHS edge j
  param_offsets[j:j+2]       -> slice of edge j's parameter positions
  params[...]                -> indices into the parent edge's node tuple
  nt_gen[r, p]               -> rule r (transitively) emits terminal p
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core._arrays import I64, empty, offsets_from_counts
from repro_torch.core.grammar import Grammar
from repro_torch.device import resolve_device


def _ragged_arange(counts: torch.Tensor, total: int | None = None) -> torch.Tensor:
    """[0..counts[0]), [0..counts[1]), ... concatenated."""
    if total is None:
        total = int(counts.sum()) if counts.numel() else 0
    if total == 0:
        return empty(counts.device)
    ends = torch.cumsum(counts, 0)
    return torch.arange(total, dtype=I64, device=counts.device) \
        - torch.repeat_interleave(ends - counts, counts, output_size=total)


def concat_ragged(chunks, device):
    """Concatenate ragged ``(labels, nodes_flat, offsets)`` triples into one."""
    chunks = [c for c in chunks if c[0].numel()]
    if not chunks:
        return empty(device), empty(device), torch.zeros(1, dtype=I64, device=device)
    if len(chunks) == 1:
        return chunks[0]
    labels = torch.cat([c[0] for c in chunks])
    nodes = torch.cat([c[1] for c in chunks])
    ranks = torch.cat([c[2][1:] - c[2][:-1] for c in chunks])
    return labels, nodes, offsets_from_counts(ranks)


class FrontierArena:
    """Geometrically grown device buffers for ragged result batches.

    The frontier loop emits one chunk of matched terminal edges per level;
    the arena copies each chunk into place and doubles its capacity only when
    a chunk overflows it. ``finish()`` returns right-sized copies.
    """

    def __init__(self, device, edge_cap: int = 1024, node_cap: int = 4096):
        self.device = device
        self._q = torch.empty(max(edge_cap, 1), dtype=I64, device=device)
        self._l = torch.empty_like(self._q)
        self._r = torch.empty_like(self._q)
        self._n = torch.empty(max(node_cap, 1), dtype=I64, device=device)
        self.n_edges = 0
        self.n_nodes = 0

    def reset(self) -> None:
        self.n_edges = 0
        self.n_nodes = 0

    @staticmethod
    def _grown(buf: torch.Tensor, live: int, needed: int) -> torch.Tensor:
        cap = buf.numel()
        while cap < needed:
            cap *= 2
        new = torch.empty(cap, dtype=I64, device=buf.device)
        new[:live] = buf[:live]
        return new

    def push(self, qids, labels, ranks, nodes) -> None:
        """Append one chunk of edges (qids/labels/ranks aligned, nodes flat)."""
        ne = self.n_edges + labels.numel()
        nn = self.n_nodes + nodes.numel()
        if ne > self._q.numel():
            self._q = self._grown(self._q, self.n_edges, ne)
            self._l = self._grown(self._l, self.n_edges, ne)
            self._r = self._grown(self._r, self.n_edges, ne)
        if nn > self._n.numel():
            self._n = self._grown(self._n, self.n_nodes, nn)
        self._q[self.n_edges:ne] = qids
        self._l[self.n_edges:ne] = labels
        self._r[self.n_edges:ne] = ranks
        self._n[self.n_nodes:nn] = nodes
        self.n_edges = ne
        self.n_nodes = nn

    def finish(self):
        """(qids, labels, nodes_flat, offsets) as right-sized copies; resets."""
        ne, nn = self.n_edges, self.n_nodes
        out = (self._q[:ne].clone(), self._l[:ne].clone(), self._n[:nn].clone(),
               offsets_from_counts(self._r[:ne]))
        self.reset()
        return out


@dataclass
class FlatGrammar:
    """CSR tensors for rule bodies + NT-reachability bitsets."""

    n_terminals: int
    rule_index: torch.Tensor     # int64[n_labels]: label -> rule slot or -1
    rule_labels: torch.Tensor    # int64[n_rules]: slot -> label
    edge_offsets: torch.Tensor   # int64[n_rules+1]
    edge_labels: torch.Tensor    # int64[total_rhs_edges]
    edge_ranks: torch.Tensor     # int64[total_rhs_edges]
    param_offsets: torch.Tensor  # int64[total_rhs_edges+1]
    params: torch.Tensor         # int64[total_params]
    nt_gen: torch.Tensor         # bool[n_rules, n_terminals]

    _ARRAY_FIELDS = ("rule_index", "rule_labels", "edge_offsets", "edge_labels",
                     "edge_ranks", "param_offsets", "params", "nt_gen")

    @property
    def n_rules(self) -> int:
        return int(self.rule_labels.numel())

    @classmethod
    def from_grammar(cls, grammar: Grammar) -> "FlatGrammar":
        T = grammar.table.n_terminals
        dev = grammar.device
        rule_labels, edge_offsets, edge_labels, edge_ranks, params = grammar.rule_csr()
        rule_index = torch.full((grammar.table.n_labels,), -1, dtype=I64, device=dev)
        rule_index[rule_labels] = torch.arange(rule_labels.numel(), dtype=I64, device=dev)
        gen = grammar.nt_generates()
        nt_gen = gen[rule_labels - T] if rule_labels.numel() \
            else torch.zeros((0, T), dtype=torch.bool, device=dev)
        return cls(T, rule_index, rule_labels, edge_offsets, edge_labels, edge_ranks,
                   offsets_from_counts(edge_ranks), params, nt_gen)

    def to_arrays(self) -> dict[str, np.ndarray]:
        """The CSR as host numpy arrays named as :attr:`_ARRAY_FIELDS`: the
        snapshot wire form (int64, ``nt_gen`` a 2-D bool array), as the
        reference's ``to_arrays`` gives them."""
        return {name: getattr(self, name).cpu().numpy() for name in self._ARRAY_FIELDS}

    @classmethod
    def from_arrays(cls, n_terminals: int, arrays: dict, device=None) -> "FlatGrammar":
        """Build from plain arrays named as :attr:`_ARRAY_FIELDS` (the
        reference snapshot's ``flat_*`` arrays, without the prefix)."""
        dev = resolve_device(device)
        cols = [torch.from_numpy(np.array(arrays[name], dtype=bool if name == "nt_gen"
                                          else np.int64)).to(dev)
                for name in cls._ARRAY_FIELDS]
        return cls(int(n_terminals), *cols)

    def generates(self, labels: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
        """NT[label, p] per (nonterminal label, terminal p) pair."""
        if self.nt_gen.numel() == 0:
            return torch.zeros(labels.numel(), dtype=torch.bool, device=labels.device)
        return self.nt_gen[self.rule_index[labels], preds]

    def expand(self, labels, nodes_flat, offsets, *payload):
        """One frontier level: instantiate every RHS edge of every NT edge.
        Returns (child_labels, child_nodes_flat, child_offsets, payloads)."""
        dev = labels.device
        slots = self.rule_index[labels]
        counts = self.edge_offsets[slots + 1] - self.edge_offsets[slots]
        n_child = int(counts.sum()) if counts.numel() else 0
        parent = torch.repeat_interleave(torch.arange(labels.numel(), device=dev), counts,
                                         output_size=n_child)
        rei = torch.repeat_interleave(self.edge_offsets[slots], counts,
                                      output_size=n_child) + _ragged_arange(counts, n_child)
        child_labels = self.edge_labels[rei]
        child_ranks = self.edge_ranks[rei]
        n_nodes = int(child_ranks.sum()) if n_child else 0
        pidx = torch.repeat_interleave(self.param_offsets[rei], child_ranks,
                                       output_size=n_nodes) \
            + _ragged_arange(child_ranks, n_nodes)
        parent_starts = offsets[:-1][parent]
        child_nodes = nodes_flat[torch.repeat_interleave(parent_starts, child_ranks,
                                                         output_size=n_nodes)
                                 + self.params[pidx]]
        out_payload = tuple(col[parent] for col in payload)
        return child_labels, child_nodes, offsets_from_counts(child_ranks), out_payload
