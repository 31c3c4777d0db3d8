"""Array-based hypergraph with labeled (hyper)edges, as torch tensors.

Same struct-of-arrays layout as the reference:

  labels[e]                -> label id of edge e
  nodes_flat / offsets[e]  -> node tuple of edge e (ragged)

Terminal labels occupy ids ``0..n_terminals-1``; nonterminals introduced by
compression are appended after. All tensors of one graph live on one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core._arrays import I64, empty, offsets_from_counts
from repro_torch.device import as_i64, resolve_device


@dataclass
class LabelTable:
    ranks: torch.Tensor  # int64[n_labels]
    n_terminals: int
    names: list[str] | None = None

    @classmethod
    def terminals(cls, ranks, names=None, device=None) -> "LabelTable":
        dev = ranks.device if isinstance(ranks, torch.Tensor) and device is None \
            else resolve_device(device)
        ranks = as_i64(ranks, dev)
        return cls(ranks=ranks, n_terminals=int(ranks.numel()), names=names)

    @property
    def n_labels(self) -> int:
        return int(self.ranks.numel())

    @property
    def device(self) -> torch.device:
        return self.ranks.device

    def add_label(self, rank: int) -> int:
        """Append a nonterminal label; returns its id."""
        self.ranks = torch.cat(
            [self.ranks, torch.tensor([rank], dtype=I64, device=self.device)])
        return self.n_labels - 1

    def it_offsets(self) -> torch.Tensor:
        """Incidence-type id of (label a, connection m) is it_offsets[a] + m."""
        return offsets_from_counts(self.ranks)

    def copy(self) -> "LabelTable":
        return LabelTable(self.ranks.clone(), self.n_terminals, self.names)


@dataclass
class Hypergraph:
    n_nodes: int
    labels: torch.Tensor      # int64[E]
    nodes_flat: torch.Tensor  # int64[sum ranks]
    offsets: torch.Tensor     # int64[E+1]

    @classmethod
    def from_edges(cls, n_nodes: int, edges: list[tuple[int, list[int]]],
                   device=None) -> "Hypergraph":
        """edges: list of (label, [v0..vk])."""
        dev = resolve_device(device)
        labels = torch.tensor([e[0] for e in edges], dtype=I64, device=dev)
        counts = torch.tensor([len(e[1]) for e in edges], dtype=I64, device=dev)
        flat = [int(v) for e in edges for v in e[1]]
        nodes_flat = torch.tensor(flat, dtype=I64, device=dev)
        return cls(n_nodes, labels, nodes_flat, offsets_from_counts(counts))

    @classmethod
    def from_triples(cls, triples, n_nodes: int, device=None) -> "Hypergraph":
        """triples: (n, 3) rows (s, p, o) -> rank-2 edges p(s, o)."""
        dev = triples.device if isinstance(triples, torch.Tensor) and device is None \
            else resolve_device(device)
        triples = as_i64(triples, dev).reshape(-1, 3)
        labels = triples[:, 1].clone()
        nodes_flat = triples[:, [0, 2]].reshape(-1).contiguous()
        offsets = torch.arange(triples.shape[0] + 1, dtype=I64, device=dev) * 2
        return cls(n_nodes, labels, nodes_flat, offsets)

    @property
    def n_edges(self) -> int:
        return int(self.labels.numel())

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def ranks(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def edge_tuples(self) -> list[tuple[int, tuple[int, ...]]]:
        """Python-friendly view (tests / small graphs only)."""
        labels = self.labels.tolist()
        nodes = self.nodes_flat.tolist()
        off = self.offsets.tolist()
        return [(labels[e], tuple(nodes[off[e]:off[e + 1]])) for e in range(len(labels))]

    def validate(self, table: LabelTable | None = None) -> None:
        """Raise ``AssertionError`` unless the layout is consistent: offsets
        span the node list, every node lies in ``[0, n_nodes)`` (any node
        when ``n_nodes`` is 0), and with `table` every edge's arity equals
        its label's rank."""
        _check(self.offsets.numel() == self.n_edges + 1, "offsets must have n_edges + 1 entries")
        _check(int(self.offsets[0]) == 0 and int(self.offsets[-1]) == self.nodes_flat.numel(),
               "offsets must span the node list")
        if self.n_edges and self.nodes_flat.numel():
            _check(int(self.nodes_flat.min()) >= 0 and (
                self.n_nodes == 0 or int(self.nodes_flat.max()) < self.n_nodes),
                "node ids must lie in [0, n_nodes)")
        if table is not None and self.n_edges:
            _check(0 <= int(self.labels.min()) and int(self.labels.max()) < table.n_labels,
                   "edge label outside the label table")
            _check(torch.equal(self.ranks(), table.ranks[self.labels]), "edge arity != label rank")

    def size_units(self) -> int:
        """Integer-unit size model: 1 (label) + rank per edge."""
        return int(self.n_edges + self.nodes_flat.numel())

    def select(self, mask: torch.Tensor) -> "Hypergraph":
        """Subgraph with the edges where mask holds (nodes untouched)."""
        return self.gather_edges(torch.nonzero(mask).reshape(-1))

    def gather_edges(self, idx: torch.Tensor) -> "Hypergraph":
        new_ranks = self.ranks()[idx]
        take = _ragged_take(self.offsets, idx, new_ranks)
        return Hypergraph(self.n_nodes, self.labels[idx], self.nodes_flat[take],
                          offsets_from_counts(new_ranks))

    def concat_edges(self, labels: torch.Tensor, nodes_flat: torch.Tensor,
                     ranks: torch.Tensor) -> "Hypergraph":
        new_offsets = torch.cat([self.offsets, self.offsets[-1] + torch.cumsum(ranks, 0)])
        return Hypergraph(self.n_nodes, torch.cat([self.labels, labels]),
                          torch.cat([self.nodes_flat, nodes_flat]), new_offsets)

    def copy(self) -> "Hypergraph":
        return Hypergraph(self.n_nodes, self.labels.clone(), self.nodes_flat.clone(),
                          self.offsets.clone())


def _check(ok: bool, msg: str) -> None:
    """``validate``'s assertion, raised explicitly so that ``python -O``
    keeps it."""
    if not ok:
        raise AssertionError(msg)


def _ragged_take(offsets: torch.Tensor, idx: torch.Tensor,
                 out_ranks: torch.Tensor) -> torch.Tensor:
    """Flat indices selecting the node tuples of edges `idx`."""
    total = int(out_ranks.sum()) if out_ranks.numel() else 0
    if total == 0:
        return empty(offsets.device)
    out_offsets = offsets_from_counts(out_ranks)
    pos = torch.arange(total, dtype=I64, device=offsets.device) \
        - torch.repeat_interleave(out_offsets[:-1], out_ranks, output_size=total)
    return torch.repeat_interleave(offsets[idx], out_ranks, output_size=total) + pos
