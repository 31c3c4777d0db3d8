"""GraphStore: the paper's compressed graph as a data layer for training.

The twin of the reference's ``data/graph_store.py``. The graph is held as
an ITR grammar on the device; point lookups (neighbourhoods, triple
patterns) run on the compressed form through
:class:`~repro_torch.core.query.TripleQueryEngine` and share its result
cache. Training hot paths (full-batch GNN adjacency) read a materialized
CSR or CSC view: the grammar decompressed once on the device, the overlay
applied, one stable sort and a ``bincount``; int64 tensors on the store's
device, the order of the reference's arrays. Storage stays compressed; a
view is working memory.

The store is writable: ``insert_triples`` / ``delete_triples`` ride the
engine's delta overlay, so point lookups stay exact at once, and the
materialized views are dropped (and rebuilt overlay-applied at next use).
Node ids must stay within the store's fixed ``n_nodes``, which training
adjacency shapes are allocated against, unlike the bare engine, which lets
inserts grow the graph.
"""
from __future__ import annotations

import torch

from repro_torch.core import (
    Hypergraph,
    LabelTable,
    RepairConfig,
    TripleQueryEngine,
    compress,
    encode,
)
from repro_torch.core._arrays import I64, offsets_from_counts
from repro_torch.device import as_i64, resolve_device

_DEFAULT = object()  # "the engine decides" sentinel: cache=None must mean off


class GraphStore:
    def __init__(self, grammar, stats=None, cache=_DEFAULT, config=None):
        self.grammar = grammar
        self.stats = stats
        self.encoded = encode(grammar)
        engine_kwargs = {} if cache is _DEFAULT else {"cache": cache}
        self.engine = TripleQueryEngine(grammar, self.encoded, config=config, **engine_kwargs)
        self._csr = None
        self._csc = None

    # ------------------------------------------------------------- build
    @classmethod
    def from_triples(cls, triples, n_nodes: int, n_preds: int,
                     config: RepairConfig | None = None, device=None) -> "GraphStore":
        """Compress `triples` ((n, 3) rows) on `device` (``None`` means
        CUDA) into a store over `n_nodes` nodes and `n_preds` predicates."""
        dev = resolve_device(device)
        table = LabelTable.terminals([2] * n_preds, device=dev)
        graph = Hypergraph.from_triples(as_i64(triples, dev), n_nodes)
        grammar, stats = compress(graph, table, config)
        return cls(grammar, stats, config=config)

    @property
    def n_nodes(self) -> int:
        return self.grammar.start.n_nodes

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # ------------------------------------------------------- point paths
    def neighbors_out(self, v: int) -> torch.Tensor:
        """Compressed-path neighbourhood query (paper: ``v ? ?``)."""
        return self.engine.neighbors_out(v)

    def neighbors_in(self, v: int) -> torch.Tensor:
        return self.engine.neighbors_in(v)

    def neighbors_out_batch(self, vs) -> list[torch.Tensor]:
        """Batched ``v ? ?`` neighbourhoods, one frontier, cache-shared;
        duplicate vs share one tensor."""
        return self.engine.neighbors_out_batch(vs)

    def neighbors_in_batch(self, vs) -> list[torch.Tensor]:
        return self.engine.neighbors_in_batch(vs)

    def triples(self, s=None, p=None, o=None) -> list[tuple]:
        return self.engine.query(s, p, o)

    def triples_batch_view(self, s_arr, p_arr, o_arr):
        """Batched pattern lookup as a
        :class:`~repro_torch.core.query.QueryResultView`."""
        return self.engine.query_batch_view(s_arr, p_arr, o_arr)

    def query_cache_stats(self):
        """The engine's result-cache counters (None when caching is off)."""
        return self.engine.cache.stats if self.engine.cache is not None else None

    def compressed_size_bytes(self) -> int:
        return self.encoded.size_in_bytes()

    # ----------------------------------------------------------- mutation
    def insert_triples(self, triples) -> int:
        """Insert (s, p, o) rows (the engine's delta overlay); returns how
        many were new. Node ids must be < `n_nodes`: the training views'
        shapes are fixed at build. Materialized views are dropped."""
        rows = as_i64(triples, self.device).reshape(-1, 3)
        if rows.shape[0] and int(rows[:, [0, 2]].max()) >= self.n_nodes:
            raise ValueError(
                f"node ids must be < n_nodes={self.n_nodes}; rebuild the "
                f"store from triples to grow the node universe")
        return self._after_mutation(self.engine.insert_triples(rows))

    def delete_triples(self, triples) -> int:
        """Delete (s, p, o) rows; returns how many were present."""
        return self._after_mutation(self.engine.delete_triples(triples))

    def rebuild(self, config=None) -> bool:
        """Recompress base and delta now; True if the overlay was not empty."""
        return bool(self._after_mutation(int(self.engine.rebuild(config))))

    def _after_mutation(self, applied: int) -> int:
        """Refresh the grammar and encoding (the engine swaps them on a
        rebuild) and drop materialized views when anything changed."""
        if applied:
            self.grammar = self.engine.grammar
            self.encoded = self.engine.encoded
            self._csr = None
            self._csc = None
        return applied

    # ---------------------------------------------------- training paths
    def _rank2_rows(self) -> torch.Tensor:
        """The logical (s, p, o) rows: the decompressed rank-2 base edges
        with the overlay applied (ITR+ node-label edges are skipped)."""
        g = self.grammar.decompress()
        starts = g.offsets[:-1][g.ranks() == 2]
        rows = torch.stack([g.nodes_flat[starts], g.labels[g.ranks() == 2],
                            g.nodes_flat[starts + 1]], 1)
        return self.engine.delta.apply(rows)

    def csr(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(indptr, indices) over out-edges; materialized once."""
        if self._csr is None:
            rows = self._rank2_rows()
            self._csr = _to_csr(rows[:, 0], rows[:, 2], self.n_nodes)
        return self._csr

    def csc(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(indptr, indices) over in-edges: row o lists its subjects."""
        if self._csc is None:
            rows = self._rank2_rows()
            self._csc = _to_csr(rows[:, 2], rows[:, 0], self.n_nodes)
        return self._csc

    def edge_index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(senders, receivers) COO tensors for full-batch GNNs."""
        indptr, indices = self.csr()
        counts = indptr[1:] - indptr[:-1]
        senders = torch.repeat_interleave(
            torch.arange(counts.numel(), dtype=I64, device=indptr.device), counts,
            output_size=indices.numel())
        return senders, indices


def _to_csr(src: torch.Tensor, dst: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indptr, indices) grouping `dst` by `src`, each row in input order
    (a stable sort), as the reference's argsort and ``bincount`` give."""
    order = torch.sort(src, stable=True).indices
    counts = torch.bincount(src, minlength=n)
    return offsets_from_counts(counts), dst[order].contiguous()
