"""GCN (Kipf & Welling): the twin of ``gcn_init`` / ``gcn_apply`` in
``repro.models.gnn``, and the classification loss of the reference's GNN
train cell.

A layer is ``h = x @ w + b`` followed by the symmetric-normalised
propagation with self loops, ``D^-1/2 (A + I) D^-1/2 h``, where A sums the
senders' rows at each receiver. The reference gathers per edge and sums
with ``segment_sum``; here the sum is the sparse-dense product of kernel
``csr_spmm`` on the graph's CSR (:class:`Graph`), and its gradient the
same kernel on the transposed CSR. ReLU follows every layer but the last.

Port decision: the degree comes from the CSR's row lengths (exact
integers) instead of a float segment sum of the valid flags; the two are
equal below 2**24 edges a node, and the CSR way needs no launch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.segment_matmul import CSR, CSRSpMM, build_csr
from repro_torch.models.common import dense_init


@dataclass(frozen=True)
class GCNConfig:
    n_layers: int = 2
    d_hidden: int = 16
    norm: str = "sym"    # carried as the reference carries it: both compute "sym"
    name: str = "gcn-cora"


@dataclass(frozen=True)
class Graph:
    """A graph's two CSRs and its normalisation, built once per graph:
    ``fwd`` has a row per receiver (columns name senders), ``bwd`` is its
    transpose, ``inv_sqrt`` (n_nodes, 1) float32 is (in-degree + 1) ** -1/2."""

    fwd: CSR
    bwd: CSR
    inv_sqrt: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.fwd.n_rows

    @classmethod
    def from_edges(cls, senders: torch.Tensor, receivers: torch.Tensor,
                   n_nodes: int) -> "Graph":
        """Edges sender -> receiver on the nodes [0, n_nodes); a sender -1
        is padding and a receiver outside [0, n_nodes) is dropped, as in the
        reference."""
        fwd, bwd = build_csr(senders, receivers, n_nodes, n_nodes)
        deg = fwd.row_lengths().to(torch.float32) + 1.0
        return cls(fwd, bwd, torch.rsqrt(deg)[:, None])


class GCN(nn.Module):
    """``gcn_apply`` with trainable float32 weights ``w`` (in, out) and
    biases ``b``, one pair a layer, in the reference's layout."""

    def __init__(self, cfg: GCNConfig, layers: list[dict]):
        super().__init__()
        self.cfg = cfg
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in layers])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in layers])

    @classmethod
    def from_config(cls, cfg: GCNConfig, d_in: int, n_out: int, device=None,
                    seed: int = 0) -> "GCN":
        """``gcn_init``'s shapes: ``dense_init`` weights drawn from a
        generator seeded with ``seed`` on ``device``, zero biases."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [n_out]
        layers = [{"w": dense_init(a, b, generator=gen, device=dev),
                   "b": torch.zeros(b, device=dev)} for a, b in zip(dims[:-1], dims[1:])]
        return cls(cfg, layers)

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: GCNConfig, device=None) -> "GCN":
        """The reference's ``gcn_init`` pytree, ``{"layers": [{"w", "b"}, ...]}``,
        as numpy arrays."""
        dev = resolve_device(device)
        layers = [{k: torch.from_numpy(np.array(p[k], dtype=np.float32)).to(dev)
                   for k in ("w", "b")} for p in params["layers"]]
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers given for a {cfg.n_layers}-layer config")
        return cls(cfg, layers)

    def leaves(self) -> dict[str, torch.Tensor]:
        """The parameters under the reference's pytree paths, in its leaf
        order (``layers/0/b``, ``layers/0/w``, ...)."""
        return {f"layers/{i}/{k}": getattr(self, k)[i]
                for i in range(len(self.w)) for k in ("b", "w")}

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        inv_sqrt = graph.inv_sqrt
        last = len(self.w) - 1
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            h = torch.addmm(b, x, w)
            agg = CSRSpMM.apply(h * inv_sqrt, graph.fwd, graph.bwd) * inv_sqrt
            h = agg + h * (inv_sqrt * inv_sqrt)
            x = torch.relu(h) if i < last else h
        return x


def node_loss(logits: torch.Tensor, y: torch.Tensor,
              seed_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of the labels ``max(y, 0)`` over every
    node, padding included, as the reference cell's ``loss_fn``; with a
    ``seed_mask``, over the masked nodes only (at least 1 in the divisor)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_node = -logp.gather(1, y.clamp(min=0)[:, None])[:, 0]
    if seed_mask is None:
        return per_node.mean()
    w = seed_mask.to(torch.float32)
    return (per_node * w).sum() / w.sum().clamp(min=1)


def gcn_loss(model: GCN, batch: dict) -> torch.Tensor:
    """``node_loss`` of the model on a batch {"x", "y", "graph"} (and
    optionally "seed_mask")."""
    return node_loss(model(batch["x"], batch["graph"]), batch["y"], batch.get("seed_mask"))
