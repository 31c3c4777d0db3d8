"""GCN (Kipf & Welling) and GatedGCN (Bresson & Laurent): the twins of
``gcn_init`` / ``gcn_apply`` and ``gatedgcn_init`` / ``gatedgcn_apply`` in
``repro.models.gnn``, and the classification loss of the reference's GNN
train cell and of its GatedGCN example.

A layer is ``h = x @ w + b`` followed by the symmetric-normalised
propagation with self loops, ``D^-1/2 (A + I) D^-1/2 h``, where A sums the
senders' rows at each receiver. The reference gathers per edge and sums
with ``segment_sum``; here the sum is the sparse-dense product of kernel
``csr_spmm`` on the graph's CSR (:class:`Graph`), and its gradient the
same kernel on the transposed CSR. ReLU follows every layer but the last.

GatedGCN's two aggregations a layer (the gate's denominator and the
messages) sum edge values at their receivers: ``csr_spmm`` over a CSR of
edge ids (:class:`EdgeCSR`, rows by receiver, ``col`` the edge's own
index, stable by edge order), built once a batch; the backward is the
same kernel on the transposed CSR, one entry a row.

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
from repro_torch.models.common import dense_init, layer_norm


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


# ================================================================ GatedGCN
@dataclass(frozen=True)
class GatedGCNConfig:
    n_layers: int = 16
    d_hidden: int = 70
    name: str = "gatedgcn"


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with -1 = masked (a zero row), as the reference's. An
    ``index_select``, whose gradient is an ``index_add_``: the gradient of
    ``x[idx]`` walks each row's repeats one after another, and a padded
    batch repeats its dummy row for every padded edge."""
    return torch.where((idx >= 0)[:, None], x.index_select(0, idx.clamp(min=0)), 0.0)


@dataclass(frozen=True)
class EdgeCSR:
    """The aggregation of a batch's edge values at their receivers, built
    once a batch: ``fwd`` has a row per node whose columns name the edges
    it receives (in edge order), ``bwd`` is its transpose, a row per edge
    holding its receiver (none for a receiver outside [0, n_nodes), which
    ``segment_sum`` drops). ``agg(m)`` is ``segment_sum(m, receivers,
    n_nodes)`` on ``csr_spmm``."""

    fwd: CSR
    bwd: CSR

    @classmethod
    def from_receivers(cls, receivers: torch.Tensor, n_nodes: int) -> "EdgeCSR":
        edges = torch.arange(receivers.numel(), device=receivers.device)
        fwd, bwd = build_csr(edges, receivers, n_nodes, receivers.numel())
        return cls(fwd, bwd)

    def agg(self, m: torch.Tensor) -> torch.Tensor:
        return CSRSpMM.apply(m, self.fwd, self.bwd)


_LINEARS = ("A", "B", "C", "U", "V")


class GatedGCN(nn.Module):
    """``gatedgcn_apply`` with trainable float32 parameters in the
    reference's layout: linears ``w`` (in, out) and ``b``, and each layer's
    ``ln_h`` / ``ln_e`` as (gamma, beta). Both aggregations of a layer (the
    gate's denominator and the messages) run on ``csr_spmm`` over the
    batch's :class:`EdgeCSR`, and their gradients on its transpose."""

    def __init__(self, cfg: GatedGCNConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self._names = {}
        for path, t in params.items():
            name = path.replace("/", "_")
            self.register_parameter(name, nn.Parameter(t))
            self._names[path] = name

    @staticmethod
    def paths(cfg: GatedGCNConfig) -> list[str]:
        """The reference's leaf paths in its leaf order (JAX's flatten)."""
        out = [f"{top}/{k}" for top in ("embed_e", "embed_h") for k in ("b", "w")]
        for i in range(cfg.n_layers):
            out += [f"layers/{i}/{m}/{k}" for m in _LINEARS for k in ("b", "w")]
            out += [f"layers/{i}/{ln}/{j}" for ln in ("ln_e", "ln_h") for j in (0, 1)]
        return out + ["readout/b", "readout/w"]

    @classmethod
    def from_config(cls, cfg: GatedGCNConfig, d_in: int, d_edge: int, n_out: int,
                    device=None, seed: int = 0) -> "GatedGCN":
        """``gatedgcn_init``'s shapes: normal weights over sqrt(fan-in) drawn
        from a generator seeded with ``seed`` on ``device``, zero biases,
        layer-norm gammas 1 and betas 0."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_hidden
        dims = {"embed_h": (d_in, d), "embed_e": (d_edge, d), "readout": (d, n_out)}
        params = {}
        for path in cls.paths(cfg):
            parts = path.split("/")
            if parts[-2] in ("ln_e", "ln_h"):
                params[path] = (torch.ones if parts[-1] == "0" else torch.zeros)(d, device=dev)
                continue
            a, b = dims.get(parts[0], (d, d))
            params[path] = torch.zeros(b, device=dev) if parts[-1] == "b" else \
                dense_init(a, b, generator=gen, device=dev)
        return cls(cfg, params)

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: GatedGCNConfig, device=None) -> "GatedGCN":
        """The reference's ``gatedgcn_init`` pytree as numpy arrays."""
        dev = resolve_device(device)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers given for a "
                             f"{cfg.n_layers}-layer config")

        def leaf(path):
            node = params
            for part in path.split("/"):
                node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
            return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

        return cls(cfg, {p: leaf(p) for p in cls.paths(cfg)})

    def leaves(self) -> dict[str, torch.Tensor]:
        """The parameters under the reference's paths, in its leaf order."""
        return {p: getattr(self, n) for p, n in self._names.items()}

    def _p(self, path: str) -> torch.Tensor:
        return getattr(self, self._names[path])

    def _lin(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self._p(f"{prefix}/b"), x, self._p(f"{prefix}/w"))

    def forward(self, x: torch.Tensor, e_feat: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, csr: EdgeCSR | None = None) -> torch.Tensor:
        """Logits (n_nodes, n_out) for nodes x (n_nodes, d_in) and edges
        (e_feat (E, d_edge), senders, receivers); a sender -1 masks its
        edge. ``csr`` is the batch's :class:`EdgeCSR` (built here if None)."""
        csr = csr or EdgeCSR.from_receivers(receivers, x.shape[0])
        mask = (senders >= 0).to(x.dtype)[:, None]
        h = self._lin("embed_h", x)
        e = self._lin("embed_e", e_feat)
        for i in range(self.cfg.n_layers):
            p = f"layers/{i}"
            e_new = _gather(self._lin(f"{p}/A", h), senders) \
                + _gather(self._lin(f"{p}/B", h), receivers) + self._lin(f"{p}/C", e)
            e = e + torch.relu(layer_norm(e_new, self._p(f"{p}/ln_e/0"), self._p(f"{p}/ln_e/1")))
            eta = torch.sigmoid(e) * mask
            denom = csr.agg(eta) + 1e-6
            msg = eta * _gather(self._lin(f"{p}/V", h), senders)
            agg = csr.agg(msg) / denom
            h = h + torch.relu(layer_norm(self._lin(f"{p}/U", h) + agg,
                                          self._p(f"{p}/ln_h/0"), self._p(f"{p}/ln_h/1")))
        return self._lin("readout", h)


def gatedgcn_loss(model: GatedGCN, batch: dict) -> torch.Tensor:
    """The reference example's loss: the negative log-likelihood of ``y``
    averaged over the nodes of ``mask`` (the batch's seeds; at least 1 in
    the divisor), on a batch {"x", "ef", "senders", "receivers", "y",
    "mask"} and optionally "csr" (its :class:`EdgeCSR`)."""
    logits = model(batch["x"], batch["ef"], batch["senders"], batch["receivers"],
                   batch.get("csr"))
    return node_loss(logits, batch["y"], batch["mask"])
