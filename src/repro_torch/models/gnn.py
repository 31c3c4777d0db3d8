"""The reference's four GNN architectures: GCN (Kipf & Welling), GatedGCN
(Bresson & Laurent), MeshGraphNet (Pfaff et al.) and the NequIP-style
E(3)-equivariant network, the twins of ``<arch>_init`` / ``<arch>_apply``
in ``repro.models.gnn``, and the classification and regression losses of
the reference's GNN train cell (and of its GatedGCN example).

A GCN layer is ``h = x @ w + b`` followed by the symmetric-normalised
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

MeshGraphNet's one aggregation a block and NequIP's one a layer sum edge
values at their receivers through the same :class:`EdgeCSR`. NequIP's
three sums of a layer (scalars C wide, vectors 3C, tensors 9C) are
column-wise independent, so they run as one product over their
concatenation (13C columns): one launch a layer forward and one backward.

Port decision: the degree comes from the CSR's row lengths (exact
integers) instead of a float segment sum of the valid flags; the two are
equal below 2**24 edges a node, and the CSR way needs no launch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.segment_matmul import CSR, CSRSpMM, build_csr
from repro_torch.models.common import MLP, dense_init, layer_norm


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


def regression_loss(out: torch.Tensor, y: torch.Tensor,
                    seed_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The reference cell's regression loss: each node's mean squared error
    over its outputs, averaged over every node, padding included; with a
    ``seed_mask``, over the masked nodes only (at least 1 in the divisor)."""
    per_node = (out - y).square().mean(dim=-1)
    if seed_mask is None:
        return per_node.mean()
    w = seed_mask.to(torch.float32)
    return (per_node * w).sum() / w.sum().clamp(min=1)


# ================================================================ GatedGCN
@dataclass(frozen=True)
class GatedGCNConfig:
    n_layers: int = 16
    d_hidden: int = 70
    name: str = "gatedgcn"


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with -1 = masked (a zero row), as the reference's, for x
    of any rank. An ``index_select``, whose gradient is an ``index_add_``:
    the gradient of ``x[idx]`` walks each row's repeats one after another,
    and a padded batch repeats its dummy row for every padded edge."""
    keep = (idx >= 0).view(-1, *(1,) * (x.dim() - 1))
    return torch.where(keep, x.index_select(0, idx.clamp(min=0)), 0.0)


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


# ============================================================ MeshGraphNet
@dataclass(frozen=True)
class MeshGraphNetConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    name: str = "meshgraphnet"


def _mlp_from_numpy(layers: list, dev) -> MLP:
    """An :class:`MLP` from the reference's ``mlp_params`` list as numpy."""
    return MLP([{k: torch.from_numpy(np.array(p[k], dtype=np.float32)).to(dev)
                 for k in ("w", "b")} for p in layers])


class MeshGraphNet(nn.Module):
    """``meshgraphnet_apply``: MLP encoders of nodes and edges, ``n_layers``
    blocks, each an edge MLP over ``[e, h[sender], h[receiver]]`` added to
    ``e``, the sum of the masked edges at their receivers (``EdgeCSR.agg``)
    and a node MLP over ``[h, agg]`` added to ``h``, then an MLP decoder.
    Each MLP is ``mlp_apply``'s: ``mlp_layers`` hidden layers of
    ``d_hidden``, ReLU between layers, none after the last. As in the
    reference (and unlike the paper) no MLP ends in a LayerNorm."""

    def __init__(self, cfg: MeshGraphNetConfig, enc_node: MLP, enc_edge: MLP,
                 edge_mlps: list[MLP], node_mlps: list[MLP], dec: MLP):
        super().__init__()
        if not len(edge_mlps) == len(node_mlps) == cfg.n_layers:
            raise ValueError(f"{len(edge_mlps)} blocks given for a {cfg.n_layers}-layer config")
        self.cfg = cfg
        self.enc_node, self.enc_edge, self.dec = enc_node, enc_edge, dec
        self.edge_mlps, self.node_mlps = nn.ModuleList(edge_mlps), nn.ModuleList(node_mlps)

    @classmethod
    def from_config(cls, cfg: MeshGraphNetConfig, d_node: int, d_edge: int, d_out: int,
                    device=None, seed: int = 0) -> "MeshGraphNet":
        """``meshgraphnet_init``'s shapes: ``dense_init`` weights drawn from a
        generator seeded with ``seed`` on ``device``, zero biases."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_hidden

        def mlp(d_in, d_out):
            return MLP.init([d_in] + [d] * cfg.mlp_layers + [d_out], generator=gen, device=dev)

        enc_node, enc_edge = mlp(d_node, d), mlp(d_edge, d)
        blocks = [(mlp(3 * d, d), mlp(2 * d, d)) for _ in range(cfg.n_layers)]
        return cls(cfg, enc_node, enc_edge, [b[0] for b in blocks], [b[1] for b in blocks],
                   mlp(d, d_out))

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: MeshGraphNetConfig,
                          device=None) -> "MeshGraphNet":
        """The reference's ``meshgraphnet_init`` pytree as numpy arrays."""
        dev = resolve_device(device)
        blocks = params["blocks"]
        return cls(cfg, _mlp_from_numpy(params["enc_node"], dev),
                   _mlp_from_numpy(params["enc_edge"], dev),
                   [_mlp_from_numpy(b["edge_mlp"], dev) for b in blocks],
                   [_mlp_from_numpy(b["node_mlp"], dev) for b in blocks],
                   _mlp_from_numpy(params["dec"], dev))

    def leaves(self) -> dict[str, torch.Tensor]:
        """The parameters under the reference's paths, in its leaf order
        (JAX's flatten sorts dict keys: ``blocks``, ``dec``, ``enc_edge``,
        ``enc_node``; within a block ``edge_mlp`` before ``node_mlp``)."""
        out = {}
        for i, (em, nm) in enumerate(zip(self.edge_mlps, self.node_mlps)):
            out.update(em.leaves(f"blocks/{i}/edge_mlp"))
            out.update(nm.leaves(f"blocks/{i}/node_mlp"))
        for name in ("dec", "enc_edge", "enc_node"):
            out.update(getattr(self, name).leaves(name))
        return out

    def forward(self, x: torch.Tensor, e_feat: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, csr: EdgeCSR | None = None) -> torch.Tensor:
        """Outputs (n_nodes, d_out) for nodes x (n_nodes, d_node) and edges
        (e_feat (E, d_edge), senders, receivers); a sender -1 masks its
        edge. ``csr`` is the batch's :class:`EdgeCSR` (built here if None)."""
        csr = csr or EdgeCSR.from_receivers(receivers, x.shape[0])
        mask = (senders >= 0).to(x.dtype)[:, None]
        h = self.enc_node(x)
        e = self.enc_edge(e_feat)
        for edge_mlp, node_mlp in zip(self.edge_mlps, self.node_mlps):
            e = e + edge_mlp(torch.cat([e, _gather(h, senders), _gather(h, receivers)], -1))
            agg = csr.agg(e * mask)
            h = h + node_mlp(torch.cat([h, agg], -1))
        return self.dec(h)


# ================================================================== NequIP
@dataclass(frozen=True)
class NequIPConfig:
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep order
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    name: str = "nequip"


def _sym_traceless(m: torch.Tensor) -> torch.Tensor:
    """The symmetric traceless part of the trailing 3 x 3 matrices."""
    sym = 0.5 * (m + m.transpose(-1, -2))
    tr = sym.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return sym - tr * torch.eye(3, device=m.device) / 3.0


def _rbf(r: torch.Tensor, cfg: NequIPConfig) -> torch.Tensor:
    """The reference's Bessel-like radial basis with its smooth cutoff
    envelope: (E, n_rbf)."""
    n = torch.arange(1, cfg.n_rbf + 1, dtype=torch.float32, device=r.device)
    rc = cfg.cutoff
    safe = r.clamp(min=1e-6)
    basis = torch.sin(n * math.pi * safe[:, None] / rc) / safe[:, None]
    env = 0.5 * (torch.cos(math.pi * (r / rc).clamp(0, 1)) + 1.0)
    return basis * env[:, None]


_NEQUIP_MATS = ("mix0", "self0", "self1", "self2")


class NequIP(nn.Module):
    """``nequip_apply`` with the reference's Cartesian irreps: scalars s
    (N, C), vectors v (N, C, 3) and symmetric traceless tensors t (N, C,
    3, 3), the exact couplings of the reference in its order of terms (so
    float32 sums round alike), radial MLPs ``rad0`` / ``rad1`` / ``rad2``
    over the basis of :func:`_rbf`, channel mixes ``self0..2`` and
    ``mix0``, the sigmoid gate, and the output MLP to one energy a node.

    The three aggregations of a layer (C, 3C and 9C columns) run as one
    ``EdgeCSR.agg`` over their concatenation, 13C wide: the same column
    sums as the reference's three ``segment_sum`` calls, in one launch a
    layer (and one on the transposed CSR in the backward)."""

    def __init__(self, cfg: NequIPConfig, embed: torch.Tensor, layers: list[dict],
                 out: MLP):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers given for a {cfg.n_layers}-layer config")
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.rad = nn.ModuleList([nn.ModuleList([p[f"rad{k}"] for k in range(3)])
                                  for p in layers])
        self.mats = nn.ModuleList([nn.ParameterDict({k: nn.Parameter(p[k]) for k in _NEQUIP_MATS})
                                   for p in layers])
        self.out = out

    @classmethod
    def from_config(cls, cfg: NequIPConfig, n_species: int, device=None,
                    seed: int = 0) -> "NequIP":
        """``nequip_init``'s shapes: the embedding normal x 0.5, the channel
        mixes normal / sqrt(C), the MLPs ``dense_init`` with zero biases,
        drawn from a generator seeded with ``seed`` on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        C = cfg.d_hidden
        layers = []
        for _ in range(cfg.n_layers):
            p = {f"rad{k}": MLP.init([cfg.n_rbf, 32, w * C], generator=gen, device=dev)
                 for k, w in enumerate((4, 4, 3))}
            p.update({k: dense_init(C, C, generator=gen, device=dev) for k in _NEQUIP_MATS})
            layers.append(p)
        embed = torch.randn(n_species, C, generator=gen, device=dev) * 0.5
        return cls(cfg, embed, layers, MLP.init([C, 32, 1], generator=gen, device=dev))

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: NequIPConfig, device=None) -> "NequIP":
        """The reference's ``nequip_init`` pytree as numpy arrays."""
        dev = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

        layers = [{**{f"rad{k}": _mlp_from_numpy(p[f"rad{k}"], dev) for k in range(3)},
                   **{k: t(p[k]) for k in _NEQUIP_MATS}} for p in params["layers"]]
        return cls(cfg, t(params["embed"]), layers, _mlp_from_numpy(params["out"], dev))

    def leaves(self) -> dict[str, torch.Tensor]:
        """The parameters under the reference's paths, in its leaf order:
        ``embed``, then ``layers/<i>/{mix0, rad0/<j>/{b,w}, rad1, rad2,
        self0, self1, self2}``, then ``out``."""
        out = {"embed": self.embed}
        for i, (rad, mats) in enumerate(zip(self.rad, self.mats)):
            out[f"layers/{i}/mix0"] = mats["mix0"]
            for k in range(3):
                out.update(rad[k].leaves(f"layers/{i}/rad{k}"))
            out.update({f"layers/{i}/{k}": mats[k] for k in ("self0", "self1", "self2")})
        out.update(self.out.leaves("out"))
        return out

    def forward(self, species: torch.Tensor, positions: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, csr: EdgeCSR | None = None) -> torch.Tensor:
        """Energies (N, 1) for species (N,) and positions (N, 3) in Å; a
        sender -1 masks its edge. ``csr`` is the batch's :class:`EdgeCSR`
        (built here if None)."""
        C = self.cfg.d_hidden
        n = species.shape[0]
        csr = csr or EdgeCSR.from_receivers(receivers, n)
        emask = (senders >= 0).to(torch.float32)
        s = self.embed.index_select(0, species)
        v = positions.new_zeros((n, C, 3))
        t = positions.new_zeros((n, C, 3, 3))

        rel = _gather(positions, senders) - _gather(positions, receivers)  # (E, 3)
        r = torch.linalg.vector_norm(rel + 1e-12, dim=-1)
        dirs = rel / r[:, None].clamp(min=1e-6)                            # l = 1
        dir2 = _sym_traceless(dirs[:, :, None] * dirs[:, None, :])         # l = 2
        rbf = _rbf(r, self.cfg) * emask[:, None]                           # pads zeroed
        n_e = rbf.shape[0]

        for rad, mats in zip(self.rad, self.mats):
            w0 = rad[0](rbf).reshape(-1, 4, C)
            w1 = rad[1](rbf).reshape(-1, 4, C)
            w2 = rad[2](rbf).reshape(-1, 3, C)
            s_j, v_j, t_j = _gather(s, senders), _gather(v, senders), _gather(t, senders)
            m0 = (w0[:, 0] * s_j
                  + w0[:, 1] * torch.einsum("eci,eci->ec", v_j, dirs[:, None, :])
                  + w0[:, 2] * torch.einsum("ecij,eij->ec", t_j, dir2)
                  + w0[:, 3] * torch.einsum("eci,eci->ec", v_j, v_j))
            m1 = (w1[:, 0, :, None] * s_j[:, :, None] * dirs[:, None, :]
                  + w1[:, 1, :, None] * torch.linalg.cross(
                      v_j, dirs[:, None, :].expand_as(v_j), dim=-1)
                  + w1[:, 2, :, None] * torch.einsum("ecij,ej->eci", t_j, dirs)
                  + w1[:, 3, :, None] * v_j)
            outer = _sym_traceless(v_j[:, :, :, None] * dirs[:, None, None, :])
            m2 = (w2[:, 0, :, None, None] * s_j[:, :, None, None] * dir2[:, None, :, :]
                  + w2[:, 1, :, None, None] * outer
                  + w2[:, 2, :, None, None] * t_j)
            agg = csr.agg(torch.cat([m0, m1.reshape(n_e, 3 * C), m2.reshape(n_e, 9 * C)], -1))
            s_agg = agg[:, :C]
            v_agg = agg[:, C:4 * C].reshape(-1, C, 3)
            t_agg = agg[:, 4 * C:].reshape(-1, C, 3, 3)

            s_new = s + torch.nn.functional.silu(s_agg @ mats["self0"] + s @ mats["mix0"])
            gate = torch.sigmoid(s_new)[:, :, None]
            v = v + gate * torch.einsum("eci,cd->edi", v_agg, mats["self1"])
            t = t + gate[..., None] * torch.einsum("ecij,cd->edij", t_agg, mats["self2"])
            s = s_new
        return self.out(s)


# ============================================================ the cell loss
def gnn_outputs(model: nn.Module, batch: dict) -> torch.Tensor:
    """The model's per-node outputs on a cell batch: GCN reads {"x",
    "graph"}; GatedGCN and MeshGraphNet {"x", "ef", "senders",
    "receivers", "csr"}; NequIP {"species", "pos", "senders", "receivers",
    "csr"}."""
    if isinstance(model, GCN):
        return model(batch["x"], batch["graph"])
    if isinstance(model, NequIP):
        return model(batch["species"], batch["pos"], batch["senders"], batch["receivers"],
                     batch["csr"])
    return model(batch["x"], batch["ef"], batch["senders"], batch["receivers"], batch["csr"])


def output_loss(model: nn.Module, out: torch.Tensor, batch: dict) -> torch.Tensor:
    """The reference GNN cell's ``loss_fn`` on the model's outputs:
    :func:`regression_loss` of MeshGraphNet's and NequIP's against ``y``,
    :func:`node_loss` of GCN's and GatedGCN's logits, each over
    ``seed_mask`` where the batch has one."""
    if isinstance(model, (MeshGraphNet, NequIP)):
        return regression_loss(out, batch["y"], batch.get("seed_mask"))
    return node_loss(out, batch["y"], batch.get("seed_mask"))


def gnn_loss(model: nn.Module, batch: dict) -> torch.Tensor:
    """:func:`output_loss` of :func:`gnn_outputs`: a cell's step loss."""
    return output_loss(model, gnn_outputs(model, batch), batch)
