"""Step functions per (arch, shape) cell, with real inputs made from a seed.

The twin of ``repro.launch.steps`` for the kinds the port runs: the LM's
train, prefill and decode cells, the recsys serve, retrieval and train cells, and
the GNN training cells of every kind (full graph, sampled minibatch,
molecule batch) for the four GNN archs. The reference returns abstract shapes for
an ahead-of-time compile on a mesh; the port runs eagerly on one GPU, so a
cell here holds the model on the device and inputs drawn from the seed,
ready to call.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import lru_cache, partial
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.data.graphs import (N_SPECIES, atoms, csc, edge_features, molecule_graph,
                                     node_graph, node_targets, sampled_batch)
from repro_torch.data.sampler import NeighborSampler
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import logical_spec, param_spec, spec_bytes, zero1_spec
from repro_torch.models.dlrm import DLRM, DLRMConfig, _mlp_sizes, dlrm_grads, retrieval_scores
from repro_torch.models.gnn import (GCN, EdgeCSR, GatedGCN, Graph, MeshGraphNet, NequIP,
                                    gnn_loss)
from repro_torch.models.transformer import (DTYPES, Transformer, moe_group_size,
                                            normal_chunked, param_shapes)
from repro_torch.train.loop import train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclass
class Cell:
    arch_id: str
    shape: str
    fn: Callable
    args: tuple
    model: torch.nn.Module | None = None  # the model, None for retrieval

    def run(self):
        return self.fn(*self.args)


def _r256(n: int) -> int:
    return ((n + 255) // 256) * 256


class CellRefused(ValueError):
    """A cell that does not fit one card, refused before anything is
    allocated; ``nbytes`` is what it would need (the refusal names it)."""

    def __init__(self, msg: str, nbytes: int):
        super().__init__(msg)
        self.nbytes = nbytes


def dlrm_batch(cfg: DLRMConfig, batch: int, generator: torch.Generator):
    """(dense, sparse): dense (B, n_dense) float32 standard normal, sparse
    (B, n_sparse) int32 uniform over [0, rows_i) of each field, on the
    generator's device."""
    dev = generator.device
    dense = torch.randn((batch, cfg.n_dense), generator=generator, device=dev)
    rows = torch.tensor(cfg.row_counts, dtype=torch.float64, device=dev)
    u = torch.rand((batch, cfg.n_sparse), generator=generator, device=dev,
                   dtype=torch.float64)
    sparse = torch.minimum((u * rows).floor(), rows - 1).to(torch.int32)
    return dense, sparse


LABEL_RATE = 0.5  # P(label = 1) of a synthetic train batch: a fair coin, no dataset's rate


def dlrm_train_batch(cfg: DLRMConfig, batch: int, generator: torch.Generator):
    """(dense, sparse, labels): :func:`dlrm_batch`, then labels (B,) float32
    in {0, 1}, 1 with probability ``LABEL_RATE``, from the same generator."""
    dense, sparse = dlrm_batch(cfg, batch, generator)
    u = torch.rand((batch,), generator=generator, device=generator.device)
    return dense, sparse, (u < LABEL_RATE).to(torch.float32)


def dlrm_train_step(model: DLRM, opt_state: dict, dense: torch.Tensor, sparse: torch.Tensor,
                    labels: torch.Tensor, opt_cfg: AdamWConfig) -> tuple:
    """One train step of the DLRM cell, the twin of the reference cell's
    ``train_step``: ``dlrm_loss``, its gradients (:func:`dlrm_grads`), then
    AdamW on the MLPs and SGD on the touched table rows, in place on the
    model and ``opt_state``. Returns (loss, {"lr", "grad_norm"}) as tensors
    on the device; one host sync (the id check)."""
    loss, grads = dlrm_grads(model, dense, sparse, labels)
    return loss, adamw_update(model.leaves(), grads, opt_state, opt_cfg)


def lm_cache(model: Transformer, batch: int, seq_len: int,
             generator: torch.Generator) -> tuple:
    """A (k, v) cache of ``seq_len`` positions, each (L, batch, seq_len,
    Hkv, D) in ``cfg.dtype``, filled with standard normal values drawn on
    the generator's device a chunk at a time (no float32 copy of the whole
    cache is made)."""
    cfg = model.cfg
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return tuple(normal_chunked(shape, 1.0, DTYPES[cfg.dtype], generator, generator.device)
                 for _ in range(2))


# gradient-accumulation micro-batches of an LM train step (the reference's
# GRAD_ACCUM, repro/launch/steps.py:37); 1 when reduced
GRAD_ACCUM = {
    "yi-34b": 16,
    "gemma2-9b": 8,
    "phi3.5-moe-42b-a6.6b": 8,
    "qwen2-1.5b": 4,
    "olmoe-1b-7b": 8,
}
# bytes of training state a parameter: bf16 weight 2, float32 master 4, m 4,
# v 4, float32 gradient accumulator 4, bf16 micro-batch gradient 2
TRAIN_STATE_BYTES = 20


def lm_state_bytes(cfg) -> int:
    """The training state of ``cfg`` in bytes: TRAIN_STATE_BYTES for each
    parameter of :func:`param_shapes` (biases included)."""
    return TRAIN_STATE_BYTES * sum(math.prod(shape) for shape, _ in param_shapes(cfg).values())


def lm_grads(model: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
             n_micro: int) -> tuple:
    """The reference cell's accumulation: tokens and targets (B, S) cut into
    ``n_micro`` micro-batches of B / n_micro rows; each micro-batch's
    gradients (in the parameters' dtype) are added into float32
    accumulators, which are then divided by n_micro. Returns (loss, grads):
    the mean of the micro-batch losses, a float32 scalar, and {path:
    float32 tensor} in the shapes of :meth:`Transformer.leaves`."""
    b = tokens.shape[0]
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"a batch of {b} does not split into {n_micro} micro-batches")
    mb = b // n_micro
    leaves = model.leaves()
    names = [n for n, _ in model.named_parameters()]
    params = [getattr(model, n) for n in names]
    paths = {n: n if n in leaves else f"layers/{n}" for n in names}
    acc: dict = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(n_micro):
        loss = model.forward_loss(tokens[i * mb:(i + 1) * mb], targets[i * mb:(i + 1) * mb])
        grads = torch.autograd.grad(loss, params)
        loss_sum = loss_sum + loss.detach()
        for n, g in zip(names, grads):
            g = g.view(leaves[paths[n]].shape)
            if i == 0:
                acc[paths[n]] = g.to(torch.float32, copy=True)
            else:
                acc[paths[n]].add_(g)
        del grads, loss
    for g in acc.values():
        g.div_(n_micro)
    return loss_sum / n_micro, dict(sorted(acc.items()))


def lm_train_step(model: Transformer, opt_state: dict, tokens: torch.Tensor,
                  targets: torch.Tensor, opt_cfg: AdamWConfig, n_micro: int) -> tuple:
    """One train step of an LM cell, the twin of the reference cell's
    ``train_step``: :func:`lm_grads` over ``n_micro`` micro-batches, then
    one :func:`adamw_update` in place on the model's leaves and
    ``opt_state``. Returns (loss, {"lr", "grad_norm"}) as tensors on the
    device."""
    loss, grads = lm_grads(model, tokens, targets, n_micro)
    return loss, adamw_update(model.leaves(), grads, opt_state, opt_cfg)


def lm_serve_bytes(cfg, batch: int, seq_len: int) -> int:
    """The bytes a serving cell of ``cfg`` holds on the card before its
    step: the weights of :func:`param_shapes` and a (k, v) cache of
    ``seq_len`` positions for ``batch`` sequences, all in ``cfg.dtype``."""
    item = DTYPES[cfg.dtype].itemsize
    weights = sum(math.prod(shape) for shape, _ in param_shapes(cfg).values())
    cache = 2 * cfg.n_layers * batch * seq_len * cfg.n_kv_heads * cfg.head_dim
    return item * (weights + cache)


def _lm_cell(arch_id: str, shape, cfg, reduced: bool, dev, seed: int,
             batch: int | None, layers: int | None) -> Cell:
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
    if batch is not None:
        B = batch
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    if shape.kind == "train":
        return _lm_train_cell(arch_id, shape, cfg, reduced, dev, seed, B, S)
    need = lm_serve_bytes(cfg, B, S)
    if not reduced and need > CARD_BYTES:
        raise CellRefused(
            f"{arch_id} {shape.name} does not fit one card: its {cfg.dtype} weights and a cache "
            f"of {S:,} positions for {B} sequences take {need:,} bytes against "
            f"{CARD_BYTES:,}; ROADMAP.md queue A, item 27", need)
    if cfg.n_experts:  # the group rule, before the weights are drawn
        moe_group_size(cfg, B * (S if shape.kind == "prefill" else 1))
    model = Transformer.from_config(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if shape.kind == "prefill":
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
        return Cell(arch_id, shape.name, model.prefill_step, (tokens,), model)
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    cache = lm_cache(model, B, S, gen)
    tokens = torch.randint(0, cfg.vocab, (B,), generator=gen, device=dev)
    return Cell(arch_id, shape.name, model.decode_step, (cache, tokens, S - 1), model)


def _lm_train_cell(arch_id: str, shape, cfg, reduced: bool, dev, seed: int, B: int,
                   S: int) -> Cell:
    n_micro = 1 if reduced else GRAD_ACCUM.get(arch_id, 1)
    if B % n_micro:
        raise ValueError(f"{arch_id} {shape.name}: a batch of {B} does not split into its "
                         f"{n_micro} micro-batches")
    need = lm_state_bytes(cfg)
    if not reduced and need > CARD_BYTES:
        raise CellRefused(
            f"{arch_id} {shape.name} does not fit one card: its training state takes "
            f"{need:,} bytes ({TRAIN_STATE_BYTES} a parameter: bf16 weight, float32 master, "
            f"m and v, float32 accumulator, bf16 gradient) against {CARD_BYTES:,}; "
            "ROADMAP.md queue A, item 16 (a sharded optimizer)", need)
    if cfg.n_experts:  # the group rule, before the weights are drawn
        moe_group_size(cfg, B // n_micro * S)
    model = Transformer.from_config(cfg, device=dev, seed=seed).requires_grad_()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    targets = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    opt_cfg = AdamWConfig()
    opt_state = init_opt_state(model.leaves(), opt_cfg)
    return Cell(arch_id, shape.name, partial(lm_train_step, opt_cfg=opt_cfg, n_micro=n_micro),
                (model, opt_state, tokens, targets), model)


GNN_EDGE_FEAT = 8                                    # the reference cell's _GNN_EDGE_FEAT
GNN_OUT = {"gcn-cora": None, "gatedgcn": None, "meshgraphnet": 3, "nequip": 1}  # its _GNN_OUT
CARD_BYTES = 80 * 10**9  # one H100's device memory
# The widest edge-sized float32 tensor a step of the arch makes (what, and
# its width in d_hidden), of which the backward keeps one a layer at the
# least. GCN makes none: its aggregation reads node rows through the CSR.
_EDGE_TENSORS = {
    "gatedgcn": ("one (E, d_hidden) edge activation", 1),
    "meshgraphnet": ("the first edge-MLP input [e, h[s], h[r]] (E, 3 d_hidden)", 3),
    "nequip": ("the tensor messages m2 (E, d_hidden, 3, 3)", 9),
}


def _gnn_sizes(shape: ShapeSpec, reduced: bool) -> tuple:
    """(nodes, edges, d_feat, n_classes) of a GNN shape as the reference's
    ``_gnn_sizes`` gives them (cut to at most 64 nodes' scale and 16
    features when reduced, rounded up to multiples of 256), and (nodes,
    edges) before the rounding. A minibatch holds the most that
    ``batch_nodes`` seeds can sample at its fanouts; a molecule batch
    ``batch`` molecules of one class."""
    p = shape.params
    if shape.kind == "minibatch":
        seeds = p["batch_nodes"]
        f1, f2 = p["fanouts"]
        n = seeds * (1 + f1 + f1 * f2)
        e = seeds * f1 + seeds * f1 * f2
        d_feat, n_cls = p["d_feat"], p["n_classes"]
    elif shape.kind == "molecule":
        n = p["batch"] * p["n_nodes"]
        e = p["batch"] * p["n_edges"]
        d_feat, n_cls = p["d_feat"], 1
    else:
        n, e = p["n_nodes"], p["n_edges"]
        d_feat, n_cls = p["d_feat"], p.get("n_classes", 2)
    if reduced:
        scale = max(n // 64, 1)
        n, e = max(n // scale, 8), max(e // scale, 16)
        d_feat = min(d_feat, 16)
    return _r256(n), _r256(e), d_feat, n_cls, n, e


def _reduced_scale(shape: ShapeSpec) -> int:
    """The factor by which the reference's reduced sizes cut the shape."""
    n = _gnn_sizes(shape, False)[4]
    return max(n // 64, 1)


def _refuse_unfit(arch_id: str, shape: ShapeSpec) -> None:
    """:class:`CellRefused`, before anything is allocated, where the cell at full size
    keeps more edge-sized activations for its backward than one card
    holds, naming the reckoned bytes."""
    if arch_id not in _EDGE_TENSORS:
        return
    cfg = get_arch(arch_id).config()
    e = _gnn_sizes(shape, False)[1]
    what, width = _EDGE_TENSORS[arch_id]
    one = e * width * cfg.d_hidden * 4
    if one * cfg.n_layers > CARD_BYTES:
        raise CellRefused(
            f"{arch_id} {shape.name} does not fit one card: {what} over its {e:,} padded edges "
            f"takes {one:,} bytes, and a step keeps at least one a layer for the backward "
            f"({one * cfg.n_layers:,} bytes over {cfg.n_layers} layers against "
            f"{CARD_BYTES:,}); ROADMAP.md queue A, item 24", one * cfg.n_layers)


def _minibatch_graph(shape: ShapeSpec, reduced: bool, dev, seed: int) -> dict:
    """The graph a ``minibatch`` cell samples, drawn on ``dev`` from a
    generator seeded with ``seed``: a symmetric Chung-Lu graph
    (:func:`node_graph`) of the shape's published size (Reddit: 232,965
    nodes, 114,615,892 edges, 602 features, 41 classes), or cut by the
    reference's reduced scale (2,656 at ``minibatch_lg``: 87 nodes, 43,153
    edges, 16 features) when reduced, and its CSC. {"x", "y", "indptr",
    "indices"}: features, labels and the CSC; the edge lists are freed."""
    p = shape.params
    n, e, d_feat = p["n_nodes"], p["n_edges"], p["d_feat"]
    if reduced:
        scale = _reduced_scale(shape)
        n, e, d_feat = max(n // scale, 8), max(e // scale, 16), min(d_feat, 16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = node_graph(n, e, d_feat, p["n_classes"], real_nodes=n, real_edges=e, generator=gen)
    indptr, indices = csc(g.pop("senders"), g.pop("receivers"), n)
    return {"x": g["x"], "y": g["y"], "indptr": indptr, "indices": indices}


def _gnn_model(arch_id: str, cfg, d_feat: int, n_cls: int, dev, seed: int):
    if arch_id == "gcn-cora":
        return GCN.from_config(cfg, d_feat, n_cls, device=dev, seed=seed)
    if arch_id == "gatedgcn":
        return GatedGCN.from_config(cfg, d_feat, GNN_EDGE_FEAT, n_cls, device=dev, seed=seed)
    if arch_id == "meshgraphnet":
        return MeshGraphNet.from_config(cfg, d_feat, GNN_EDGE_FEAT, GNN_OUT[arch_id],
                                        device=dev, seed=seed)
    return NequIP.from_config(cfg, N_SPECIES, device=dev, seed=seed)


def _gnn_batch(arch_id: str, shape: ShapeSpec, reduced: bool, gen: torch.Generator) -> dict:
    """The cell's batch as the reference's cell takes it (senders,
    receivers, x or species and pos, ef, y, and seed_mask or graph_ids by
    kind) drawn from ``gen``, with the port's CSRs: "graph" for GCN,
    "csr" (an :class:`EdgeCSR`) for the others. A padded edge is -1 at
    both ends in every kind, so no CSR row holds one."""
    dev = gen.device
    n, e, d_feat, n_cls, real_n, real_e = _gnn_sizes(shape, reduced)
    p = shape.params
    d_out = GNN_OUT[arch_id]
    if shape.kind == "minibatch":
        graph = _minibatch_graph(shape, reduced, dev, gen.initial_seed() + 1)
        n_graph = graph["indptr"].numel() - 1
        seeds = p["batch_nodes"] if not reduced else max(p["batch_nodes"]
                                                        // _reduced_scale(shape), 1)
        sampler = NeighborSampler(graph["indptr"], graph["indices"], p["fanouts"])
        seed_ids = torch.randperm(n_graph, generator=gen, device=dev)[:seeds]
        tables = {"x": graph["x"], "y": graph["y"]}
        if d_out:
            tables["y"] = node_targets(n_graph, d_out, n_graph, gen)
        if arch_id == "nequip":
            tables["species"], tables["pos"] = atoms(n_graph, n_graph, gen)
        b = sampled_batch(sampler, seed_ids, tables, n, e, gen)
        del b["node_ids"]
    else:
        if shape.kind == "molecule":
            molecules = min(real_n // p["n_nodes"], real_e // p["n_edges"])
            b = molecule_graph(n, e, d_feat, n_cls, molecules=molecules,
                               mol_nodes=p["n_nodes"], mol_edges=p["n_edges"], generator=gen)
            real_n = molecules * p["n_nodes"]
        else:
            b = node_graph(n, e, d_feat, n_cls, real_nodes=real_n, real_edges=real_e,
                           generator=gen)
            b["receivers"][real_e:] = -1  # padding at both ends, as the other kinds'
        if d_out:
            b["y"] = node_targets(n, d_out, real_n, gen)
        if arch_id == "nequip":
            b["species"], b["pos"] = atoms(n, real_n, gen)
    if arch_id == "nequip":
        del b["x"]
    if arch_id in ("gatedgcn", "meshgraphnet"):
        b["ef"] = edge_features(b["senders"], GNN_EDGE_FEAT, gen)
    if arch_id == "gcn-cora":
        b["graph"] = Graph.from_edges(b["senders"], b["receivers"], n)
    else:
        b["csr"] = EdgeCSR.from_receivers(b["receivers"], n)
    return b


def gnn_step(model, opt_state: dict, batch: dict, opt_cfg: AdamWConfig) -> tuple:
    """One train step of a GNN cell (any of the four models, its loss by
    :func:`gnn_loss`): (loss, metrics), with the model's parameters and
    ``opt_state`` updated in place."""
    return train_step(lambda b: gnn_loss(model, b), model.leaves(), opt_state, batch, opt_cfg)


def _gnn_cell(arch_id: str, shape: ShapeSpec, cfg, reduced: bool, dev, seed: int) -> Cell:
    _refuse_unfit(arch_id, shape)
    _, _, d_feat, n_cls, _, _ = _gnn_sizes(shape, reduced)
    model = _gnn_model(arch_id, cfg, d_feat, n_cls, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = _gnn_batch(arch_id, shape, reduced, gen)
    opt_cfg = AdamWConfig()
    opt_state = init_opt_state(model.leaves(), opt_cfg)
    return Cell(arch_id, shape.name, partial(gnn_step, opt_cfg=opt_cfg),
                (model, opt_state, batch), model)


def build_cell(arch_id: str, shape_name: str, reduced: bool = False, device=None,
               seed: int = 0, batch: int | None = None, layers: int | None = None) -> Cell:
    """The cell's step function and its inputs on ``device`` (None: CUDA).

    train (LM, ``train_4k``): the Transformer built by
    :meth:`Transformer.from_config` from ``seed``, made trainable, its
    AdamW state (:func:`init_opt_state`) and (B, S) tokens and targets drawn
    uniformly from the vocabulary by a generator seeded with seed + 1;
    ``cell.args`` is (model, opt_state, tokens, targets) and ``cell.run()``
    one :func:`lm_train_step` over the arch's ``GRAD_ACCUM`` micro-batches
    (1 when reduced), returning (loss, metrics). ``batch`` must stay a
    multiple of the micro-batches. A full-size config whose training state
    (:func:`lm_state_bytes`) exceeds one card raises :class:`CellRefused`
    (a ValueError) naming its bytes before anything is allocated (olmoe-1b-7b, gemma2-9b, yi-34b,
    phi3.5-moe-42b-a6.6b; ``layers`` cuts the depth first).

    prefill: the Transformer built by :meth:`Transformer.from_config` from
    ``seed`` and one (B, S) batch of token ids, ``cell.run()`` one
    ``prefill_step`` with a cache of S positions; decode: the model, a
    cache of S positions filled by :func:`lm_cache` and B tokens,
    ``cell.run()`` one ``decode_step`` at ``cur_index = S - 1``. (B, S)
    are the shape's (global_batch, seq_len), (2, min(S, 64)) when reduced;
    ``batch`` overrides B and ``layers`` the depth, in LM cells only (a
    single card holds neither prefill_32k's 32 sequences in the time of a
    smoke run nor decode_32k's 128 caches, nor phi-3.5-MoE's 83.7 GB of
    bf16 weights). A full-size serving cell whose weights and cache
    (:func:`lm_serve_bytes`) exceed one card raises :class:`CellRefused`
    naming them before anything is allocated: at full size every LM
    serving cell but qwen2-1.5b's prefill_32k and long_500k. An MoE config whose B * S (prefill) or B (decode) tokens
    break the group rule of :func:`moe_group_size` raises its ValueError
    here: a cell never regroups.

    serve: the DLRM built by :meth:`DLRM.from_config` from ``seed`` and one
    batch (512 for ``serve_p99``, 262,144 for ``serve_bulk``, 32 when
    reduced); retrieval: one query against 1,000,192 candidates (the
    reference's 1,000,000 rounded up to a multiple of 256; 1,024 when
    reduced), top 100. Inputs draw from a generator seeded with seed + 1.

    GNN (all four archs, all three kinds): the model built by its
    ``from_config`` from ``seed`` as the reference cell builds it (GCN and
    GatedGCN ``n_classes`` logits, MeshGraphNet 3 outputs, NequIP one
    energy over 64 species; 8 edge features), its AdamW state and one
    batch at the sizes of :func:`_gnn_sizes`, drawn from a generator seeded
    with seed + 1 (see :func:`_gnn_batch`): full_graph a :func:`node_graph`;
    molecule as many whole molecules as the sizes hold (128 of 30 nodes and
    64 edges; 2 when reduced, the rest padding) with ``graph_ids``;
    minibatch one sample of 1,024 seeds (1 when reduced) at the shape's
    fanouts over a graph of the shape's size (:func:`_minibatch_graph`,
    drawn from seed + 2), padded with edges -1 at both ends, with
    ``seed_mask``.
    MeshGraphNet and NequIP regress standard normal targets, NequIP on
    standard normal positions. ``cell.args`` is (model, opt_state, batch)
    and ``cell.run()`` one train step (:func:`gnn_step`), returning (loss,
    metrics) and updating the parameters and ``opt_state`` in place.
    GatedGCN, MeshGraphNet and NequIP at ``ogb_products`` raise ValueError
    before allocating, naming the bytes of edge activations that do not fit
    one card; their reduced cells refuse too, though they would fit, so
    that the reduced registry runs the same cells as the full one.

    train (DLRM): the DLRM built by :meth:`DLRM.from_config` from ``seed``
    with its float32 master in host memory (``master=True``), its AdamW
    state (SGD on ``tables``, whose master is the model's) and one batch of
    65,536 (32 when reduced) from :func:`dlrm_train_batch`; ``cell.args``
    is (model, opt_state, dense, sparse, labels) and ``cell.run()`` one
    :func:`dlrm_train_step`, returning (loss, metrics).
    """
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    cfg = arch.reduced() if reduced else arch.config()
    if arch.family == "lm":
        return _lm_cell(arch_id, shape, cfg, reduced, dev, seed, batch, layers)
    if layers is not None:
        raise ValueError(f"{arch_id} {shape_name}: layers= cuts LM cells only")
    if arch.family == "gnn":
        if batch is not None:
            raise ValueError(f"{arch_id} {shape_name}: batch= cuts LM cells only; a "
                             "GNN step takes the shape's batch")
        return _gnn_cell(arch_id, shape, cfg, reduced, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if shape.kind == "train":
        model = DLRM.from_config(cfg, device=dev, seed=seed, master=True)
        batch = dlrm_train_batch(cfg, 32 if reduced else shape.params["batch"], gen)
        opt_cfg = AdamWConfig(sgd_paths=("tables",))
        opt_state = init_opt_state(model.leaves(), opt_cfg, master={"tables": model.master})
        return Cell(arch_id, shape_name, partial(dlrm_train_step, opt_cfg=opt_cfg),
                    (model, opt_state, *batch), model)
    if shape.kind == "retrieval":
        n_cand = 1024 if reduced else _r256(shape.params["n_candidates"])
        query = torch.randn((cfg.embed_dim,), generator=gen, device=dev)
        cands = torch.randn((n_cand, cfg.embed_dim), generator=gen, device=dev)
        return Cell(arch_id, shape_name, partial(retrieval_scores, k=100), (query, cands))
    if shape.kind != "serve":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    batch = 32 if reduced else shape.params["batch"]
    model = DLRM.from_config(cfg, device=dev, seed=seed)
    return Cell(arch_id, shape_name, model, dlrm_batch(cfg, batch, gen), model)


# ============================================================ input specs
_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool


def _opt_leaves(params: dict, sgd: tuple = ()) -> dict:
    """The reference's AdamW state of ``params`` ({path: (shape, dtype)}):
    ``step``, a float32 master of every leaf, m and v of every leaf whose
    path names none of ``sgd`` (an SGD leaf has no moments)."""
    out = {"step": ((), _I32)}
    for path, (shape, _) in params.items():
        out[f"master/{path}"] = (shape, _F32)
        if not any(s in path for s in sgd):
            out[f"m/{path}"] = (shape, _F32)
            out[f"v/{path}"] = (shape, _F32)
    return out


def _param_specs(params: dict, mesh) -> dict:
    return {path: param_spec(path, shape, mesh) for path, (shape, _) in params.items()}


def _opt_specs(opt: dict, pspecs: dict, mesh) -> dict:
    """The reference's ``_tree_opt_specs``: the step replicated, master, m
    and v the ZeRO-1 spec of their parameter's."""
    return {path: () if path == "step" else
            zero1_spec(pspecs.get(path.split("/", 1)[1], ()), shape, mesh)
            for path, (shape, _) in opt.items()}


def _lm_inputs(arch_id: str, shape: ShapeSpec, reduced: bool, mesh) -> list:
    arch = get_arch(arch_id)
    cfg = arch.reduced() if reduced else arch.config()
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
    dt, lead = DTYPES[cfg.dtype], cfg.layers_leading
    top = ("embed", "ln_final", "w_vocab")
    params = {(k if k in top else f"layers/{k}"): ((shp if k in top else lead + shp[1:]), dt)
              for k, (shp, _) in param_shapes(cfg).items()}
    pspecs = _param_specs(params, mesh)
    tok = ((B, S), _I32)
    tok_spec = logical_spec(("batch", None), (B, S), mesh)
    if shape.kind == "train":
        opt = _opt_leaves(params)
        return [(params, pspecs), (opt, _opt_specs(opt, pspecs, mesh)),
                tok + (tok_spec,), tok + (tok_spec,)]
    if shape.kind == "prefill":
        return [(params, pspecs), tok + (tok_spec,)]
    cache_shape = lead + (B, S, cfg.n_kv_heads, cfg.head_dim)
    cache_spec = logical_spec((None,) * len(lead) + ("batch", "kv_seq", "kv_heads", None),
                              cache_shape, mesh)
    cache = {str(i): (cache_shape, dt) for i in range(2)}
    return [(params, pspecs), (cache, {k: cache_spec for k in cache}),
            ((B,), _I32, logical_spec(("batch",), (B,), mesh)), ((), _I32, ())]


@lru_cache(maxsize=64)
def _gnn_param_leaves(arch_id: str, d_feat: int, n_cls: int, reduced: bool) -> dict:
    """{path: (shape, dtype)} of the arch's parameters, from its constructor
    run under a fake-tensor mode: shapes only, no storage anywhere. Cached
    (a cell's parameters do not depend on the mesh); callers must not
    mutate the result."""
    arch = get_arch(arch_id)
    cfg = arch.reduced() if reduced else arch.config()
    with FakeTensorMode():
        model = _gnn_model(arch_id, cfg, d_feat, n_cls, "cpu", 0)
        return {k: (tuple(v.shape), v.dtype) for k, v in model.leaves().items()}


def _gnn_inputs(arch_id: str, shape: ShapeSpec, reduced: bool, mesh) -> list:
    n, e, d_feat, n_cls, _, _ = _gnn_sizes(shape, reduced)
    params = _gnn_param_leaves(arch_id, d_feat, n_cls, reduced)
    pspecs = _param_specs(params, mesh)
    opt = _opt_leaves(params)
    edge_spec = logical_spec(("edges",), (e,), mesh)
    batch = {"senders": ((e,), _I32, edge_spec), "receivers": ((e,), _I32, edge_spec)}
    if arch_id == "nequip":
        batch["species"] = ((n,), _I32, ())
        batch["pos"] = ((n, 3), _F32, ())
    else:
        batch["x"] = ((n, d_feat), _F32, ())
        if arch_id != "gcn-cora":
            batch["ef"] = ((e, GNN_EDGE_FEAT), _F32,
                           logical_spec(("edges", None), (e, GNN_EDGE_FEAT), mesh))
    d_out = GNN_OUT[arch_id]
    batch["y"] = ((n, d_out), _F32, ()) if d_out else ((n,), _I32, ())
    if shape.kind == "minibatch":
        batch["seed_mask"] = ((n,), _BOOL, ())
    if shape.kind == "molecule":
        batch["graph_ids"] = ((n,), _I32, ())
    return [(params, pspecs), (opt, _opt_specs(opt, pspecs, mesh)),
            ({k: v[:2] for k, v in batch.items()}, {k: v[2] for k, v in batch.items()})]


def _dlrm_inputs(arch_id: str, shape: ShapeSpec, reduced: bool, mesh) -> list:
    arch = get_arch(arch_id)
    cfg = arch.reduced() if reduced else arch.config()
    if shape.kind == "retrieval":
        n_cand = 1024 if reduced else _r256(shape.params["n_candidates"])
        d = cfg.embed_dim
        return [((d,), _F32, ()),
                ((n_cand, d), _F32, logical_spec(("table_rows", None), (n_cand, d), mesh))]
    B = 32 if reduced else shape.params["batch"]
    params = {f"tables/table_{i}": ((cfg.padded_rows(r), cfg.embed_dim), _F32)
              for i, r in enumerate(cfg.row_counts)}
    for top, sizes in zip(("bot", "top"), _mlp_sizes(cfg)):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"{top}/{i}/w"] = ((a, b), _F32)
            params[f"{top}/{i}/b"] = ((b,), _F32)
    pspecs = _param_specs(params, mesh)
    bspec = logical_spec(("wide_batch", None), (B, cfg.n_dense), mesh)
    dense, sparse = ((B, cfg.n_dense), _F32, bspec), ((B, cfg.n_sparse), _I32, bspec)
    if shape.kind == "serve":
        return [(params, pspecs), dense, sparse]
    opt = _opt_leaves(params, sgd=("tables",))
    return [(params, pspecs), (opt, _opt_specs(opt, pspecs, mesh)), dense, sparse,
            ((B,), _F32, logical_spec(("wide_batch",), (B,), mesh))]


def cell_specs(arch_id: str, shape_name: str, mesh, reduced: bool = False) -> tuple:
    """The reference cell's ``in_specs`` on ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`, or None for no mesh) and what
    they imply for one device: ({path: spec}, argument_bytes).

    A path names one input leaf as the reference's ``_kp_str`` names it
    within the ``in_specs`` tuple (``"0/layers/wq"``, ``"1/master/embed"``,
    ``"2/senders"``, ``"3"``); a spec is a tuple of the ``PartitionSpec``'s
    entries. The leaves are the reference cell's arguments, in its dtypes
    (float32 tables and master copies, int32 ids), so ``argument_bytes``,
    each leaf's bytes over the product of the mesh axes its spec names, is
    the reference's per-device argument size. Shapes come from the configs'
    arithmetic (a GNN's parameters from its constructor under a fake-tensor
    mode): nothing is allocated, not even DLRM's tables."""
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    inputs = {"lm": _lm_inputs, "gnn": _gnn_inputs}.get(arch.family, _dlrm_inputs)(
        arch_id, shape, reduced, mesh)
    specs, nbytes = {}, 0
    for i, arg in enumerate(inputs):
        if isinstance(arg[0], dict):  # (leaves, specs) of a tree
            leaves, tree_specs = arg
            items = [(f"{i}/{k}", leaf, tree_specs[k]) for k, leaf in leaves.items()]
        else:                         # (shape, dtype, spec) of a leaf
            items = [(str(i), arg[:2], arg[2])]
        for path, (shp, dt), spec in items:
            specs[path] = spec
            nbytes += spec_bytes(shp, dt.itemsize, spec, mesh)
    return specs, nbytes
