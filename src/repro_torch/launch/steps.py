"""Step functions per (arch, shape) cell, with real inputs made from a seed.

The twin of ``repro.launch.steps`` for the kinds the port runs: the LM's
prefill and decode cells, the recsys serve, retrieval and train cells, and
the GNN's full-graph training cells. The reference returns abstract shapes for
an ahead-of-time compile on a mesh; the port runs eagerly on one GPU, so a
cell here holds the model on the device and inputs drawn from the seed,
ready to call.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.data.graphs import node_graph
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRM, DLRMConfig, dlrm_grads, retrieval_scores
from repro_torch.models.gnn import GCN, Graph, gcn_loss
from repro_torch.models.transformer import DTYPES, Transformer, moe_group_size, normal_chunked
from repro_torch.train.loop import train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclass
class Cell:
    arch_id: str
    shape: str
    fn: Callable
    args: tuple
    model: DLRM | Transformer | GCN | None = None  # the model, None for retrieval

    def run(self):
        return self.fn(*self.args)


def _r256(n: int) -> int:
    return ((n + 255) // 256) * 256


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
        raise NotImplementedError(
            f"{arch_id} {shape.name}: LM training is not ported yet (ROADMAP.md "
            "queue A: LM training with the flash_attention backward)")
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


def _gnn_sizes(shape: ShapeSpec, reduced: bool) -> tuple:
    """(nodes, edges, d_feat, n_classes) of a full-graph shape, cut as the
    reference's ``_gnn_sizes`` cuts it when reduced, rounded up to
    multiples of 256, and (nodes, edges) before the rounding."""
    p = shape.params
    n, e = p["n_nodes"], p["n_edges"]
    d_feat, n_cls = p["d_feat"], p.get("n_classes", 2)
    if reduced:
        scale = max(n // 64, 1)
        n, e = max(n // scale, 8), max(e // scale, 16)
        d_feat = min(d_feat, 16)
    return _r256(n), _r256(e), d_feat, n_cls, n, e


def gnn_step(model: GCN, opt_state: dict, batch: dict, opt_cfg: AdamWConfig) -> tuple:
    """One train step of the GNN cell: (loss, metrics), with the model's
    parameters and ``opt_state`` updated in place."""
    return train_step(lambda b: gcn_loss(model, b), model.leaves(), opt_state, batch, opt_cfg)


def _gatedgcn_not_ported(shape: ShapeSpec) -> NotImplementedError:
    """GatedGCN runs in the port (``models.gnn.GatedGCN``, trained from a
    sampled GraphStore by ``launch.gnn_compressed``) but has no cell of the
    registry's shapes yet. Its full-graph shapes do not fit one card the
    way the reference lays them out: at ``ogb_products`` (61,859,140 edges)
    one edge-sized float32 activation of width 70 takes 61.9M x 70 x 4 B,
    over 17 GB, and a step keeps several of them for each of the 16
    layers for the backward."""
    return NotImplementedError(
        f"gatedgcn {shape.name}: no gatedgcn cell is ported yet (ROADMAP.md queue A, item "
        "19: GatedGCN's cells of the minibatch_lg, full_graph and molecule kinds)")


def _gnn_cell(arch_id: str, shape: ShapeSpec, cfg, reduced: bool, dev, seed: int) -> Cell:
    if arch_id == "gatedgcn":
        raise _gatedgcn_not_ported(shape)
    if shape.kind != "full_graph":
        raise NotImplementedError(
            f"{arch_id} {shape.name}: the {shape.kind} kind is not ported yet (ROADMAP.md "
            "queue A, item 19: the minibatch_lg and molecule GNN shapes)")
    n, e, d_feat, n_cls, real_n, real_e = _gnn_sizes(shape, reduced)
    model = GCN.from_config(cfg, d_feat, n_cls, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = node_graph(n, e, d_feat, n_cls, real_nodes=real_n, real_edges=real_e, generator=gen)
    batch = {"x": g["x"], "y": g["y"],
             "graph": Graph.from_edges(g["senders"], g["receivers"], n)}
    opt_cfg = AdamWConfig()
    opt_state = init_opt_state(model.leaves(), opt_cfg)
    return Cell(arch_id, shape.name, partial(gnn_step, opt_cfg=opt_cfg),
                (model, opt_state, batch), model)


def build_cell(arch_id: str, shape_name: str, reduced: bool = False, device=None,
               seed: int = 0, batch: int | None = None, layers: int | None = None) -> Cell:
    """The cell's step function and its inputs on ``device`` (None: CUDA).

    prefill: the Transformer built by :meth:`Transformer.from_config` from
    ``seed`` and one (B, S) batch of token ids, ``cell.run()`` one
    ``prefill_step`` with a cache of S positions; decode: the model, a
    cache of S positions filled by :func:`lm_cache` and B tokens,
    ``cell.run()`` one ``decode_step`` at ``cur_index = S - 1``. (B, S)
    are the shape's (global_batch, seq_len), (2, min(S, 64)) when reduced;
    ``batch`` overrides B and ``layers`` the depth, in LM cells only (a
    single card holds neither prefill_32k's 32 sequences in the time of a
    smoke run nor decode_32k's 128 caches, nor phi-3.5-MoE's 83.7 GB of
    bf16 weights). An MoE config whose B * S (prefill) or B (decode) tokens
    break the group rule of :func:`moe_group_size` raises its ValueError
    here: a cell never regroups.

    serve: the DLRM built by :meth:`DLRM.from_config` from ``seed`` and one
    batch (512 for ``serve_p99``, 262,144 for ``serve_bulk``, 32 when
    reduced); retrieval: one query against 1,000,192 candidates (the
    reference's 1,000,000 rounded up to a multiple of 256; 1,024 when
    reduced), top 100. Inputs draw from a generator seeded with seed + 1.

    full_graph (GNN): the GCN built by :meth:`GCN.from_config` from ``seed``,
    its AdamW state and one batch {"x", "y", "graph"} drawn by
    :func:`node_graph` at the shape's sizes padded to multiples of 256
    (cut as the reference cuts them when reduced); ``cell.args`` is (model,
    opt_state, batch) and ``cell.run()`` one train step, returning (loss,
    metrics) and updating the parameters and ``opt_state`` in place. The
    minibatch and molecule kinds raise NotImplementedError, as does every
    shape of ``gatedgcn``.

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
                             "full-graph step takes the whole graph")
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
