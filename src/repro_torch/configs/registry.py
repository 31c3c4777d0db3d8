"""Architecture registry: maps arch ids to config constructors and shapes.

The twin of ``repro.configs.registry``: the same ten archs and shapes.
Each arch has a module in :mod:`repro_torch.configs` with ``config()``
(the exact published numbers) and ``reduced()`` (smoke-test scale).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | serve | retrieval | full_graph | minibatch | molecule
    params: dict


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "full_graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "minibatch",
        dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
             fanouts=(15, 10), d_feat=602, n_classes=41)),
    "ogb_products": ShapeSpec(
        "ogb_products", "full_graph",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47)),
    "molecule": ShapeSpec(
        "molecule", "molecule",
        dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1000000)),
}


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str          # lm | gnn | recsys
    module: str          # repro_torch.configs.<module>
    shapes: dict = field(default_factory=dict)

    def config(self):
        return importlib.import_module(self.module).config()

    def reduced(self):
        return importlib.import_module(self.module).reduced()


ARCHS: dict[str, ArchSpec] = {
    a.arch_id: a
    for a in [
        ArchSpec("phi3.5-moe-42b-a6.6b", "lm", "repro_torch.configs.phi35_moe", LM_SHAPES),
        ArchSpec("olmoe-1b-7b", "lm", "repro_torch.configs.olmoe", LM_SHAPES),
        ArchSpec("qwen2-1.5b", "lm", "repro_torch.configs.qwen2_1_5b", LM_SHAPES),
        ArchSpec("yi-34b", "lm", "repro_torch.configs.yi_34b", LM_SHAPES),
        ArchSpec("gemma2-9b", "lm", "repro_torch.configs.gemma2_9b", LM_SHAPES),
        ArchSpec("gatedgcn", "gnn", "repro_torch.configs.gatedgcn", GNN_SHAPES),
        ArchSpec("meshgraphnet", "gnn", "repro_torch.configs.meshgraphnet", GNN_SHAPES),
        ArchSpec("gcn-cora", "gnn", "repro_torch.configs.gcn_cora", GNN_SHAPES),
        ArchSpec("nequip", "gnn", "repro_torch.configs.nequip", GNN_SHAPES),
        ArchSpec("dlrm-mlperf", "recsys", "repro_torch.configs.dlrm_mlperf", RECSYS_SHAPES),
    ]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch, shape) dry-run cell: 40 in all."""
    return [(a, s) for a in ARCHS for s in ARCHS[a].shapes]
