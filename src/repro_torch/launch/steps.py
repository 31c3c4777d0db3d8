"""Step functions per (arch, shape) cell, with real inputs made from a seed.

The twin of the serve and retrieval kinds of ``repro.launch.steps``'s
recsys cell. The reference returns abstract shapes for an ahead-of-time
compile on a mesh; the port runs eagerly on one GPU, so a cell here holds
the model on the device and a batch drawn from the seed, ready to call.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRM, DLRMConfig, retrieval_scores


@dataclass
class Cell:
    arch_id: str
    shape: str
    fn: Callable
    args: tuple
    model: DLRM | None = None  # the served model, None for retrieval

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


def build_cell(arch_id: str, shape_name: str, reduced: bool = False, device=None,
               seed: int = 0) -> Cell:
    """The cell's step function and its inputs on ``device`` (None: CUDA).

    serve: the DLRM built by :meth:`DLRM.from_config` from ``seed`` and one
    batch (512 for ``serve_p99``, 262,144 for ``serve_bulk``, 32 when
    reduced); retrieval: one query against 1,000,192 candidates (the
    reference's 1,000,000 rounded up to a multiple of 256; 1,024 when
    reduced), top 100. Inputs draw from a generator seeded with seed + 1.
    """
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    cfg = arch.reduced() if reduced else arch.config()
    if shape.kind == "train":
        raise NotImplementedError(
            f"{arch_id} {shape_name}: DLRM training is not ported yet "
            "(ROADMAP.md queue A, item 3: DLRM training and the embedding_bag backward)")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
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
