"""Step functions per (arch, shape) cell, with real inputs made from a seed.

The twin of ``repro.launch.steps`` for the kinds the port runs: the LM's
prefill and decode cells and the recsys serve and retrieval cells. The
reference returns abstract shapes for an ahead-of-time compile on a mesh;
the port runs eagerly on one GPU, so a cell here holds the model on the
device and inputs drawn from the seed, ready to call.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRM, DLRMConfig, retrieval_scores
from repro_torch.models.transformer import DTYPES, Transformer, normal_chunked


@dataclass
class Cell:
    arch_id: str
    shape: str
    fn: Callable
    args: tuple
    model: DLRM | Transformer | None = None  # the served model, None for retrieval

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
             batch: int | None) -> Cell:
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
    if batch is not None:
        B = batch
    if shape.kind == "train":
        raise NotImplementedError(
            f"{arch_id} {shape.name}: LM training is not ported yet (ROADMAP.md "
            "queue A: LM training with the flash_attention backward)")
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


def build_cell(arch_id: str, shape_name: str, reduced: bool = False, device=None,
               seed: int = 0, batch: int | None = None) -> Cell:
    """The cell's step function and its inputs on ``device`` (None: CUDA).

    prefill: the Transformer built by :meth:`Transformer.from_config` from
    ``seed`` and one (B, S) batch of token ids, ``cell.run()`` one
    ``prefill_step`` with a cache of S positions; decode: the model, a
    cache of S positions filled by :func:`lm_cache` and B tokens,
    ``cell.run()`` one ``decode_step`` at ``cur_index = S - 1``. (B, S)
    are the shape's (global_batch, seq_len), (2, min(S, 64)) when reduced;
    ``batch`` overrides B, in LM cells only (a single card holds neither
    prefill_32k's 32 sequences in the time of a smoke run nor decode_32k's
    128 caches).

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
    if arch.family == "lm":
        return _lm_cell(arch_id, shape, cfg, reduced, dev, seed, batch)
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
