"""DLRM (Naumov et al. 2019), MLPerf benchmark config over Criteo-1TB: the
serving path of ``repro.models.dlrm`` on one GPU.

Bottom MLP over the dense features, one embedding row per sparse field, dot
interaction of the 27 fields, top MLP. Lookups are single-hot per field on
Criteo; the lookup is the hand-written ``embedding_bag`` kernel with bags of
one, and the interaction the hand-written ``dot_interaction`` kernel.

Port decisions:

- (a) Tables are stored on the device in ``compute_dtype``: bfloat16 for
  ``config()``, float32 for ``reduced()``. The reference keeps float32
  tables and casts every gathered row to ``compute_dtype`` before use, so
  the fields are the same bit for bit; at full size the 177,948,416 padded
  rows x 128 take 45.6 GB in bfloat16, which fits on one 80 GB card,
  against 91.1 GB in float32, which does not.
- (b) The 26 tables are one concatenated (sum of padded rows, D) tensor
  with per-field row offsets added to the indices, so a batch's whole
  lookup is ONE ``embedding_bag`` launch over (B * 26, 1) bags. The summed
  row count fits int32 indices; the element offsets do not, and the kernel
  computes them in int64.
- (c) The MLPs are float32 like the reference's. They rely on PyTorch's
  default float32 matmul precision, "highest" (no TF32); this module does
  not change that global setting.
- ``shard()`` is a no-op on one card and is dropped; training
  (``dlrm_loss`` and the optimizer) is not ported yet.

A sparse id outside [0, padded rows) of its field raises ``ValueError``
(the reference wraps negative ids around; that is not reproduced). With the
tables concatenated, such an id would otherwise read a row of a neighbouring
field's table, or past the end of the last one. The check masks bad ids to
padding on the device, so the lookup never reads out of bounds, and reads
one flag back per batch: a host sync that ``forward`` makes after every
launch of the batch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import MLP

# MLPerf DLRM Criteo Terabyte per-field cardinalities (dlrm repo day-23)
CRITEO_TB_ROWS = (
    45833188, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457,
    11316796, 40094537, 452104, 12606, 104, 35,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_INIT_CHUNK_ROWS = 1 << 22  # rows drawn at a time: 2 GiB of float32 scratch at D = 128


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    row_counts: tuple = CRITEO_TB_ROWS
    interaction: str = "dot"
    compute_dtype: str = "bfloat16"  # table and field dtype; float32 in reduced
    row_pad: int = 256  # table rows padded to a multiple, as in the reference

    def padded_rows(self, rows: int) -> int:
        return ((rows + self.row_pad - 1) // self.row_pad) * self.row_pad

    @property
    def n_fields(self) -> int:
        return self.n_sparse + 1  # + bottom-MLP output as a field

    def n_params(self) -> int:
        total = sum(self.row_counts) * self.embed_dim
        dims = [self.n_dense] + list(self.bot_mlp)
        total += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        f = self.n_fields
        d_int = f * (f - 1) // 2 + self.embed_dim
        dims = [d_int] + list(self.top_mlp)
        total += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return total


def _mlp_sizes(cfg: DLRMConfig) -> tuple[list, list]:
    f = cfg.n_fields
    d_int = f * (f - 1) // 2 + cfg.embed_dim
    return [cfg.n_dense] + list(cfg.bot_mlp), [d_int] + list(cfg.top_mlp)


class DLRM(nn.Module):
    """``dlrm_apply`` as a module: ``forward(dense, sparse)`` -> logits (B,).

    ``table`` is the (sum of padded rows, embed_dim) concatenation of the
    26 tables in ``compute_dtype``; ``row_offsets`` (n_sparse,) holds the
    first row of each field in it and ``row_limits`` (n_sparse,) each
    field's padded row count.
    """

    def __init__(self, cfg: DLRMConfig, table: torch.Tensor, bot: MLP, top: MLP):
        super().__init__()
        if cfg.interaction != "dot":
            raise ValueError(f"only the dot interaction is ported, not {cfg.interaction!r}")
        if cfg.bot_mlp[-1] != cfg.embed_dim:
            raise ValueError("the bottom MLP must end at embed_dim to be a field")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        padded = [cfg.padded_rows(r) for r in cfg.row_counts]
        if table.shape != (sum(padded), cfg.embed_dim) or table.dtype != self.compute_dtype:
            raise ValueError(f"table must be ({sum(padded)}, {cfg.embed_dim}) "
                             f"{self.compute_dtype}, not {tuple(table.shape)} {table.dtype}")
        starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
        idx_dtype = torch.int32 if sum(padded) < 2**31 else torch.int64
        self.register_buffer("table", table)
        self.register_buffer("row_offsets",
                             torch.tensor(starts, dtype=idx_dtype, device=table.device))
        self.register_buffer("row_limits",
                             torch.tensor(padded, dtype=idx_dtype, device=table.device))
        self.bot = bot
        self.top = top

    @classmethod
    def from_config(cls, cfg: DLRMConfig, device=None, seed: int = 0) -> "DLRM":
        """``dlrm_init`` on the device, from a ``torch.Generator`` seeded with
        ``seed``: table rows normal / sqrt(embed_dim), drawn in float32 a
        chunk of rows at a time and stored in ``compute_dtype`` (the tables
        never pass through the host, and no float32 copy of all of them is
        made); MLP weights normal / sqrt(fan_in), biases zero."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cdt = _DTYPES[cfg.compute_dtype]
        d = cfg.embed_dim
        padded = [cfg.padded_rows(r) for r in cfg.row_counts]
        table = torch.empty((sum(padded), d), dtype=cdt, device=dev)
        start = 0
        for rows in padded:
            for a in range(start, start + rows, _INIT_CHUNK_ROWS):
                b = min(a + _INIT_CHUNK_ROWS, start + rows)
                chunk = torch.randn((b - a, d), generator=gen, device=dev)
                table[a:b] = (chunk / math.sqrt(d)).to(cdt)
            start += rows
        bot_sizes, top_sizes = _mlp_sizes(cfg)
        bot = MLP.init(bot_sizes, generator=gen, device=dev, final_act=True)
        top = MLP.init(top_sizes, generator=gen, device=dev)
        return cls(cfg, table, bot, top)

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: DLRMConfig, device=None) -> "DLRM":
        """Carry the JAX package's parameters across: ``params`` is the
        ``dlrm_init`` pytree as numpy float arrays, ``{"tables": {"table_i":
        (padded_rows_i, D)}, "bot": [{"w", "b"}, ...], "top": [...]}``."""
        dev = resolve_device(device)
        cdt = _DTYPES[cfg.compute_dtype]
        padded = [cfg.padded_rows(r) for r in cfg.row_counts]
        table = torch.empty((sum(padded), cfg.embed_dim), dtype=cdt, device=dev)
        start = 0
        for i, rows in enumerate(padded):
            t = np.asarray(params["tables"][f"table_{i}"])
            if t.shape != (rows, cfg.embed_dim):
                raise ValueError(f"table_{i} is {t.shape}, expected {(rows, cfg.embed_dim)}")
            table[start:start + rows] = _f32(t).to(dev).to(cdt)
            start += rows
        mlps = []
        for key, sizes in zip(("bot", "top"), _mlp_sizes(cfg)):
            layers = params[key]
            if len(layers) != len(sizes) - 1:
                raise ValueError(f"{key} has {len(layers)} layers, expected {len(sizes) - 1}")
            for p, d_in, d_out in zip(layers, sizes[:-1], sizes[1:]):
                if np.shape(p["w"]) != (d_in, d_out) or np.shape(p["b"]) != (d_out,):
                    raise ValueError(f"{key} layer shapes {np.shape(p['w'])}, "
                                     f"{np.shape(p['b'])} != {(d_in, d_out)}, {(d_out,)}")
            mlps.append([{"w": _f32(p["w"]).to(dev), "b": _f32(p["b"]).to(dev)}
                         for p in layers])
        return cls(cfg, table, MLP(mlps[0], final_act=True), MLP(mlps[1]))

    def _fields(self, dense: torch.Tensor, sparse: torch.Tensor):
        """``fields`` without the id check: also returns the device flag
        that every id lies in its field."""
        cfg = self.cfg
        if dense.dim() != 2 or dense.shape[1] != cfg.n_dense:
            raise ValueError(f"dense must be (B, {cfg.n_dense}), not {tuple(dense.shape)}")
        if sparse.shape != (dense.shape[0], cfg.n_sparse):
            raise ValueError(f"sparse must be (B, {cfg.n_sparse}), not {tuple(sparse.shape)}")
        x_bot = self.bot(dense)
        in_range = (sparse >= 0) & (sparse < self.row_limits)
        bags = torch.where(in_range, sparse + self.row_offsets, -1).reshape(-1, 1)
        emb = ops.embedding_bag(self.table, bags, "sum")
        emb = emb.view(dense.shape[0], cfg.n_sparse, cfg.embed_dim)
        fields = torch.cat([x_bot.to(self.compute_dtype).unsqueeze(1), emb], dim=1)
        return x_bot, fields, in_range.all()

    def fields(self, dense: torch.Tensor, sparse: torch.Tensor):
        """(x_bot, fields): the bottom MLP's float32 output (B, D) and the
        interaction's input (B, 27, D) in ``compute_dtype``, [x_bot, the 26
        embeddings]. The 26 lookups are one ``embedding_bag`` launch."""
        x_bot, fields, ids_ok = self._fields(dense, sparse)
        _check_ids(ids_ok)
        return x_bot, fields

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
        """dense (B, n_dense) float32, sparse (B, n_sparse) int32 or int64 ->
        logits (B,) float32."""
        x_bot, fields, ids_ok = self._fields(dense, sparse)
        inter = ops.dot_interaction(fields)  # float32, as `_interact`
        logits = self.top(torch.cat([x_bot, inter], dim=1))[:, 0]
        _check_ids(ids_ok)  # the batch's one host sync, after all its launches
        return logits


def _check_ids(ids_ok: torch.Tensor) -> None:
    if not bool(ids_ok):
        raise ValueError("a sparse id lies outside [0, padded rows) of its field")


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def retrieval_scores(query_emb: torch.Tensor, candidate_embs: torch.Tensor, k: int = 100):
    """retrieval_cand: one query (D,) against (n_cand, D) item vectors ->
    (values, indices) of the k best dot scores, best first. A plain product
    and ``torch.topk``: no kernel of this repository runs here."""
    return torch.topk(candidate_embs @ query_emb, k)
