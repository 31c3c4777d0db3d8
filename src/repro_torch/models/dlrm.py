"""DLRM (Naumov et al. 2019), MLPerf benchmark config over Criteo-1TB: the
serving and training paths of ``repro.models.dlrm`` on one GPU.

Bottom MLP over the dense features, one embedding row per sparse field, dot
interaction of the 27 fields, top MLP. Lookups are single-hot per field on
Criteo; the lookup is the hand-written ``embedding_bag`` kernel with bags of
one, and the interaction the hand-written ``dot_interaction`` kernel.
Training (:func:`dlrm_loss`, :func:`dlrm_grads`) adds their gradients, the
``dot_interaction_backward`` kernel under autograd and the
``embedding_bag_backward`` kernel on the lookup's gradient, and the
optimizer's ``sgd_rows`` kernel on the rows a batch touched.

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
- (d) Training keeps the tables' float32 master rows in host memory, not
  on the card. The reference trains the tables as float32 leaves and keeps
  a float32 master copy of every leaf (``src/repro/train/optimizer.py:60``):
  91.1 GB at full size, more than the card's 80 GB beside the 45.6 GB bf16
  table. So the bf16 table stays on the card, as the forward reads it, and
  the master (``DLRM.master``, built with ``master=True``) is one CPU
  tensor of (rows, D) float32 on 2 MB-aligned anonymous memory advised
  for huge pages (``kernels.embedding_bag.host_empty``),
  registered once with the card (``cudaHostRegister``, pinned and mapped:
  ``kernels.embedding_bag.register_host``; on an H100 host with 108 GB of
  memory, 91.1 GB registered in 41-57 s). The tables are SGD
  leaves, with no moments and no weight decay, so a row whose gradient is
  zero keeps its master bit for bit; a step updates only the rows its batch
  touched, reading and writing their master rows over PCIe from the
  ``sgd_rows`` kernel and writing each one's bf16 rounding into the table.
  ``from_config`` draws each chunk of rows in float32 on the card, copies
  it to the master and stores its rounding in the table, so the train
  cell's table is the serve cell's bit for bit and no float32 copy of all
  the tables is ever on the card. There is one layout: a host that cannot
  register the master fails there. The autograd leaf of the tables is the
  lookup's output (``Lookup.emb``), not the table: a gradient of the table's
  shape (45.6 GB in bf16) cannot exist on the card, and autograd would give
  it the table's dtype where the reference sums rows in float32. The MLPs'
  master and moments stay on the card.
- ``shard()`` is a no-op on one card and is dropped.

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
import weakref
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.dot_interaction import DotInteraction
from repro_torch.kernels.embedding_bag import host_empty, register_host, unregister_host
from repro_torch.models.common import MLP
from repro_torch.train.optimizer import SparseRows

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


@dataclass
class Lookup:
    """The training forward's lookup: ``emb`` (B * n_sparse, D) in
    ``compute_dtype``, the autograd leaf that stands for the tables;
    ``bags`` (B * n_sparse, 1) the rows it read from the concatenated table
    (-1 for an id out of range); ``ids_ok`` the device flag that every id
    lay in its field."""
    emb: torch.Tensor
    bags: torch.Tensor
    ids_ok: torch.Tensor


def _host_master(n_rows: int, d: int, dev: torch.device) -> tuple:
    """(master, seconds): an empty (n_rows, d) float32 CPU tensor on
    huge-page-advised memory (``host_empty``), registered with the card when
    ``dev`` is one (decision (d)), and the seconds the registration took
    (0.0 on the CPU)."""
    master = host_empty((n_rows, d))
    return master, register_host(master) if dev.type == "cuda" else 0.0


class DLRM(nn.Module):
    """``dlrm_apply`` as a module: ``forward(dense, sparse)`` -> logits (B,).

    ``table`` is the (sum of padded rows, embed_dim) concatenation of the
    26 tables in ``compute_dtype``; ``row_offsets`` (n_sparse,) holds the
    first row of each field in it and ``row_limits`` (n_sparse,) each
    field's padded row count. ``master``, for training, is the tables' float32
    master of the same shape in host memory (registered with the card when
    the table is on one; decision (d)), None for a serving model; the model
    releases the registration when it is collected, or at
    :meth:`release_master`.
    """

    def __init__(self, cfg: DLRMConfig, table: torch.Tensor, bot: MLP, top: MLP,
                 master: torch.Tensor | None = None, master_register_s: float = 0.0):
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
        self.master = None
        self.master_register_s = master_register_s
        self._release = None
        if master is not None:
            if (master.shape != table.shape or master.dtype != torch.float32
                    or master.device.type != "cpu" or not master.is_contiguous()):
                raise ValueError(f"the master must be a contiguous {tuple(table.shape)} "
                                 "float32 CPU tensor")
            self.master = master
            if table.device.type == "cuda":
                self._release = weakref.finalize(self, unregister_host, master)

    def release_master(self) -> None:
        """Drop the float32 master, releasing its registration with the card
        first (the optimizer state that holds it can no longer update it)."""
        if self._release is not None:
            self._release()
        self.master = self._release = None

    @classmethod
    def from_config(cls, cfg: DLRMConfig, device=None, seed: int = 0,
                    master: bool = False) -> "DLRM":
        """``dlrm_init`` on the device, from a ``torch.Generator`` seeded with
        ``seed``: table rows normal / sqrt(embed_dim), drawn in float32 a
        chunk of rows at a time and stored in ``compute_dtype`` (the tables
        never pass through the host, and no float32 copy of all of them is
        made); MLP weights normal / sqrt(fan_in), biases zero. With
        ``master``, each float32 chunk is also copied to the host master
        (decision (d)); the table is the same either way."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cdt = _DTYPES[cfg.compute_dtype]
        d = cfg.embed_dim
        padded = [cfg.padded_rows(r) for r in cfg.row_counts]
        table = torch.empty((sum(padded), d), dtype=cdt, device=dev)
        host, reg_s = _host_master(sum(padded), d, dev) if master else (None, 0.0)
        start = 0
        for rows in padded:
            for a in range(start, start + rows, _INIT_CHUNK_ROWS):
                b = min(a + _INIT_CHUNK_ROWS, start + rows)
                chunk = torch.randn((b - a, d), generator=gen, device=dev) / math.sqrt(d)
                if host is not None:
                    host[a:b].copy_(chunk)
                table[a:b] = chunk.to(cdt)
            start += rows
        bot_sizes, top_sizes = _mlp_sizes(cfg)
        bot = MLP.init(bot_sizes, generator=gen, device=dev, final_act=True)
        top = MLP.init(top_sizes, generator=gen, device=dev)
        return cls(cfg, table, bot, top, host, reg_s)

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: DLRMConfig, device=None,
                          master: bool = False) -> "DLRM":
        """Carry the JAX package's parameters across: ``params`` is the
        ``dlrm_init`` pytree as numpy float arrays, ``{"tables": {"table_i":
        (padded_rows_i, D)}, "bot": [{"w", "b"}, ...], "top": [...]}``. With
        ``master``, the tables also fill the float32 master exactly, and the
        table holds its rounding."""
        dev = resolve_device(device)
        cdt = _DTYPES[cfg.compute_dtype]
        padded = [cfg.padded_rows(r) for r in cfg.row_counts]
        table = torch.empty((sum(padded), cfg.embed_dim), dtype=cdt, device=dev)
        host, reg_s = (_host_master(sum(padded), cfg.embed_dim, dev) if master
                       else (None, 0.0))
        start = 0
        for i, rows in enumerate(padded):
            t = np.asarray(params["tables"][f"table_{i}"])
            if t.shape != (rows, cfg.embed_dim):
                raise ValueError(f"table_{i} is {t.shape}, expected {(rows, cfg.embed_dim)}")
            rows_f32 = _f32(t)
            if host is not None:
                host[start:start + rows] = rows_f32
            table[start:start + rows] = rows_f32.to(dev).to(cdt)
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
        return cls(cfg, table, MLP(mlps[0], final_act=True), MLP(mlps[1]), host, reg_s)

    def leaves(self) -> dict[str, torch.Tensor]:
        """The trainable tensors under the reference's pytree paths, in its
        leaf order: ``bot/<i>/b``, ``bot/<i>/w``, ``tables`` (the
        concatenated table, one leaf for the reference's 26), ``top/...``."""
        return {**self.bot.leaves("bot"), "tables": self.table, **self.top.leaves("top")}

    def numpy_params(self) -> dict:
        """The reverse of :meth:`from_numpy_params`: the ``dlrm_init`` pytree
        as numpy float32 arrays, the tables read from the float32 master (the
        table itself when there is none)."""
        cfg = self.cfg
        src = self.master if self.master is not None else self.table.float().cpu()
        tables, start = {}, 0
        for i, rows in enumerate(cfg.padded_rows(r) for r in cfg.row_counts):
            tables[f"table_{i}"] = src[start:start + rows].numpy().copy()
            start += rows
        def layers(mlp: MLP) -> list:
            return [{"w": w.detach().cpu().numpy().copy(), "b": b.detach().cpu().numpy().copy()}
                    for w, b in zip(mlp.w, mlp.b)]

        return {"tables": tables, "bot": layers(self.bot), "top": layers(self.top)}

    def _bags(self, dense: torch.Tensor, sparse: torch.Tensor) -> tuple:
        """(bags, ids_ok): each id's row in the concatenated table, (B *
        n_sparse, 1), -1 where an id lies outside its field, and the device
        flag that none did."""
        cfg = self.cfg
        if dense.dim() != 2 or dense.shape[1] != cfg.n_dense:
            raise ValueError(f"dense must be (B, {cfg.n_dense}), not {tuple(dense.shape)}")
        if sparse.shape != (dense.shape[0], cfg.n_sparse):
            raise ValueError(f"sparse must be (B, {cfg.n_sparse}), not {tuple(sparse.shape)}")
        in_range = (sparse >= 0) & (sparse < self.row_limits)
        bags = torch.where(in_range, sparse + self.row_offsets, -1).reshape(-1, 1)
        return bags, in_range.all()

    def _fields(self, dense: torch.Tensor, sparse: torch.Tensor):
        """``fields`` without the id check: also returns the device flag
        that every id lies in its field."""
        bags, ids_ok = self._bags(dense, sparse)
        x_bot = self.bot(dense)
        emb = ops.embedding_bag(self.table, bags, "sum")
        return x_bot, self._stack(x_bot, emb), ids_ok

    def _stack(self, x_bot: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = emb.view(x_bot.shape[0], cfg.n_sparse, cfg.embed_dim)
        return torch.cat([x_bot.to(self.compute_dtype).unsqueeze(1), emb], dim=1)

    @torch.no_grad()
    def fields(self, dense: torch.Tensor, sparse: torch.Tensor):
        """(x_bot, fields): the bottom MLP's float32 output (B, D) and the
        interaction's input (B, 27, D) in ``compute_dtype``, [x_bot, the 26
        embeddings]. The 26 lookups are one ``embedding_bag`` launch."""
        x_bot, fields, ids_ok = self._fields(dense, sparse)
        _check_ids(ids_ok)
        return x_bot, fields

    @torch.no_grad()
    def forward(self, dense: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
        """dense (B, n_dense) float32, sparse (B, n_sparse) int32 or int64 ->
        logits (B,) float32. Serving: no autograd graph is recorded."""
        x_bot, fields, ids_ok = self._fields(dense, sparse)
        inter = ops.dot_interaction(fields)  # float32, as `_interact`
        logits = self.top(torch.cat([x_bot, inter], dim=1))[:, 0]
        _check_ids(ids_ok)  # the batch's one host sync, after all its launches
        return logits

    def train_forward(self, dense: torch.Tensor, sparse: torch.Tensor) -> tuple:
        """(logits, lookup): ``forward``'s logits, recorded for autograd
        through the MLPs and the interaction (``DotInteraction``: the kernel
        and its backward kernel), with the lookup's output as the leaf that
        stands for the tables (:class:`Lookup`). The id check is left to the
        caller (``lookup.ids_ok``), so that a step syncs once."""
        bags, ids_ok = self._bags(dense, sparse)
        x_bot = self.bot(dense)
        emb = ops.embedding_bag(self.table, bags, "sum").requires_grad_()
        inter = DotInteraction.apply(self._stack(x_bot, emb))
        logits = self.top(torch.cat([x_bot, inter], dim=1))[:, 0]
        return logits, Lookup(emb, bags, ids_ok)


def logit_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits against labels in {0, 1}, in the
    reference's stable form: max(z, 0) - z y + log1p(exp(-|z|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def dlrm_loss(model: DLRM, dense: torch.Tensor, sparse: torch.Tensor,
              labels: torch.Tensor) -> tuple:
    """(loss, lookup): ``dlrm_loss`` of the reference (``logit_loss`` of the
    training forward's logits) and the lookup whose ``emb`` stands for the
    tables in autograd."""
    logits, lookup = model.train_forward(dense, sparse)
    return logit_loss(logits, labels), lookup


def dlrm_grads(model: DLRM, dense: torch.Tensor, sparse: torch.Tensor,
               labels: torch.Tensor) -> tuple:
    """(loss, grads): the loss and the gradient of every leaf of
    :meth:`DLRM.leaves`, in its order; the tables' is a ``SparseRows``, the
    lookup's gradient summed by distinct row (``ops.embedding_bag_backward``),
    sized from the batch's B * n_sparse ids. Checks the ids once, after the
    backward's launches: the step's one host sync."""
    loss, lookup = dlrm_loss(model, dense, sparse, labels)
    leaves = model.leaves()
    paths = [k for k in leaves if k != "tables"]
    *grads, g_emb = torch.autograd.grad(loss, [leaves[k] for k in paths] + [lookup.emb])
    rows, g_rows, n_unique = ops.embedding_bag_backward(lookup.bags, g_emb, "sum",
                                                        model.table.shape[0])
    _check_ids(lookup.ids_ok)
    by_path = dict(zip(paths, grads))
    by_path["tables"] = SparseRows(rows, g_rows, n_unique)
    return loss.detach(), {k: by_path[k] for k in leaves}


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
