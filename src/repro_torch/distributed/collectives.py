"""Receiver-partitioned aggregation and its loader helpers: the twin of
``repro.distributed.collectives``.

On a mesh the reference makes message aggregation a local scatter per
shard: edges sorted into receiver blocks (shard s owns node rows
[s·rows, (s+1)·rows)) let each device sum its own block, instead of
all-reducing the whole (N, d) aggregate every layer. On one device the
reference falls back to ``segment_sum``, and so does the port: here
:func:`partitioned_segment_sum` is that sum, the product of kernel
``csr_spmm`` with the receivers' CSR (:class:`repro_torch.models.gnn.EdgeCSR`),
on the card the kernel and on the CPU its plain twin.

:func:`partition_edges` and :func:`validate_partitioning` are the loader's
host steps, numpy copies of the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.gnn import EdgeCSR


def partitioned_segment_sum(msgs: torch.Tensor, receivers, n_nodes: int) -> torch.Tensor:
    """Σ_{e: receivers[e] = r} msgs[e] -> (n_nodes, d), or (n_nodes,) for
    1-D messages (degree counts). A receiver outside [0, n_nodes) is
    dropped, as ``segment_sum`` drops it. msgs (E, d) or (E,), float32 or
    bfloat16; receivers (E,) integer ids, moved to msgs' device. On a CUDA
    tensor this is a launch of ``csr_spmm`` (and of its combine where the
    CSR's plan cuts a row) or an error."""
    if msgs.dim() == 1:
        return partitioned_segment_sum(msgs[:, None], receivers, n_nodes)[:, 0]
    recv = torch.as_tensor(receivers, device=msgs.device)
    if msgs.dim() != 2 or recv.shape != msgs.shape[:1]:
        raise ValueError(f"msgs (E, d) and receivers (E,), not {tuple(msgs.shape)} and "
                         f"{tuple(recv.shape)}")
    return EdgeCSR.from_receivers(recv, n_nodes).agg(msgs)


def partition_edges(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
                    n_shards: int):
    """Host loader step: sort edges by receiver block and pad each shard's
    slice to equal length (padding edges point at the shard's first row
    with a sentinel sender -1 the caller masks).

    Returns (senders', receivers', pad_mask) each of length
    n_shards * max_per_shard.
    """
    rows = (n_nodes + n_shards - 1) // n_shards
    blk = receivers // rows
    order = np.argsort(blk, kind="stable")
    senders, receivers, blk = senders[order], receivers[order], blk[order]
    counts = np.bincount(blk, minlength=n_shards)
    per = int(counts.max()) if len(counts) else 1
    out_s = np.full(n_shards * per, -1, dtype=np.int64)
    out_r = np.empty(n_shards * per, dtype=np.int64)
    for s in range(n_shards):
        out_r[s * per:(s + 1) * per] = s * rows  # pad targets: shard-local row
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(receivers)) - np.repeat(starts, counts)
    idx = blk * per + pos
    out_s[idx] = senders
    out_r[idx] = receivers
    return out_s, out_r, out_s >= 0


def validate_partitioning(receivers: np.ndarray, n_nodes: int, n_shards: int) -> bool:
    rows = (n_nodes + n_shards - 1) // n_shards
    per = len(receivers) // n_shards
    blk = np.asarray(receivers) // rows
    want = np.repeat(np.arange(n_shards), per)
    return bool((blk == want).all())
