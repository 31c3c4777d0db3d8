"""Device dispatch for the hand-written kernels.

A tensor on the CPU goes to the kernel's plain twin in
:mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the CUDA kernel,
which launches or raises. There is no fallback and no batch size below
which the card takes the plain path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import build_all, launch_counts, reset_launch_counts
from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda
from repro_torch.kernels.digram_count import (DigramTable, digram_pair_accum_cuda,
                                              digram_pair_counts_cuda, digram_select_cuda)
from repro_torch.kernels.dot_interaction import (dot_interaction_backward_cuda,
                                                 dot_interaction_cuda)
from repro_torch.kernels.embedding_bag import (embedding_bag_backward_cuda, embedding_bag_cuda,
                                               sgd_rows_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_backward_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.k2_lines import K2Layout, k2_lines_cuda
from repro_torch.kernels.segment_matmul import CSR, csr_spmm_cuda


def bitvec_rank(words: torch.Tensor, word_ranks: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """rank1 at each position; see :func:`ref.bitvec_rank_ref`."""
    if positions.device.type == "cpu":
        return ref.bitvec_rank_ref(words, word_ranks, positions)
    return bitvec_rank_cuda(words, word_ranks, positions)


def k2_lines(lay: K2Layout, fixed: torch.Tensor, axis: int):
    """Rows (axis 0) or columns (axis 1) ``fixed`` of the k²-tree ``lay``:
    (idx, coords) sorted by (idx, coord); see :func:`ref.k2_lines_ref`."""
    if fixed.device.type == "cpu":
        return ref.k2_lines_ref(lay, fixed, axis)
    return k2_lines_cuda(lay, fixed, axis)


def digram_pair_counts(its: torch.Tensor, cnts: torch.Tensor):
    """(lo, hi, count) per node pair; see :func:`ref.digram_pair_counts_ref`."""
    if its.device.type == "cpu":
        return ref.digram_pair_counts_ref(its, cnts)
    return digram_pair_counts_cuda(its, cnts)


def digram_pair_accum(table: DigramTable, row_ptr: torch.Tensor, its: torch.Tensor,
                      cnts: torch.Tensor, sign: torch.Tensor) -> None:
    """Add the signed pair counts of each CSR row of node histograms to
    `table`, in place; see :func:`ref.digram_pair_accum_ref`."""
    if row_ptr.device.type == "cpu":
        return ref.digram_pair_accum_ref(table, row_ptr, its, cnts, sign)
    return digram_pair_accum_cuda(table, row_ptr, its, cnts, sign)


def digram_select(table: DigramTable) -> torch.Tensor:
    """(key, count, slot, used) of the most frequent unflagged digram of
    `table`; see :func:`ref.digram_select_slot_ref`."""
    if table.keys.device.type == "cpu":
        return ref.digram_select_slot_ref(table)
    return digram_select_cuda(table)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """Sum or mean of the rows of each -1-padded bag; see
    :func:`ref.embedding_bag_ref`."""
    if table.device.type == "cpu":
        return ref.embedding_bag_ref(table, indices, combiner)
    return embedding_bag_cuda(table, indices, combiner)


def embedding_bag_backward(indices: torch.Tensor, grad_out: torch.Tensor,
                           combiner: str = "sum", n_rows: int | None = None) -> tuple:
    """(rows, grads, n_unique): the table's gradient by distinct row, in a
    compact float32 buffer sized B * L; see :func:`ref.embedding_bag_backward_ref`."""
    if grad_out.device.type == "cpu":
        return ref.embedding_bag_backward_ref(indices, grad_out, combiner, n_rows)
    return embedding_bag_backward_cuda(indices, grad_out, combiner, n_rows)


def sgd_rows(master: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
             grads: torch.Tensor, n_unique: torch.Tensor, lr: torch.Tensor,
             clip: torch.Tensor) -> None:
    """SGD of the first n_unique rows of the float32 master, in place, and
    their rounding into the table; see :func:`ref.sgd_rows_ref`."""
    if table.device.type == "cpu":
        return ref.sgd_rows_ref(master, table, rows, grads, n_unique, lr, clip)
    return sgd_rows_cuda(master, table, rows, grads, n_unique, lr, clip)


def dot_interaction(x: torch.Tensor) -> torch.Tensor:
    """Strictly lower triangle of x @ x^T per sample, float32; see
    :func:`ref.dot_interaction_ref`."""
    if x.device.type == "cpu":
        return ref.dot_interaction_ref(x)
    return dot_interaction_cuda(x)


def dot_interaction_backward(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """(G + Gᵀ) x per sample, in x's dtype; see
    :func:`ref.dot_interaction_backward_ref`."""
    if x.device.type == "cpu":
        return ref.dot_interaction_backward_ref(x, dz)
    return dot_interaction_backward_cuda(x, dz)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, sm_scale: float | None = None,
                    q_offset: int | None = None) -> torch.Tensor:
    """Grouped-query attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D)
    with query row i at position i + q_offset; see
    :func:`ref.flash_attention_ref`. Where autograd records (grad enabled
    and q, k or v requiring it) the call goes through
    :class:`FlashAttention`, whose backward is the hand-written one;
    otherwise (serving) it is one forward launch, as before."""
    kw = dict(causal=causal, window=window, softcap=softcap, sm_scale=sm_scale,
              q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kw)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself if its D is contiguous and its rows 16-byte aligned, as the
    kernels take it, else a contiguous copy (an incoming gradient may be
    expanded or strided)."""
    vec = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and not any(s % vec for s in t.stride()[:3]):
        return t
    return t.contiguous()


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its gradient. The forward keeps its
    output and the rows' log-sum-exp (``flash_attention_cuda(..., lse=True)``,
    one launch); the backward is :func:`flash_attention_backward_cuda` (two
    launches: ``flash_attention_bwd_dq``, which forms delta, then
    ``_dkdv``). On the CPU both are the twins, :func:`ref.flash_attention_lse_ref` and
    :func:`ref.flash_attention_backward_ref`. Nothing falls back: a CUDA
    tensor launches or raises."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        if q.device.type == "cpu":
            out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
        else:
            out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **ctx.kw)
        else:
            dq, dk, dv = flash_attention_backward_cuda(q, k, v, out, lse, _kernel_ready(dout),
                                                       **ctx.kw)
        return dq, dk, dv, None


def csr_spmm(x: torch.Tensor, a: CSR) -> torch.Tensor:
    """``a @ x``: out[r] = sum of x[col[k]] over row r of the checked CSR
    ``a``, summed in float32; see :func:`ref.csr_spmm_ref`."""
    if x.device.type == "cpu":
        return ref.csr_spmm_ref(x, a.row_ptr, a.col, a.n_rows)
    return csr_spmm_cuda(x, a)


__all__ = ["bitvec_rank", "k2_lines", "digram_pair_counts", "digram_pair_accum", "digram_select",
           "embedding_bag", "embedding_bag_backward", "sgd_rows", "dot_interaction",
           "dot_interaction_backward",
           "flash_attention", "FlashAttention", "csr_spmm", "build_all", "launch_counts",
           "reset_launch_counts", "ref"]
