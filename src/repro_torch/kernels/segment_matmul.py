"""CSR sparse-dense product: the wrapper of the CUDA kernel
``csrc/segment_matmul.cu``, the CSR it reads and its autograd function.

It replaces the Pallas kernel ``csr_spmm`` of the JAX package (a TPU
kernel) and is the aggregation of every GCN layer
(:mod:`repro_torch.models.gnn`): ``out[r] = sum over the edges e with
receiver r of x[sender e]``. The forward launches it on the CSR sorted by
receiver; the backward launches the same kernel on the transposed CSR,
sorted by sender, so a 2-layer GCN step makes exactly 4 launches. Its plain
twin is :func:`repro_torch.kernels.ref.csr_spmm_ref`.

Where the TPU kernel takes destination blocks padded to one power of two
(``build_csr_blocks``), the port takes a plain CSR: ``row_ptr`` (rows + 1,
int64) and ``col`` (nnz, int32), built on the device by :func:`build_csr`
and checked once where it is made (:class:`CSR`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class CSR:
    """Rows of a sparse 0/1 matrix with ``n_cols`` columns: row r holds the
    columns ``col[row_ptr[r]:row_ptr[r + 1]]``.

    Checked once, where it is made (one host sync): ``row_ptr`` is int64,
    starts at 0, never decreases and ends at ``col.numel()``; ``col`` is
    int32 in [0, n_cols); both are contiguous, 1-D and on one device. The
    kernel reads ``col`` through ``row_ptr`` alone, so only a checked CSR
    reaches it."""

    row_ptr: torch.Tensor  # (n_rows + 1,) int64
    col: torch.Tensor      # (nnz,) int32
    n_cols: int

    def __post_init__(self):
        rp, col = self.row_ptr, self.col
        if rp.dtype != torch.int64 or col.dtype != torch.int32:
            raise TypeError(f"a CSR takes int64 row_ptr and int32 col, not {rp.dtype} and "
                            f"{col.dtype}")
        if rp.dim() != 1 or col.dim() != 1 or rp.numel() == 0 or self.n_cols < 0:
            raise ValueError("a CSR takes row_ptr (n_rows + 1,), col (nnz,) and n_cols >= 0")
        if rp.device != col.device or not (rp.is_contiguous() and col.is_contiguous()):
            raise ValueError("a CSR's row_ptr and col are contiguous and on one device")
        bad = (rp[0] != 0) | (rp[-1] != col.numel()) | (rp[1:] < rp[:-1]).any()
        if col.numel():
            bad = bad | (col.min() < 0) | (col.max() >= self.n_cols)
        if bool(bad):
            raise ValueError("a CSR's row_ptr starts at 0, never decreases and ends at nnz, "
                             f"and its col lies in [0, n_cols = {self.n_cols})")

    @property
    def n_rows(self) -> int:
        return self.row_ptr.numel() - 1

    def row_lengths(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]


def _sorted_csr(keys: torch.Tensor, vals: torch.Tensor, n_rows: int, n_cols: int) -> CSR:
    """The CSR with one entry ``vals[e]`` in row ``keys[e]`` per edge, rows
    in a stable order (ties keep the edges' order)."""
    keys, order = torch.sort(keys, stable=True)
    counts = torch.bincount(keys, minlength=n_rows)
    row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CSR(row_ptr, vals[order].to(torch.int32), n_cols)


def build_csr(senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
              n_src: int) -> tuple[CSR, CSR]:
    """(forward, transposed) CSRs of the edges (sender -> receiver), on the
    edges' device.

    The forward CSR has ``n_nodes`` rows, one per receiver, whose columns
    name senders in [0, n_src); the transposed one has ``n_src`` rows, one
    per sender, whose columns name receivers. Both keep the edges' order
    within a row (a stable sort, as ``build_csr_blocks``). An edge is kept
    only if its sender is >= 0 (the reference's padding, which its
    ``_gather`` zeroes) and its receiver lies in [0, n_nodes) (what
    ``segment_sum`` drops). A sender >= n_src raises.
    """
    if senders.shape != receivers.shape or senders.dim() != 1:
        raise ValueError("build_csr takes senders and receivers of one (E,) shape")
    s, r = senders.to(torch.int64), receivers.to(torch.int64)
    if s.numel() and int(s.max()) >= n_src:
        raise ValueError(f"a sender is >= n_src = {n_src}")
    keep = (s >= 0) & (r >= 0) & (r < n_nodes)
    s, r = s[keep], r[keep]
    return _sorted_csr(r, s, n_nodes, n_src), _sorted_csr(s, r, n_src, n_nodes)


def csr_spmm_cuda(x: torch.Tensor, a: CSR) -> torch.Tensor:
    """``a @ x``: x (a.n_cols, D) float32 or bfloat16, contiguous on the CUDA
    device that holds the checked CSR ``a``. Returns (a.n_rows, D) in x's
    dtype, each row summed in float32 in CSR order; see
    :func:`repro_torch.kernels.ref.csr_spmm_ref`. Any D and nnz are
    accepted; a.n_rows == 0 launches nothing."""
    if not isinstance(a, CSR):
        raise TypeError(f"csr_spmm_cuda takes a CSR, not {type(a).__name__}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"csr_spmm_cuda takes float32 or bfloat16 x, not {x.dtype}")
    if x.dim() != 2 or x.shape[0] != a.n_cols:
        raise ValueError(f"csr_spmm_cuda takes x ({a.n_cols}, D), one row per column of the "
                         f"CSR, not {tuple(x.shape)}")
    dev = x.device
    if dev.type != "cuda" or a.row_ptr.device != dev:
        raise ValueError("csr_spmm_cuda needs x and the CSR on one CUDA device")
    if not x.is_contiguous():
        raise ValueError("csr_spmm_cuda takes a contiguous x")
    n_x, d = x.shape
    n_out = a.n_rows
    out = torch.empty((n_out, d), dtype=x.dtype, device=dev)
    if n_out == 0 or d == 0:
        return out
    _build.launch("segment_matmul", "csr_spmm", dev, x.data_ptr(), a.row_ptr.data_ptr(),
                  a.col.data_ptr(), out.data_ptr(), n_out, n_x, d, _DTYPES[x.dtype])
    return out


class CSRSpMM(torch.autograd.Function):
    """``out = A x`` with A the 0/1 matrix of ``fwd``; its gradient is
    ``A^T g``, the same product on ``bwd``, the transposed CSR. Both go
    through :func:`repro_torch.kernels.ops.csr_spmm`: the kernel on the
    card, the twin on the CPU. Only x can need a gradient, so backward
    runs only when it does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, fwd: CSR, bwd: CSR) -> torch.Tensor:
        from repro_torch.kernels import ops

        ctx.bwd = bwd
        return ops.csr_spmm(x.contiguous(), fwd)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from repro_torch.kernels import ops

        bwd = ctx.bwd
        return ops.csr_spmm(g.contiguous(), bwd), None, None

