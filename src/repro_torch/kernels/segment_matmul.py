"""CSR sparse-dense product: the wrapper of the CUDA kernel
``csrc/segment_matmul.cu``, the CSR it reads and its autograd function.

It replaces the Pallas kernel ``csr_spmm`` of the JAX package (a TPU
kernel) and is the aggregation of every GCN layer
(:mod:`repro_torch.models.gnn`): ``out[r] = sum over the edges e with
receiver r of x[sender e]``. The forward launches it on the CSR sorted by
receiver; the backward launches the same kernel on the transposed CSR,
sorted by sender, so a 2-layer GCN step makes exactly 4 launches (and 4
of ``csr_spmm_combine`` where its CSRs hold rows longer than a chunk).

Where the TPU kernel takes destination blocks padded to one power of two
(``build_csr_blocks``), the port takes a plain CSR: ``row_ptr`` (rows + 1,
int64) and ``col`` (nnz, int32), built on the device by :func:`build_csr`
and checked once where it is made (:class:`CSR`). The CSR also carries
the kernel's work split, :class:`SpmmPlan`, made there from ``row_ptr``
alone: rows of more than ``chunk`` edges are cut into chunks of ``chunk``
edges, whose float32 sums a second launch (``csr_spmm_combine``) adds in
chunk order. The kernel sums compensated (TwoSum), so each row is rounded
once. The plan's twin is :func:`repro_torch.kernels.ref.csr_spmm_segments_ref`,
the kernel's is :func:`repro_torch.kernels.ref.csr_spmm_split_ref`; the
CPU path is the plain twin :func:`repro_torch.kernels.ref.csr_spmm_ref`,
a float32 sum by ``index_add_``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPMM_CHUNK = 256  # edges a chunk of a long row; chip_smoke.py's sweep justifies it


@dataclass(frozen=True)
class SpmmPlan:
    """The kernel's work items for one CSR and chunk size C: first the
    ``n_chunks`` chunks of the ``n_long`` rows longer than C (each row's
    chunks consecutive, C edges each but its last), then the short rows.
    Long rows and short rows both run longest first (a stable sort by
    length, ties by row), so the heaviest items start first.

    long_rows (n_long,) int32 and chunk_ptr (n_long + 1,) int64: long row
    ``long_rows[l]`` owns chunks ``chunk_ptr[l]:chunk_ptr[l + 1]``, which
    cover the edges ``chunk_start[c]:chunk_end[c]`` (int64); short_rows
    (n_rows - n_long,) int32."""

    chunk: int
    n_long: int
    n_chunks: int
    long_rows: torch.Tensor
    chunk_ptr: torch.Tensor
    chunk_start: torch.Tensor
    chunk_end: torch.Tensor
    short_rows: torch.Tensor

    @property
    def n_items(self) -> int:
        return self.n_chunks + self.short_rows.numel()

    def items(self, row_ptr: torch.Tensor):
        """(row, start, end), int64, of every work item in launch order: the
        item walks the edges [start, end) of its row."""
        rows = torch.repeat_interleave(self.long_rows, self.chunk_ptr.diff(),
                                       output_size=self.n_chunks)
        short = self.short_rows.long()
        return (torch.cat([rows.long(), short]),
                torch.cat([self.chunk_start, row_ptr[short]]),
                torch.cat([self.chunk_end, row_ptr[short + 1]]))


def _plan(row_ptr: torch.Tensor, lengths: torch.Tensor, chunk: int, n_long: int,
          n_chunks: int) -> SpmmPlan:
    """The plan of :class:`SpmmPlan` on row_ptr's device, with no host sync:
    ``n_long`` and ``n_chunks`` (the long rows and their chunks) come from
    the caller's one sync."""
    order = torch.argsort(lengths, descending=True, stable=True)
    long_rows = order[:n_long]
    per_row = (lengths[long_rows] + chunk - 1) // chunk
    chunk_ptr = torch.cat([per_row.new_zeros(1), per_row.cumsum(0)])
    first = torch.repeat_interleave(chunk_ptr[:-1], per_row, output_size=n_chunks)
    row_of = torch.repeat_interleave(long_rows, per_row, output_size=n_chunks)
    idx = torch.arange(n_chunks, device=row_ptr.device)
    start = row_ptr[row_of] + (idx - first) * chunk
    end = torch.minimum(start + chunk, row_ptr[row_of + 1])
    return SpmmPlan(chunk, n_long, n_chunks, long_rows.to(torch.int32), chunk_ptr, start, end,
                    order[n_long:].to(torch.int32))


@dataclass(frozen=True)
class CSR:
    """Rows of a sparse 0/1 matrix with ``n_cols`` columns: row r holds the
    columns ``col[row_ptr[r]:row_ptr[r + 1]]``.

    Checked once, where it is made (one host sync): ``row_ptr`` is int64,
    starts at 0, never decreases and ends at ``col.numel()``; ``col`` is
    int32 in [0, n_cols); both are contiguous, 1-D and on one device. The
    kernel reads ``col`` through ``row_ptr`` alone, so only a checked CSR
    reaches it. The same sync sizes the kernel's work split, ``plan`` (an
    :class:`SpmmPlan` with chunks of ``chunk`` edges), made here on the
    CSR's device, so ``dataclasses.replace`` plans the new arrays anew."""

    row_ptr: torch.Tensor  # (n_rows + 1,) int64
    col: torch.Tensor      # (nnz,) int32
    n_cols: int
    chunk: int = SPMM_CHUNK
    plan: SpmmPlan = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        rp, col = self.row_ptr, self.col
        if rp.dtype != torch.int64 or col.dtype != torch.int32:
            raise TypeError(f"a CSR takes int64 row_ptr and int32 col, not {rp.dtype} and "
                            f"{col.dtype}")
        if rp.dim() != 1 or col.dim() != 1 or rp.numel() == 0 or self.n_cols < 0:
            raise ValueError("a CSR takes row_ptr (n_rows + 1,), col (nnz,) and n_cols >= 0")
        if rp.device != col.device or not (rp.is_contiguous() and col.is_contiguous()):
            raise ValueError("a CSR's row_ptr and col are contiguous and on one device")
        if self.chunk < 1 or rp.numel() > 2**31:
            raise ValueError(f"a CSR takes chunk >= 1 and fewer than 2**31 rows, not chunk = "
                             f"{self.chunk} and {rp.numel() - 1} rows")
        lengths = rp[1:] - rp[:-1]
        bad = (rp[0] != 0) | (rp[-1] != col.numel()) | (lengths < 0).any()
        if col.numel():
            bad = bad | (col.min() < 0) | (col.max() >= self.n_cols)
        long = lengths > self.chunk
        n_chunks = torch.where(long, (lengths + self.chunk - 1) // self.chunk, 0).sum()
        bad, n_long, n_chunks = torch.stack([bad.long(), long.sum(), n_chunks]).tolist()
        if bad:
            raise ValueError("a CSR's row_ptr starts at 0, never decreases and ends at nnz, "
                             f"and its col lies in [0, n_cols = {self.n_cols})")
        object.__setattr__(self, "plan", _plan(rp, lengths, self.chunk, n_long, n_chunks))

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
    dtype, each row summed in float32, compensated, as ``a.plan`` splits it
    (in CSR order within a chunk, then chunk by chunk) and rounded once; see
    :func:`repro_torch.kernels.ref.csr_spmm_split_ref`. Any D and nnz are
    accepted; a.n_rows == 0 launches nothing. One launch of ``csr_spmm``,
    and one of ``csr_spmm_combine`` where the plan cut a row."""
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
    p = a.plan
    part = torch.empty((p.n_chunks, d), dtype=torch.float32, device=dev)
    _build.launch("segment_matmul", "csr_spmm", dev, x.data_ptr(), a.row_ptr.data_ptr(),
                  a.col.data_ptr(), out.data_ptr(), part.data_ptr(), p.chunk_start.data_ptr(),
                  p.chunk_end.data_ptr(), p.short_rows.data_ptr(), p.n_chunks, p.n_items, n_x, d,
                  _DTYPES[x.dtype])
    if p.n_long:
        csr_spmm_combine_cuda(part, a, out)
    return out


def csr_spmm_combine_cuda(part: torch.Tensor, a: CSR, out: torch.Tensor) -> torch.Tensor:
    """Write the rows of ``out`` (a.n_rows, D) that ``a.plan`` cut into
    chunks: each the sum, in chunk order, of its chunks' float32 partials
    ``part`` (a.plan.n_chunks, D), compensated and rounded once to out's
    dtype; in place.
    See :func:`repro_torch.kernels.ref.csr_spmm_combine_ref`."""
    p = a.plan
    if part.shape != (p.n_chunks, out.shape[1]) or part.dtype != torch.float32 or not (
            part.is_contiguous() and out.is_contiguous()) or out.shape[0] != a.n_rows:
        raise ValueError(f"csr_spmm_combine_cuda takes contiguous float32 partials "
                         f"({p.n_chunks}, D) and out ({a.n_rows}, D)")
    if out.dtype not in _DTYPES:
        raise TypeError(f"csr_spmm_combine_cuda writes float32 or bfloat16, not {out.dtype}")
    if out.device.type != "cuda" or part.device != out.device or a.row_ptr.device != out.device:
        raise ValueError("csr_spmm_combine_cuda needs part, out and the CSR on one CUDA device")
    _build.launch("segment_matmul", "csr_spmm_combine", out.device, part.data_ptr(),
                  p.long_rows.data_ptr(), p.chunk_ptr.data_ptr(), out.data_ptr(), p.n_long,
                  out.shape[1], _DTYPES[out.dtype])
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

