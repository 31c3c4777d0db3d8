"""Wrappers of the CUDA kernels ``csrc/embedding_bag.cu``: sum or mean of the
table rows of each bag, its gradient by distinct row, and the SGD of those
rows.

``embedding_bag`` replaces the Pallas kernel ``embedding_bag`` of the JAX
package (a TPU kernel) and is DLRM's lookup
(:meth:`repro_torch.models.dlrm.DLRM.fields`): one launch per batch over B *
26 single-row bags of the concatenated tables. Its plain twin is
:func:`repro_torch.kernels.ref.embedding_bag_ref`.

DLRM training adds two more, whose twins are
:func:`~repro_torch.kernels.ref.embedding_bag_backward_ref` and
:func:`~repro_torch.kernels.ref.sgd_rows_ref`:
``embedding_bag_backward`` (one launch after the ids' sort) sums the
gradient of each distinct row of a batch into a compact float32 buffer,
and ``sgd_rows`` applies the table's SGD to those rows of the float32
master and writes their rounding into the table. The master lives in host
memory registered with the card (:func:`register_host`), which
``sgd_rows`` reads and writes over PCIe.
"""
from __future__ import annotations

import ctypes
import mmap
import time
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bag_runs

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
_COMBINERS = {"sum": 0, "mean": 1}


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       combiner: str = "sum") -> torch.Tensor:
    """table (V, D) float32 or bfloat16, indices (B, L) int32 or int64 with
    values in [-1, V) (negative = padding), both contiguous on one CUDA
    device. Returns (B, D) in the table's dtype, summed in float32. Any B
    and D are accepted; B == 0 launches nothing."""
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag_cuda takes a float32 or bfloat16 table, not {table.dtype}")
    if indices.dtype not in _INDEX_DTYPES:
        raise TypeError(f"embedding_bag_cuda takes int32 or int64 indices, not {indices.dtype}")
    if combiner not in _COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("embedding_bag_cuda takes a (V, D) table and (B, L) indices")
    dev = table.device
    if dev.type != "cuda" or indices.device != dev:
        raise ValueError("embedding_bag_cuda needs both tensors on one CUDA device")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("embedding_bag_cuda takes contiguous tensors")
    (n_rows, d), (n_bags, bag_len) = table.shape, indices.shape
    out = torch.empty((n_bags, d), dtype=table.dtype, device=dev)
    if n_bags == 0 or d == 0:
        return out
    _build.launch("embedding_bag", "embedding_bag", dev, table.data_ptr(),
                  indices.data_ptr(), out.data_ptr(), n_bags, n_rows, bag_len, d,
                  _DTYPES[table.dtype], _INDEX_DTYPES[indices.dtype], _COMBINERS[combiner])
    return out


BACKWARD_CHUNK = 256  # sorted positions a chunk, both backward kernels (CHUNK in the source)
BACKWARD_STAGES = 4   # stages of the one-pass kernel's ring of rows (EBB_STAGES)
BACKWARD_RING = 32    # rows of the ring a warp: BACKWARD_STAGES stages of EBB_RS = 8
BACKWARD_RINGS = (16, 32, 64)  # the source's rings (16 and 64: bfloat16, 16-byte pieces)
BACKWARD_MAX_CHUNK = 1024  # the largest chunk every instance fits in a block (EBB_MAX_CHUNK)
# the one-pass kernel's ways of gathering a slab of a row (ebb_path in the source)
BACKWARD_PATHS = {"scalar": 0, "16-byte": 1, "8-byte": 2}


@dataclass(frozen=True)
class BackwardPlan:
    """A launch of the one-pass ``embedding_bag_backward``: each warp takes
    ``chunk`` sorted positions at a time (a multiple of 32, at most
    BACKWARD_MAX_CHUNK)
    and gathers their rows through a ring of ``ring`` rows, BACKWARD_STAGES
    stages of ``ring / BACKWARD_STAGES``. Every path has a ring of
    BACKWARD_RING; bfloat16 rows in 16-byte pieces also 16 and 64, for the
    sweep (the source's instances)."""
    chunk: int = BACKWARD_CHUNK
    ring: int = BACKWARD_RING

    def __post_init__(self):
        if not (32 <= self.chunk <= BACKWARD_MAX_CHUNK and self.chunk % 32 == 0):
            raise ValueError(f"a backward chunk is a multiple of 32 up to {BACKWARD_MAX_CHUNK}, "
                             f"not {self.chunk}")
        if self.ring not in BACKWARD_RINGS:
            raise ValueError(f"a backward ring holds one of {BACKWARD_RINGS} rows, not {self.ring}")

    @property
    def stage_rows(self) -> int:
        return self.ring // BACKWARD_STAGES


def backward_path(grad_out: torch.Tensor) -> str:
    """How the one-pass kernel gathers ``grad_out``'s rows (its ebb_path):
    16-byte pieces where D and the pointer allow them, 8-byte pieces of a
    bfloat16 row of D % 4 == 0, scalar pieces otherwise."""
    d, es = grad_out.shape[1], grad_out.element_size()
    if d % 4 == 0 and (d * es) % 16 == 0 and grad_out.data_ptr() % 16 == 0:
        return "16-byte"
    if grad_out.dtype == torch.bfloat16 and d % 4 == 0 and grad_out.data_ptr() % 8 == 0:
        return "8-byte"
    return "scalar"


def backward_occupancy(plan: BackwardPlan | None = None, grad_dtype=torch.bfloat16,
                       index_dtype=torch.int32, path: str = "16-byte", *,
                       two_pass: bool = False) -> dict:
    """What the card fits of an instance of the backward, launching nothing:
    the one-pass kernel at ``plan`` on ``path`` (BACKWARD_PATHS), or, with
    ``two_pass``, the two-pass kernel (vectorised unless ``path`` is
    "scalar"): its blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and spilled bytes a thread, shared bytes and threads a block,
    and warps an SM."""
    plan = plan or BackwardPlan()
    fn = _build.load("embedding_bag").embedding_bag_backward_occupancy
    fn.argtypes = [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 5)()
    vec = BACKWARD_PATHS[path] if not two_pass else int(path != "scalar")
    err = fn(int(two_pass), _DTYPES[grad_dtype], _INDEX_DTYPES[index_dtype], vec, plan.chunk,
             plan.stage_rows, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"embedding_bag_backward_occupancy failed with error {err}")
    return {"blocks_an_sm": out[0], "registers": out[1], "spill_bytes": out[2],
            "smem_bytes": out[3], "threads": out[4], "warps_an_sm": out[0] * out[4] // 32}


def _check_backward(indices: torch.Tensor, grad_out: torch.Tensor, combiner: str) -> None:
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag_backward_cuda takes float32 or bfloat16 gradients, "
                        f"not {grad_out.dtype}")
    if indices.dtype not in _INDEX_DTYPES:
        raise TypeError(f"embedding_bag_backward_cuda takes int32 or int64 indices, "
                        f"not {indices.dtype}")
    if combiner not in _COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
    if indices.dim() != 2 or grad_out.dim() != 2 or grad_out.shape[0] != indices.shape[0]:
        raise ValueError("embedding_bag_backward_cuda takes (B, L) indices and (B, D) gradients")
    if grad_out.device.type != "cuda" or indices.device != grad_out.device:
        raise ValueError("embedding_bag_backward_cuda needs both tensors on one CUDA device")


def _denom(indices: torch.Tensor, combiner: str) -> torch.Tensor | None:
    return (indices >= 0).sum(dim=1).clamp(min=1).float() if combiner == "mean" else None


def embedding_bag_backward_cuda(indices: torch.Tensor, grad_out: torch.Tensor,
                                combiner: str = "sum", n_rows: int | None = None, *,
                                plan: BackwardPlan | None = None,
                                two_pass: bool = False) -> tuple:
    """The gradient of :func:`embedding_bag_cuda` with respect to the table,
    by distinct row: indices (B, L) int32 or int64 (negative = padding),
    grad_out (B, D) float32 or bfloat16, on one CUDA device. Returns (rows,
    grads, n_unique): rows (B * L,) int64 and grads (B * L, D) float32, whose
    first n_unique slots hold the distinct valid ids in ascending order and
    their summed gradients (slots past it are not written), and n_unique a
    0-dim int64 tensor on the device. Sized from B * L, so nothing is read
    back; an id >= n_rows stops the kernel with an error. The ids are sorted
    (``torch.sort``, stable), then one launch of the one-pass kernel
    (:func:`embedding_bag_backward_sorted_cuda`, at ``plan``). With
    ``two_pass``, the first design instead, to be timed beside it:
    :func:`embedding_bag_backward_pieces_cuda`, then
    :func:`embedding_bag_backward_combine_cuda`."""
    if two_pass and plan is not None:
        raise ValueError("the two-pass backward takes no plan")
    _check_backward(indices, grad_out, combiner)
    if two_pass:
        rows, grads, n_unique, pieces = embedding_bag_backward_pieces_cuda(indices, grad_out,
                                                                           combiner, n_rows)
        embedding_bag_backward_combine_cuda(*pieces, grads)
        return rows, grads, n_unique
    ids, perm = torch.sort(indices.reshape(-1), stable=True)
    return embedding_bag_backward_sorted_cuda(ids, perm, grad_out, indices.shape[1],
                                              _denom(indices, combiner), n_rows, plan)


def embedding_bag_backward_sorted_cuda(ids: torch.Tensor, perm: torch.Tensor,
                                       grad_out: torch.Tensor, bag_len: int,
                                       denom: torch.Tensor | None = None,
                                       n_rows: int | None = None,
                                       plan: BackwardPlan | None = None) -> tuple:
    """The one-pass kernel (``embedding_bag_backward``) on ids already
    sorted: ids (n,) int32 or int64 ascending, perm (n,) int64 each sorted
    id's position in the flattened (B, L) indices (``torch.sort(...,
    stable=True)``'s pair), both contiguous and 16-byte aligned; grad_out (B,
    D) with B * bag_len == n; denom (B,) float32 for the mean, None for the
    sum. Returns :func:`embedding_bag_backward_cuda`'s (rows, grads,
    n_unique). The kernel finds the runs' heads and slots itself; its
    scratch (the scan, the cut runs' counts and pieces) is allocated here,
    and the part it reads before writing is zeroed: one fill."""
    plan = plan or BackwardPlan()
    if ids.dim() != 1 or ids.dtype not in _INDEX_DTYPES or perm.dtype != torch.int64 \
            or perm.shape != ids.shape:
        raise ValueError("embedding_bag_backward_sorted_cuda takes ids (n,) int32 or int64 and "
                         "perm (n,) int64")
    if grad_out.dtype not in _DTYPES or grad_out.dim() != 2 \
            or grad_out.shape[0] * bag_len != ids.numel():
        raise ValueError("embedding_bag_backward_sorted_cuda takes grad_out (B, D) float32 or "
                         "bfloat16 with B * bag_len == n")
    dev = grad_out.device
    if dev.type != "cuda" or ids.device != dev or perm.device != dev or (
            denom is not None and denom.device != dev):
        raise ValueError("embedding_bag_backward_sorted_cuda needs its tensors on one CUDA "
                         "device")
    if denom is not None and (denom.dtype != torch.float32 or denom.shape != grad_out.shape[:1]
                              or not denom.is_contiguous()):
        raise ValueError("embedding_bag_backward_sorted_cuda takes denom (B,) float32")
    if not (ids.is_contiguous() and perm.is_contiguous()) or ids.data_ptr() % 16 \
            or perm.data_ptr() % 16:
        raise ValueError("embedding_bag_backward_sorted_cuda takes contiguous, 16-byte aligned "
                         "ids and perm")
    n, d = ids.numel(), grad_out.shape[1]
    if n >= 2**32:
        raise ValueError(f"embedding_bag_backward_sorted_cuda takes fewer than 2^32 ids, not {n}")
    grad_out = grad_out.contiguous()
    n_chunks = -(-n // plan.chunk)
    rows = torch.empty((n,), dtype=torch.int64, device=dev)
    grads = torch.empty((n, d), dtype=torch.float32, device=dev)
    part = torch.empty((2, n_chunks, d), dtype=torch.float32, device=dev)
    work = torch.empty((2 + 3 * n_chunks,), dtype=torch.int64, device=dev)
    work[:2 + 2 * n_chunks].zero_()
    if n == 0:
        return rows, grads, work[1]
    limit = n_rows if n_rows is not None else 2**62
    _build.launch("embedding_bag", "embedding_bag_backward", dev, ids.data_ptr(),
                  perm.data_ptr(), grad_out.data_ptr(),
                  denom.data_ptr() if denom is not None else None, rows.data_ptr(),
                  grads.data_ptr(), part.data_ptr(), work.data_ptr(), n, limit, bag_len, d,
                  _DTYPES[grad_out.dtype], _INDEX_DTYPES[ids.dtype], plan.chunk,
                  plan.stage_rows)
    return rows, grads, work[1]


def embedding_bag_backward_pieces_cuda(indices: torch.Tensor, grad_out: torch.Tensor,
                                       combiner: str = "sum",
                                       n_rows: int | None = None) -> tuple:
    """The two-pass backward's first launch (``embedding_bag_backward_two_pass``):
    (rows, grads, n_unique, pieces), every run that lies inside one chunk
    of ``BACKWARD_CHUNK`` sorted positions already summed into its slot, and
    ``pieces`` = (part_first, part_last, last_slot, first_kind), the sums of
    the runs cut by chunk boundaries, for the combine (``csrc`` explains
    the layout; :func:`repro_torch.kernels.ref.embedding_bag_backward_combine_ref`
    is their plain reading). The slots come from :func:`ref.bag_runs`."""
    _check_backward(indices, grad_out, combiner)
    dev = grad_out.device
    grad_out = grad_out.contiguous()
    (n_bags, bag_len), d = indices.shape, grad_out.shape[1]
    n = n_bags * bag_len
    ids, perm, slot, n_unique = bag_runs(indices)
    rows = torch.empty((n,), dtype=torch.int64, device=dev)
    grads = torch.empty((n, d), dtype=torch.float32, device=dev)
    n_chunks = -(-n // BACKWARD_CHUNK)
    pieces = (torch.empty((n_chunks, d), dtype=torch.float32, device=dev),
              torch.empty((n_chunks, d), dtype=torch.float32, device=dev),
              torch.full((n_chunks,), -1, dtype=torch.int64, device=dev),
              torch.zeros((n_chunks,), dtype=torch.int32, device=dev))
    if n == 0 or d == 0:
        return rows, grads, n_unique, pieces
    limit = n_rows if n_rows is not None else 2**62
    denom = _denom(indices, combiner)
    _build.launch("embedding_bag", "embedding_bag_backward_two_pass", dev, ids.data_ptr(),
                  perm.data_ptr(), slot.data_ptr(), grad_out.data_ptr(),
                  denom.data_ptr() if denom is not None else None, rows.data_ptr(), grads.data_ptr(), *(p.data_ptr() for p in pieces), n, limit,
                  bag_len, d, _DTYPES[grad_out.dtype], _INDEX_DTYPES[ids.dtype])
    return rows, grads, n_unique, pieces


def embedding_bag_backward_combine_cuda(part_first: torch.Tensor, part_last: torch.Tensor,
                                        last_slot: torch.Tensor, first_kind: torch.Tensor,
                                        grads: torch.Tensor) -> None:
    """The two-pass backward's second launch (``embedding_bag_backward_combine``):
    in place on ``grads``, each run cut by chunk boundaries gets the sum of
    its pieces, in chunk order."""
    n_chunks, d = part_first.shape
    if grads.dim() != 2 or grads.shape[1] != d or part_last.shape != part_first.shape:
        raise ValueError("embedding_bag_backward_combine_cuda: pieces and grads disagree")
    if n_chunks == 0 or d == 0:
        return
    _build.launch("embedding_bag", "embedding_bag_backward_combine", grads.device,
                  part_first.data_ptr(), part_last.data_ptr(), last_slot.data_ptr(),
                  first_kind.data_ptr(), grads.data_ptr(), n_chunks, d)


HUGE_PAGE = 2 << 20  # bytes of a transparent huge page on x86-64
BACKINGS = ("huge", "plain")

# host address -> bytes of each registration of host memory
_registered: dict[int, int] = {}


def host_empty(shape: tuple, backing: str = "huge") -> torch.Tensor:
    """An uninitialised contiguous float32 CPU tensor of ``shape``, for memory
    the card reads and writes over PCIe (:func:`register_host`). ``"huge"``:
    anonymous memory aligned to HUGE_PAGE and advised ``MADV_HUGEPAGE``
    before anything touches it, so that the kernel backs it with 2 MB pages
    where its transparent-huge-page mode allows (``launch/host_probe.py``
    reads what it got); ``"plain"``: ``torch.empty``. The tensor keeps its
    mapping alive."""
    if backing not in BACKINGS:
        raise ValueError(f"backing must be one of {BACKINGS}, not {backing!r}")
    numel = 1
    for n in shape:
        numel *= n
    if backing == "plain" or numel == 0:
        return torch.empty(shape, dtype=torch.float32)
    nbytes = numel * 4
    buf = mmap.mmap(-1, nbytes + HUGE_PAGE, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    base = torch.frombuffer(buf, dtype=torch.uint8, count=1).data_ptr()
    lead = -base % HUGE_PAGE
    buf.madvise(mmap.MADV_HUGEPAGE, lead, nbytes)
    return torch.frombuffer(buf, dtype=torch.float32, offset=lead, count=numel).view(shape)


def register_host(t: torch.Tensor) -> float:
    """Pin the memory of the contiguous CPU tensor ``t`` for the card with
    ``cudaHostRegister`` (default flags: under unified addressing, pinned
    and mapped, its device address its host address), so that
    :func:`sgd_rows_cuda` can update it in place; returns the seconds the
    registration took. Undo it with :func:`unregister_host` before ``t``'s
    memory is freed."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("register_host takes a contiguous CPU tensor")
    nbytes = t.numel() * t.element_size()
    t0 = time.perf_counter()
    err = int(torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes, 0))
    if err != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed with CUDA error {err}")
    _registered[t.data_ptr()] = nbytes
    return time.perf_counter() - t0


def unregister_host(t: torch.Tensor) -> None:
    """Release a registration made by :func:`register_host`."""
    if _registered.pop(t.data_ptr(), None) is not None:
        err = int(torch.cuda.cudart().cudaHostUnregister(t.data_ptr()))
        if err != 0:
            raise RuntimeError(f"cudaHostUnregister failed with CUDA error {err}")


def mapped_ptr(t: torch.Tensor) -> int:
    """The address the card reads a CPU tensor at, which must lie inside
    memory registered by :func:`register_host`; raises if it does not."""
    start, end = t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()
    for host, nbytes in _registered.items():
        if host <= start and end <= host + nbytes:
            return start
    raise ValueError("the master is host memory that is not registered with the card "
                     "(kernels.embedding_bag.register_host)")


SGD_THREADS = 256  # threads a block of sgd_rows: 8 warps
SGD_ROWS_PER_WARP = (1, 2, 4, 8)  # the sweep's instances (bfloat16 table, D % 4 == 0)
SGD_MODES = {"update": 0, "read": 1, "write": 2}  # SGD_UPDATE ... in the source
SGD_R = 4  # rows a warp of the update on every table (SGD_R in the source)
# blocks an SM each count of rows a warp is compiled to fit (sgd_blocks_an_sm
# in the source; sgd_rows_occupancy reads it back on the card)
SGD_BLOCKS_AN_SM = {1: 8, 2: 6, 4: 4, 8: 2}


@dataclass(frozen=True)
class SgdPlan:
    """A launch of ``sgd_rows``: ``blocks`` blocks of SGD_THREADS threads;
    warp w of the grid takes the groups w, w + warps, ... of
    ``rows_per_warp`` consecutive slots below n_unique; ``mode`` the update
    or one of the sweep's passes (SGD_MODES)."""
    rows_per_warp: int
    blocks: int
    mode: str = "update"

    def strides(self, n_unique: int) -> int:
        """The most groups one warp of the grid takes for ``n_unique`` live
        slots: 1 where the grid has a warp for every group."""
        groups = -(-max(n_unique, 0) // self.rows_per_warp)
        return -(-groups // (self.blocks * (SGD_THREADS // 32)))


def sgd_rows_plan(cap: int, rows_per_warp: int = SGD_R, blocks: int | None = None,
                  mode: str = "update") -> SgdPlan:
    """The launch for ``cap`` slots: with ``blocks``, a persistent grid of
    that many blocks (fewer where ``cap`` needs fewer), which walk only the
    slots below n_unique; without, one warp a group of ``rows_per_warp``
    slots for every group up to ``cap``, live or not (a warp past
    n_unique, read on the card, exits at once)."""
    if rows_per_warp not in SGD_ROWS_PER_WARP or mode not in SGD_MODES:
        raise ValueError(f"sgd_rows_plan: rows_per_warp in {SGD_ROWS_PER_WARP}, mode in "
                         f"{tuple(SGD_MODES)}")
    full = max(1, -(-cap // (rows_per_warp * (SGD_THREADS // 32))))
    return SgdPlan(rows_per_warp, full if blocks is None else max(1, min(full, blocks)), mode)


def sgd_rows_occupancy(rows_per_warp: int, mode: str = "update") -> dict:
    """What the card fits of the sweep's instance of ``sgd_rows`` (a
    bfloat16 table, D % 4 == 0): its blocks of SGD_THREADS an SM, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them, its
    registers a thread and the rows in flight an SM. Launches nothing."""
    fn = _build.load("embedding_bag").sgd_rows_occupancy
    fn.argtypes, fn.restype = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int64 * 2)()
    err = fn(rows_per_warp, SGD_MODES[mode], ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"sgd_rows_occupancy failed with error {err}")
    return {"blocks_an_sm": out[0], "registers": out[1],
            "rows_in_flight_an_sm": out[0] * SGD_THREADS // 32 * rows_per_warp}


def sgd_rows_cuda(master: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                  grads: torch.Tensor, n_unique: torch.Tensor, lr: torch.Tensor,
                  clip: torch.Tensor, plan: SgdPlan | None = None) -> None:
    """In place, for each slot s < n_unique: ``master[rows[s]] -= lr * (clip *
    grads[s])`` in float32, then ``table[rows[s]] = master[rows[s]]`` rounded
    to the table's type. master (V, D) float32, in host memory registered
    with :func:`register_host`; table (V, D) float32
    or bfloat16 on a CUDA device; rows (cap,) int64, grads (cap, D) float32,
    n_unique 0-dim int64, lr and clip 0-dim float32, all on that device
    (:func:`embedding_bag_backward_cuda`'s layout). A row outside [0, V)
    stops the kernel with an error. The launch is SGD_R rows a warp on a
    persistent grid of SGD_BLOCKS_AN_SM[SGD_R] blocks on each SM of the
    card; ``plan`` (:func:`sgd_rows_plan`) forces another, for
    ``launch/sgd_sweep.py``."""
    if table.dtype not in _DTYPES or master.dtype != torch.float32:
        raise TypeError("sgd_rows_cuda takes a float32 master and a float32 or bfloat16 table")
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("sgd_rows_cuda needs the table on a CUDA device")
    if master.shape != table.shape or table.dim() != 2:
        raise ValueError(f"master {tuple(master.shape)} and table {tuple(table.shape)} "
                         "must be one (V, D) shape")
    cap, d = grads.shape if grads.dim() == 2 else (-1, -1)
    if (rows.shape != (cap,) or d != table.shape[1] or rows.dtype != torch.int64
            or grads.dtype != torch.float32 or n_unique.shape != ()
            or n_unique.dtype != torch.int64 or lr.shape != () or clip.shape != ()
            or lr.dtype != torch.float32 or clip.dtype != torch.float32):
        raise ValueError("sgd_rows_cuda takes rows (cap,) int64, grads (cap, D) float32, "
                         "n_unique int64 and lr, clip float32 scalars")
    if any(t.device != dev for t in (rows, grads, n_unique, lr, clip)):
        raise ValueError("sgd_rows_cuda needs rows, grads, n_unique, lr and clip on the "
                         "table's device")
    if not (master.is_contiguous() and table.is_contiguous() and rows.is_contiguous()
            and grads.is_contiguous()):
        raise ValueError("sgd_rows_cuda takes contiguous tensors")
    if master.device.type != "cpu":
        raise ValueError("sgd_rows_cuda needs the master in registered host memory")
    master_ptr = mapped_ptr(master)
    if cap == 0:
        return
    if plan is None:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = sgd_rows_plan(cap, SGD_R, n_sms * SGD_BLOCKS_AN_SM[SGD_R])
    _build.launch("embedding_bag", "sgd_rows", dev, master_ptr, table.data_ptr(),
                  rows.data_ptr(), grads.data_ptr(), n_unique.data_ptr(), lr.data_ptr(),
                  clip.data_ptr(), cap, table.shape[0], d, _DTYPES[table.dtype],
                  plan.rows_per_warp, plan.blocks, SGD_MODES[plan.mode])
