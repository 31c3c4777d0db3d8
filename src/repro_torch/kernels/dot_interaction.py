"""Wrapper of the CUDA kernels ``csrc/dot_interaction.cu``: the strictly lower
triangle of X Xᵀ per sample, in float32, and its gradient.

It replaces the Pallas kernel ``dot_interaction`` of the JAX package (a TPU
kernel) and is DLRM's feature interaction
(:meth:`repro_torch.models.dlrm.DLRM.forward`), one launch per batch. Unlike
the Pallas kernel, which casts its float32 sums back to the input's type,
it returns float32, as DLRM's ``_interact`` does. Its plain twin is
:func:`repro_torch.kernels.ref.dot_interaction_ref`.

A call launches one of two kernels, chosen by the input's type and shape
(:func:`uses_tensor_cores`) and counted under its own name in
``launch_counts``: ``dot_interaction``, bfloat16 with D % 16 == 0 on the
tensor cores (DLRM's fields), whose tiling twin is
:func:`repro_torch.kernels.ref.dot_interaction_tc_ref`; and
``dot_interaction_simt``, float32 FMAs, for the rest. The tensor-core kernel
walks groups of samples through a ring in shared memory with persistent
blocks, planned here by :func:`tc_plan`.

The gradient (its twin
:func:`repro_torch.kernels.ref.dot_interaction_backward_ref`) is two more
kernels of the same source, chosen by the same rule
(:func:`backward_uses_tensor_cores`, which also asks for an aligned dz):
``dot_interaction_backward`` on the tensor cores, dz split exactly into
three bfloat16 terms, planned by :func:`tc_backward_plan`, whose tiling twin
is :func:`repro_torch.kernels.ref.dot_interaction_backward_tc_ref`; and
``dot_interaction_backward_simt`` for the rest. DLRM's training forward
reaches the forward and the gradient through :class:`DotInteraction`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_SAMPLES = 8        # most samples a group: one a warp, 8 warps a block
TC_STAGES = 3         # ring slots: two groups in flight while one is multiplied
SMEM_CAP = 232_448    # dynamic shared memory one block may use (sm_90)
SM_SMEM = 233_472     # shared memory of one SM; each resident block also takes 1 KB
SM_THREADS = 2_048    # resident threads of one SM
_sm_counts: dict[int, int] = {}


@dataclass(frozen=True)
class TcPlan:
    """A launch of a tensor-core kernel (the interaction or its gradient):
    groups of ``samples`` consecutive samples (one ring slot each), a ring
    of ``stages`` slots, ``blocks`` persistent blocks of ``threads``
    threads, block k taking groups k, k + blocks, ...; ``smem`` bytes of
    shared memory a block."""
    samples: int
    stages: int
    blocks: int
    threads: int
    smem: int
    groups: int


def tc_smem(f: int, d: int, samples: int, stages: int) -> int:
    """Shared memory of a tensor-core block: the output staging (samples *
    P floats and a lead of up to 3, in 16-byte units), then `stages` slots of
    samples * F rows and 16 * ceil(F / 16) - F tail rows of 2 D + 16 bytes.
    The kernel's launch computes the same (``tc_staging_bytes``,
    ``tc_slot_bytes``)."""
    p = f * (f - 1) // 2
    staging = (samples * p + 6) // 4 * 16
    return staging + stages * _rows_bytes(f, d, samples)


def _rows_bytes(f: int, d: int, samples: int) -> int:
    return (samples * f + -(-f // 16) * 16 - f) * (2 * d + 16)


def tc_backward_smem(f: int, d: int, samples: int, stages: int) -> int:
    """Shared memory of a tensor-core backward block: `stages` slots, each
    the group's rows as in :func:`tc_smem` (dX overwrites them in place)
    and its dz span (samples * P floats after a lead of up to 3, in 16-byte
    units). The kernel's launch computes the same (``bwd_slot_bytes``)."""
    p = f * (f - 1) // 2
    return stages * (_rows_bytes(f, d, samples) + (samples * p + 6) // 4 * 16)


def _plan(b: int, smem_of, n_sm: int, samples: int | None, stages: int | None,
          what: str) -> TcPlan:
    want = samples or max(1, min(TC_SAMPLES, b // n_sm))
    sizes = [want] if samples else range(want, 0, -1)
    for st in [stages] if stages else range(TC_STAGES, 0, -1):
        for spg in sizes:
            smem = smem_of(spg, st)
            if smem <= SMEM_CAP:
                threads = 32 * min(spg, TC_SAMPLES)
                per_sm = max(1, min(SM_SMEM // (smem + 1024), SM_THREADS // threads))
                groups = -(-b // spg)
                return TcPlan(spg, st, min(groups, n_sm * per_sm), threads, smem, groups)
    raise ValueError(f"{what} does not fit in a block's shared memory")


def tc_plan(b: int, f: int, d: int, n_sm: int = 132, *, samples: int | None = None,
            stages: int | None = None) -> TcPlan:
    """The tensor-core launch for a (b, f, d) batch on `n_sm` SMs.
    Samples a group: b // n_sm, between 1 and TC_SAMPLES, so that a small
    batch still gives every SM a group; then the deepest ring (up to
    TC_STAGES), and the most samples, that fit in a block's shared memory.
    Blocks: as many as are resident at once on the card, at most one a
    group. `samples` and `stages` force either (a sweep's knobs). Raises
    ValueError where one sample's rows do not fit."""
    return _plan(b, lambda spg, st: tc_smem(f, d, spg, st), n_sm, samples, stages,
                 f"dot_interaction: one sample of {f} rows of {d} bfloat16 values")


def tc_backward_plan(b: int, f: int, d: int, n_sm: int = 132, *, samples: int | None = None,
                     stages: int | None = None) -> TcPlan:
    """The tensor-core backward's launch for a (b, f, d) batch, chosen as
    :func:`tc_plan` chooses, with :func:`tc_backward_smem`'s slots. Raises
    ValueError where one sample's rows and dz do not fit."""
    return _plan(b, lambda spg, st: tc_backward_smem(f, d, spg, st), n_sm, samples, stages,
                 f"dot_interaction_backward: one sample of {f} rows of {d} bfloat16 values "
                 "and its dz")


def uses_tensor_cores(x: torch.Tensor) -> bool:
    """Whether :func:`dot_interaction_cuda` sends x to the tensor-core kernel:
    bfloat16, D a positive multiple of 16, and 16-byte aligned (each
    cp.async moves 16 bytes)."""
    d = x.shape[-1]
    return (x.dtype == torch.bfloat16 and d > 0 and d % 16 == 0
            and x.data_ptr() % 16 == 0)


def backward_uses_tensor_cores(x: torch.Tensor, dz: torch.Tensor) -> bool:
    """Whether :func:`dot_interaction_backward_cuda` sends (x, dz) to the
    tensor-core kernel: x as :func:`uses_tensor_cores` takes it, and dz
    16-byte aligned too."""
    return uses_tensor_cores(x) and dz.data_ptr() % 16 == 0


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def dot_interaction_cuda(x: torch.Tensor, plan: TcPlan | None = None) -> torch.Tensor:
    """x (B, F, D) float32 or bfloat16, contiguous, on a CUDA device.
    Returns (B, F(F-1)/2) float32 in ``tril_indices(F, -1)`` order. Any B is
    accepted; B == 0 launches nothing. One sample's rows, padded, must fit
    in one block's shared memory (F * D up to about 56K floats); the kernel
    refuses a larger sample and the launch raises. `plan` replaces
    :func:`tc_plan`'s for the tensor-core kernel (a sweep's knob)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"dot_interaction_cuda takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError("dot_interaction_cuda takes a (B, F, D) tensor")
    if x.device.type != "cuda":
        raise ValueError("dot_interaction_cuda needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("dot_interaction_cuda takes a contiguous tensor")
    b, f, d = x.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if uses_tensor_cores(x):
        if plan is None:
            plan = tc_plan(b, f, d, _sm_count(x.device))
        _build.launch("dot_interaction", "dot_interaction", x.device, x.data_ptr(),
                      out.data_ptr(), b, f, d, 1, plan.samples, plan.stages, plan.blocks)
    else:
        _build.launch("dot_interaction", "dot_interaction_simt", x.device, x.data_ptr(),
                      out.data_ptr(), b, f, d, _DTYPES[x.dtype], 0, 0, 0)
    return out


BACKWARD_BLOCKS_PER_SM = 16  # resident blocks a SIMT backward launch aims at on each SM


def dot_interaction_backward_cuda(x: torch.Tensor, dz: torch.Tensor, plan: TcPlan | None = None,
                                  *, simt: bool = False) -> torch.Tensor:
    """The gradient of :func:`dot_interaction_cuda` with respect to x: x (B,
    F, D) float32 or bfloat16 and dz (B, F(F-1)/2) float32, contiguous on one
    CUDA device -> (G + Gᵀ) x per sample, G (F, F) holding dz at
    ``tril_indices(F, -1)``, summed in float32 and rounded once to x's
    dtype. :func:`backward_uses_tensor_cores` picks the kernel; `plan`
    replaces :func:`tc_backward_plan`'s for the tensor cores and `simt`
    forces the SIMT kernel (a sweep's and a comparison's knobs). One
    sample's x and dz, as the chosen kernel stages them, must fit in a
    block's shared memory; a larger one raises."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"dot_interaction_backward_cuda takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError("dot_interaction_backward_cuda takes a (B, F, D) tensor")
    b, f, d = x.shape
    if dz.shape != (b, f * (f - 1) // 2) or dz.dtype != torch.float32:
        raise ValueError(f"dz must be (B, F(F-1)/2) = {(b, f * (f - 1) // 2)} float32, not "
                         f"{tuple(dz.shape)} {dz.dtype}")
    if x.device.type != "cuda" or dz.device != x.device:
        raise ValueError("dot_interaction_backward_cuda needs both tensors on one CUDA device")
    if not (x.is_contiguous() and dz.is_contiguous()):
        raise ValueError("dot_interaction_backward_cuda takes contiguous tensors")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    if not simt and backward_uses_tensor_cores(x, dz):
        if plan is None:
            plan = tc_backward_plan(b, f, d, _sm_count(x.device))
        _build.launch("dot_interaction", "dot_interaction_backward", x.device, x.data_ptr(),
                      dz.data_ptr(), dx.data_ptr(), b, f, d, 1, plan.samples, plan.stages,
                      plan.blocks)
    else:
        grid = min(b, _sm_count(x.device) * BACKWARD_BLOCKS_PER_SM)
        _build.launch("dot_interaction", "dot_interaction_backward_simt", x.device,
                      x.data_ptr(), dz.data_ptr(), dx.data_ptr(), b, f, d, _DTYPES[x.dtype], 0,
                      0, grid)
    return dx


def backward_occupancy(f: int, plan: TcPlan) -> dict:
    """What the card fits of the tensor-core backward's instance for F
    under `plan`: its blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local memory (spills) a thread. Launches nothing."""
    fn = _build.load("dot_interaction").dot_interaction_backward_occupancy
    fn.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 3)()
    err = fn(f, plan.threads, plan.smem, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"dot_interaction_backward_occupancy failed with error {err}")
    return {"blocks_an_sm": out[0], "registers": out[1], "local_bytes": out[2]}


class DotInteraction(torch.autograd.Function):
    """``ops.dot_interaction`` with its gradient, ``ops.dot_interaction_backward``
    (the kernels on the card, the twins on the CPU): the interaction of
    DLRM's training forward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        ctx.save_for_backward(x)
        return ops.dot_interaction(x)

    @staticmethod
    def backward(ctx, dz: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        (x,) = ctx.saved_tensors
        return ops.dot_interaction_backward(x, dz.contiguous())
