"""The cost of one eager step, op by op: the twin of ``repro.roofline.hlo_cost``.

The reference walks the optimized HLO text that XLA compiles a cell into,
multiplying loop bodies by their trip counts. The port compiles no HLO: a
step is a sequence of eager ATen ops and hand-written kernels, so a module
named ``hlo_cost`` would mislead, and this one is ``op_cost``. It applies
the reference's cost model to the ops one eager run dispatches:

  dot (every op ``FlopCounterMode`` counts: mm, addmm, bmm, attention, ...)
                 flops = the counter's (2 · |result| · contracted size);
                 bytes = result + operands; the products it does not count
                 (mv, addmv, dot, vdot) the same way: 2 · the matrix's or
                 the vectors' elements
  other op       flops ≈ |result| (elementwise estimate); bytes = result + operands
  in-place slice update (``copy_``, ``index_put_``, ``scatter_``, ...)
                 bytes = 2 · the operands but the destination (the update,
                 not the whole buffer: the reference's dynamic-update-slice);
                 flops = their elements
  views and metadata (select, slice, view, transpose, detach, empty, ...): free

A Python loop is its trip count by construction: each iteration's ops are
dispatched and counted. An operand is charged at its own size, so reading
``W[i]`` of a stacked (L, ...) weight costs one slice, as the reference
charges a dynamic-slice. Bytes count each op's operands and result once,
with no cache and no fusion: an upper estimate of HBM traffic, as the
reference's count of post-fusion ops is.

Two things the dispatcher does not see. The hand-written kernels launch
through ctypes, below ATen: :func:`op_cost` diffs
:data:`repro_torch.kernels._build.launch_counts` around the step and names
each kernel it could not cost in ``unseen_launches`` (on the CPU the
wrappers run their plain twins, which it does see, so that dict is empty).
And on one card there is no collective: ``wire_bytes`` is 0 and
``collectives`` empty.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels import _build

_aten = torch.ops.aten
# ops that move no data a step would pay for: allocations without a write,
# aliases, shape queries, a scalar read
FREE_OPS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
            _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
            _aten._unsafe_view,
            _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
            _aten.sym_storage_offset, _aten.is_same_size, _aten.resize_, _aten.set_,
            _aten.record_stream}
# the products FlopCounterMode does not count: {op: index of the operand
# whose elements, twice, are the op's FLOPs}
PRODUCTS = {_aten.mv: 0, _aten.addmv: 1, _aten.dot: 0, _aten.vdot: 0}
# in-place updates of part of a buffer: charged at their update's size
UPDATE_OPS = {_aten.copy_, _aten.index_put_, _aten.index_copy_, _aten.index_add_,
              _aten.scatter_, _aten.scatter_add_, _aten.scatter_reduce_,
              _aten.masked_scatter_, _aten.slice_scatter, _aten.select_scatter}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclass
class Cost:
    """The reference's ``Cost`` fields, and what the port adds: ``by_op``
    ({aten op: {"count", "flops", "bytes"}}) and ``unseen_launches``
    ({kernel: launches} of the hand-written kernels, whose work is in no
    other field)."""

    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)
    by_op: dict = field(default_factory=dict)
    unseen_launches: dict = field(default_factory=dict)


class _OpBytes(TorchDispatchMode):
    """Records every dispatched op's bytes and its elementwise FLOPs; the
    dots' FLOPs are left to ``FlopCounterMode``."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in FREE_OPS:
            return out
        outs = _tensors(out)
        if packet in UPDATE_OPS:
            dest = args[0] if args and isinstance(args[0], torch.Tensor) else None
            upd = [t for t in _tensors((args, kwargs)) if t is not dest]
            flops = float(sum(t.numel() for t in upd))
            nbytes = 2.0 * sum(_nbytes(t) for t in upd)
        else:
            nbytes = float(sum(_nbytes(t) for t in outs)
                           + sum(_nbytes(t) for t in _tensors((args, kwargs))))
            if packet in PRODUCTS:
                flops = 2.0 * args[PRODUCTS[packet]].numel()
            elif packet in flop_registry:
                flops = 0.0  # FlopCounterMode's
            else:
                flops = float(sum(t.numel() for t in outs))
        d = self.cost.by_op.setdefault(str(packet), {"count": 0, "flops": 0.0, "bytes": 0.0})
        d["count"] += 1
        d["flops"] += flops
        d["bytes"] += nbytes
        self.cost.flops += flops
        self.cost.bytes += nbytes
        return out


def op_cost(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and return its :class:`Cost`
    under the cost model of this module's docstring. The run is a real
    one: it updates whatever ``fn`` updates in place."""
    cost = Cost()
    before = dict(_build.launch_counts)
    with FlopCounterMode(display=False) as flops, _OpBytes(cost):
        fn(*args, **kwargs)
    for packet, n in flops.get_flop_counts().get("Global", {}).items():
        d = cost.by_op.setdefault(str(packet), {"count": 0, "flops": 0.0, "bytes": 0.0})
        d["flops"] += float(n)
        cost.flops += float(n)
    cost.unseen_launches = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
                            if v != before.get(k, 0)}
    return cost
