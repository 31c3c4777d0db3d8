"""The port's roofline (``repro_torch.roofline``) against the JAX package's,
on the CPU.

``_cell_meta`` and ``model_flops`` equal the reference's for all 40 cells
(exactly: the same integer and float arithmetic); ``roofline_terms``
equals it under the reference's TPU constants, passed explicitly (exactly);
``parse_collectives`` and ``collective_wire_bytes`` equal it on HLO text
(exactly). ``op_cost``, the twin of ``hlo_cost``, is exact on constructed
steps: a matmul is 2·m·n·k, a loop of eight is eight times one, a loop over
the slices of a 100-layer weight stack is charged slice-sized (the bound of
the reference's ``test_dynamic_slice_of_weight_stack_charged_slice_sized``),
a slice update its update's bytes twice, views nothing; and on the CPU it
sees every op of a cell's step (``unseen_launches`` empty).
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.roofline import analysis as janalysis
from repro_torch.configs.registry import all_cells
from repro_torch.kernels import _build
from repro_torch.launch.dryrun import _cell_meta
from repro_torch.roofline import HW, collective_wire_bytes, model_flops, op_cost
from repro_torch.roofline import parse_collectives, roofline_terms
from tests._reference_cells import reference_cells
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

CELLS = all_cells()
TPU = HW(197e12, 819e9, 50e9)  # the reference's constants, passed to both


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_cells(str(tmp_path_factory.mktemp("reference_cells")))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_meta_equals_the_references(arch, shape, ref):
    assert json.loads(json.dumps(_cell_meta(arch, shape))) == ref["meta"][f"{arch}|{shape}"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape, ref):
    got = model_flops(arch, shape, _cell_meta(arch, shape))
    assert got == ref["flops"][f"{arch}|{shape}"] and got > 0


def test_hw_defaults_are_the_h100_datasheet():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 450e9)
    assert HW.__dataclass_fields__.keys() == janalysis.HW.__dataclass_fields__.keys()


@pytest.mark.parametrize("terms", [
    (197e12 * 0.5, 819e9 * 0.1, 50e9 * 0.05), (0.0, 819e9, 50e9 * 3), (1e15, 1e9, 0.0),
    (0.0, 0.0, 0.0), (9.4e10, 1.86e10, 0.0), (3.3e17, 2.1e11, 4.4e12),
])
def test_roofline_terms_equal_the_references(terms):
    assert roofline_terms(*terms, TPU) == janalysis.roofline_terms(*terms, janalysis.HW())
    # on one card, at the H100's rates
    got = roofline_terms(*terms)
    assert got["compute_s"] == terms[0] / 989e12 and got["memory_s"] == terms[1] / 3.35e12


_HLO = """
ENTRY %main (p0: f32[16,16]) -> f32[16,16] {
  %p0 = f32[16,16]{1,0} parameter(0)
  %ag = f32[64,16]{1,0} all-gather(%p0), channel_id=1, replica_groups=[4,4]<=[16], dimensions={0}
  %ar = f32[16,16]{1,0} all-reduce(%p0), channel_id=2, replica_groups=[2,8]<=[16], to_apply=%add
  ROOT %cp = f32[16,16]{1,0} collective-permute(%ar), channel_id=3
}
"""
_HLO_MORE = """
ENTRY %main (p0: bf16[8,128], p1: s32[4]) -> bf16[8,128] {
  %p0 = bf16[8,128]{1,0} parameter(0)
  %rs = bf16[2,128]{1,0} reduce-scatter(%p0), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %a2a = bf16[8,128]{1,0} all-to-all(%p0), replica_groups={{0,1},{2,3}}, dimensions={0}
  %ars = (bf16[8,128]{1,0}, u32[]) all-reduce-start(%p0), replica_groups=[1,8]<=[8]
  %ard = bf16[8,128]{1,0} all-reduce-done(%ars)
  %ags = (f32[4]{0}, f32[32]{0}) all-gather-start(%p1), replica_groups={}
  %agd = f32[32]{0} all-gather-done(%ags)
  ROOT %t = (pred[3], s8[5], u16[2,2], c64[1]) all-reduce(%p0), to_apply=%add
}
"""


def _jax_hlo() -> str:
    return jax.jit(lambda x, w: jnp.tanh(x @ w).sum(0)).lower(
        jnp.ones((8, 16)), jnp.ones((16, 4))).compile().as_text()


@pytest.mark.parametrize("which", ["reference_test", "more", "jax_compiled"])
@pytest.mark.parametrize("n_devices", [1, 16, 256])
def test_parse_collectives_equals_the_references(which, n_devices):
    text = {"reference_test": _HLO, "more": _HLO_MORE}.get(which) or _jax_hlo()
    got = parse_collectives(text, n_devices)
    assert got == janalysis.parse_collectives(text, n_devices)
    assert collective_wire_bytes(got) == janalysis.collective_wire_bytes(got)
    if which == "reference_test":
        assert got["all-gather"]["wire_bytes"] == pytest.approx(4096 * 3 / 4)


def test_op_cost_of_a_matmul_is_2mnk():
    m, n, k = 4, 32, 64
    c = op_cost(torch.matmul, torch.ones(m, k), torch.ones(k, n))
    assert c.flops == 2 * m * n * k
    assert c.bytes == 4 * (m * k + k * n + m * n)
    assert (c.wire_bytes, c.collectives, c.unseen_launches) == (0.0, {}, {})
    assert c.by_op == {"aten.mm": {"count": 1, "flops": 2.0 * m * n * k,
                                   "bytes": 4.0 * (m * k + k * n + m * n)}}


def test_the_products_the_flop_counter_misses_are_counted():
    a, x = torch.ones(1000, 64), torch.ones(64)
    assert op_cost(torch.mv, a, x).flops == 2 * 1000 * 64
    assert op_cost(torch.addmv, torch.ones(1000), a, x).flops == 2 * 1000 * 64
    assert op_cost(torch.dot, x, x).flops == 2 * 64
    # the retrieval cell's scores: 2 n d, as its model FLOPs count them
    assert op_cost(lambda: a @ x).flops == 2 * 1000 * 64


def test_op_cost_of_a_loop_is_its_trips_times_one():
    c0, w = torch.ones(4, 64), torch.ones(64, 32)

    def one(c):
        return (c @ w) @ w.T

    def eight(c):
        for _ in range(8):
            c = one(c)
        return c

    a, b = op_cost(one, c0), op_cost(eight, c0)
    assert a.flops == 2 * 4 * 64 * 32 * 2 and b.flops == 8 * a.flops and b.bytes == 8 * a.bytes


def test_a_weight_stack_slice_is_charged_slice_sized():
    W, x = torch.ones(100, 64, 64), torch.ones(4, 64)

    def fn(x):
        for i in range(100):
            x = x @ W[i]
        return x

    c = op_cost(fn, x)
    assert c.bytes < 100 * (64 * 64 * 4 * 4 + 4 * 64 * 4 * 8)  # the reference's bound
    assert c.bytes == 100 * 4 * (4 * 64 + 64 * 64 + 4 * 64)
    assert c.flops == 100 * 2 * 4 * 64 * 64


def test_a_slice_update_is_charged_its_update_twice_and_views_nothing():
    buf, W = torch.zeros(100, 64, 64), torch.ones(100, 64, 64)

    def fn():
        for i in range(100):
            buf[i] = W[i]

    c = op_cost(fn)
    assert c.bytes == 100 * 2 * 64 * 64 * 4 and c.flops == 100 * 64 * 64
    assert op_cost(lambda: W[3].reshape(-1)[:10].unsqueeze(0).transpose(0, 1).detach()).bytes == 0
    # a reshape that must copy is charged its copy (read and write) and no more
    c = op_cost(lambda: W.transpose(1, 2)[3].reshape(-1))
    assert c.bytes == 2 * 64 * 64 * 4 and list(c.by_op) == ["aten.clone"]


def test_op_cost_reports_the_kernels_it_cannot_see():
    def fn(x):
        _build.count_launch("csr_spmm")  # what a wrapper does where it launches
        return x + 1

    c = op_cost(fn, torch.ones(3))
    assert c.unseen_launches == {"csr_spmm": 1}
    assert c.flops == 3 and c.bytes == 24


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("qwen2-1.5b", "prefill_32k"),
                                        ("dlrm-mlperf", "serve_p99")])
def test_on_the_cpu_op_cost_sees_a_whole_step(arch, shape):
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch, shape, reduced=True, device="cpu")
    c = op_cost(cell.run)
    assert c.unseen_launches == {} and c.flops > 0 and c.bytes > 0
    dots = sum(v["flops"] for k, v in c.by_op.items() if k in ("aten.mm", "aten.addmm",
                                                              "aten.bmm"))
    assert 0 < dots <= c.flops
