"""The port's CSR sparse-dense product against the JAX package's, on the CPU.

``csr_spmm_ref`` (the twin of the CUDA kernel ``csrc/segment_matmul.cu``)
on the CSR of ``build_csr`` is held against the reference's Pallas kernel
(``repro.kernels.ops.csr_spmm`` on ``build_csr_blocks``, interpret mode
off-TPU) and its oracle ``repro.kernels.ref.spmm_ref``, with inputs made by
numpy from a seed. ``CSRSpMM``'s gradient, the same product on the
transposed CSR, is held against ``jax.grad`` of ``spmm_ref``.

Tolerances: float32 at rtol/atol 1e-5 (sums in another order); bfloat16 at
the reference's own ``_tol`` (rtol/atol 2e-2), where both round a float32
sum to bfloat16 once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segment_matmul import CSR, CSRSpMM, build_csr, csr_spmm_cuda
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py::_tol for bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _twin(x, senders, receivers, n):
    """csr_spmm_ref on build_csr's forward CSR; x a numpy array."""
    fwd, _ = build_csr(_t(senders), _t(receivers), n, x.shape[0])
    return ref.csr_spmm_ref(_t(x), fwd.row_ptr, fwd.col, n)


def _pallas(x, senders, receivers, n):
    src_idx, local_dst = jops.build_csr_blocks(senders, receivers, n)
    return np.asarray(jops.csr_spmm(jnp.asarray(x), jnp.asarray(src_idx),
                                    jnp.asarray(local_dst), n).astype(jnp.float32))


# ---------------------------------------------------------------- the twin
@pytest.mark.parametrize("n,e,d", [(200, 1000, 64), (777, 3000, 128), (64, 64, 256)])
def test_twin_matches_pallas_and_oracle_f32(n, e, d):
    """The reference's own sweep (tests/test_kernels.py::test_csr_spmm_sweep)."""
    rng = np.random.default_rng(3)
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = _twin(x, senders, receivers, n)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    want = jref.spmm_ref(jnp.asarray(x), jnp.asarray(senders), jnp.asarray(receivers), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), _pallas(x, senders, receivers, n), **F32)


@pytest.mark.parametrize("n,e,d", [(200, 1000, 64), (777, 3000, 128), (64, 64, 256)])
def test_twin_matches_pallas_and_oracle_bf16(n, e, d):
    rng = np.random.default_rng(3)
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    xb = jnp.asarray(rng.normal(size=(n, d)), jnp.bfloat16)
    x32 = np.asarray(xb.astype(jnp.float32))
    fwd, _ = build_csr(_t(senders), _t(receivers), n, n)
    got = ref.csr_spmm_ref(_t(x32).to(torch.bfloat16), fwd.row_ptr, fwd.col, n)
    assert got.dtype == torch.bfloat16
    want = jref.spmm_ref(jnp.asarray(x32), jnp.asarray(senders), jnp.asarray(receivers),
                         n).astype(jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **BF16)
    np.testing.assert_allclose(got.float().numpy(), _pallas(xb, senders, receivers, n), **BF16)


def test_twin_isolated_nodes():
    """tests/test_kernels.py::test_csr_spmm_isolated_nodes: rows with no
    edges are 0."""
    n = 300
    senders, receivers = np.array([0, 1, 2]), np.array([5, 5, 7])
    x = np.ones((n, 128), np.float32)
    got = _twin(x, senders, receivers, n)
    assert float(got[5, 0]) == 2.0 and float(got[7, 0]) == 1.0
    assert float(got.abs().sum()) == 3 * 128
    np.testing.assert_array_equal(got.numpy(), _pallas(x, senders, receivers, n))


@pytest.mark.parametrize("d", [1, 47])
def test_twin_masked_senders(d):
    """Sender -1 is padding: the Pallas kernel skips it, and so does the
    CSR; the oracle sees only the valid edges."""
    rng = np.random.default_rng(d)
    n, e = 150, 900
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    senders[rng.random(e) < 0.3] = -1
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = _twin(x, senders, receivers, n)
    keep = senders >= 0
    want = jref.spmm_ref(jnp.asarray(x), jnp.asarray(senders[keep]),
                         jnp.asarray(receivers[keep]), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), _pallas(x, senders, receivers, n), **F32)


@pytest.mark.parametrize("d", [1, 47])
def test_twin_drops_receivers_out_of_range(d):
    """segment_sum drops receivers outside [0, n) (the Pallas host prep
    cannot take them), and so does build_csr."""
    rng = np.random.default_rng(10 + d)
    n, e = 120, 700
    senders, receivers = rng.integers(0, n, e), rng.integers(-5, n + 5, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = _twin(x, senders, receivers, n)
    want = jref.spmm_ref(jnp.asarray(x), jnp.asarray(senders), jnp.asarray(receivers), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("d", [1, 7, 47])
def test_twin_no_edges(d):
    n = 40
    empty = np.zeros(0, np.int64)
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    got = _twin(x, empty, empty, n)
    assert got.shape == (n, d) and float(got.abs().max()) == 0.0
    np.testing.assert_array_equal(got.numpy(), _pallas(x, empty, empty, n))


def test_twin_more_sources_than_rows():
    """The transposed CSR's shape: n_out rows gathered from n_x != n_out
    source rows."""
    rng = np.random.default_rng(7)
    n_out, n_x, e = 30, 90, 400
    senders, receivers = rng.integers(0, n_x, e), rng.integers(0, n_out, e)
    x = rng.normal(size=(n_x, 16)).astype(np.float32)
    got = _twin(x, senders, receivers, n_out)
    want = jref.spmm_ref(jnp.asarray(x), jnp.asarray(senders), jnp.asarray(receivers), n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------- the CSR
def test_build_csr_keeps_edge_order_and_transposes():
    senders = torch.tensor([3, 0, -1, 3, 1, 2, 0])
    receivers = torch.tensor([1, 1, 0, 0, 9, 1, -2])
    fwd, bwd = build_csr(senders, receivers, 4, 5)
    # kept: (3->1), (0->1), (3->0), (2->1); row 1 keeps their order 3, 0, 2
    assert fwd.row_ptr.tolist() == [0, 1, 4, 4, 4] and fwd.col.tolist() == [3, 3, 0, 2]
    assert bwd.row_ptr.tolist() == [0, 1, 1, 2, 4, 4] and bwd.col.tolist() == [1, 1, 1, 0]
    assert fwd.row_ptr.dtype == torch.int64 and fwd.col.dtype == torch.int32
    assert (fwd.n_rows, bwd.n_rows) == (4, 5)
    assert fwd.row_lengths().tolist() == [1, 3, 0, 0]


def test_build_csr_refuses_senders_past_the_sources():
    with pytest.raises(ValueError, match="n_src"):
        build_csr(torch.tensor([0, 5]), torch.tensor([0, 1]), 4, 5)
    with pytest.raises(ValueError):
        build_csr(torch.tensor([0, 1]), torch.tensor([0]), 4, 5)


# ---------------------------------------------------------------- the gradient
@pytest.mark.parametrize("d", [1, 16, 47])
def test_csrspmm_gradient_matches_jax_grad(d):
    """d/dx sum(G * A x) is A^T G: the backward runs the product on the
    transposed CSR, held against jax.grad of spmm_ref at 1e-5."""
    rng = np.random.default_rng(20 + d)
    n_out, n_x, e = 70, 110, 600
    senders, receivers = rng.integers(0, n_x, e), rng.integers(0, n_out, e)
    x = rng.normal(size=(n_x, d)).astype(np.float32)
    g = rng.normal(size=(n_out, d)).astype(np.float32)
    fwd, bwd = build_csr(_t(senders), _t(receivers), n_out, n_x)
    xt = _t(x).requires_grad_(True)
    out = CSRSpMM.apply(xt, fwd, bwd)
    (out * _t(g)).sum().backward()

    def f(xj):
        return jnp.sum(jnp.asarray(g) * jref.spmm_ref(xj, jnp.asarray(senders),
                                                       jnp.asarray(receivers), n_out))

    want = jax.grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **F32)


def test_csrspmm_needs_no_gradient_for_a_constant():
    fwd, bwd = build_csr(torch.tensor([0, 1]), torch.tensor([1, 0]), 2, 2)
    out = CSRSpMM.apply(torch.ones(2, 3), fwd, bwd)
    assert not out.requires_grad and out.tolist() == [[1.0] * 3] * 2


# ---------------------------------------------------------------- dispatch
def test_cpu_dispatch_takes_the_twin_and_counts_no_launch():
    ops.reset_launch_counts()
    fwd, bwd = build_csr(torch.tensor([0, 1, 1]), torch.tensor([1, 0, 1]), 2, 2)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_(True)
    out = ops.csr_spmm(x.detach(), fwd)
    assert out.tolist() == [[3.0, 4.0, 5.0], [3.0, 5.0, 7.0]]
    CSRSpMM.apply(x, fwd, bwd).sum().backward()
    assert x.grad.tolist() == [[1.0] * 3, [2.0] * 3]
    assert ops.launch_counts["csr_spmm"] == 0


@pytest.mark.parametrize("case,err", [
    ("cpu_tensor", ValueError),
    ("float16", TypeError),
    ("raw_tensors", TypeError),
    ("x_rows", ValueError),
    ("one_dim_x", ValueError),
])
def test_csr_spmm_cuda_refuses(case, err):
    x = torch.zeros((3, 4))
    a = CSR(torch.tensor([0, 1, 2]), torch.tensor([0, 2], dtype=torch.int32), 3)
    args = {"cpu_tensor": (x, a), "float16": (x.half(), a),
            "raw_tensors": (x, (a.row_ptr, a.col)), "x_rows": (x[:2], a),
            "one_dim_x": (x[0], a)}[case]
    with pytest.raises(err):
        csr_spmm_cuda(*args)


@pytest.mark.parametrize("case,err", [
    ("int64_col", TypeError),
    ("int32_row_ptr", TypeError),
    ("empty_row_ptr", ValueError),
    ("starts_past_0", ValueError),
    ("decreases", ValueError),
    ("ends_short_of_nnz", ValueError),
    ("ends_past_nnz", ValueError),
    ("col_negative", ValueError),
    ("col_past_n_cols", ValueError),
    ("strided_col", ValueError),
])
def test_csr_refuses_malformed(case, err):
    """A CSR is checked where it is made, so a row_ptr that would walk the
    kernel past the end of col, or a col past x's rows, never reaches it."""
    col = torch.tensor([0, 2, 1], dtype=torch.int32)
    rp = torch.tensor([0, 1, 3])
    args = {"int64_col": (rp, col.long(), 3), "int32_row_ptr": (rp.int(), col, 3),
            "empty_row_ptr": (rp[:0], col, 3), "starts_past_0": (torch.tensor([1, 1, 3]), col, 3),
            "decreases": (torch.tensor([0, 2, 1, 3]), col, 3),
            "ends_short_of_nnz": (torch.tensor([0, 1, 2]), col, 3),
            "ends_past_nnz": (torch.tensor([0, 1, 4]), col, 3),
            "col_negative": (rp, torch.tensor([0, -1, 1], dtype=torch.int32), 3),
            "col_past_n_cols": (rp, col, 2),
            "strided_col": (rp, torch.tensor([0, 9, 2, 9, 1, 9], dtype=torch.int32)[::2], 3)}[case]
    with pytest.raises(err):
        CSR(*args)


def test_csr_takes_well_formed_rows():
    a = CSR(torch.tensor([0, 0, 3, 3]), torch.tensor([4, 0, 4], dtype=torch.int32), 5)
    assert (a.n_rows, a.n_cols) == (3, 5) and a.row_lengths().tolist() == [0, 3, 0]
    assert CSR(torch.zeros(1, dtype=torch.int64), torch.zeros(0, dtype=torch.int32), 0).n_rows == 0
    fwd, bwd = build_csr(torch.tensor([0, 4]), torch.tensor([1, 2]), 3, 5)
    assert (fwd.n_cols, bwd.n_cols) == (5, 3)
