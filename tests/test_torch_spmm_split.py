"""The CSR kernel's work split and its split twins, on the CPU.

The CUDA kernel ``csrc/segment_matmul.cu`` walks the plan that each
``CSR`` carries (``SpmmPlan``): rows of more than ``chunk`` edges cut into
chunks of ``chunk`` edges, each summed in float32 in CSR order, then added
row by row in chunk order. Here the plan is held against a plain loop over
the rows and against its twin ``ref.csr_spmm_segments_ref``, and the split
product ``ref.csr_spmm_split_ref`` against the reference's Pallas kernel
(``repro.kernels.ops.csr_spmm`` on ``build_csr_blocks``, interpret mode
off-TPU) and its oracle ``repro.kernels.ref.spmm_ref``, with inputs made by
numpy from a seed. ``CSRSpMM``'s gradient through the split twin is held
against ``jax.grad`` of ``spmm_ref``.

Tolerances: float32 at rtol/atol 1e-5 (sums in another order); bfloat16 at
the reference's own ``_tol`` (rtol/atol 2e-2), where both round a float32
sum to bfloat16 once. The split twin against a float32 sum written out in
its order is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.data.graphs import node_graph
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segment_matmul import (CSR, SPMM_CHUNK, CSRSpMM, build_csr,
                                                csr_spmm_combine_cuda)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py::_tol for bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _csr(lengths, n_cols=7, chunk=SPMM_CHUNK, seed=0):
    """A CSR with the given row lengths and seeded columns."""
    lengths = np.asarray(lengths, np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    col = np.random.default_rng(seed).integers(0, n_cols, int(row_ptr[-1])).astype(np.int32)
    return CSR(_t(row_ptr), _t(col), n_cols, chunk)


def _loop_segments(row_ptr, chunk):
    """The plan's segments by a plain loop over the rows: (row, start, end)."""
    rp = row_ptr.tolist()
    out = []
    for r, (a, b) in enumerate(zip(rp[:-1], rp[1:])):
        if b - a <= chunk:
            out.append((r, a, b))
        else:
            out += [(r, s, min(s + chunk, b)) for s in range(a, b, chunk)]
    return out


C = 8
PLAN_CASES = {  # name -> (row lengths, chunk)
    "mixed": ([0, C - 1, C, C + 1, 3 * C, 0, 1, 2 * C + 5, C + 1], C),
    "one_row_holds_every_edge": ([0, 0, 50, 0], C),
    "empty_csr": ([], C),
    "no_edges": ([0, 0, 0], C),
    "chunk_1": ([0, C - 1, C, C + 1, 3 * C, 0, 1], 1),
    "chunk_past_nnz": ([0, C - 1, C, C + 1, 3 * C, 0, 1], 8 * C),
    "only_long_rows": ([C + 1, 4 * C, 2 * C], C),
}


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_covers_every_edge_once_in_csr_order(case):
    lengths, chunk = PLAN_CASES[case]
    a = _csr(lengths, chunk=chunk)
    p = a.plan
    rows, start, end = (t.tolist() for t in p.items(a.row_ptr))
    assert len(rows) == p.n_items == p.n_chunks + p.short_rows.numel()
    # as a set, the plan's items are the plain loop's segments and the twin's
    want = _loop_segments(a.row_ptr, chunk)
    assert sorted(zip(rows, start, end)) == want
    assert sorted(zip(*(t.tolist() for t in ref.csr_spmm_segments_ref(a.row_ptr, chunk)))) == want
    # in CSR order they cover every edge exactly once, none longer than chunk
    covered = [k for _, s, e in want for k in range(s, e)]
    assert covered == list(range(a.col.numel()))
    assert all(e - s <= chunk for _, s, e in want)
    # every row has an item; a row is cut only if it is longer than chunk
    lens = np.asarray(lengths, np.int64)
    per_row = np.bincount(np.asarray(rows, np.int64), minlength=len(lengths))
    np.testing.assert_array_equal(per_row, np.where(lens > chunk, -(-lens // chunk), 1))
    assert p.n_long == int((lens > chunk).sum()) and p.n_chunks == int(per_row[lens > chunk].sum())


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_runs_chunks_first_then_short_rows_longest_first(case):
    lengths, chunk = PLAN_CASES[case]
    a = _csr(lengths, chunk=chunk)
    p = a.plan
    lens = a.row_lengths()
    assert p.long_rows.dtype == p.short_rows.dtype == torch.int32
    assert p.chunk_ptr.tolist()[0] == 0 and p.chunk_ptr.numel() == p.n_long + 1
    # long rows by length, longest first, ties by row; each row's chunks consecutive
    long_len = lens[p.long_rows.long()].tolist()
    assert long_len == sorted(long_len, reverse=True)
    short_len = lens[p.short_rows.long()].tolist()
    assert short_len == sorted(short_len, reverse=True) and max(short_len, default=0) <= chunk
    assert sorted(p.long_rows.tolist() + p.short_rows.tolist()) == list(range(len(lengths)))
    for lr, lo, hi in zip(p.long_rows.tolist(), p.chunk_ptr[:-1].tolist(), p.chunk_ptr[1:].tolist()):
        s, e = p.chunk_start[lo:hi].tolist(), p.chunk_end[lo:hi].tolist()
        assert s[0] == int(a.row_ptr[lr]) and e[-1] == int(a.row_ptr[lr + 1])
        assert s[1:] == e[:-1] and all(y - x == chunk for x, y in zip(s[:-1], e[:-1]))


def test_plan_follows_dataclasses_replace():
    """A CSR made by dataclasses.replace (as chip_smoke.py's _graph_to makes
    the host copy) plans its own arrays and chunk."""
    a = _csr([3, 20, 0, 9], chunk=4)
    b = dataclasses.replace(a, row_ptr=torch.tensor([0, 0, 12, 12, 32]), col=a.col.flip(0).clone())
    assert b.chunk == 4 and (b.plan.n_long, b.plan.n_chunks) == (2, 8)
    assert sorted(zip(*(t.tolist() for t in b.plan.items(b.row_ptr)))) == \
        _loop_segments(b.row_ptr, 4)
    c = dataclasses.replace(a, chunk=10)
    assert (c.plan.chunk, c.plan.n_long, c.plan.n_chunks) == (10, 1, 2)
    assert (a.plan.chunk, a.plan.n_long, a.plan.n_chunks) == (4, 2, 8)
    with pytest.raises(ValueError, match="chunk"):
        dataclasses.replace(a, chunk=0)


def test_build_csr_plans_both_directions():
    """One receiver with every edge: the forward CSR cuts its one row, the
    transposed one holds short rows only."""
    senders = torch.arange(40) % 13
    fwd, bwd = build_csr(senders, torch.full((40,), 2), 5, 13)
    assert fwd.chunk == SPMM_CHUNK and fwd.plan.n_long == int(40 > SPMM_CHUNK)
    f2 = dataclasses.replace(fwd, chunk=16)
    assert (f2.plan.n_long, f2.plan.n_chunks, f2.plan.long_rows.tolist()) == (1, 3, [2])
    assert dataclasses.replace(bwd, chunk=16).plan.n_long == 0


# ---------------------------------------------------------------- the split twins
def _add2(s, c, x):
    """Knuth's TwoSum on numpy float32 scalars: the new (s, c)."""
    t = np.float32(s + x)
    z = np.float32(t - s)
    return t, np.float32(c + np.float32(np.float32(s - np.float32(t - z)) + np.float32(x - z)))


def _compensated(terms):
    """The terms' compensated float32 sum from 0, rounded once (s + c)."""
    s = c = np.float32(0)
    for t in terms:
        s, c = _add2(s, c, t)
    return np.float32(s + c)


def test_split_twin_sums_in_csr_order_then_chunk_order():
    """Bit for bit, the twin is the compensated float32 sum written out in
    its order: each segment from 0 in CSR order, rounded once; then the
    segments of a row from 0 in order, rounded once."""
    rng = np.random.default_rng(5)
    lengths, chunk = [0, 3, 4, 5, 17, 1, 9], 4
    a = _csr(lengths, n_cols=30, chunk=chunk, seed=5)
    x = (rng.normal(size=(30, 6)) * 10.0 ** rng.integers(-4, 5, size=(30, 1))).astype(np.float32)
    got = ref.csr_spmm_split_ref(_t(x), a.row_ptr, a.col, a.n_rows, chunk).numpy()
    col = a.col.numpy()
    segs = _loop_segments(a.row_ptr, chunk)
    want = np.zeros((len(lengths), 6), np.float32)
    for r in range(len(lengths)):
        mine = [(s0, e0) for r2, s0, e0 in segs if r2 == r]
        for f in range(6):
            want[r, f] = _compensated([_compensated(x[col[s0:e0], f]) for s0, e0 in mine])
    np.testing.assert_array_equal(got, want)


def test_compensated_sum_is_the_rounded_exact_sum():
    """1 + 1e-8 * 1000 terms: a plain float32 sum stays at 1, the twin's
    (and the kernel's) reaches the sum rounded once."""
    x = np.concatenate([[1.0], np.full(1000, 1e-8)]).astype(np.float32)[:, None]
    a = CSR(torch.tensor([0, 1001]), torch.arange(1001, dtype=torch.int32), 1001, 100)
    got = ref.csr_spmm_split_ref(_t(x), a.row_ptr, a.col, 1, 100)
    exact = np.float32(np.sum(x.astype(np.float64)))
    assert float(got[0, 0]) == float(exact) != 1.0
    assert float(ref.csr_spmm_ref(_t(x), a.row_ptr, a.col, 1)[0, 0]) == 1.0


def test_combine_twin_adds_in_segment_order():
    """Each row's segments in the order given, compensated: 1e8 + 1 - 1e8
    keeps the 1 that a plain float32 sum loses; rows without segments are
    0; a segment list need not be sorted by row."""
    parts = torch.tensor([[1e8], [5.0], [1.0], [-1e8]])
    got = ref.csr_spmm_combine_ref(parts, torch.tensor([0, 2, 0, 0]), 4, torch.float32)
    assert got[:, 0].tolist() == [1.0, 0.0, 5.0, 0.0]
    plain = torch.zeros(4, 1).index_add_(0, torch.tensor([0, 2, 0, 0]), parts)
    assert plain[0, 0].item() == 0.0


def _graphs():
    """name -> (senders, receivers, n_out, n_x, chunk): a uniform graph at a
    small chunk (most rows cut), a heavy-tailed one whose heaviest row spans
    many chunks, senders -1 (padding), receivers out of range (dropped),
    more sources than rows, and no edges."""
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(11)
    g = node_graph(1024, 16_000, 1, 2, real_nodes=1000, real_edges=15_000, generator=gen)
    return {
        "uniform": (rng.integers(0, 200, 1000), rng.integers(0, 200, 1000), 200, 200, 4),
        "heavy_tailed": (g["senders"].numpy(), g["receivers"].numpy(), 1024, 1024, 16),
        "masked_senders": (np.where(rng.random(900) < 0.3, -1, rng.integers(0, 150, 900)),
                           rng.integers(0, 150, 900), 150, 150, 3),
        "dropped_receivers": (rng.integers(0, 120, 700), rng.integers(-5, 125, 700), 120, 120, 3),
        "more_sources": (rng.integers(0, 90, 400), rng.integers(0, 30, 400), 30, 90, 5),
        "no_edges": (np.zeros(0, np.int64), np.zeros(0, np.int64), 40, 40, 4),
    }


GRAPHS = _graphs()


def _pallas(x, senders, receivers, n):
    src_idx, local_dst = jops.build_csr_blocks(senders, receivers, n)
    return np.asarray(jops.csr_spmm(jnp.asarray(x), jnp.asarray(src_idx),
                                    jnp.asarray(local_dst), n).astype(jnp.float32))


def _pallas_takes(name):
    """build_csr_blocks gathers from n_out source rows and cannot take a
    receiver out of range (the reference's segment_sum drops it)."""
    s, r, n_out, n_x, _ = GRAPHS[name]
    return n_out == n_x and bool(((r >= 0) & (r < n_out)).all())


def _oracle(x, senders, receivers, n):
    keep = senders >= 0
    return jref.spmm_ref(jnp.asarray(x), jnp.asarray(senders[keep]),
                         jnp.asarray(receivers[keep]), n)


def _split(x, senders, receivers, n_out, n_x, chunk):
    fwd, _ = build_csr(_t(senders), _t(receivers), n_out, n_x)
    fwd = dataclasses.replace(fwd, chunk=chunk)
    return ref.csr_spmm_split_ref(x, fwd.row_ptr, fwd.col, n_out, fwd.chunk), fwd


def test_heavy_tailed_graph_spans_many_chunks():
    s, r, n_out, n_x, chunk = GRAPHS["heavy_tailed"]
    fwd, _ = build_csr(_t(s), _t(r), n_out, n_x)
    heaviest = int(fwd.row_lengths().max())
    assert heaviest > 10 * chunk
    assert dataclasses.replace(fwd, chunk=chunk).plan.n_long > 10


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("d", [1, 16, 47])
def test_split_twin_matches_pallas_and_oracle_f32(name, d):
    s, r, n_out, n_x, chunk = GRAPHS[name]
    x = np.random.default_rng(d).normal(size=(n_x, d)).astype(np.float32)
    got, _ = _split(_t(x), s, r, n_out, n_x, chunk)
    assert got.dtype == torch.float32 and got.shape == (n_out, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(_oracle(x, s, r, n_out)), **F32)
    if _pallas_takes(name):
        np.testing.assert_allclose(got.numpy(), _pallas(x, s, r, n_out), **F32)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_split_twin_matches_pallas_and_oracle_bf16(name):
    s, r, n_out, n_x, chunk = GRAPHS[name]
    xb = jnp.asarray(np.random.default_rng(2).normal(size=(n_x, 16)), jnp.bfloat16)
    x32 = np.asarray(xb.astype(jnp.float32))
    got, _ = _split(_t(x32).to(torch.bfloat16), s, r, n_out, n_x, chunk)
    assert got.dtype == torch.bfloat16
    want = np.asarray(_oracle(x32, s, r, n_out).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    if _pallas_takes(name):
        np.testing.assert_allclose(got.float().numpy(), _pallas(xb, s, r, n_out), **BF16)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_split_twin_matches_the_plain_twin(name):
    """Against csr_spmm_ref (one index_add_ per edge), the CPU path."""
    s, r, n_out, n_x, chunk = GRAPHS[name]
    x = _t(np.random.default_rng(4).normal(size=(n_x, 7)).astype(np.float32))
    got, fwd = _split(x, s, r, n_out, n_x, chunk)
    want = ref.csr_spmm_ref(x, fwd.row_ptr, fwd.col, n_out)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("name", ["heavy_tailed", "uniform"])
def test_split_twin_twice_is_bit_identical(name):
    s, r, n_out, n_x, chunk = GRAPHS[name]
    x = _t(np.random.default_rng(9).normal(size=(n_x, 47)).astype(np.float32))
    a, _ = _split(x, s, r, n_out, n_x, chunk)
    b, _ = _split(x, s, r, n_out, n_x, chunk)
    assert torch.equal(a, b)


@pytest.mark.parametrize("d", [1, 16, 47])
def test_csrspmm_gradient_through_split_twin_matches_jax_grad(d, monkeypatch):
    """d/dx sum(G * A x) is A^T G: CSRSpMM's forward and backward routed
    through the split twin on the heavy-tailed graph, whose transposed CSR
    is cut too (the graph is symmetric), held against jax.grad of
    spmm_ref at 1e-5."""
    s, r, n_out, n_x, chunk = GRAPHS["heavy_tailed"]
    fwd, bwd = build_csr(_t(s), _t(r), n_out, n_x)
    fwd, bwd = dataclasses.replace(fwd, chunk=chunk), dataclasses.replace(bwd, chunk=chunk)
    assert fwd.plan.n_long and bwd.plan.n_long
    seen = []

    def split(x, a):
        seen.append(a.plan.n_long)
        return ref.csr_spmm_split_ref(x, a.row_ptr, a.col, a.n_rows, a.chunk)

    monkeypatch.setattr(ops, "csr_spmm", split)
    rng = np.random.default_rng(30 + d)
    x = rng.normal(size=(n_x, d)).astype(np.float32)
    g = rng.normal(size=(n_out, d)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    (CSRSpMM.apply(xt, fwd, bwd) * _t(g)).sum().backward()
    assert seen == [fwd.plan.n_long, bwd.plan.n_long]
    keep = s >= 0

    def f(xj):
        return jnp.sum(jnp.asarray(g) * jref.spmm_ref(xj, jnp.asarray(s[keep]),
                                                       jnp.asarray(r[keep]), n_out))

    want = jax.grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------- the combine wrapper
@pytest.mark.parametrize("case", ["cpu_tensors", "part_rows", "part_dtype", "out_rows",
                                  "out_float16"])
def test_csr_spmm_combine_cuda_refuses(case):
    a = _csr([0, 20, 3], chunk=8)
    part, out = torch.zeros((a.plan.n_chunks, 4)), torch.zeros((3, 4))
    args = {"cpu_tensors": (part, a, out), "part_rows": (part[:1], a, out),
            "part_dtype": (part.double(), a, out), "out_rows": (part, a, out[:2]),
            "out_float16": (part, a, out.half())}[case]
    with pytest.raises((TypeError, ValueError)):
        csr_spmm_combine_cuda(*args)
