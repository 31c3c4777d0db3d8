"""The fused k²-tree row / column expansion against the reference, on the CPU.

Both plain twins of the CUDA kernels ``k2_lines_count`` / ``k2_lines_write``
(``repro_torch.kernels.ref.k2_lines_ref``, the level loop and the CPU
path, and ``k2_lines_walk_ref``, the kernel's own warp walk) are held bit
for bit against ``repro.core.succinct.K2Tree.rows_many`` / ``cols_many`` on
trees made by numpy from a seed. The walk twin's stack must stay within
the bound the kernel sizes its shared memory by. The kernels themselves run
only on a GPU (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import succinct as R
from repro_torch.core import succinct as P
from repro_torch.kernels import ops, ref
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _trees(r, c, n_rows, n_cols, k):
    return (R.K2Tree(r, c, n_rows, n_cols, k=k),
            P.K2Tree(torch.from_numpy(r), torch.from_numpy(c), n_rows, n_cols, k=k,
                     device="cpu"))


def _probe(n, rng):
    """Every line, out-of-range values on both sides, and duplicates."""
    dup = rng.integers(0, n, 3) if n else np.zeros(0, np.int64)
    return np.concatenate([np.arange(n), [-1, n, n + 7, -(2**40)], dup, dup]).astype(np.int64)


def _check_all(rt, pt, probe, axis):
    """The port's call, both twins and the reference agree; the walk stays
    within the stack bound."""
    want = (rt.rows_many if axis == 0 else rt.cols_many)(probe)
    lay = pt.layout()
    fixed = torch.from_numpy(probe)
    peaks = []
    got = {"port": (pt.rows_many if axis == 0 else pt.cols_many)(fixed),
           "level loop": ref.k2_lines_ref(lay, fixed, axis),
           "walk": ref.k2_lines_walk_ref(lay, fixed, axis, peaks)}
    for name, (idx, coords) in got.items():
        assert idx.dtype == coords.dtype == torch.int64, name
        np.testing.assert_array_equal(idx.numpy(), want[0], err_msg=name)
        np.testing.assert_array_equal(coords.numpy(), want[1], err_msg=name)
    assert max(peaks, default=0) <= ref.k2_stack_cap(pt.k, pt.h)
    return want


CASES = [(2, 31, 31, 60), (3, 40, 17, 100), (4, 9, 50, 40), (2, 200, 1000, 800),
         (3, 1, 1, 1), (2, 2, 2, 4), (4, 64, 64, 4096), (2, 5, 5, 0), (3, 30, 10, 0),
         (2, 1000, 3, 500), (4, 3, 700, 300)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k,n_rows,n_cols,n_pts", CASES)
def test_twins_match_reference(k, n_rows, n_cols, n_pts, axis):
    rng = np.random.default_rng(k * 1000 + n_pts + axis)
    r, c = rng.integers(0, n_rows, n_pts), rng.integers(0, n_cols, n_pts)
    rt, pt = _trees(r, c, n_rows, n_cols, k)
    _check_all(rt, pt, _probe(n_rows if axis == 0 else n_cols, rng), axis)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_tree_loaded_with_from_levels(k, axis):
    rng = np.random.default_rng(40 + k)
    r, c = rng.integers(0, 90, 300), rng.integers(0, 70, 300)
    rt = R.K2Tree(r, c, 90, 70, k=k)
    pt = P.K2Tree.from_levels(rt.n_rows, rt.n_cols, rt.k, rt.h, rt.n_points,
                              [torch.from_numpy(lv.words.astype(np.int64)) for lv in rt.levels],
                              [lv.n for lv in rt.levels], device="cpu")
    _check_all(rt, pt, _probe(90 if axis == 0 else 70, rng), axis)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_empty_tree_yields_nothing(k):
    """The empty tree stores one level of k² zero bits at any height."""
    rt, pt = _trees(np.zeros(0, np.int64), np.zeros(0, np.int64), 100, 40, k)
    assert pt.h > 1 and len(pt.levels) == 1
    lay = pt.layout()
    assert lay.bits == (k * k,) + (0,) * (pt.h - 1)
    for axis in (0, 1):
        want = _check_all(rt, pt, np.array([0, 5, 39, -1, 100, 5], np.int64), axis)
        assert want[0].size == 0
    loaded = P.K2Tree.from_levels(100, 40, k, pt.h, 0, [torch.zeros(1, dtype=torch.int64)],
                                  [k * k], device="cpu")
    _check_all(rt, loaded, np.array([0, 1, 2], np.int64), 0)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k,n", [(2, 4096), (3, 2187), (4, 1024), (2, 3000)])
def test_one_row_holding_every_point(k, n, axis):
    """The heavy-row case: one line of the matrix holds every point, the
    case a thread per query would serialise on."""
    rows = np.full(n, 5, np.int64)
    cols = np.arange(n, dtype=np.int64)
    r, c = (rows, cols) if axis == 0 else (cols, rows)
    n_rows, n_cols = (8, n) if axis == 0 else (n, 8)
    rt, pt = _trees(r, c, n_rows, n_cols, k)
    want = _check_all(rt, pt, np.array([5, 4, 5, 7], np.int64), axis)
    assert want[0].tolist() == [0] * n + [2] * n
    # the crossing lines hold one point each
    _check_all(rt, pt, _probe(n, np.random.default_rng(n)), 1 - axis)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_walk_stays_within_the_stack_bound_on_a_full_matrix(k):
    """Every bit set: the widest walk a tree of this height can make."""
    side = k ** (6 if k == 2 else 4 if k == 3 else 3)
    rr, cc = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    rt, pt = _trees(rr.ravel(), cc.ravel(), side, side, k)
    peaks = []
    idx, coords = ref.k2_lines_walk_ref(pt.layout(), torch.arange(side), 0, peaks)
    assert idx.numel() == side * side
    assert max(peaks) <= ref.k2_stack_cap(k, pt.h)
    np.testing.assert_array_equal(coords.numpy(), rt.rows_many(np.arange(side))[1])


@pytest.mark.parametrize("q", [0, 1, 33, 4097])
def test_batch_sizes(q):
    rng = np.random.default_rng(q)
    r, c = rng.integers(0, 500, 2000), rng.integers(0, 300, 2000)
    rt, pt = _trees(r, c, 500, 300, 2)
    probe = rng.integers(-3, 503, q).astype(np.int64)
    want = _check_all(rt, pt, probe, 0)
    assert want[0].size == 0 or want[0].max() < q


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 3), st.integers(1, 80), st.integers(1, 80),
       st.lists(st.tuples(st.integers(0, 79), st.integers(0, 79)), max_size=200),
       st.integers(0, 1))
def test_property_random_point_sets(k_minus_1, n_rows, n_cols, pts, axis):
    pts = [(a % n_rows, b % n_cols) for a, b in pts]
    r = np.array([a for a, _ in pts], np.int64)
    c = np.array([b for _, b in pts], np.int64)
    rt, pt = _trees(r, c, n_rows, n_cols, k_minus_1 + 1)
    n = n_rows if axis == 0 else n_cols
    _check_all(rt, pt, np.concatenate([np.arange(-1, n + 1), [0, n - 1]]).astype(np.int64),
               axis)


@pytest.mark.parametrize("k,n_pts", [(2, 500), (3, 300), (4, 0)])
def test_layout_is_the_levels_flattened(k, n_pts):
    rng = np.random.default_rng(k)
    r, c = rng.integers(0, 60, n_pts), rng.integers(0, 90, n_pts)
    _, pt = _trees(r, c, 60, 90, k)
    lay = pt.layout()
    assert pt.layout() is lay  # built once
    assert (lay.k, lay.h, lay.n_rows, lay.n_cols) == (k, pt.h, 60, 90)
    assert lay.words.dtype == torch.int32 and lay.ranks.dtype == torch.int64
    assert lay.word_off.tolist() == list(lay.offsets) and len(lay.offsets) == pt.h + 1
    assert lay.nbits.tolist() == list(lay.bits)
    assert lay.words.shape == lay.ranks.shape == (lay.offsets[-1],)
    for t in range(pt.h):
        words, ranks = lay.level(t)
        if t < len(pt.levels):
            lv = pt.levels[t]
            assert lay.bits[t] == lv.n
            np.testing.assert_array_equal(words.numpy().view(np.uint32)[:-1],
                                          lv.words.numpy().astype(np.uint32))
            np.testing.assert_array_equal(ranks.numpy(), lv.word_ranks.numpy())
        else:
            assert lay.bits[t] == 0 and ranks.tolist() == [0]
        assert words[-1] == 0  # the level's pad word


def test_level_loop_takes_one_rank_a_level():
    """``k2_lines_ref`` with another rank function (on the card, the
    standalone ``bitvec_rank`` kernel: the per-level path) calls it once a
    level above the last and gets the same lines."""
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 300, 900), rng.integers(0, 300, 900)
    _, pt = _trees(r, c, 300, 300, 2)
    calls = []

    def rank(words, ranks, pos):
        calls.append(pos.numel())
        return ref.bitvec_rank_ref(words, ranks, pos)

    fixed = torch.from_numpy(r[:50])
    got = ref.k2_lines_ref(pt.layout(), fixed, 0, rank=rank)
    want = ref.k2_lines_ref(pt.layout(), fixed, 0)
    assert len(calls) == pt.h - 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k2tree_lines_on_the_cpu_is_the_level_loop(monkeypatch):
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, 40, 100), rng.integers(0, 40, 100)
    _, pt = _trees(r, c, 40, 40, 2)
    seen = []
    real = ref.k2_lines_ref

    def spy(lay, fixed, axis):
        seen.append((lay, axis))
        return real(lay, fixed, axis)

    monkeypatch.setattr(ref, "k2_lines_ref", spy)
    ops.reset_launch_counts()
    pt.rows_many(torch.arange(40))
    pt.cols_many([1, 2])
    assert seen == [(pt.layout(), 0), (pt.layout(), 1)]
    assert set(ops.launch_counts.values()) == {0}
