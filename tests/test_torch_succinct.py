"""The port's succinct layer against the reference, on the CPU.

BitVector, K2Tree, Elias–Fano and the δ codes of ``repro_torch`` are
held against ``repro.core.succinct`` on the same inputs (numpy, seeded).
Everything is integer and compared exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import succinct as R
from repro_torch.core import succinct as P
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np(t):
    return t.cpu().numpy()


def _words64(words):
    return np.asarray(words).astype(np.int64)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_bitvector_matches_reference(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    bits[: min(n, 32)] = 1  # a first word with its top bit set
    ref = R.BitVector(bits)
    port = P.BitVector(torch.from_numpy(bits))
    np.testing.assert_array_equal(_np(port.words), _words64(ref.words))
    np.testing.assert_array_equal(_np(port.word_ranks), ref.word_ranks)
    assert port.n_ones == ref.n_ones and len(port) == len(ref)
    pos = np.arange(n + 1)
    np.testing.assert_array_equal(_np(port.rank1(torch.from_numpy(pos))), ref.rank1(pos))
    idx = np.arange(n)
    np.testing.assert_array_equal(_np(port.access(torch.from_numpy(idx))), ref.access(idx))
    j = np.arange(ref.n_ones)
    np.testing.assert_array_equal(_np(port.select1(torch.from_numpy(j))), ref.select1(j))
    assert port.size_in_bytes() == ref.size_in_bytes()
    assert port.size_in_bytes(False) == ref.size_in_bytes(False)
    np.testing.assert_array_equal(_np(P.unpack_bits(port.words, n)), ref.to_numpy())
    again = P.BitVector.from_words(torch.from_numpy(_words64(ref.words)), n)
    np.testing.assert_array_equal(_np(again.word_ranks), ref.word_ranks)
    assert int(port.rank1(n)) == int(ref.rank1(n))
    with pytest.raises(IndexError):
        port.select1(ref.n_ones)
    with pytest.raises(ValueError):
        P.BitVector.from_words(torch.zeros(5, dtype=torch.int64), n)


def test_pack_bits_round_trip():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 77).astype(np.uint8)
    words = P.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_np(words), _words64(R.pack_bits(bits)))
    np.testing.assert_array_equal(_np(P.unpack_bits(words, 77)), bits)


def _points(rng, n_rows, n_cols, n_pts):
    return rng.integers(0, n_rows, n_pts), rng.integers(0, n_cols, n_pts)


@pytest.mark.parametrize("k,n_rows,n_cols,n_pts", [
    (2, 31, 31, 60), (3, 40, 17, 100), (4, 9, 50, 40), (2, 200, 1000, 800), (2, 5, 5, 0)])
def test_k2tree_matches_reference(k, n_rows, n_cols, n_pts):
    rng = np.random.default_rng(k * 1000 + n_pts)
    r, c = _points(rng, n_rows, n_cols, n_pts)
    ref = R.K2Tree(r, c, n_rows, n_cols, k=k)
    port = P.K2Tree(torch.from_numpy(r), torch.from_numpy(c), n_rows, n_cols, k=k)
    assert (port.h, port.side, port.n_points) == (ref.h, ref.side, ref.n_points)
    assert len(port.levels) == len(ref.levels)
    for lp, lr in zip(port.levels, ref.levels):
        assert lp.n == lr.n
        np.testing.assert_array_equal(_np(lp.words), _words64(lr.words))
    assert port.size_in_bytes() == ref.size_in_bytes()
    probe = np.concatenate([np.arange(n_rows), [-1, n_rows, n_rows + 7, 0, 0]])
    for axis_port, axis_ref, p in ((port.rows_many, ref.rows_many, probe),
                                   (port.cols_many, ref.cols_many,
                                    np.concatenate([np.arange(n_cols), [-3, n_cols, 1, 1]]))):
        qi, cc = axis_port(torch.from_numpy(p))
        wq, wc = axis_ref(p)
        np.testing.assert_array_equal(_np(qi), wq)
        np.testing.assert_array_equal(_np(cc), wc)
    np.testing.assert_array_equal(_np(port.to_dense()), ref.to_dense())
    for rr, cc in list(zip(r[:10], c[:10])) + [(0, 0), (n_rows - 1, n_cols - 1)]:
        assert port.access(int(rr), int(cc)) == ref.access(int(rr), int(cc))
    loaded = P.K2Tree.from_levels(ref.n_rows, ref.n_cols, ref.k, ref.h, ref.n_points,
                                  [torch.from_numpy(_words64(lv.words)) for lv in ref.levels],
                                  [lv.n for lv in ref.levels])
    qi, cc = loaded.rows_many(torch.from_numpy(probe))
    wq, wc = ref.rows_many(probe)
    np.testing.assert_array_equal(_np(qi), wq)
    np.testing.assert_array_equal(_np(cc), wc)


def test_k2tree_rejects_out_of_bounds_points():
    with pytest.raises(ValueError):
        P.K2Tree(torch.tensor([5]), torch.tensor([0]), 5, 5)
    with pytest.raises(ValueError):
        P.K2Tree.from_levels(8, 8, 2, 3, 4, [torch.zeros(1, dtype=torch.int64)] * 2, [4, 4])


@pytest.mark.parametrize("n,universe,maxv", [
    (1, None, 0), (10, None, 5), (100, 10_000, 9_999), (257, None, 1 << 20), (50, 1 << 40, (1 << 40) - 1)])
def test_elias_fano_matches_reference(n, universe, maxv):
    rng = np.random.default_rng(n)
    vals = np.sort(rng.integers(0, maxv + 1, n))
    ref = R.EliasFano(vals, universe=universe)
    port = P.EliasFano(torch.from_numpy(vals), universe=universe)
    assert (port.n, port.universe, port.l, port._low_bits) == \
        (ref.n, ref.universe, ref.l, ref._low_bits)
    np.testing.assert_array_equal(_np(port._lows), ref._lows.astype(np.int64))
    np.testing.assert_array_equal(_np(port._low_words), _words64(ref._low_words))
    np.testing.assert_array_equal(_np(port._upper.words), _words64(ref._upper.words))
    np.testing.assert_array_equal(_np(port.access(torch.arange(n))), ref.to_numpy())
    assert port.size_in_bytes() == ref.size_in_bytes()


def test_elias_fano_validation():
    with pytest.raises(ValueError):
        P.EliasFano(torch.tensor([3, 1, 2]))
    with pytest.raises(ValueError):
        P.EliasFano(torch.tensor([1, 5, 9]), universe=9)
    with pytest.raises(ValueError):
        P.EliasFano(torch.tensor([-1, 2]))
    assert P.EliasFano(torch.zeros(0, dtype=torch.int64)).size_in_bytes() == \
        R.EliasFano(np.zeros(0, dtype=np.int64)).size_in_bytes()


@pytest.mark.parametrize("maxv", [1, 2, 17, 1000, 1 << 30])
def test_delta_codes_match_reference(maxv):
    rng = np.random.default_rng(maxv)
    vals = rng.integers(1, maxv + 1, 300)
    vals[:3] = [1, maxv, 1]
    w_ref, b_ref = R.delta_encode(vals.astype(np.uint64))
    w_port, b_port = P.delta_encode(torch.from_numpy(vals))
    assert b_port == b_ref
    np.testing.assert_array_equal(_np(w_port), _words64(w_ref))
    np.testing.assert_array_equal(_np(P.delta_decode(w_port, b_port, len(vals))), vals)


def test_codes_reject_values_below_one_and_empty_is_empty():
    with pytest.raises(ValueError):
        P.delta_encode(torch.tensor([0, 3]))
    with pytest.raises(ValueError):
        P.delta_encode(torch.tensor([1 << 55]))  # a code over 63 bits
    words, bits = P.delta_encode(torch.zeros(0, dtype=torch.int64))
    assert bits == 0 and words.numel() == 0
