"""The port's kernel twins against the JAX package's kernels, on the CPU.

Each plain PyTorch twin (``repro_torch.kernels.ref``) is held against the
reference's pure-jnp oracle (``repro.kernels.ref``) and its Pallas kernel
(``repro.kernels.ops``, interpret mode off-TPU), on inputs made by numpy
from a seed. All outputs are integers and compared exactly. The CUDA
kernels themselves run only on a GPU (``chip_smoke.py``); here the tests
check that their wrappers refuse CPU tensors and that a missing ``nvcc``
raises instead of falling back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.succinct import BitVector as RefBitVector
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitvec_rank import bitvec_rank as pallas_bitvec_rank
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda
from repro_torch.kernels.digram_count import digram_pair_counts_cuda
from repro_torch.kernels.k2_lines import K2Layout, k2_lines_cuda
from repro_torch.kernels.segment_matmul import CSR
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rank_inputs(rng, nbits):
    bv = RefBitVector(rng.integers(0, 2, nbits).astype(np.uint8))
    words = np.concatenate([bv.words, np.zeros(1, np.uint32)])  # pos == n pad
    return bv, words, bv.word_ranks


def _t(a, dtype=torch.int64):
    """int64 values, or with dtype=int32 the uint32 bit patterns as int32."""
    if dtype == torch.int32:
        return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy())
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


@pytest.mark.parametrize("nbits,q", [(4096, 1024), (100_000, 2048), (64, 65), (33, 1)])
def test_bitvec_rank_twin_matches_reference_kernel(nbits, q):
    rng = np.random.default_rng(8)
    bv, words, ranks = _rank_inputs(rng, nbits)
    pos = rng.integers(0, nbits + 1, q)
    pos[-1] = nbits
    got = ref.bitvec_rank_ref(_t(words, torch.int32), _t(ranks), _t(pos))
    assert got.dtype == torch.int64
    want_np = bv._rank1_numpy(pos.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want_np)
    j_words = jnp.asarray(words)
    j_ranks = jnp.asarray(ranks.astype(np.int32))
    j_pos = jnp.asarray(pos.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.bitvec_rank(j_words, j_ranks, j_pos)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.bitvec_rank_ref(j_words, j_ranks, j_pos)))


@pytest.mark.parametrize("q", [0, 1, 7, 64, 100, 1023])
def test_bitvec_rank_arbitrary_batch_sizes(q):
    rng = np.random.default_rng(q)
    bv, words, ranks = _rank_inputs(rng, 2048)
    pos = rng.integers(0, bv.n + 1, q)
    got = ops.bitvec_rank(_t(words, torch.int32), _t(ranks), _t(pos))
    assert got.shape == (q,)
    if q:
        out = pallas_bitvec_rank(jnp.asarray(words), jnp.asarray(ranks.astype(np.int32)),
                                 jnp.asarray(pos.astype(np.int32)), block_q=64, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    np.testing.assert_array_equal(got.numpy(), bv._rank1_numpy(pos.astype(np.int64)))


def test_bitvec_rank_twin_takes_int64_words_with_top_bits():
    words = np.array([0xFFFFFFFF, 0x80000001, 0], dtype=np.uint32)
    ranks = np.array([0, 32, 34], dtype=np.int64)
    pos = np.array([0, 1, 31, 32, 33, 63, 64], dtype=np.int64)
    a = ref.bitvec_rank_ref(_t(words, torch.int32), _t(ranks), _t(pos))
    b = ref.bitvec_rank_ref(_t(words), _t(ranks), _t(pos))
    assert a.tolist() == b.tolist() == [0, 1, 31, 32, 33, 33, 34]


def _digram_inputs(rng, n, k):
    its = rng.integers(0, 50, (n, k)).astype(np.int32)
    cnts = rng.integers(1, 10, (n, k)).astype(np.int32)
    pad = rng.random((n, k)) < 0.3
    its[pad] = -1
    cnts[pad] = 0
    return its, cnts


@pytest.mark.parametrize("n,k", [(256, 4), (512, 8), (256, 16), (1, 1), (257, 2), (33, 7)])
def test_digram_pair_counts_twin_matches_reference(n, k):
    rng = np.random.default_rng(6)
    its, cnts = _digram_inputs(rng, n, k)
    got = ref.digram_pair_counts_ref(torch.from_numpy(its), torch.from_numpy(cnts))
    want = jref.digram_pair_counts_ref(jnp.asarray(its), jnp.asarray(cnts))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (n, k * (k + 1) // 2)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if n % min(256, n) == 0:  # the Pallas kernel needs a block multiple
        kern = jops.digram_pair_counts(jnp.asarray(its), jnp.asarray(cnts))
        for g, w in zip(got, kern):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_digram_pair_counts_matches_host_counter():
    """Twin output summed over nodes == the reference's full recount."""
    from repro.core import digram_counts
    from repro.core.digram import node_it_counts
    from tests.test_itr_core import random_hypergraph

    rng = np.random.default_rng(7)
    g, table = random_hypergraph(rng, n_nodes=30, n_edges=100)
    v, it, c = node_it_counts(g, table)
    k = 16
    uniq, inv = np.unique(v, return_inverse=True)
    its = np.full((len(uniq), k), -1, np.int32)
    cs = np.zeros((len(uniq), k), np.int32)
    slot = np.zeros(len(uniq), np.int64)
    for node_i, it_i, c_i in zip(inv, it, c):
        its[node_i, slot[node_i]] = it_i
        cs[node_i, slot[node_i]] = c_i
        slot[node_i] += 1
    lo, hi, cnt = ops.digram_pair_counts(torch.from_numpy(its), torch.from_numpy(cs))
    sel = cnt > 0
    keys = (lo[sel].to(torch.int64) << 32) | hi[sel].to(torch.int64)
    agg = {}
    for kk, cc in zip(keys.tolist(), cnt[sel].tolist()):
        agg[kk] = agg.get(kk, 0) + cc
    want_keys, want_cnts = digram_counts(g, table, cap=None)
    assert agg == dict(zip(want_keys.tolist(), want_cnts.tolist()))


def test_cpu_dispatch_takes_the_twin_and_counts_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(1)
    _, words, ranks = _rank_inputs(rng, 100)
    ops.bitvec_rank(_t(words, torch.int32), _t(ranks), _t([0, 5, 100]))
    its, cnts = _digram_inputs(rng, 5, 3)
    ops.digram_pair_counts(torch.from_numpy(its), torch.from_numpy(cnts))
    q, kv = torch.zeros((1, 2, 3, 8)), torch.zeros((1, 1, 4, 8))
    ops.flash_attention(q, kv, kv)
    ops.flash_attention(q.requires_grad_(), kv, kv).sum().backward()  # the backward's twin
    ops.csr_spmm(torch.ones((2, 3)), CSR(torch.tensor([0, 1]), torch.tensor([1], dtype=torch.int32), 2))
    ops.k2_lines(_layout(), torch.tensor([0, 1, 3]), 0)
    rows, grads, n = ops.embedding_bag_backward(torch.tensor([[1], [0], [1]]), torch.ones(3, 4))
    ops.dot_interaction_backward(torch.ones((2, 3, 4)), torch.ones((2, 3)))
    ops.sgd_rows(torch.zeros((2, 4)), torch.zeros((2, 4)), rows, grads, n, torch.tensor(0.5),
                 torch.tensor(1.0))
    assert ops.launch_counts["bitvec_rank"] == ops.launch_counts["digram_pair_counts"] == 0
    assert set(ops.launch_counts) == {"bitvec_rank", "k2_lines_count", "k2_lines_write",
                                      "digram_pair_counts", "digram_pair_accum",
                                      "digram_select", "embedding_bag",
                                      "embedding_bag_backward",
                                      "embedding_bag_backward_two_pass",
                                      "embedding_bag_backward_combine", "sgd_rows",
                                      "dot_interaction", "dot_interaction_simt",
                                      "dot_interaction_backward",
                                      "dot_interaction_backward_simt",
                                      "flash_attention",
                                      "flash_attention_combine",
                                      "flash_attention_combine_rowwise",
                                      "flash_attention_bwd_delta",
                                      "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
                                      "csr_spmm",
                                      "csr_spmm_combine"}
    assert set(ops.launch_counts.values()) == {0}


@pytest.mark.parametrize("kernel", ["bitvec_rank", "digram_pair_counts"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    if kernel == "bitvec_rank":
        with pytest.raises(ValueError):
            bitvec_rank_cuda(torch.zeros(2, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
    else:
        with pytest.raises(ValueError):
            digram_pair_counts_cuda(torch.zeros((2, 2), dtype=torch.int32),
                                    torch.zeros((2, 2), dtype=torch.int32))


def _layout(**change):
    """A 4 x 4 k²-tree (k = 2, h = 2) with points (0, 1) and (3, 3), on the CPU."""
    lay = dict(k=2, h=2, n_rows=4, n_cols=4,
               words=torch.tensor([0b1001, 0, 0b10000010, 0], dtype=torch.int32),
               ranks=torch.tensor([0, 2, 0, 2]), word_off=torch.tensor([0, 2, 4]),
               nbits=torch.tensor([4, 8]), offsets=(0, 2, 4), bits=(4, 8))
    lay.update(change)
    return K2Layout(**lay)


def test_k2_layout_helper_is_a_tree():
    from repro_torch.core.succinct import K2Tree

    tree = K2Tree(torch.tensor([0, 3]), torch.tensor([1, 3]), 4, 4, device="cpu")
    for f in ("words", "ranks", "word_off", "nbits"):
        assert torch.equal(getattr(tree.layout(), f), getattr(_layout(), f))
    idx, coords = ops.k2_lines(_layout(), torch.tensor([0, 3, 1, -1, 4, 0]), 0)
    assert idx.tolist() == [0, 1, 5] and coords.tolist() == [1, 3, 1]
    idx, coords = ops.k2_lines(_layout(), torch.tensor([3, 1]), 1)
    assert idx.tolist() == [0, 1] and coords.tolist() == [3, 0]


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA device"),
    ("int32 fixed", TypeError, "int64 fixed"),
    ("int64 words", TypeError, "int32 words"),
    ("int32 ranks", TypeError, "int64 ranks"),
    ("2-D fixed", ValueError, "1-D"),
    ("short ranks", ValueError, "one length"),
    ("offsets", ValueError, "h \\+ 1 offsets"),
    ("bit lengths", ValueError, "h bit lengths"),
    ("strided fixed", ValueError, "contiguous"),
    ("axis", ValueError, "axis"),
    ("k", ValueError, "2 <= k <= 32"),
    ("stack", ValueError, "shared memory"),
    ("coordinates", ValueError, "int64 coordinates"),
])
def test_k2_lines_wrapper_refuses(case, exc, match):
    """The CUDA wrapper raises on what its kernels do not take, before any
    launch: types, shapes, the axis, k, a (k, h) whose walk stack would not
    fit in a block's shared memory, coordinates past int64, then tensors
    that are not on one CUDA device."""
    lay, fixed, axis = _layout(), torch.tensor([0, 1]), 0
    change = {"int64 words": dict(words=lay.words.long()),
              "int32 ranks": dict(ranks=lay.ranks.int()),
              "short ranks": dict(ranks=lay.ranks[:-1]),
              "offsets": dict(word_off=lay.word_off[:-1]),
              "bit lengths": dict(nbits=torch.tensor([4, 8, 0])),
              "k": dict(k=33),
              "stack": dict(k=32, h=18, word_off=torch.zeros(19, dtype=torch.int64),
                            nbits=torch.zeros(18, dtype=torch.int64)),
              "coordinates": dict(k=4, h=32, word_off=torch.zeros(33, dtype=torch.int64),
                                  nbits=torch.zeros(32, dtype=torch.int64))}.get(case)
    if change:
        lay = _layout(**change)
    fixed = {"int32 fixed": fixed.int(), "2-D fixed": fixed[None],
             "strided fixed": torch.arange(4)[::2]}.get(case, fixed)
    with pytest.raises(exc, match=match):
        k2_lines_cuda(lay, fixed, 2 if case == "axis" else axis)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
