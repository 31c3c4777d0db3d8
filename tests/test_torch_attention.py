"""The port's flash-attention twin against the JAX package's, on the CPU.

``repro_torch.kernels.ops.flash_attention`` (on a CPU tensor, the plain
twin ``flash_attention_ref``) is held against the Pallas kernel
(``repro.kernels.ops.flash_attention``, interpret mode off-TPU) on every
case of the reference's attention sweeps, and against the reference's
oracle ``attention_ref`` where the Pallas kernel refuses the shape (lengths
that are not block multiples, one query row, more queries than keys). The
CUDA kernel runs only on a GPU (``chip_smoke.py``); here its wrapper is
checked to refuse what it does not take. Inputs are made by numpy from a
seed.

Tolerances are the reference sweep's (``tests/test_kernels.py::_tol``):
rtol/atol 1e-5 in float32 (summation order), 2e-2 in bfloat16 (p is
rounded to bfloat16 against a different running max).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (MERGE_BLOCKS_PER_SM, MERGE_LOADS,
                                                 MERGE_MAX_SPLITS, MERGE_ONE_LEVEL_ROUNDS,
                                                 MERGE_THREADS, SPLIT_MAX_ROWS,
                                                 flash_attention_combine_cuda,
                                                 flash_attention_combine_rowwise_cuda,
                                                 flash_attention_cuda, merge_scratch_size,
                                                 pack_partials, partials_size, plan_merge,
                                                 plan_splits, planned_splits)
from repro_torch.kernels.ref import SPLIT_KEYS, merge_chunks, split_bounds, visible_range
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else F32


def _qkv(seed, b, hq, hkv, sq, sk, d, dtype=jnp.float32):
    """The same inputs for both packages: jnp arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.normal(size=shape), dtype)
              for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tensors = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in arrays]
    return arrays, tensors


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------ the reference's sweeps, vs Pallas
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 4, 4, 128, 128, 64),     # MHA square
    (2, 8, 2, 128, 128, 64),     # GQA 4:1
    (1, 4, 1, 64, 256, 32),      # MQA decode-ish (Sq < Sk)
    (1, 2, 2, 256, 256, 128),
])
def test_twin_matches_pallas_sweep(b, hq, hkv, sq, sk, d, dtype):
    (q, k, v), (tq, tk, tv) = _qkv(0, b, hq, hkv, sq, sk, d, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("window", [None, 64, 128])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_twin_matches_pallas_window_softcap(window, softcap):
    (q, k, v), (tq, tk, tv) = _qkv(1, 1, 4, 2, 256, 256, 64)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window, softcap=softcap)
    want = jops.flash_attention(q, k, v, causal=True, window=window, softcap=softcap,
                                block_q=64, block_k=64)
    _close(got, want, F32)


def test_twin_matches_pallas_noncausal():
    (q, k, v), (tq, tk, tv) = _qkv(2, 1, 2, 2, 128, 128, 32)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = jops.flash_attention(q, k, v, causal=False, block_q=64, block_k=64)
    _close(got, want, F32)


def test_twin_matches_pallas_explicit_scale():
    (q, k, v), (tq, tk, tv) = _qkv(3, 1, 6, 2, 64, 128, 16, jnp.bfloat16)
    got = ops.flash_attention(tq, tk, tv, sm_scale=0.3)
    want = jops.flash_attention(q, k, v, sm_scale=0.3, block_q=64, block_k=64)
    _close(got, want, _tol(jnp.bfloat16))


# --------------------------------------- what Pallas refuses, vs the jnp oracle
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window", [
    (2, 6, 2, 77, 333, 8, None),     # neither length a block multiple
    (1, 4, 2, 130, 130, 16, 40),     # ragged square with a window
    (3, 6, 2, 1, 97, 24, None),      # one query row (decode)
    (1, 4, 2, 100, 50, 32, None),    # Sq > Sk: the first 50 rows see no key
    (1, 2, 1, 5, 1, 8, None),        # a single key
])
def test_twin_matches_oracle_on_any_length(b, hq, hkv, sq, sk, d, window):
    (q, k, v), (tq, tk, tv) = _qkv(4, b, hq, hkv, sq, sk, d)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    want = jref.attention_ref(q, k, v, causal=True, window=window)
    _close(got, want, F32)
    if sq > sk:
        assert torch.equal(got[:, :, :sq - sk], torch.zeros_like(got[:, :, :sq - sk]))


@pytest.mark.parametrize("sq,q_offset,window", [(1, 0, None), (1, 40, None), (1, 96, 16),
                                                (17, 30, None), (8, 0, 3)])
def test_q_offset_equals_the_sliced_right_aligned_call(sq, q_offset, window):
    """Rows at positions q_offset.. against a longer cache == the same rows
    right-aligned against the cache cut to q_offset + Sq keys."""
    (_, k, v), (tq, tk, tv) = _qkv(5, 2, 6, 2, sq, 97, 16)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    cut = q_offset + sq
    sliced = ops.flash_attention(tq, tk[:, :, :cut], tv[:, :, :cut], causal=True,
                                 window=window)
    torch.testing.assert_close(got, sliced, **F32)
    want = jref.attention_ref(jnp.asarray(tq.numpy()), k[:, :, :cut], v[:, :, :cut],
                              causal=True, window=window)
    _close(got, want, F32)


def test_strided_views_equal_contiguous_inputs():
    """The model hands (B, S, H, D) memory over as (B, H, S, D) views."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 9, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    got = ops.flash_attention(*views, q_offset=31)
    want = ops.flash_attention(*[x.contiguous() for x in views], q_offset=31)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_empty_lengths():
    q = torch.zeros((1, 2, 0, 8))
    kv = torch.zeros((1, 1, 5, 8))
    assert ops.flash_attention(q, kv, kv).shape == (1, 2, 0, 8)
    q = torch.ones((1, 2, 3, 8))
    kv = torch.zeros((1, 1, 0, 8))
    assert torch.equal(ops.flash_attention(q, kv, kv), torch.zeros((1, 2, 3, 8)))


# ------------------------------------------------- the split decode's arithmetic
SPLITS = [1, 2, 3, 7]


@pytest.mark.parametrize("n_splits", SPLITS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("sk,window,block_k", [
    (256, None, 64),    # causal decode at q_offset 255 against the cache cut there
    (256, 20, 64),      # a window of 20 keys: every split but the first is empty
    (200, None, 40),    # Sk not a multiple of 64: the last chunk is ragged
])
def test_split_ref_matches_pallas(n_splits, dtype, sk, window, block_k):
    """One decode row per head at position Sk - 1 (the Pallas kernel's right
    alignment, q_offset = Sk - 1), split and merged, against Pallas."""
    (q, k, v), (tq, tk, tv) = _qkv(8, 2, 12, 2, 1, sk, 16, dtype)
    got = tref.flash_attention_split_ref(tq, tk, tv, n_splits=n_splits, window=window,
                                         q_offset=sk - 1)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jops.flash_attention(q, k, v, causal=True, window=window, block_q=1,
                                block_k=block_k)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("n_splits", SPLITS)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,kw", [
    (3, 6, 2, 1, 1000, 32, dict(q_offset=700)),                # causal decode mid-cache
    (2, 12, 2, 1, 2048, 16, dict(q_offset=1500, window=100)),  # 2 of 32 chunks visible
    (1, 4, 2, 2, 97, 8, dict(causal=False)),                   # 4 rows, Sk prime
    (2, 8, 2, 2, 300, 16, dict(q_offset=130, softcap=20.0)),  # 8 rows, soft-capped
    (1, 4, 2, 3, 64, 8, dict(q_offset=-5)),                    # rows before every key
    (1, 4, 2, 1, 0, 8, {}),                                    # no key at all
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_ref_matches_twin(n_splits, b, hq, hkv, sq, sk, d, kw, dtype):
    _, (tq, tk, tv) = _qkv(9, b, hq, hkv, sq, sk, d)
    tq, tk, tv = tq.to(dtype), tk.to(dtype), tv.to(dtype)
    got = tref.flash_attention_split_ref(tq, tk, tv, n_splits=n_splits, **kw)
    want = tref.flash_attention_ref(tq, tk, tv, **kw)
    tol = F32 if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, want, **tol)


def test_split_partials_merge_to_the_unsplit_partial():
    """Merging the partials of any split count gives the one-split result,
    and an empty split carries m = -1e30, l = 0, acc = 0."""
    _, (tq, tk, tv) = _qkv(10, 2, 6, 2, 1, 500, 16)
    kw = dict(q_offset=480, window=90)
    one = tref.flash_attention_combine_ref(
        *tref.flash_attention_partials_ref(tq, tk, tv, n_splits=1, **kw), 3, tq.dtype)
    m, l, acc = tref.flash_attention_partials_ref(tq, tk, tv, n_splits=7, **kw)
    assert m.shape == l.shape == (7, 2, 2, 3) and acc.shape == (7, 2, 2, 3, 16)
    empty = [s for s, (lo, hi) in enumerate(split_bounds(391, 481, 7)) if hi <= lo]
    assert empty == [2, 3, 4, 5, 6]
    assert bool((m[empty] == tref.NEG_INF).all() and (l[empty] == 0).all()
                and (acc[empty] == 0).all())
    torch.testing.assert_close(tref.flash_attention_combine_ref(m, l, acc, 3, tq.dtype), one,
                               **F32)


# ---------------------------------------------------- many splits and their merge
@pytest.mark.parametrize("window", [None, 1000])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_many_splits_match_the_oracle(window, dtype):
    """long_500k's regime at a small width: one decode row, 12 query heads
    over 2 kv heads, 512 splits of 32,768 keys (a window of 1,000 keys
    leaves 496 of them empty), merged in one level and in the merge
    kernel's two (the plan's chunks at long_500k's width and at this one),
    against the reference's attention_ref (the Pallas kernel takes no block
    of one query row at this length in reasonable time)."""
    sk, n = 32768, 512
    (q, k, v), (tq, tk, tv) = _qkv(12, 1, 12, 2, 1, sk, 16, dtype)
    m, l, acc = tref.flash_attention_partials_ref(tq, tk, tv, n_splits=n, window=window,
                                                  q_offset=sk - 1)
    empty = int((l == 0).all(dim=(1, 2, 3)).sum())
    assert empty == (n - 1000 // SPLIT_KEYS - 1 if window else 0)
    want = jref.attention_ref(q, k, v, causal=True, window=window)
    _close(tref.flash_attention_combine_ref(m, l, acc, 6, tq.dtype), want, _tol(dtype))
    chunkings = {plan_merge(12, n, 128), plan_merge(12, n, 16), 7}
    assert chunkings == {16, 1, 7}
    for chunks in chunkings:
        got = tref.flash_attention_combine_chunked_ref(m, l, acc, 6, tq.dtype, chunks)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, want, _tol(dtype))


CHUNK_CASES = [  # (B, Hq, Hkv, Sq, Sk, D, n_splits, kwargs)
    (2, 12, 2, 1, 2048, 16, 7, dict(q_offset=1500, window=100)),  # splits 2..6 see no key
    (1, 12, 2, 1, 2048, 16, 32, dict(q_offset=2047, window=300)),  # 5 of 32 see keys
    (1, 4, 2, 3, 64, 8, 5, dict(q_offset=-2)),                     # 2 rows see no key
    (3, 6, 2, 1, 1000, 32, 9, dict(q_offset=999, softcap=20.0)),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,n_splits,kw", CHUNK_CASES)
def test_chunked_merge_equals_the_one_level_merge(b, hq, hkv, sq, sk, d, n_splits, kw):
    """The merge kernel's two levels (flash_attention_combine_chunked_ref)
    against the one-level merge within 1e-5 for every chunking 1..n_splits,
    chunks whose splits all saw no key among them; a row that saw no key
    is 0 in both."""
    _, (tq, tk, tv) = _qkv(13, b, hq, hkv, sq, sk, d)
    m, l, acc = tref.flash_attention_partials_ref(tq, tk, tv, n_splits=n_splits, **kw)
    one = tref.flash_attention_combine_ref(m, l, acc, hq // hkv, tq.dtype)
    seen = l > 0  # (S, B, Hkv, rows): the splits that saw a key, a row each
    empty_chunks = 0
    for chunks in range(1, n_splits + 1):
        got = tref.flash_attention_combine_chunked_ref(m, l, acc, hq // hkv, tq.dtype, chunks)
        torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)
        empty_chunks += sum(not bool(seen[a:e].any()) for a, e in merge_chunks(n_splits, chunks))
        if kw.get("q_offset", 0) < 0:
            assert torch.equal(got[:, :, :-kw["q_offset"]], torch.zeros_like(got[:, :, :2]))
    if "window" in kw:
        assert empty_chunks > 0
    if kw.get("q_offset", 0) < 0:
        assert torch.equal(one[:, :, :2], torch.zeros_like(one[:, :, :2]))


MERGE_PLAN_CASES = [  # (rows, n_splits, D, SMs)
    (12, 512, 128, 132),    # long_500k: 16 chunks of 32
    (768, 9, 128, 132),     # decode_32k at batch 64: the rows fill the card
    (96, 25, 128, 132),     # lm_serve: a block reads its 25 splits in one round
    (56, 128, 128, 132),    # yi-34b decode_32k at batch 1
    (12, 512, 256, 132),    # long_500k's splits at D = 256: 22 chunks
    (64, 32, 256, 132),     # Gemma-2 decode_32k at batch 4, D = 256
    (64, 64, 128, 132),     # phi-3.5-MoE decode_32k at batch 2
    (12, 512, 24, 132),
    (1, 5000, 128, 132),    # more splits than a block weighs
    (300, 2500, 64, 132),   # the rows fill the card, the splits do not fit one block
    (6, 2, 8, 8),
]


@pytest.mark.parametrize("rows,n_splits,d,n_sm", MERGE_PLAN_CASES)
def test_plan_merge_chunks_cover_every_split_once(rows, n_splits, d, n_sm):
    c = plan_merge(rows, n_splits, d, n_sm)
    bounds = merge_chunks(n_splits, c)
    assert 1 <= c <= min(n_splits, MERGE_MAX_SPLITS) and len(bounds) == c
    assert all(e > a and e - a <= MERGE_MAX_SPLITS for a, e in bounds)  # none empty or too big
    assert [s for a, e in bounds for s in range(a, e)] == list(range(n_splits))
    least = -(-n_splits // MERGE_MAX_SPLITS)  # chunks a block can weigh
    rounds = -(-n_splits // (MERGE_THREADS // (d // 4) * MERGE_LOADS))  # of one block a row
    if rows >= MERGE_BLOCKS_PER_SM * n_sm or rounds <= MERGE_ONE_LEVEL_ROUNDS:
        assert c == least  # the rows fill the card, or one block a row reads fast enough
    assert c == least or (c <= rounds and rows * (c - 1) < MERGE_BLOCKS_PER_SM * n_sm)
    assert merge_scratch_size(rows, c, d) == (rows * c * (d + 2) if c > 1 else 0)


def test_plan_merge_at_the_main_paths():
    assert plan_merge(12, 512, 128) == 16   # long_500k: 192 blocks, one round of loads each
    assert plan_merge(768, 9, 128) == 1     # decode_32k
    assert plan_merge(96, 25, 128) == 1     # lm_serve
    assert plan_merge(56, 128, 128) == 1    # yi-34b's decode_32k: 4 rounds of loads
    assert plan_merge(12, 512, 256) == 22   # long_500k's splits at D = 256: 32 rounds
    assert plan_merge(1, 5000, 128) == 157  # 157 chunks of 32 splits


def test_merge_chunks_forced_past_the_last_split_are_empty():
    assert merge_chunks(10, 6) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 10)]
    assert merge_chunks(512, 16) == [(32 * c, 32 * c + 32) for c in range(16)]
    assert merge_chunks(7, 1) == [(0, 7)]


# ------------------------------------------------------------------ the planner
PLAN_CASES = [  # (pairs, Sq, group, Sk, q_offset, causal, window, SMs)
    (128, 1, 6, 32768, 32767, True, None, 132),  # decode_32k at batch 64
    (16, 1, 6, 4096, 1600, True, None, 132),     # lm_serve decode against its 4,096 cache
    (16, 1, 6, 4096, 1600, True, 100, 132),
    (2, 1, 8, 1000, 999, False, None, 132),
    (6, 1, 6, 97, 50, True, None, 132),
    (4, 2, 4, 5000, 4000, True, None, 8),
    (1, 1, 6, 64, 63, True, None, 132),          # one chunk: no split
    (64, 2, 6, 32768, 32766, True, None, 132),   # 12 rows: prefill, no split
    (8, 128, 6, 4096, 0, True, None, 132),
    (4, 1, 6, 300, -1, True, None, 132),         # sees no key
]


@pytest.mark.parametrize("pairs,sq,group,sk,q_offset,causal,window,n_sm", PLAN_CASES)
def test_plan_splits_tiles_the_visible_keys(pairs, sq, group, sk, q_offset, causal, window,
                                            n_sm):
    lo, hi = visible_range(sq, sk, q_offset, causal, window)
    n = plan_splits(pairs, sq * group, lo, hi, n_sm)
    assert n >= 1
    if sq * group > SPLIT_MAX_ROWS:
        assert n == 1
    bounds = split_bounds(lo, hi, n)
    assert len(bounds) == n
    seen = [(a, e) for a, e in bounds if e > a]
    if hi > lo:
        assert len(seen) == n  # a planned split is never empty
        assert seen[0][0] == lo and seen[-1][1] == hi
        for (a, e), (a2, _) in zip(seen, seen[1:]):
            assert e == a2 and (e - a) % SPLIT_KEYS == 0  # contiguous, whole chunks
        assert n <= -(-(hi - lo) // SPLIT_KEYS)
    else:
        assert n == 1 and seen == []
    # the visible keys by brute force: every visible key in some split, none outside
    pos = np.arange(sq)[:, None] + q_offset
    key = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= pos >= key
    if window:
        vis &= key > pos - window
    cols = np.flatnonzero(vis.any(axis=0))
    covered = np.zeros(sk, bool)
    for a, e in seen:
        covered[a:min(e, sk)] = True
    assert covered[cols].all()
    if cols.size:
        assert lo == cols.min() and hi == cols.max() + 1


def test_plan_splits_fills_the_card():
    assert plan_splits(128, 6, 0, 32768, n_sm=132) == 9      # 1,152 blocks for 132 SMs
    assert plan_splits(16, 6, 0, 1600, n_sm=132) == 25       # one split a 64-key chunk
    assert plan_splits(16, 6, 0, 1600, n_sm=132) * 16 >= 132
    assert plan_splits(100000, 6, 0, 32768, n_sm=132) == 1   # enough pairs already


@pytest.mark.parametrize("pairs,sq,group,sk,q_offset,causal,window,n_sm", PLAN_CASES)
def test_planned_splits_is_the_plan_of_the_call(pairs, sq, group, sk, q_offset, causal, window,
                                                n_sm):
    """planned_splits reads the plan off a call's tensors and keywords as
    the wrapper does, and gives a forced n_splits back unchanged."""
    q = torch.zeros((pairs, group, sq, 8))
    k = torch.zeros((pairs, 1, sk, 8))
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=30.0, sm_scale=0.5)
    want = plan_splits(pairs, sq * group, *visible_range(sq, sk, q_offset, causal, window), n_sm)
    assert planned_splits(q, k, n_sm=n_sm, **kw) == want
    assert planned_splits(q, k, n_sm=n_sm, n_splits=3, **kw) == 3
    if q_offset == sk - sq:  # q_offset None means Sk - Sq
        assert planned_splits(q, k, n_sm=n_sm, **{**kw, "q_offset": None}) == want


def test_pack_partials_is_the_flat_layout():
    """acc, then m, then l, float32, partials_size values in all."""
    _, (tq, tk, tv) = _qkv(11, 2, 6, 2, 1, 300, 16)
    m, l, acc = tref.flash_attention_partials_ref(tq, tk, tv, n_splits=3)
    flat = pack_partials(m, l, acc)
    assert flat.dtype == torch.float32 and flat.dim() == 1
    assert flat.numel() == partials_size(3, 2, 2, 3, 16)
    n = acc.numel()
    assert torch.equal(flat[:n].view(acc.shape), acc)
    assert torch.equal(flat[n:n + m.numel()].view(m.shape), m)
    assert torch.equal(flat[n + m.numel():].view(l.shape), l)


# ---------------------------------------------------------------- the wrapper
def test_cpu_dispatch_takes_the_twin_and_counts_no_launch():
    ops.reset_launch_counts()
    _, (tq, tk, tv) = _qkv(7, 1, 2, 1, 4, 4, 8)
    ops.flash_attention(tq, tk, tv)
    assert ops.launch_counts["flash_attention"] == 0


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim_256+", "head_dim_odd",
                                  "groups", "window", "softcap", "cpu_tensor", "n_splits_0",
                                  "n_splits_float", "n_splits_prefill"])
def test_cuda_wrapper_refuses(case):
    q = torch.zeros((1, 4, 3, 16))
    kv = torch.zeros((1, 2, 5, 16))
    kw = {}
    err = ValueError
    if case == "dtype":
        q, kv, err = q.half(), kv.half(), TypeError
    elif case == "mixed_dtype":
        kv, err = kv.bfloat16(), TypeError
    elif case == "head_dim_256+":
        q, kv = torch.zeros((1, 4, 3, 264)), torch.zeros((1, 2, 5, 264))
    elif case == "head_dim_odd":
        q, kv = torch.zeros((1, 4, 3, 12)), torch.zeros((1, 2, 5, 12))
    elif case == "groups":
        kv = torch.zeros((1, 3, 5, 16))
    elif case == "window":
        kw = dict(window=0)
    elif case == "softcap":
        kw = dict(softcap=-1.0)
    elif case == "n_splits_0":
        kw = dict(n_splits=0)
    elif case == "n_splits_float":
        kw = dict(n_splits=2.0)
    elif case == "n_splits_prefill":  # 6 positions x a group of 2 = 12 rows: prefill
        q, kw = torch.zeros((1, 4, 6, 16)), dict(n_splits=2)
    with pytest.raises(err, match="n_splits" if case.startswith("n_splits") else None):
        flash_attention_cuda(q, kv, kv, **kw)


COMBINE_REFUSALS = ["cpu_tensor", "size", "dtype", "one_split", "head_dim_odd"]


def _combine_refusal(case):
    """(part, out, hkv, n_splits, error) of a merge call the wrappers refuse."""
    out = torch.zeros((1, 4, 1, 16))
    part = torch.zeros(3 * 1 * 2 * 2 * 18)
    hkv, n, err = 2, 3, ValueError
    if case == "size":
        part = part[:-1]
    elif case == "dtype":
        part, err = part.double(), TypeError
    elif case == "one_split":
        n, part = 1, torch.zeros(1 * 1 * 2 * 2 * 18)
    elif case == "head_dim_odd":
        out, part = torch.zeros((1, 4, 1, 12)), torch.zeros(3 * 1 * 2 * 2 * 14)
    return part, out, hkv, n, err


@pytest.mark.parametrize("case", COMBINE_REFUSALS)
def test_combine_wrapper_refuses(case):
    *args, err = _combine_refusal(case)
    with pytest.raises(err):
        flash_attention_combine_cuda(*args)


@pytest.mark.parametrize("case", COMBINE_REFUSALS)
def test_combine_rowwise_wrapper_refuses(case):
    *args, err = _combine_refusal(case)
    with pytest.raises(err):
        flash_attention_combine_rowwise_cuda(*args)


@pytest.mark.parametrize("chunks", [0, 4, 2.0, True])
def test_combine_wrapper_refuses_chunks(chunks):
    """chunks: an int in 1..n_splits (3 here), or None for the plan."""
    with pytest.raises(ValueError, match="chunks"):
        flash_attention_combine_cuda(torch.zeros(3 * 2 * 2 * 18), torch.zeros((1, 4, 1, 16)),
                                     2, 3, chunks=chunks)
