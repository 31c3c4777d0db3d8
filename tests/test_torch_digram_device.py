"""The port's device Count and Update Count against the reference, on the CPU.

The twins of the two kernels of the build (``digram_pair_accum``,
``digram_select``) are held against the JAX package's Pallas kernel
``digram_pair_counts`` (interpret mode off-TPU) and its host recount
``digram_counts``; the port's ``DigramCounter``, whose state is tensors,
against the reference's dict-and-heap ``DigramCounter`` over random
sequences of updates; and ``compress`` against the reference's, so that
the grammar stays the same bit for bit. All values are integers and are
compared exactly. The CUDA kernels run only on a GPU (``chip_smoke.py``);
here their wrappers must refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.digram import node_it_counts as ref_node_it_counts
from repro.kernels import ops as jops
from repro_torch.core.digram import DigramCounter, _capped_csr
from repro_torch.kernels import ref
from repro_torch.kernels.digram_count import (EMPTY, SKIP, DigramTable, digram_pair_accum_cuda,
                                              digram_select_cuda)
from tests.test_itr_core import random_hypergraph
from tests.test_torch_build import DATASETS, assert_same_grammar, both_graphs, port_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _ragged(rng, n_rows, max_k, empty_share=0.2):
    """Random node histograms as a CSR: distinct types a row, counts 1..9,
    some rows empty, and a sign a row."""
    lens = rng.integers(0, max_k + 1, n_rows)
    lens[rng.random(n_rows) < empty_share] = 0
    lens[0] = max_k
    its = np.concatenate([rng.permutation(200)[:k] for k in lens]).astype(np.int32)
    cnts = rng.integers(1, 10, int(lens.sum())).astype(np.int32)
    sign = rng.choice(np.array([-1, 1], np.int32), n_rows)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return row_ptr, its, cnts, sign


def _pallas_sums(row_ptr, its, cnts, sign) -> dict:
    """key -> signed sum, from the JAX package's dense kernel run once per sign."""
    sums = {}
    k = int(np.diff(row_ptr).max())
    for s in (-1, 1):
        rows = np.flatnonzero(sign == s)
        if not len(rows):
            continue
        pad_its = np.full((len(rows), k), -1, np.int32)
        pad_cnt = np.zeros((len(rows), k), np.int32)
        for r_i, r in enumerate(rows):
            a, b = row_ptr[r], row_ptr[r + 1]
            pad_its[r_i, :b - a], pad_cnt[r_i, :b - a] = its[a:b], cnts[a:b]
        lo, hi, cv = (np.asarray(x) for x in jops.digram_pair_counts(
            jnp.asarray(pad_its), jnp.asarray(pad_cnt)))
        keys = (lo.astype(np.int64) << 32) | hi.astype(np.int64)
        for key, c in zip(keys[cv > 0].tolist(), cv[cv > 0].tolist()):
            sums[key] = sums.get(key, 0) + s * c
    return {key: c for key, c in sums.items() if c}


def _nonzero(table) -> dict:
    keys, counts = table.keys.tolist(), table.counts.tolist()
    return {key: c for key, c in zip(keys, counts) if c}


@pytest.mark.parametrize("n_rows,max_k,seed", [(40, 70, 0), (120, 12, 1), (7, 3, 2), (1, 65, 3)])
def test_pair_accum_twin_matches_pallas_kernel(n_rows, max_k, seed):
    """Signed, ragged, with empty rows and rows past the kernel's 64-item
    stage; twice into one table, so the second pass adds to the first."""
    rng = np.random.default_rng(seed)
    row_ptr, its, cnts, sign = _ragged(rng, n_rows, max_k)
    want = _pallas_sums(row_ptr, its, cnts, sign)
    table = DigramTable.sorted("cpu")
    args = [torch.from_numpy(a) for a in (row_ptr, its, cnts, sign)]
    ref.digram_pair_accum_ref(table, *args)
    assert _nonzero(table) == want
    assert torch.equal(table.keys, torch.sort(table.keys).values)
    ref.digram_pair_accum_ref(table, *args)
    assert _nonzero(table) == {key: 2 * c for key, c in want.items()}
    keys, vals = ref.digram_pairs_ref(*args)
    assert bool((vals != 0).all()) and keys.numel() == vals.numel()


def test_pair_accum_twin_empty_batch_changes_nothing():
    table = DigramTable.sorted("cpu")
    ref.digram_pair_accum_ref(table, torch.tensor([0, 2]), torch.tensor([3, 5], dtype=torch.int32),
                              torch.tensor([4, 2], dtype=torch.int32),
                              torch.tensor([1], dtype=torch.int32))
    before = _nonzero(table)
    assert before == {(3 << 32) | 3: 2, (3 << 32) | 5: 2, (5 << 32) | 5: 1}
    ref.digram_pair_accum_ref(table, torch.zeros(1, dtype=torch.int64),
                              torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32))
    assert _nonzero(table) == before


@pytest.mark.parametrize("cap", [None, 64, 3, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_accum_twin_count_matches_reference_digram_counts(cap, seed):
    """Sign +1 over every node's capped histogram: the reference's full recount."""
    rng = np.random.default_rng(seed)
    g, table = random_hypergraph(rng, n_nodes=18, n_labels=6, n_edges=140, max_rank=3)
    v, it, c = (torch.from_numpy(a) for a in ref_node_it_counts(g, table))
    row_ptr, its, cnts, _ = _capped_csr((v << 32) | it, c, torch.arange(v.numel()), cap)
    if cap is not None:
        assert int(torch.diff(row_ptr).max()) <= cap
    if cap in (2, 3):  # the cap cuts rows
        assert int(torch.bincount(v).max()) > cap
    t = DigramTable.sorted("cpu")
    ref.digram_pair_accum_ref(t, row_ptr, its, cnts,
                              torch.ones(row_ptr.numel() - 1, dtype=torch.int32))
    wk, wc = R.digram_counts(g, table, cap=cap)
    gk, gc = t.live()
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gc.numpy(), wc)


def _hashed(keys, counts, flags=None, slots=16):
    """A hashed-layout table holding (keys, counts) at scattered slots."""
    t = DigramTable.hashed(slots, "cpu")
    at = torch.randperm(slots, generator=torch.Generator().manual_seed(0))[:len(keys)]
    t.keys[at] = torch.tensor(keys, dtype=torch.int64)
    t.counts[at] = torch.tensor(counts, dtype=torch.int64)
    if flags is not None:
        t.flags[at] = torch.tensor(flags, dtype=torch.uint8)
    t.used[0] = len(keys)
    return t, at


def _sorted(keys, counts, flags=None):
    order = np.argsort(keys)
    return DigramTable(torch.tensor(keys, dtype=torch.int64)[order],
                       torch.tensor(counts, dtype=torch.int64)[order],
                       torch.tensor(flags if flags is not None else [0] * len(keys),
                                    dtype=torch.uint8)[order])


@pytest.mark.parametrize("layout", ["sorted", "hashed"])
@pytest.mark.parametrize("case,keys,counts,flags,want", [
    ("ties_smallest_key", [9, 4, 7, 12], [5, 5, 2, 5], None, (4, 5)),
    ("skipped_best", [9, 4, 7, 12], [5, 5, 6, 5], [0, SKIP, SKIP, 0], (9, 5)),
    ("popped_and_skipped", [1, 2, 3], [3, 3, 3], [2, SKIP, 0], (3, 3)),
    ("counts_not_positive", [3, 8, 5], [0, -4, 1], None, (5, 1)),
    ("all_zero", [3, 8], [0, 0], None, None),
    ("all_skipped", [3, 8], [2, 2], [SKIP, SKIP], None),
    ("empty", [], [], None, None)])
def test_select_twin(layout, case, keys, counts, flags, want):
    if layout == "hashed":
        t, _ = _hashed(keys, counts, flags)
    else:
        t = _sorted(keys, counts, flags)
    assert ref.digram_select_ref(t) == want
    key, count, slot, used = ref.digram_select_slot_ref(t).tolist()
    assert used == len(keys)
    if want is None:
        assert (key, count, slot) == (-1, 0, -1)
    else:
        assert int(t.keys[slot]) == key and int(t.counts[slot]) == count


def test_hashed_table_layout():
    t = DigramTable.hashed(1000, "cpu")
    assert t.capacity == 1024 and bool((t.keys == EMPTY).all()) and int(t.used[0]) == 0
    assert DigramTable.sorted("cpu").capacity is None
    t, _ = _hashed([5, 2], [3, -1])
    keys, counts = t.live()
    assert keys.tolist() == [5] and counts.tolist() == [3]


# -- the device counter against the reference's --------------------------
def _random_updates(rng, g, table, steps):
    """Yield (removed, added) incidence arrays of random edge replacements:
    edges removed, new edges under old and new labels added, and some
    removed edges added back (their types fall to 0 and come back)."""
    ranks = [int(r) for r in table.ranks]
    edges = [(int(lbl), g.nodes_flat[g.offsets[e]:g.offsets[e + 1]].tolist())
             for e, lbl in enumerate(g.labels)]

    def incid(es):
        offs = np.concatenate([[0], np.cumsum(ranks)])
        v = [n for _, ns in es for n in ns]
        it = [int(offs[lbl]) + m for lbl, ns in es for m in range(len(ns))]
        return np.array(v, np.int64), np.array(it, np.int64)

    for _ in range(steps):
        gone = sorted(set(rng.integers(0, len(edges), int(rng.integers(1, 6)))), reverse=True)
        removed = [edges.pop(e) for e in gone]
        if rng.random() < 0.5:
            ranks.append(int(rng.integers(1, 4)))
        new = [(lbl, rng.integers(0, g.n_nodes, ranks[lbl]).tolist())
               for lbl in rng.integers(0, len(ranks), int(rng.integers(0, 5)))]
        back = [removed[i] for i in range(len(removed)) if rng.random() < 0.5]
        added = new + back if rng.random() < 0.5 else back + new
        edges += added
        yield incid(removed), incid(added)


@pytest.mark.parametrize("cap", [None, 64, 3, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_matches_reference_counter_over_updates(cap, seed):
    rng = np.random.default_rng(seed)
    g, table = random_hypergraph(rng, n_nodes=40, n_labels=6, n_edges=90, max_rank=3)
    pg, pt = port_hypergraph(g, table)
    want = R.DigramCounter(g, table, cap=cap)
    got = DigramCounter(pg, pt, cap=cap)
    assert not any(isinstance(v, dict) for v in vars(got).values())
    skip: set = set()
    for step, (rem, add) in enumerate(_random_updates(rng, g, table, 25)):
        want.apply_delta(rem, add)
        got.apply_delta(*[tuple(torch.from_numpy(a) for a in x) for x in (rem, add)])
        wk, wc = want.as_arrays()
        gk, gc = got.as_tensors("cpu")
        np.testing.assert_array_equal(gk.numpy(), wk)
        np.testing.assert_array_equal(gc.numpy(), wc)
        best = want.pop_best(skip)
        assert got.pop_best(skip) == best
        if best is not None and step % 3 == 0:
            skip.add(best[0])  # skipped from now on, as compress and _select_digram do
            assert got.pop_best(skip) == want.pop_best(skip)


def test_counter_peek_pop_push_back_and_skip_by_key():
    rng = np.random.default_rng(5)
    g, table = random_hypergraph(rng, n_nodes=10, n_labels=4, n_edges=60, max_rank=3)
    pg, pt = port_hypergraph(g, table)
    want = R.DigramCounter(g, table, cap=3)
    got = DigramCounter(pg, pt, cap=3)
    keys, cnts = got.as_tensors("cpu")
    order = sorted(zip((-cnts).tolist(), keys.tolist()))
    walk = [got.peek_pop() for _ in range(4)]
    assert walk == [(k, -c) for c, k in order[:4]]
    for item in walk:
        got.push_back(*item)
    assert got.pop_best() == want.pop_best() == walk[0]
    # a key the selection never returned is skipped through its key
    skip = {walk[1][0], order[-1][1]}
    assert got.pop_best(skip) == want.pop_best(skip) == walk[0]
    skip.add(walk[0][0])
    assert got.pop_best(skip) == want.pop_best(skip) == walk[2]


def test_counter_rebuild_keeps_counts_and_skips():
    """The rebuild that grows a hashed table on the card: the Count of the
    current histograms, with the skipped keys flagged again."""
    rng = np.random.default_rng(6)
    g, table = random_hypergraph(rng, n_nodes=12, n_labels=5, n_edges=90, max_rank=3)
    pg, pt = port_hypergraph(g, table)
    got = DigramCounter(pg, pt, cap=3)
    for rem, add in _random_updates(rng, g, table, 5):
        got.apply_delta(*[tuple(torch.from_numpy(a) for a in x) for x in (rem, add)])
    skip = {got.pop_best()[0]}
    best = got.pop_best(skip)
    before = got.as_tensors("cpu")
    got._rebuild(0)
    for a, b in zip(got.as_tensors("cpu"), before):
        assert torch.equal(a, b)
    assert got.pop_best(skip) == best


@pytest.mark.parametrize("config", [
    dict(cap=None), dict(cap=64), dict(cap=3), dict(cap=2), dict(selection="savings"),
    dict(min_count=4), dict(max_rank=3)], ids=str)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_compress_matches_reference(name, config):
    (rg, rt), (pg, pt) = both_graphs(DATASETS[name]())
    ref_grammar, rstats = R.compress(rg, rt, R.RepairConfig(**config))
    grammar, pstats = P.compress(pg, pt, P.RepairConfig(**config))
    assert vars(pstats) == vars(rstats)
    assert_same_grammar(ref_grammar, grammar)


def test_cuda_wrappers_refuse_cpu_tensors():
    t = DigramTable.hashed(16, "cpu")
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        digram_pair_accum_cuda(t, torch.zeros(2, dtype=torch.int64), one, one, one)
    with pytest.raises(ValueError):
        digram_select_cuda(t)
    with pytest.raises(ValueError):  # the kernel takes only a hashed table
        digram_select_cuda(DigramTable.sorted("cpu"))
