"""The port's query engine against the reference engine, on the CPU.

On the same triples, all eight (S, P, O) patterns must give the same
canonically sorted results as ``repro.core.TripleQueryEngine`` with
``cache=None, crossover=0, delta_budget=None``, both for an engine the port
builds itself and for one made by ``from_numpy_state`` from the reference
engine's snapshot arrays. Batches hold duplicates, out-of-range ids and
unbound slots; the empty batch is covered too.
"""
import json

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.persist.snapshot import MANIFEST, save_snapshot
from tests.test_torch_build import DATASETS, both_graphs
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERNS = ["s??", "?p?", "??o", "sp?", "s?o", "?po", "spo", "???"]


def _engines(name):
    ds = DATASETS[name]()
    (rg, rt), (pg, pt) = both_graphs(ds)
    ref_g, _ = R.compress(rg, rt)
    port_g, _ = P.compress(pg, pt)
    ref = R.TripleQueryEngine(ref_g, cache=None, crossover=0, delta_budget=None)
    return ds, ref, P.TripleQueryEngine(port_g, cache=None, delta_budget=None)


@pytest.fixture(scope="module", params=sorted(DATASETS))
def engines(request):
    return _engines(request.param)


def _batch(ds, pattern, n=40, seed=0):
    """n queries of `pattern` drawn from the triples, with duplicates and
    out-of-range ids mixed in; -1 marks unbound."""
    rng = np.random.default_rng(seed)
    pick = ds.triples[rng.integers(0, len(ds.triples), n)].copy()
    dup = min(5, n // 2)
    pick[n // 2:n // 2 + dup] = pick[:dup]           # duplicates
    pick[-1] = [ds.n_nodes + 3, ds.n_preds + 2, ds.n_nodes + 9]  # out of range
    pick[-2] = [ds.n_nodes, 0, 0]
    return [pick[:, i] if pattern[i] != "?" else np.full(n, -1, np.int64) for i in range(3)]


def _rows(qids, labels, nodes, offsets):
    t = [torch.as_tensor(np.asarray(a)) for a in (qids, labels, nodes, offsets)]
    return P.result_rows(*t).cpu()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_all_patterns_match_reference(engines, pattern):
    ds, ref, port = engines
    n = 4 if pattern == "???" else 40
    cols = _batch(ds, pattern, n=n)
    want = _rows(*ref.query_batch_view(*cols).materialize())
    view = port.query_batch_view(*(torch.from_numpy(c) for c in cols))
    got = _rows(*view.materialize())
    assert torch.equal(got, want)
    oracle = P.query_oracle(torch.from_numpy(ds.triples), *(torch.from_numpy(c) for c in cols))
    assert torch.equal(got, oracle)
    np.testing.assert_array_equal(
        view.result_counts().numpy(), ref.query_batch_view(*cols).result_counts())
    arrays = port.query_batch_arrays(*(torch.from_numpy(c) for c in cols))
    assert torch.equal(_rows(*arrays), _rows(*ref.query_batch_arrays(*cols)))


def test_single_query_and_list_inputs(engines):
    ds, ref, port = engines
    s, p, o = (int(x) for x in ds.triples[7])
    for q in ([s], [None], [None]), ([None], [p], [o]), ([s], [p], [o]):
        want = _rows(*ref.query_batch_view(*q).materialize())
        view = port.query_batch_view(*q)
        assert view.n_queries == 1
        assert torch.equal(_rows(*view.materialize()), want)
        labels, nodes, offsets = view.entry(0)
        assert labels.numel() == int(view.result_counts()[0])
        assert offsets[0] == 0 and offsets[-1] == nodes.numel()


def test_empty_batch(engines):
    _, _, port = engines
    empty = torch.zeros(0, dtype=torch.int64)
    view = port.query_batch_view(empty, empty, empty)
    assert view.n_queries == 0 and view.total_results() == 0
    q, lbl, nodes, off = port.query_batch_arrays([], [], [])
    assert q.numel() == lbl.numel() == nodes.numel() == 0 and off.tolist() == [0]
    with pytest.raises(ValueError):
        port.query_batch_view(None, None, None)


def test_concat_ragged_matches_reference():
    rng = np.random.default_rng(3)
    chunks = []
    for n in (3, 0, 5, 1):
        ranks = rng.integers(1, 4, n)
        chunks.append((rng.integers(0, 9, n), rng.integers(0, 50, int(ranks.sum())),
                       np.concatenate([[0], np.cumsum(ranks)])))
    want = R.concat_ragged(chunks)
    got = P.concat_ragged([tuple(torch.from_numpy(a) for a in c) for c in chunks], "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    empty = P.concat_ragged([], "cpu")
    assert [t.tolist() for t in empty] == [[], [], [0]]


def _load_reference_state(engine, tmp_path):
    """The reference engine's snapshot as plain arrays plus manifest."""
    d = save_snapshot(engine, tmp_path / "snap")
    with open(tmp_path / "snap" / MANIFEST) as f:
        meta = json.load(f)
    arrays = {name[:-len(".npy")]: np.load(tmp_path / "snap" / name)
              for name in meta["checksums"]}
    assert d
    return arrays, meta


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_from_numpy_state_answers_like_reference(name, tmp_path):
    ds, ref, _ = _engines(name)
    arrays, meta = _load_reference_state(ref, tmp_path)
    port = P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu", cache=None)
    assert port.grammar is None and port.T == ref.T
    for pattern in PATTERNS:
        cols = _batch(ds, pattern, n=4 if pattern == "???" else 30, seed=5)
        want = _rows(*ref.query_batch_view(*cols).materialize())
        got = _rows(*port.query_batch_view(*(torch.from_numpy(c) for c in cols)).materialize())
        assert torch.equal(got, want), pattern


def test_from_numpy_state_rejects_unsorted_start(tmp_path):
    ds, ref, _ = _engines("version_graph")
    arrays, meta = _load_reference_state(ref, tmp_path)
    arrays["start_labels"] = arrays["start_labels"][::-1].copy()
    with pytest.raises(ValueError):
        P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu", cache=None)
