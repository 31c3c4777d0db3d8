"""The port's baselines (k²-triples, HDT Bitmap-Triples, the N-Triples size
model) against the JAX package's, on the CPU.

Every query's list must equal the reference's in order (exactly: Python
ints), for all eight patterns, and every size must equal the reference's
integer. The reference's own parity and size tests also run on the port's
classes.
"""
import numpy as np
import pytest
import torch

import tests.test_baselines_data as ref_suite
from repro.baselines import HDTBitmapTriples as RefHDT
from repro.baselines import K2Triples as RefK2
from repro.baselines import ntriples_size_bytes as ref_ntriples
from repro.data.synthetic import PAPER_DATASETS, rdf_like, version_graph
from repro_torch.baselines import HDTBitmapTriples, K2Triples, ntriples_size_bytes
from repro_torch.core.succinct import BitVector
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERNS = ["spo", "sp?", "s?o", "s??", "?po", "?p?", "??o", "???"]
DATASETS = {
    "rdf_like": lambda: rdf_like(n_nodes=80, n_edges=300, n_preds=5, seed=1),
    "version_graph": lambda: version_graph(n_groups=100, seed=3),
    "geo-coordinates-en@0.1": lambda: PAPER_DATASETS["geo-coordinates-en"](scale=0.1, seed=0),
}


@pytest.fixture(scope="module", params=list(DATASETS))
def built(request):
    ds = DATASETS[request.param]()
    return (ds, (RefK2(ds.triples, ds.n_nodes, ds.n_preds),
                 RefHDT(ds.triples, ds.n_nodes, ds.n_preds)),
            (K2Triples(ds.triples, ds.n_nodes, ds.n_preds, device="cpu"),
             HDTBitmapTriples(ds.triples, ds.n_nodes, ds.n_preds, device="cpu")))


def _queries(ds, pattern, n=4):
    """n triples of the dataset and one with an absent subject and object,
    bound as the pattern says."""
    rng = np.random.default_rng(len(pattern) + ord(pattern[1]))
    rows = [tuple(int(x) for x in ds.triples[i]) for i in rng.integers(0, ds.n_triples, n)]
    no_out = sorted(set(range(ds.n_nodes)) - set(ds.triples[:, 0].tolist()))
    no_in = sorted(set(range(ds.n_nodes)) - set(ds.triples[:, 2].tolist()))
    if no_out and no_in:
        rows.append((no_out[0], 0, no_in[0]))
    if pattern in ("?p?", "???"):  # no S or O bound; the reference scans every node
        rows = rows[:1]
    return [tuple(v if pattern[i] != "?" else None for i, v in enumerate(r)) for r in rows]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_query_lists_equal_the_reference_in_order(built, pattern):
    ds, refs, ports = built
    for q in _queries(ds, pattern):
        for ref, port in zip(refs, ports):
            want = [(int(p), (int(s), int(o))) for p, (s, o) in ref.query(*q)]
            got = port.query(*q)
            assert got == want, (type(port).__name__, pattern, q)
            assert all(type(v) is int for p, (s, o) in got for v in (p, s, o))


def test_sizes_equal_the_reference(built):
    ds, refs, ports = built
    for ref, port in zip(refs, ports):
        assert port.size_in_bytes() == ref.size_in_bytes(), type(port).__name__
    assert ntriples_size_bytes(ds.triples) == ref_ntriples(ds.triples)


def test_hdt_layers_equal_the_reference(built):
    _, (_, ref), (_, port) = built
    for name in ("Sp", "So", "subjects"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), getattr(ref, name))
    for name in ("Bp", "Bo"):
        assert getattr(port, name).n == getattr(ref, name).n
        np.testing.assert_array_equal(getattr(port, name).words.numpy(),
                                      np.asarray(getattr(ref, name).words, np.int64))


def test_a_flipped_bo_bit_changes_the_answers():
    ds = rdf_like(n_nodes=80, n_edges=300, n_preds=5, seed=1)
    hdt = HDTBitmapTriples(ds.triples, ds.n_nodes, ds.n_preds, device="cpu")
    want = hdt.query(None, None, None)
    words = hdt.Bo.words.clone()
    words[0] ^= 1 << 3  # a run end moves
    hdt.Bo = BitVector.from_words(words, hdt.Bo.n)
    try:
        got = hdt.query(None, None, None)
    except IndexError:
        got = None
    assert got != want


def _port_classes_on_the_cpu(monkeypatch):
    monkeypatch.setattr(ref_suite, "K2Triples",
                        lambda t, n, p: K2Triples(t, n, p, device="cpu"))
    monkeypatch.setattr(ref_suite, "HDTBitmapTriples",
                        lambda t, n, p: HDTBitmapTriples(t, n, p, device="cpu"))
    monkeypatch.setattr(ref_suite, "ntriples_size_bytes", ntriples_size_bytes)


def test_reference_parity_test_on_the_port(monkeypatch):
    _port_classes_on_the_cpu(monkeypatch)
    ref_suite.test_baseline_query_parity(rdf_like(n_nodes=80, n_edges=300, n_preds=5, seed=1))


def test_reference_sizes_test_on_the_port(monkeypatch):
    _port_classes_on_the_cpu(monkeypatch)
    ref_suite.test_baseline_sizes_positive(rdf_like(n_nodes=80, n_edges=300, n_preds=5, seed=1))


def test_entry_points_take_the_device():
    k2 = K2Triples(np.array([[0, 0, 1]]), 2, 1, device="cpu")
    hdt = HDTBitmapTriples(np.array([[0, 0, 1]]), 2, 1, device="cpu")
    assert k2.trees[0].device == hdt.device == torch.device("cpu")


@pytest.mark.parametrize("n", [1, 33, 4097])
def test_unchecked_select1_equals_select1(n):
    """HDT-BT's run lookups use ``BitVector._select1``, the lookup without
    its range check: it equals ``select1`` over every set bit."""
    bits = np.random.default_rng(n).integers(0, 2, n)
    bits[0] = 1
    bv = BitVector(torch.from_numpy(bits))
    j = torch.arange(bv.n_ones)
    assert torch.equal(bv._select1(j), bv.select1(j))
    assert torch.equal(bv._select1(j[-1:]).reshape(()), bv.select1(j[-1]))
