"""The port's neighbour sampler against the JAX package's, on the CPU.

Both samplers take the same uniforms: the port draws them from a
``torch.Generator`` (its default) and records them, and the reference takes
a stub ``rng`` whose ``random(n)`` returns those draws in turn. The
batches must then be equal array for array: node ids, seeds, and each
block's senders, receivers and sizes. Exact: integer work on the same
float64 draws.
"""
import numpy as np
import pytest
import torch

import tests.test_baselines_data as ref_suite
from repro.data import GraphStore as RefStore
from repro.data import NeighborSampler as RefSampler
from repro.data.synthetic import rdf_like, web_graph
from repro_torch.data import GraphStore, NeighborSampler, SampledBatch
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _Replay:
    """A numpy-Generator stand-in whose ``random(n)`` returns given draws."""

    def __init__(self, draws):
        self.draws = list(draws)

    def random(self, n):
        out = self.draws.pop(0)
        assert len(out) == n
        return out


def _sample_both(indptr, indices, fanouts, seeds, seed=0):
    port = NeighborSampler(torch.from_numpy(indptr), torch.from_numpy(indices), fanouts)
    gen = torch.Generator().manual_seed(seed)
    draws = []

    def record(n):
        u = NeighborSampler.draw(n, gen)
        draws.append(u.numpy().copy())
        return u

    got = port.sample(torch.from_numpy(seeds), uniforms=record)
    want = RefSampler(indptr, indices, fanouts).sample(seeds, _Replay(draws))
    return got, want


def _assert_same_batch(got: SampledBatch, want):
    np.testing.assert_array_equal(got.node_ids.numpy(), want.node_ids)
    np.testing.assert_array_equal(got.seeds.numpy(), want.seeds)
    assert len(got.blocks) == len(want.blocks)
    for g, w in zip(got.blocks, want.blocks):
        np.testing.assert_array_equal(g.senders.numpy(), w.senders)
        np.testing.assert_array_equal(g.receivers.numpy(), w.receivers)
        assert (g.n_src, g.n_dst) == (w.n_src, w.n_dst)


def _csr(rng, n, degrees):
    """A CSR whose row v holds degrees[v] random neighbours (repeats allowed)."""
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    return indptr, rng.integers(0, n, int(indptr[-1])).astype(np.int64)


@pytest.mark.parametrize("case", ["isolated", "below_fanout", "above_fanout", "mixed"])
@pytest.mark.parametrize("fanouts", [(15, 10), (3,), (2, 2, 2)])
def test_plain_csr_batches_equal_the_reference(case, fanouts):
    rng = np.random.default_rng(len(case) + len(fanouts))
    n = 300
    deg = {"isolated": np.where(rng.random(n) < 0.5, 0, rng.integers(1, 4, n)),
           "below_fanout": rng.integers(1, 3, n),
           "above_fanout": rng.integers(20, 60, n),
           "mixed": rng.choice([0, 1, 5, 15, 16, 40], n)}[case]
    indptr, indices = _csr(rng, n, deg)
    seeds = rng.choice(n, 32, replace=False)
    got, want = _sample_both(indptr, indices, fanouts, seeds, seed=len(case))
    _assert_same_batch(got, want)


@pytest.mark.parametrize("ds", ["web_graph", "rdf_like"])
def test_graph_store_csc_batches_equal_the_reference(ds):
    d = {"web_graph": lambda: web_graph(n_nodes=500, n_edges=3000, seed=9),
         "rdf_like": lambda: rdf_like(n_nodes=400, n_edges=2000, n_preds=4, seed=2)}[ds]()
    ref = RefStore.from_triples(d.triples, d.n_nodes, d.n_preds)
    port = GraphStore.from_triples(d.triples, d.n_nodes, d.n_preds, device="cpu")
    r_indptr, r_indices = ref.csc()
    p_indptr, p_indices = port.csc()
    np.testing.assert_array_equal(p_indptr.numpy(), r_indptr)
    np.testing.assert_array_equal(p_indices.numpy(), r_indices)
    seeds = np.random.default_rng(0).choice(d.n_nodes, 64, replace=False)
    got, want = _sample_both(r_indptr, r_indices, (15, 10), seeds, seed=3)
    _assert_same_batch(got, want)


def test_sampled_edges_are_edges_and_respect_the_fanout():
    d = web_graph(n_nodes=500, n_edges=3000, seed=9)
    indptr, indices = GraphStore.from_triples(d.triples, d.n_nodes, d.n_preds,
                                              device="cpu").csc()
    batch = NeighborSampler(indptr, indices, (15, 10)).sample(
        torch.arange(0, 500, 7), torch.Generator().manual_seed(1))
    edges = {(v, int(u)) for v in range(d.n_nodes)
             for u in indices[indptr[v]:indptr[v + 1]].tolist()}
    ids = batch.node_ids
    assert torch.equal(ids, torch.unique(ids)) and bool(torch.isin(batch.seeds, ids).all())
    for blk, fan in zip(batch.blocks, (15, 10)):
        pairs = list(zip(ids[blk.receivers].tolist(), ids[blk.senders].tolist()))
        assert set(pairs) <= edges and len(set(pairs)) == len(pairs)
        assert int(torch.bincount(blk.receivers).max()) <= fan


def test_draws_come_from_the_generator():
    indptr, indices = _csr(np.random.default_rng(0), 50, np.full(50, 30))
    s = NeighborSampler(torch.from_numpy(indptr), torch.from_numpy(indices), (5,))
    a = s.sample(torch.arange(10), torch.Generator().manual_seed(7))
    b = s.sample(torch.arange(10), torch.Generator().manual_seed(7))
    c = s.sample(torch.arange(10), torch.Generator().manual_seed(8))
    assert torch.equal(a.blocks[0].senders, b.blocks[0].senders)
    assert not torch.equal(a.blocks[0].senders, c.blocks[0].senders)


class _PortStore:
    @staticmethod
    def from_triples(triples, n_nodes, n_preds):
        return GraphStore.from_triples(triples, n_nodes, n_preds, device="cpu")


class _PortSampler:
    """The port's sampler behind the reference's ``sample(seeds, rng)``: the
    numpy generator's draws feed it."""

    def __init__(self, indptr, indices, fanouts):
        self.sampler = NeighborSampler(torch.as_tensor(indptr), torch.as_tensor(indices),
                                       fanouts)

    def sample(self, seeds, rng):
        return self.sampler.sample(seeds, uniforms=lambda n: torch.from_numpy(rng.random(n)))


def test_reference_fanout_test_on_the_port(monkeypatch):
    monkeypatch.setattr(ref_suite, "GraphStore", _PortStore)
    monkeypatch.setattr(ref_suite, "NeighborSampler", _PortSampler)
    ref_suite.test_neighbor_sampler_fanout()
