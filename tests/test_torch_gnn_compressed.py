"""The port's counterpart of ``examples/train_gnn_compressed.py``
(``repro_torch.launch.gnn_compressed``) on the CPU, at the example's sizes
with fewer steps: the injected failure, the restore from the last
committed checkpoint, and a loss that falls; and its padded batches."""
import numpy as np
import torch

from repro_torch.data import GraphStore, NeighborSampler, web_graph
from repro_torch.launch import gnn_compressed as gc
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_pad_sizes_are_the_examples():
    assert gc.pad_sizes(2000, 64, (15, 10)) == (2001, 10560)
    assert gc.pad_sizes(46107, 1024, (15, 10)) == (46108, 168960)
    assert gc.pad_sizes(10**6, 64, (15, 10)) == (64 * 166, 10560)


def test_batches_are_padded_on_the_dummy_node():
    ds = web_graph(n_nodes=300, n_edges=1500, seed=1)
    store = GraphStore.from_triples(ds.triples, ds.n_nodes, ds.n_preds, device="cpu")
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn((store.n_nodes, 5), generator=gen)
    labels = torch.randint(0, 3, (store.n_nodes,), generator=gen)
    n_pad, e_pad = gc.pad_sizes(store.n_nodes, 16, (4, 3))
    sampler = NeighborSampler(*store.csc(), fanouts=(4, 3))
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    b = next(gc.make_batches(sampler, feats, labels, gen, 16, n_pad, e_pad))
    seeds = torch.randperm(store.n_nodes, generator=replay)[:16]
    want = sampler.sample(seeds, replay)
    n = want.node_ids.numel()
    assert torch.equal(b["x"][:n], feats[want.node_ids]) and not bool(b["x"][n:].any())
    assert torch.equal(b["y"][:n], labels[want.node_ids]) and not bool(b["y"][n:].any())
    assert torch.equal(torch.nonzero(b["mask"]).reshape(-1),
                       torch.searchsorted(want.node_ids, seeds).sort().values)
    e = sum(blk.senders.numel() for blk in want.blocks)
    assert torch.equal(b["senders"][:e], torch.cat([blk.senders for blk in want.blocks]))
    assert torch.equal(b["receivers"][:e], torch.cat([blk.receivers for blk in want.blocks]))
    assert b["x"].shape == (n_pad, 5) and b["senders"].shape == (e_pad,)
    assert bool((b["receivers"][e:] == n_pad - 1).all())
    assert bool((b["senders"][e:] == n_pad - 1).all())
    assert int(b["csr"].fwd.row_lengths()[-1]) == e_pad - e

def test_main_fails_restores_and_the_loss_falls():
    res = gc.main("cpu", total_steps=40, checkpoint_every=10, log_every=10, fail_at=25,
                  warmup_steps=5, out=lambda *_: None)
    assert res["failed_at"] == 25 and res["restored_step"] == 20
    assert [r["step"] for r in res["first_log"]] == [10, 20]
    assert [r["step"] for r in res["log"]] == [30, 40]
    assert res["trainer"].step == 40 and res["restore_s"] > 0
    losses = [r["loss"] for r in res["first_log"] + res["log"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
