"""End-to-end training: a GatedGCN trained from an ITR-compressed
GraphStore, on the device. The port's counterpart of the reference's
``examples/train_gnn_compressed.py``, with its flow and defaults.

The compressed graph is the data layer: the store holds the graph as an
SL-HR grammar, the neighbour sampler draws fanout batches from its CSC,
and a GatedGCN trains for ``total_steps`` steps with a checkpoint every
``checkpoint_every`` steps, an injected worker failure at ``fail_at``, and
the restore: a fresh model, ``maybe_restore``, and a run to the end.

Every batch is built on the device: seeds drawn by ``randperm`` from a
``torch.Generator``, features and labels gathered from tables on the
device, the seed mask from a ``searchsorted``, the edges padded to
``e_pad`` on a dummy node, and the batch's :class:`EdgeCSR` built once.

    PYTHONPATH=src python -m repro_torch.launch.gnn_compressed [--device cpu]

Graph, widths and seeds are arguments of :func:`main`; the defaults are the
example's (a 2,000-node web graph, 32 features, 7 classes, 64 seeds,
fanouts (15, 10), the reduced GatedGCN, 300 steps).
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data import GraphStore, NeighborSampler, web_graph
from repro_torch.device import resolve_device
from repro_torch.models.gnn import EdgeCSR, GatedGCN, gatedgcn_loss
from repro_torch.train import (AdamWConfig, FailureInjector, Trainer, TrainerConfig,
                               WorkerFailure)

D_EDGE = 4  # zero edge features, as in the example


def pad_sizes(n_nodes: int, seeds: int, fanouts: tuple) -> tuple[int, int]:
    """(n_pad, e_pad): the example's padded batch, min(n_nodes + 1, seeds *
    (1 + f1 + f1 f2)) nodes and seeds * f1 * (1 + f2) edges, the most two
    hops can sample."""
    f1, f2 = fanouts
    return min(n_nodes + 1, seeds * (1 + f1 + f1 * f2)), seeds * f1 * (1 + f2)


def make_batches(sampler: NeighborSampler, feats: torch.Tensor, labels: torch.Tensor,
                 generator: torch.Generator, seeds: int, n_pad: int, e_pad: int):
    """Endless padded batches {"x", "ef", "senders", "receivers", "y",
    "mask", "csr"} of ``n_pad`` nodes and ``e_pad`` edges; padded edges
    point at the dummy node ``n_pad - 1``."""
    dev = feats.device
    n_nodes = feats.shape[0]
    dummy = n_pad - 1
    while True:
        seed_ids = torch.randperm(n_nodes, generator=generator, device=dev)[:seeds]
        batch = sampler.sample(seed_ids, generator)
        senders = torch.cat([b.senders for b in batch.blocks])[:e_pad]
        receivers = torch.cat([b.receivers for b in batch.blocks])[:e_pad]
        n, e = batch.node_ids.numel(), senders.numel()
        x = torch.zeros((n_pad, feats.shape[1]), device=dev)
        x[:n] = feats[batch.node_ids]
        y = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        y[:n] = labels[batch.node_ids]
        mask = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        mask[torch.searchsorted(batch.node_ids, batch.seeds)] = True
        s_pad = torch.full((e_pad,), dummy, dtype=torch.int64, device=dev)
        r_pad = torch.full((e_pad,), dummy, dtype=torch.int64, device=dev)
        s_pad[:e], r_pad[:e] = senders, receivers
        yield {"x": x, "ef": torch.zeros((e_pad, D_EDGE), device=dev), "senders": s_pad,
               "receivers": r_pad, "y": y, "mask": mask,
               "csr": EdgeCSR.from_receivers(r_pad, n_pad)}


def main(device=None, *, store: GraphStore | None = None, n_nodes: int = 2000,
         n_edges: int = 12000, graph_seed: int = 0, d_feat: int = 32, n_classes: int = 7,
         seeds: int = 64, fanouts: tuple = (15, 10), cfg=None, total_steps: int = 300,
         checkpoint_every: int = 50, log_every: int = 50, fail_at: int | None = 120,
         lr: float = 3e-3, warmup_steps: int = 20, seed: int = 0,
         checkpoint_dir: str | None = None, keep_checkpoints: int = 3, out=print) -> dict:
    """Run the example's flow on ``device`` (None: CUDA). ``store`` is the
    graph (default: the example's web graph, compressed here); ``cfg`` the
    GatedGCN config (default: the registry's reduced one). Checkpoints go to
    ``checkpoint_dir``, or to a temporary directory removed at the end; the
    last ``keep_checkpoints`` stay.

    Returns {"log": the restored trainer's log, "first_log": the first
    trainer's, "failed_at", "restored_step", "restore_s", "trainer",
    "first_trainer" (the one that failed), "model", "store", "n_pad",
    "e_pad"}."""
    dev = resolve_device(device)
    if store is None:
        ds = web_graph(n_nodes=n_nodes, n_edges=n_edges, seed=graph_seed)
        store = GraphStore.from_triples(ds.triples, ds.n_nodes, ds.n_preds, device=dev)
        out(f"GraphStore: |V|={store.n_nodes} |E|={ds.n_triples} "
            f"compressed={store.compressed_size_bytes()} bytes "
            f"({store.stats.rules_created} grammar rules)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    indptr, indices = store.csc()
    sampler = NeighborSampler(indptr, indices, fanouts=fanouts)
    feats = torch.randn((store.n_nodes, d_feat), generator=gen, device=dev)
    labels = torch.randint(0, n_classes, (store.n_nodes,), generator=gen, device=dev)
    cfg = cfg or get_arch("gatedgcn").reduced()
    model = GatedGCN.from_config(cfg, d_feat, D_EDGE, n_classes, device=dev, seed=seed)
    own_dir = checkpoint_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="gnn_ckpt_") if own_dir else checkpoint_dir
    tc = TrainerConfig(total_steps=total_steps, checkpoint_every=checkpoint_every,
                       log_every=log_every, checkpoint_dir=ckpt_dir,
                       keep_checkpoints=keep_checkpoints,
                       opt=AdamWConfig(lr=lr, warmup_steps=warmup_steps,
                                       total_steps=total_steps))
    injector = FailureInjector({fail_at: [0]} if fail_at is not None else {})
    trainer = Trainer(lambda b: gatedgcn_loss(model, b), model.leaves(), tc,
                      failure_injector=injector)
    n_pad, e_pad = pad_sizes(store.n_nodes, seeds, fanouts)
    data = make_batches(sampler, feats, labels, gen, seeds, n_pad, e_pad)
    res = {"failed_at": None, "restored_step": None, "restore_s": None, "first_log": [],
           "first_trainer": None,
           "store": store, "n_pad": n_pad, "e_pad": e_pad}
    try:
        try:
            trainer.run(data)
        except WorkerFailure as e:
            out(f"!! {e}: restoring from checkpoint")
            res["failed_at"], res["first_log"] = e.step, trainer.metrics_log
            res["first_trainer"] = trainer
            # a fresh worker: a fresh model, then the checkpoint copied into it
            model = GatedGCN.from_config(cfg, d_feat, D_EDGE, n_classes, device=dev,
                                         seed=seed + 1)
            trainer = Trainer(lambda b: gatedgcn_loss(model, b), model.leaves(), tc)
            t0 = time.perf_counter()
            if not trainer.maybe_restore():
                raise RuntimeError(f"no checkpoint under {ckpt_dir} to restore") from e
            res["restore_s"] = time.perf_counter() - t0
            res["restored_step"] = trainer.step
            out(f"   restored at step {trainer.step}")
            trainer.run(data, steps=tc.total_steps - trainer.step)
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    log = trainer.metrics_log
    for rec in log:
        out(f"  step {rec['step']:>4} loss {rec['loss']:.4f}")
    if log:
        first, last = log[0]["loss"], log[-1]["loss"]
        out(f"loss {first:.3f} -> {last:.3f} ({'improved' if last < first else 'WORSE'})")
    res.update(log=log, trainer=trainer, model=model)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=120)
    a = ap.parse_args()
    main(a.device, total_steps=a.steps, fail_at=a.fail_at)
