"""Seeded graphs and batches at a GNN shape's sizes, drawn on the device:
whole graphs (:func:`node_graph`), batches of small molecules
(:func:`molecule_graph`), sampled minibatches of a large graph
(:func:`csc` and :func:`sampled_batch`) and the inputs an architecture
adds to them (:func:`edge_features`, :func:`node_targets`,
:func:`atoms`).

The datasets the shapes name (Cora, ogbn-products) are not in the
repository, so the cells train on graphs of exactly their sizes drawn from
a seed. Both datasets are undirected (ogbn-products is Amazon's product
co-purchase graph, Hu et al., arXiv:2005.00687), so the graph is
symmetric: half the published edge count is drawn as node pairs, and each
pair becomes two edges, one each way. A node's in-degree is then its
out-degree, and the forward and transposed CSRs have the same row lengths.

The degree law is Chung and Lu's random graph with given expected degrees
(PNAS 99(25), 2002) at power-law exponent beta = 3, the exponent of
preferential attachment (Barabasi and Albert, Science 286, 1999): each
endpoint of a pair is node ``perm[i]`` with probability proportional to
``(i + 1) ** (-1 / (beta - 1))``, for a seeded permutation ``perm``. The
mean degree is the published edge count over the node count (25.26 at
ogb_products, 3.90 at full_graph_sm), and the heaviest node expects
``E / sum_i (i + 1) ** -0.5`` edges each way (about 19,770 at ogb_products,
103 at full_graph_sm). beta is not measured on either dataset: no degree
statistic of them beyond their node and edge counts is in the repository,
so a time that depends on the longest row describes this law, not the
dataset. A pair may repeat or join a node to itself, as in Chung and Lu's
graph; an odd edge count leaves the last pair one edge.

Features are standard normal and labels uniform over the classes on the
published nodes. The sizes are padded to the reference's multiples of 256:
padding nodes have zero features and label -1, and the edges past the
published count carry sender -1, the reference's padding convention.

A molecule batch (the ``molecule`` shape) is ``molecules`` graphs of
``mol_nodes`` nodes and ``mol_edges`` directed edges each, laid out one
after another: each molecule's edges are ``mol_edges / 2`` node pairs
drawn uniformly within it, one edge each way (a pair may join a node to
itself), and ``graph_ids`` names each node's molecule. A sampled
minibatch (``minibatch_lg``) is one draw of the fanout sampler over a
graph's CSC, its nodes and edges padded to the reference's batch sizes;
its padded edges carry sender -1 and receiver -1, which the reference's
gather masks and its ``segment_sum`` drops, so no node collects them.
"""
from __future__ import annotations

import torch

BETA = 3.0  # the degree distribution's power-law exponent, see the module docstring
N_SPECIES = 64  # atom types of the GNN cells' NequIP (the reference cell's nequip_init)


def node_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int, *,
               real_nodes: int, real_edges: int,
               generator: torch.Generator) -> dict:
    """{"x", "y", "senders", "receivers"} on the generator's device: x
    (n_nodes, d_feat) float32, y (n_nodes,) int64, senders and receivers
    (n_edges,) int64. Nodes past ``real_nodes`` and edges past
    ``real_edges`` are padding."""
    if not (0 < real_nodes <= n_nodes and 0 <= real_edges <= n_edges):
        raise ValueError("need 0 < real_nodes <= n_nodes and 0 <= real_edges <= n_edges")
    dev = generator.device
    x = torch.zeros((n_nodes, d_feat), device=dev)
    x[:real_nodes] = torch.randn((real_nodes, d_feat), generator=generator, device=dev)
    y = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    y[:real_nodes] = torch.randint(0, n_classes, (real_nodes,), generator=generator, device=dev)

    n_pairs = (real_edges + 1) // 2
    weight = torch.arange(1, real_nodes + 1, device=dev, dtype=torch.float64)
    cum = weight.pow_(-1.0 / (BETA - 1.0)).cumsum_(0)
    u = torch.rand((2, n_pairs), generator=generator, device=dev, dtype=torch.float64)
    rank = torch.searchsorted(cum, u.mul_(cum[-1])).clamp_(max=real_nodes - 1)
    perm = torch.randperm(real_nodes, generator=generator, device=dev)
    a, b = perm[rank]
    senders = torch.full((n_edges,), -1, dtype=torch.int64, device=dev)
    receivers = torch.zeros((n_edges,), dtype=torch.int64, device=dev)
    senders[:real_edges] = torch.cat([a, b])[:real_edges]
    receivers[:real_edges] = torch.cat([b, a])[:real_edges]
    return {"x": x, "y": y, "senders": senders, "receivers": receivers}


def molecule_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int, *,
                   molecules: int, mol_nodes: int, mol_edges: int,
                   generator: torch.Generator) -> dict:
    """{"x", "y", "senders", "receivers", "graph_ids"} on the generator's
    device for ``molecules`` molecules (see the module docstring), padded
    to ``n_nodes`` nodes and ``n_edges`` edges: x (n_nodes, d_feat)
    float32 standard normal, y (n_nodes,) int64 uniform over the classes,
    graph_ids (n_nodes,) int64 ``node // mol_nodes``; padding nodes have
    zero features, label -1 and graph id -1, padding edges sender and
    receiver -1."""
    real_n, real_e = molecules * mol_nodes, molecules * mol_edges
    if not (molecules > 0 and mol_edges % 2 == 0 and real_n <= n_nodes and real_e <= n_edges):
        raise ValueError(f"{molecules} molecules of {mol_nodes} nodes and {mol_edges} edges "
                         f"(an even count) do not fit {n_nodes} nodes and {n_edges} edges")
    dev = generator.device
    x = torch.zeros((n_nodes, d_feat), device=dev)
    x[:real_n] = torch.randn((real_n, d_feat), generator=generator, device=dev)
    y = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    y[:real_n] = torch.randint(0, n_classes, (real_n,), generator=generator, device=dev)
    ends = torch.randint(0, mol_nodes, (2, molecules, mol_edges // 2), generator=generator,
                         device=dev)
    ends += torch.arange(molecules, device=dev)[:, None] * mol_nodes
    a, b = ends
    senders = torch.full((n_edges,), -1, dtype=torch.int64, device=dev)
    receivers = torch.full((n_edges,), -1, dtype=torch.int64, device=dev)
    senders[:real_e] = torch.cat([a, b], 1).reshape(-1)
    receivers[:real_e] = torch.cat([b, a], 1).reshape(-1)
    graph_ids = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    graph_ids[:real_n] = torch.arange(real_n, device=dev) // mol_nodes
    return {"x": x, "y": y, "senders": senders, "receivers": receivers, "graph_ids": graph_ids}


def csc(senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int) -> tuple:
    """(indptr (n_nodes + 1,), indices) int64 of the edges by receiver:
    row ``dst`` lists the senders of its in-edges in edge order, the view
    :class:`repro_torch.data.NeighborSampler` samples."""
    order = torch.argsort(receivers, stable=True)
    indices = senders[order]
    del order
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=receivers.device)
    indptr[1:] = torch.cumsum(torch.bincount(receivers, minlength=n_nodes), 0)
    return indptr, indices


def sampled_batch(sampler, seeds: torch.Tensor, tables: dict, n_pad: int, e_pad: int,
                  generator: torch.Generator) -> dict:
    """One sample of ``sampler`` from ``seeds`` padded to ``n_pad`` nodes and
    ``e_pad`` edges: {"senders", "receivers"} (int64, both blocks' edges
    in hop order, padding -1 at both ends), "seed_mask" (n_pad,) bool over
    the seeds' positions, "node_ids" (the sampled nodes' graph ids), and
    each of ``tables`` (a per-node tensor of the graph) gathered at the
    sampled nodes, padded with -1 where it is "y" of an integer type
    (labels), with 0 otherwise."""
    batch = sampler.sample(seeds, generator)
    ids = batch.node_ids
    senders = torch.cat([b.senders for b in batch.blocks])
    receivers = torch.cat([b.receivers for b in batch.blocks])
    n, e = ids.numel(), senders.numel()
    if n > n_pad or e > e_pad:
        raise ValueError(f"a sample of {n} nodes and {e} edges exceeds the batch's "
                         f"{n_pad} x {e_pad}")
    dev = ids.device
    out = {"senders": torch.full((e_pad,), -1, dtype=torch.int64, device=dev),
           "receivers": torch.full((e_pad,), -1, dtype=torch.int64, device=dev),
           "seed_mask": torch.zeros(n_pad, dtype=torch.bool, device=dev), "node_ids": ids}
    out["senders"][:e], out["receivers"][:e] = senders, receivers
    out["seed_mask"][torch.searchsorted(ids, batch.seeds)] = True
    for name, t in tables.items():
        fill = -1 if name == "y" and not t.is_floating_point() else 0
        col = torch.full((n_pad, *t.shape[1:]), fill, dtype=t.dtype, device=dev)
        col[:n] = t[ids]
        out[name] = col
    return out


def edge_features(senders: torch.Tensor, d_edge: int, generator: torch.Generator):
    """(E, d_edge) float32 standard normal features of the edges, zero on
    padded edges (sender -1)."""
    ef = torch.randn((senders.numel(), d_edge), generator=generator, device=senders.device)
    return ef * (senders >= 0)[:, None]


def node_targets(n_nodes: int, d_out: int, real_nodes: int, generator: torch.Generator):
    """(n_nodes, d_out) float32 standard normal regression targets, zero on
    the padding nodes past ``real_nodes``."""
    y = torch.randn((n_nodes, d_out), generator=generator, device=generator.device)
    y[real_nodes:] = 0
    return y


def atoms(n_nodes: int, real_nodes: int, generator: torch.Generator) -> tuple:
    """(species (n_nodes,) int64 uniform over ``N_SPECIES``, positions
    (n_nodes, 3) float32 standard normal in Å, so most pairs lie within a
    5 Å cutoff); padding nodes past ``real_nodes`` have species 0 and
    position 0."""
    dev = generator.device
    species = torch.randint(0, N_SPECIES, (n_nodes,), generator=generator, device=dev)
    pos = torch.randn((n_nodes, 3), generator=generator, device=dev)
    species[real_nodes:], pos[real_nodes:] = 0, 0
    return species, pos
