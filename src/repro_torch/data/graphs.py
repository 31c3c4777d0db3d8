"""Seeded node-classification graphs at a GNN shape's sizes, drawn on the
device.

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
"""
from __future__ import annotations

import torch

BETA = 3.0  # the degree distribution's power-law exponent, see the module docstring


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
