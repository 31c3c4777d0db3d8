"""Fanout neighbour sampler (GraphSAGE-style) over a GraphStore CSR view,
on the device: the twin of ``repro.data.sampler``.

Produces layered subgraph batches for ``minibatch_lg``: seed nodes, then
for each hop a uniform sample of up to ``fanouts[h]`` in-neighbours per
frontier node. Output is a bipartite block per hop (senders / receivers
into a compacted node set), the structure the GNN minibatch step consumes.

Port decisions. The draws are float64 uniforms of the reference's length,
one per candidate edge a hop, from a ``torch.Generator``
(:meth:`NeighborSampler.draw`); a caller may pass its own ``uniforms``
(a function of the count), which is how the tests feed both packages the
same draws. numpy's ``unique(key, return_index=True)`` is a stable sort
and the first of each run of equal keys, which gives its order; the
position lookup is a ``searchsorted`` into ``node_ids``. A ``sample``
makes 3 host syncs a hop (the candidate count that sizes the
``repeat_interleave``, the kept first-of-run positions, the frontier's
``unique``) and 1 for ``node_ids``: 7 with two hops.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core._arrays import I64


@dataclass
class SampledBlock:
    senders: torch.Tensor    # positions into the previous layer's node list
    receivers: torch.Tensor  # positions into the next (smaller) node list
    n_src: int
    n_dst: int


@dataclass
class SampledBatch:
    node_ids: torch.Tensor   # global ids of all nodes needed (sorted, unique)
    blocks: list[SampledBlock]
    seeds: torch.Tensor


def _unique_first(key: torch.Tensor) -> torch.Tensor:
    """Positions of the first occurrence of each distinct key, in order of
    the keys: ``np.unique(key, return_index=True)[1]``."""
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    head = torch.ones(sk.numel(), dtype=torch.bool, device=key.device)
    head[1:] = sk[1:] != sk[:-1]
    return order[head]


class NeighborSampler:
    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor, fanouts: tuple[int, ...]):
        self.indptr, self.indices = indptr, indices
        self.fanouts = tuple(fanouts)
        self._key_base = int(indices.max()) + 2 if indices.numel() else 2

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @staticmethod
    def draw(n: int, generator: torch.Generator) -> torch.Tensor:
        """n float64 uniforms in [0, 1) on the generator's device."""
        return torch.rand(n, dtype=torch.float64, generator=generator, device=generator.device)

    def sample(self, seeds, generator: torch.Generator | None = None, *,
               uniforms=None) -> SampledBatch:
        """One batch from ``seeds``; the draws come from ``uniforms(n)`` if
        given, else :meth:`draw` on ``generator``."""
        dev = self.device
        seeds = torch.as_tensor(seeds, dtype=I64).to(dev)
        uniforms = uniforms or (lambda n: self.draw(n, generator))
        layers = [seeds]
        edges_per_hop = []
        frontier = seeds
        for f in self.fanouts:
            start = self.indptr[frontier]
            deg = self.indptr[frontier + 1] - start
            take = torch.clamp(deg, max=f)
            total = int(take.sum())
            # ragged uniform sample without replacement approximated by a
            # with-replacement draw, then dedup per (dst, src)
            dst_rep = torch.repeat_interleave(
                torch.arange(frontier.numel(), dtype=I64, device=dev), take, output_size=total)
            base = start[dst_rep]
            degs = deg.clamp(min=1)[dst_rep]
            offs = (uniforms(total).to(dev) * degs).to(I64)
            src = self.indices[base + offs]
            keep = _unique_first(dst_rep * self._key_base + src)
            dst_rep, src = dst_rep[keep], src[keep]
            edges_per_hop.append((src, dst_rep))
            frontier = torch.unique(src)
            layers.append(frontier)

        # compact node ids: the union of all layers, sorted
        node_ids = torch.unique(torch.cat(layers))
        n = node_ids.numel()
        blocks = []
        for hop, (src, dst_rep) in enumerate(edges_per_hop):
            senders = torch.searchsorted(node_ids, src)
            receivers = torch.searchsorted(node_ids, layers[hop][dst_rep])
            blocks.append(SampledBlock(senders, receivers, n_src=n, n_dst=n))
        return SampledBatch(node_ids=node_ids, blocks=blocks, seeds=seeds)
