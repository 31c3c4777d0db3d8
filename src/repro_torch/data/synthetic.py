"""Synthetic graph generators mirroring the paper's dataset families
(Table 1b) at configurable scale: structural stand-ins with the same
|V| / |E| / |T| regimes and skew, not the same data.

A copy of the JAX package's generators, so that a run of the port makes
its data from a seed without that package. Data is made on the host with
numpy's generator (the same seed gives the same triples as the
reference's), and moved to the device by ``Hypergraph.from_triples``.

* :func:`rdf_like`      — homepages/geo/jamendo style: Zipf predicates,
                          star-shaped subjects, literal-like leaf objects.
* :func:`web_graph`     — WikiTalk/NotreDame style: single label,
                          preferential attachment.
* :func:`version_graph` — ttt-win/chess style: many near-isomorphic small
                          subgraphs + few node labels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TripleDataset:
    triples: np.ndarray          # int64[n, 3] (s, p, o), deduplicated
    n_nodes: int
    n_preds: int
    node_labels: np.ndarray | None = None
    node_label_names: list[str] | None = None
    name: str = ""

    @property
    def n_triples(self) -> int:
        return len(self.triples)


def _dedup(triples: np.ndarray) -> np.ndarray:
    return np.unique(triples, axis=0)


def rdf_like(n_nodes=5000, n_edges=20000, n_preds=25, seed=0, name="rdf-like") -> TripleDataset:
    rng = np.random.default_rng(seed)
    # Zipf predicates; entity-like subjects each carrying a handful of
    # (predicate, object) pairs, and objects that are mostly fresh leaves
    # (literals) plus some shared resources
    preds = (rng.zipf(1.6, n_edges * 2) - 1) % n_preds
    n_subjects = max(n_nodes // 3, 1)
    subj_pool = rng.integers(0, n_subjects, n_edges * 2)
    hub = (rng.zipf(2.8, n_edges * 2) - 1).clip(0, 19)
    subj_pool = (subj_pool + hub * 0) % n_subjects  # keep uniform base
    obj_shared = rng.integers(0, n_nodes, n_edges * 2)
    obj_leaf = rng.integers(n_nodes // 3, n_nodes, n_edges * 2)
    is_leaf = rng.random(n_edges * 2) < 0.6
    objs = np.where(is_leaf, obj_leaf, obj_shared)
    triples = _dedup(np.stack([subj_pool, preds, objs], axis=1).astype(np.int64))[:n_edges]
    return TripleDataset(triples, n_nodes, n_preds, name=name)


def web_graph(n_nodes=3000, n_edges=15000, seed=0, name="web-graph") -> TripleDataset:
    rng = np.random.default_rng(seed)
    # preferential attachment, approximated by sampling targets from a
    # growing multiset
    src = rng.integers(0, n_nodes, n_edges * 2)
    targets = np.empty(n_edges * 2, dtype=np.int64)
    pool = rng.integers(0, max(n_nodes // 10, 1), 64)
    for i in range(0, len(targets), 1024):
        chunk = min(1024, len(targets) - i)
        picks = rng.integers(0, len(pool), chunk)
        fresh = rng.integers(0, n_nodes, chunk)
        use_pool = rng.random(chunk) < 0.7
        targets[i : i + chunk] = np.where(use_pool, pool[picks], fresh)
        pool = np.concatenate([pool, targets[i : i + chunk][:128]])
    triples = _dedup(
        np.stack([src, np.zeros(len(src), dtype=np.int64), targets], axis=1).astype(np.int64)
    )[:n_edges]
    return TripleDataset(triples, n_nodes, 1, name=name)


def version_graph(n_groups=400, group_size=9, n_node_labels=3, seed=0,
                  name="version-graph") -> TripleDataset:
    """ttt-win style: each state is a star of `group_size` cells whose edges
    use per-position predicates; states chain via a `move` predicate; cells
    carry one of `n_node_labels` node labels."""
    rng = np.random.default_rng(seed)
    n_preds = group_size + 1  # position predicates + 'move'
    centers = np.arange(n_groups)
    cell_base = n_groups
    triples = []
    for g in range(n_groups):
        cells = cell_base + g * group_size + np.arange(group_size)
        for pos in range(group_size):
            triples.append((centers[g], pos, cells[pos]))
        if g > 0:
            triples.append((centers[g - 1], group_size, centers[g]))
    triples = np.array(triples, dtype=np.int64)
    n_nodes = cell_base + n_groups * group_size
    node_labels = np.full(n_nodes, -1, dtype=np.int64)
    node_labels[cell_base:] = rng.integers(0, n_node_labels, n_groups * group_size)
    return TripleDataset(
        _dedup(triples), n_nodes, n_preds,
        node_labels=node_labels,
        node_label_names=[f"lab{i}" for i in range(n_node_labels)],
        name=name,
    )


# paper Table 1b stand-ins; the default scales are the reference's
PAPER_DATASETS = {
    "homepages-en": lambda scale=0.1, seed=0: rdf_like(
        int(98665 * scale), int(50000 * scale), 1, seed, "homepages-en"),
    "geo-coordinates-en": lambda scale=0.1, seed=0: rdf_like(
        int(46107 * scale), int(50000 * scale), 4, seed, "geo-coordinates-en"),
    "jamendo": lambda scale=0.05, seed=0: rdf_like(
        int(396531 * scale), int(1047951 * scale), 25, seed, "jamendo"),
    "archiveshub": lambda scale=0.05, seed=0: rdf_like(
        int(280556 * scale), int(1361816 * scale), 139, seed, "archiveshub"),
    "scholarydata-dump": lambda scale=0.05, seed=0: rdf_like(
        int(140042 * scale), int(1159985 * scale), 84, seed, "scholarydata-dump"),
    "chess-legal": lambda scale=0.2, seed=0: version_graph(
        max(int(76272 * scale) // 10, 10), 9, 13, seed, "chess-legal"),
    "ttt-win": lambda scale=1.0, seed=0: version_graph(
        max(int(5634 * scale) // 10, 10), 9, 3, seed, "ttt-win"),
    "WikiTalk": lambda scale=0.01, seed=0: web_graph(
        int(2394385 * scale), int(5021410 * scale), seed, "WikiTalk"),
    "NotreDame": lambda scale=0.02, seed=0: web_graph(
        int(325729 * scale), int(1497134 * scale), seed, "NotreDame"),
    "CA-AstroPh": lambda scale=0.1, seed=0: web_graph(
        int(18772 * scale), int(396160 * scale), seed, "CA-AstroPh"),
}
