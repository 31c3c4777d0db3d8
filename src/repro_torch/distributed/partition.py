"""Graph partitioning for the sharded serving tier, the twin of
``repro.distributed.partition``: a copy of its numpy code, which the port
keeps on the host.

A partition plan splits a triple set into P disjoint subgraphs, each
compressed into its own grammar and served by its own
:class:`~repro_torch.core.query.TripleQueryEngine`. The partitions are
disjoint, so the exact answer to any (S, P, O) pattern is the
concatenation of the per-shard answers: no dedup, no overlap bookkeeping.

Two strategies, each with an "owning" axis that lets the router send a
selective pattern to one shard:

* ``predicate_hash``: vertical partitioning by predicate (the k²-Triples
  axis): every triple with predicate p lives in shard ``hash(p) % P``. A
  pattern binding P is owned by one shard; ``S??``, ``??O`` and ``???``
  scatter-gather.
* ``node_range``: horizontal partitioning by subject: node ids
  ``[0, n_nodes)`` are cut into P contiguous ranges and a triple lives in
  the shard owning its subject. A pattern binding S is owned; ``?P?``,
  ``??O`` and ``???`` scatter-gather.

Plans are numpy on the host and stateless. The hash multiplies in uint64,
which torch has no general arithmetic for on CUDA, and pattern columns
come from host lists anyway; routing a batch is one vectorized pass
(`route_batch`).

Placement and routing share one rule, which keeps the tier exact under
mutation: `route_triples` sends an inserted or deleted (s, p, o) row to
exactly the shard whose engine would answer an owned pattern for it. Ids
outside the planned universe (subjects past the last ``node_range``
boundary, from inserts that grow the graph) clip onto the last shard,
identically for placement and queries.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

STRATEGIES = ("predicate_hash", "node_range")

# Knuth multiplicative hash over 32-bit predicate ids: consecutive
# predicate ids (the common dictionary encoding) spread across shards
# instead of striping p % P onto correlated workloads.
_HASH_MULT = np.uint64(2654435761)
_HASH_MASK = np.uint64(0xFFFFFFFF)


def _hash_pred(p, n_shards: int):
    h = (np.asarray(p).astype(np.uint64) * _HASH_MULT) & _HASH_MASK
    return (h % np.uint64(n_shards)).astype(np.int64)


@dataclass(frozen=True)
class PartitionPlan:
    """Deterministic triple -> shard assignment + pattern routing rules.

    `pred_assign` (predicate_hash only) overrides the hash with an
    explicit predicate -> shard map — the form online rebalancing
    produces when it re-packs predicate groups onto shards by observed
    load. Absent, the Knuth hash is the assignment; either way placement
    and routing read the same function, so the build/mutation invariant
    survives a re-cut.
    """

    strategy: str
    n_shards: int
    n_nodes: int
    n_preds: int
    boundaries: np.ndarray | None = None   # node_range: int64[n_shards+1]
    pred_assign: np.ndarray | None = None  # predicate_hash: int64[n_preds]

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown partition strategy {self.strategy!r}; "
                f"expected one of {STRATEGIES}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.strategy == "node_range":
            b = self.boundaries
            if b is None or len(b) != self.n_shards + 1:
                raise ValueError(
                    "node_range plans need boundaries of length n_shards+1 "
                    "(build plans with make_plan)")
            if np.any(np.diff(b) < 0):
                raise ValueError("node_range boundaries must be non-decreasing")
        if self.pred_assign is not None:
            if self.strategy != "predicate_hash":
                raise ValueError(
                    "pred_assign only applies to predicate_hash plans")
            pa = np.asarray(self.pred_assign)
            if pa.shape != (self.n_preds,):
                raise ValueError(
                    f"pred_assign must have shape ({self.n_preds},), "
                    f"got {pa.shape}")
            if len(pa) and (int(pa.min()) < 0 or int(pa.max()) >= self.n_shards):
                raise ValueError(
                    f"pred_assign values must be shard ids in "
                    f"[0, {self.n_shards})")

    # -- triple placement ------------------------------------------------
    def triple_shards(self, triples: np.ndarray) -> np.ndarray:
        """Owning shard per (s, p, o) row."""
        triples = np.asarray(triples, dtype=np.int64)
        if self.strategy == "predicate_hash":
            return self._pred_shard(triples[:, 1])
        return self._node_shard(triples[:, 0])

    def _node_shard(self, nodes) -> np.ndarray:
        idx = np.searchsorted(self.boundaries, np.asarray(nodes, dtype=np.int64),
                              side="right") - 1
        return np.clip(idx, 0, self.n_shards - 1)

    def _pred_shard(self, preds) -> np.ndarray:
        preds = np.asarray(preds, dtype=np.int64)
        if self.pred_assign is not None:
            # ids at/above n_preds clamp onto the last predicate's shard —
            # the same clamp placement uses, so routing can never disagree
            return np.asarray(self.pred_assign, dtype=np.int64)[
                np.clip(preds, 0, self.n_preds - 1)]
        return _hash_pred(preds, self.n_shards)

    def pred_assignment(self) -> np.ndarray:
        """Explicit predicate -> shard map of a predicate_hash plan (the
        stored re-cut assignment, or the hash evaluated per predicate)."""
        if self.strategy != "predicate_hash":
            raise ValueError("pred_assignment() needs a predicate_hash plan")
        return self._pred_shard(np.arange(self.n_preds, dtype=np.int64)).copy()

    def route_triples(self, triples: np.ndarray) -> np.ndarray:
        """Owning shard per mutation row — the write-path routing surface.

        Identical to :meth:`triple_shards` (one placement rule for build
        and mutation, by construction), but validates the ``(n, 3)``
        shape so a malformed mutation batch fails here instead of
        landing rows on arbitrary shards. Zero-row batches of any empty
        shape (``[]`` included) are a valid no-op.
        """
        triples = np.asarray(triples, dtype=np.int64)
        if triples.size == 0:
            return np.zeros(0, dtype=np.int64)
        if triples.ndim != 2 or triples.shape[1] != 3:
            raise ValueError(
                f"expected (n, 3) triple rows, got shape {triples.shape}")
        return self.triple_shards(triples)

    # -- pattern routing -------------------------------------------------
    def route(self, s: int, p: int, o: int) -> int:
        """Owning shard of one pattern (-1 = scatter-gather all shards).

        Unbound slots are encoded as -1, matching the engine's batch
        convention.
        """
        if self.strategy == "predicate_hash":
            return int(self._pred_shard(p)) if p >= 0 else -1
        return int(self._node_shard(s)) if s >= 0 else -1

    def route_batch(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> np.ndarray:
        """Vectorized `route` over aligned pattern columns (zero-length
        columns return an empty route array)."""
        s = np.asarray(s, dtype=np.int64)
        p = np.asarray(p, dtype=np.int64)
        if self.strategy == "predicate_hash":
            return np.where(p >= 0, self._pred_shard(np.maximum(p, 0)), -1)
        return np.where(s >= 0, self._node_shard(np.maximum(s, 0)), -1)


def plan_to_dict(plan: PartitionPlan) -> dict:
    """JSON-serializable form of a plan — the wire format service
    snapshots and WAL plan records use. Inverse: :func:`plan_from_dict`."""
    d = {"strategy": plan.strategy, "n_shards": int(plan.n_shards),
         "n_nodes": int(plan.n_nodes), "n_preds": int(plan.n_preds)}
    if plan.boundaries is not None:
        d["boundaries"] = [int(v) for v in plan.boundaries]
    if plan.pred_assign is not None:
        d["pred_assign"] = [int(v) for v in plan.pred_assign]
    return d


def plan_from_dict(d: dict) -> PartitionPlan:
    """Rebuild a plan from :func:`plan_to_dict` output (validation reruns
    in ``PartitionPlan.__post_init__``, so a corrupted record fails loudly
    instead of mis-routing rows)."""
    boundaries = d.get("boundaries")
    pred_assign = d.get("pred_assign")
    return PartitionPlan(
        d["strategy"], int(d["n_shards"]), int(d["n_nodes"]),
        int(d["n_preds"]),
        boundaries=None if boundaries is None
        else np.asarray(boundaries, dtype=np.int64),
        pred_assign=None if pred_assign is None
        else np.asarray(pred_assign, dtype=np.int64))


def plans_equal(a: PartitionPlan, b: PartitionPlan) -> bool:
    """Semantic plan equality (same routing for every row and pattern).

    Plans that round-trip through the WAL (`plan_from_dict`) are new
    objects, so identity alone cannot compare a primary's plan with a
    replica's replayed copy; the serialized form is the routing state."""
    return a is b or plan_to_dict(a) == plan_to_dict(b)


def make_plan(strategy: str, n_shards: int, n_nodes: int, n_preds: int,
              triples: np.ndarray | None = None) -> PartitionPlan:
    """Build a partition plan.

    `node_range` boundaries default to even node-id ranges; when `triples`
    are provided they are placed at subject-distribution *quantiles*
    instead — real RDF subjects concentrate in a prefix of the id space
    (objects hold literals/values), and even id ranges would park every
    triple in shard 0. Duplicate boundaries (skewed hot subjects) simply
    leave the middle shards empty.
    """
    if n_shards < 1:  # validate before boundary math (PartitionPlan re-checks)
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    boundaries = None
    if strategy == "node_range":
        hi = max(n_nodes, n_shards)
        subjects = np.asarray(triples, dtype=np.int64)[:, 0] \
            if triples is not None and len(triples) else None
        boundaries = subject_quantile_boundaries(subjects, n_shards, hi)
    return PartitionPlan(strategy, int(n_shards), int(n_nodes), int(n_preds),
                         boundaries)


def subject_quantile_boundaries(subjects, n_shards: int, hi: int) -> np.ndarray:
    """node_range boundary (re-)cut from an observed subject distribution.

    Boundaries sit at subject quantiles so each shard owns roughly the
    same number of triples regardless of how subjects cluster in the id
    space; with no observations (``subjects=None`` or empty) the cut
    falls back to even id ranges. This is the single boundary function —
    `make_plan` uses it at build and `repro_torch.distributed.rebalance`
    re-runs it on live subjects to re-cut a skewed tier online.
    """
    if subjects is not None:
        subjects = np.asarray(subjects, dtype=np.int64)
    if subjects is None or len(subjects) == 0:
        boundaries = np.floor(
            np.arange(n_shards + 1) * hi / n_shards).astype(np.int64)
        boundaries[0], boundaries[-1] = 0, hi
        return boundaries
    subs = np.sort(subjects)
    cuts = subs[np.minimum(
        np.arange(1, n_shards) * len(subs) // n_shards, len(subs) - 1)]
    boundaries = np.concatenate([[0], np.maximum(cuts, 1), [hi]]).astype(np.int64)
    return np.maximum.accumulate(boundaries)


def diff_plans(old: PartitionPlan, new: PartitionPlan,
               triples: np.ndarray) -> np.ndarray:
    """Boolean mask per triple row: does its owning shard change from
    `old` to `new`? Zero rows diff to an empty mask. Diagnostic helper
    for inspecting a re-cut; the actual migration moves are computed in
    `repro_torch.distributed.rebalance.plan_rebalance` against each engine's
    *physical* rows (robust to ids that clamped onto a boundary shard),
    not against where `old` says they should be."""
    triples = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
    if len(triples) == 0:
        return np.zeros(0, dtype=bool)
    return old.triple_shards(triples) != new.triple_shards(triples)


def partition_triples(triples: np.ndarray, plan: PartitionPlan) -> list[np.ndarray]:
    """Split (n, 3) triples into per-shard subsets (global node/pred ids are
    kept, so shard results are directly mergeable and comparable)."""
    triples = np.asarray(triples, dtype=np.int64)
    if len(triples) == 0:
        return [triples[:0] for _ in range(plan.n_shards)]
    shards = plan.triple_shards(triples)
    order = np.argsort(shards, kind="stable")
    sorted_triples = triples[order]
    counts = np.bincount(shards, minlength=plan.n_shards)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [sorted_triples[bounds[k]:bounds[k + 1]] for k in range(plan.n_shards)]
