"""Online shard rebalancing: skew detection, plan re-cut, bounded moves; the
twin of ``repro.distributed.rebalance``.

Mutations skew a partitioned tier: a `PartitionPlan` routes rows where the
build-time cut put their axis value, so a burst of inserts landing on one
shard degrades every scatter-gather flush until something re-cuts the
plan. This module is that something, in three pieces the serving tier
(:mod:`repro_torch.serve.sharded`) wires together:

* **Skew detection.** :func:`live_shard_edges` reads each engine's live
  triple count (compressed base + overlay inserts - tombstones) and
  :func:`measure_skew` condenses the counts to a ``max/mean`` ratio, which
  the mutation path compares with its trigger (:func:`resolve_rebalance_skew`,
  an argument only).
* **Plan re-cut.** :func:`plan_rebalance` computes a successor plan from the
  live data: ``node_range`` boundaries re-quantiled from the observed
  subjects (``partition.subject_quantile_boundaries``, the build's own
  function), ``predicate_hash`` groups re-packed onto shards by greedy LPT
  over live per-predicate counts (:func:`balance_predicates`, kept as the
  plan's explicit ``pred_assign``). The engines' rows come to the host once
  for it: the plan is host state.
* **Migration bookkeeping.** :class:`RebalancePlan` carries the pending
  per-``(src, dst)`` moves as int64 row tensors on the engines' device.
  Rows leave their source through tombstones and arrive through the
  destination's delta overlay, in bounded batches; `discard` drops rows the
  caller deleted mid-flight (through
  :func:`~repro_torch.core.delta.rows_in`), so a later batch never
  resurrects them.

Exactness rests on two invariants the service keeps: every migrated batch
arrives before it departs inside one call (partitions stay disjoint at
every public boundary), and while moves are pending the router trusts
single-shard ownership only for patterns the outgoing and incoming plans
route alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delta import rows_in
from repro_torch.device import as_i64
from repro_torch.distributed.partition import PartitionPlan, subject_quantile_boundaries

_EMPTY_ROWS = np.zeros((0, 3), dtype=np.int64)

# the default trigger: rebalance when one shard holds 4x the mean load
DEFAULT_REBALANCE_SKEW = 4.0


def resolve_rebalance_skew(value=None) -> float | None:
    """The auto-rebalance trigger as a ``float`` skew threshold (>= 1), or
    ``None`` (automatic rebalancing off; only an explicit
    ``rebalance(force=True)`` re-cuts).

    ``value=None`` gives :data:`DEFAULT_REBALANCE_SKEW`. A number > 0 is
    the ``max/mean`` live-edge ratio at or above which the mutation path
    starts a rebalance (below 1 it clamps to 1.0, the least skew there
    is); a number <= 0 turns the trigger off."""
    if value is None:
        return DEFAULT_REBALANCE_SKEW
    value = float(value)
    if value <= 0:
        return None
    return max(value, 1.0)


def live_shard_edges(engines) -> np.ndarray:
    """Live triple count a shard: compressed base edges plus overlay
    inserts minus tombstones, the quantity mutation skews. The base count is
    cached by each engine, so the mutation path can afford it every batch."""
    return np.array(
        [e.base_edges + e.delta.n_inserts - e.delta.n_tombstones
         for e in engines], dtype=np.int64)


def measure_skew(counts) -> float:
    """``max/mean`` shard load: 1.0 is balanced, ``n_shards`` means one
    shard holds everything. A single shard or an empty tier reads as
    balanced."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if len(counts) <= 1 or total <= 0:
        return 1.0
    return float(int(counts.max()) * len(counts) / total)


def balance_predicates(pred_counts, n_shards: int, prior) -> np.ndarray:
    """Greedy LPT re-pack of predicate groups onto shards.

    Predicates in descending live-count order land on the least-loaded
    shard; ties keep the `prior` owner and zero-count predicates keep it
    always, so idle ids never move for nothing. The floor is the largest
    single predicate, which vertical partitioning cannot split."""
    counts = np.asarray(pred_counts, dtype=np.int64)
    assign = np.asarray(prior, dtype=np.int64).copy()
    if assign.shape != counts.shape:
        raise ValueError(
            f"prior assignment shape {assign.shape} != counts {counts.shape}")
    load = np.zeros(n_shards, dtype=np.int64)
    for p in np.argsort(-counts, kind="stable"):
        p = int(p)
        if counts[p] == 0:
            continue
        k = int(np.argmin(load))
        if load[int(assign[p])] == load[k]:
            k = int(assign[p])
        assign[p] = k
        load[k] += counts[p]
    return assign


class RebalancePlan:
    """One online re-cut: the successor plan plus the pending moves.

    Built by :func:`plan_rebalance`, consumed by the sharded service, which
    relies on this contract:

    * every pending row is on its ``src`` shard until a `take` batch
      migrates it (or `discard` drops it: the caller mutated it mid-flight);
    * `take` consumes moves front to back in bounded batches, splitting a
      move where the cap lands inside it;
    * once `done`, `new_plan` routes exactly where every row now lives.

    Rows are int64 ``(n, 3)`` tensors on the device they were given on.
    """

    def __init__(self, old_plan: PartitionPlan, new_plan: PartitionPlan, moves: list):
        self.old_plan = old_plan
        self.new_plan = new_plan
        self._moves = [(int(src), int(dst), _as_rows(rows))
                       for src, dst, rows in moves if len(rows)]
        #: rows this re-cut set out to migrate (fixed at plan time)
        self.total_rows = sum(len(r) for _, _, r in self._moves)

    @property
    def pending_rows(self) -> int:
        """Rows still waiting to migrate."""
        return sum(len(r) for _, _, r in self._moves)

    @property
    def done(self) -> bool:
        return not self._moves

    def pending_moves(self) -> list:
        """The pending (src, dst, rows) moves (read-only)."""
        return list(self._moves)

    def discard(self, rows) -> int:
        """Drop `rows` from the pending moves; returns how many pending rows
        were dropped. The service calls it for every row deleted while the
        migration is in flight, so a later batch cannot resurrect it."""
        if len(rows) == 0:
            return 0
        dropped = 0
        kept = []
        gone = None
        for src, dst, pending in self._moves:
            if gone is None or gone.device != pending.device:
                gone = as_i64(rows, pending.device).reshape(-1, 3)
            hit = rows_in(pending, gone)
            n_hit = int(hit.sum())
            if n_hit:
                dropped += n_hit
                pending = pending[~hit]
            if len(pending):
                kept.append((src, dst, pending))
        self._moves = kept
        return dropped

    def take(self, max_rows: int | None = None) -> list:
        """Pop up to `max_rows` pending rows (``None``: all) as a list of
        (src, dst, rows) batches ready to apply."""
        budget = self.pending_rows if max_rows is None else max(0, int(max_rows))
        out = []
        while self._moves and budget > 0:
            src, dst, pending = self._moves[0]
            if len(pending) <= budget:
                out.append((src, dst, pending))
                budget -= len(pending)
                self._moves.pop(0)
            else:
                out.append((src, dst, pending[:budget]))
                self._moves[0] = (src, dst, pending[budget:])
                budget = 0
        return out


def _as_rows(rows) -> torch.Tensor:
    """Move rows as an int64 ``(n, 3)`` tensor, on their own device."""
    if isinstance(rows, torch.Tensor):
        return rows.to(torch.int64).reshape(-1, 3)
    return torch.from_numpy(np.asarray(rows, dtype=np.int64).reshape(-1, 3))


def _host_rows(engines) -> list[np.ndarray]:
    """Each engine's logical triples on the host, one copy a shard. An
    engine made by ``from_numpy_state`` has no grammar to read them from
    and raises ``NotImplementedError``."""
    return [e.current_triples().cpu().numpy() for e in engines]


def plan_rebalance(plan: PartitionPlan, engines) -> RebalancePlan:
    """Re-cut `plan` from the engines' live triples; compute the moves.

    ``node_range`` re-quantiles the boundaries from the observed subjects;
    ``predicate_hash`` re-packs predicate groups by live count (LPT) into an
    explicit ``pred_assign``. The node universe grows to cover inserted
    ids. Moves are computed against each engine's actual rows (overlay
    applied), so the migration is exact even for rows whose ids clamped
    onto a boundary shard. The rows come to the host once a shard; the
    moves go back to each source engine's device. Engines made by
    ``from_numpy_state`` cannot list their triples, so a tier of them
    raises ``NotImplementedError`` here."""
    per_shard = _host_rows(engines)
    rows = np.concatenate(per_shard) if per_shard else _EMPTY_ROWS
    n_nodes = plan.n_nodes
    if len(rows):
        n_nodes = max(n_nodes, int(rows[:, [0, 2]].max()) + 1)
    if plan.strategy == "node_range":
        hi = max(n_nodes, plan.n_shards)
        boundaries = subject_quantile_boundaries(
            rows[:, 0] if len(rows) else None, plan.n_shards, hi)
        new_plan = PartitionPlan("node_range", plan.n_shards, n_nodes,
                                 plan.n_preds, boundaries=boundaries)
    else:
        counts = np.bincount(rows[:, 1], minlength=plan.n_preds) \
            if len(rows) else np.zeros(plan.n_preds, dtype=np.int64)
        assign = balance_predicates(counts, plan.n_shards,
                                    prior=plan.pred_assignment())
        new_plan = PartitionPlan("predicate_hash", plan.n_shards, n_nodes,
                                 plan.n_preds, pred_assign=assign)
    return RebalancePlan(plan, new_plan, _moves_for(new_plan, per_shard, engines))


def _moves_for(new_plan: PartitionPlan, per_shard: list, engines) -> list:
    """(src, dst, rows) moves turning the given placement (host rows a
    shard) into `new_plan`'s: for each shard, the rows the successor routes
    elsewhere, copied to that shard's device."""
    moves = []
    for k, shard_rows in enumerate(per_shard):
        if len(shard_rows) == 0:
            continue
        dst = new_plan.triple_shards(shard_rows)
        for d in np.unique(dst):
            d = int(d)
            if d != k:
                moves.append((k, d, torch.from_numpy(shard_rows[dst == d]).to(
                    engines[k].device)))
    return moves


def migration_moves(new_plan: PartitionPlan, engines) -> list:
    """Pending (src, dst, rows) moves for an already decided successor plan,
    diffed against the engines' current rows: the rows still to move are
    exactly those the engines hold on shards the plan routes elsewhere, so
    a journaled or snapshotted migration needs no row lists. Deterministic
    given the engines' state."""
    return _moves_for(new_plan, _host_rows(engines), engines)
