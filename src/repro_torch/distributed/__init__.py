"""Graph partitioning for the sharded serving tier and its online
rebalancing: the twins of ``repro.distributed.partition`` and
``repro.distributed.rebalance``."""
from repro_torch.distributed.partition import (
    STRATEGIES,
    PartitionPlan,
    diff_plans,
    make_plan,
    partition_triples,
    plan_from_dict,
    plan_to_dict,
    plans_equal,
    subject_quantile_boundaries,
)
from repro_torch.distributed.rebalance import (
    DEFAULT_REBALANCE_SKEW,
    RebalancePlan,
    balance_predicates,
    live_shard_edges,
    measure_skew,
    migration_moves,
    plan_rebalance,
    resolve_rebalance_skew,
)

__all__ = [
    "STRATEGIES",
    "PartitionPlan",
    "diff_plans",
    "make_plan",
    "partition_triples",
    "plan_from_dict",
    "plan_to_dict",
    "plans_equal",
    "subject_quantile_boundaries",
    "DEFAULT_REBALANCE_SKEW",
    "RebalancePlan",
    "balance_predicates",
    "live_shard_edges",
    "measure_skew",
    "migration_moves",
    "plan_rebalance",
    "resolve_rebalance_skew",
]
