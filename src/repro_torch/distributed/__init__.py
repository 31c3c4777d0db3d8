"""Distribution utilities: logical-axis sharding rules, the receiver-block
aggregation and its loader helpers, graph partitioning for the sharded
serving tier and its online rebalancing: the twins of
``repro.distributed.sharding``, ``collectives``, ``partition`` and
``rebalance``."""
from repro_torch.distributed.collectives import (
    partition_edges,
    partitioned_segment_sum,
    validate_partitioning,
)
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
from repro_torch.distributed.sharding import (
    LOGICAL_RULES,
    logical_spec,
    param_spec,
    shard,
    spec_bytes,
    zero1_spec,
)

__all__ = [
    "LOGICAL_RULES",
    "logical_spec",
    "shard",
    "param_spec",
    "spec_bytes",
    "zero1_spec",
    "partition_edges",
    "partitioned_segment_sum",
    "validate_partitioning",
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
