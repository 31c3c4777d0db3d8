"""Serving on the GPU: LM generation (the twin of ``repro.serve.engine``)
and the triple-query services, one engine micro-batched or P partitioned
engines behind a scatter-gather router with WAL-fed read replica groups
(the twins of ``repro.serve.triple_service``, ``repro.serve.sharded``,
``repro.serve.replication`` and ``repro.serve.concurrency``)."""
from repro_torch.serve.concurrency import RWLock, resolve_serve_threads
from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.replication import (
    ReplicaGroup,
    ReplicaSet,
    ReplicationManager,
    ShardReplica,
    resolve_replica_dispatch,
    resolve_replica_max_lag,
    resolve_replicas,
)
from repro_torch.serve.sharded import ShardedServiceStats, ShardedTripleService
from repro_torch.serve.triple_service import (
    MicroBatchService,
    ServiceStats,
    TripleQueryService,
)

__all__ = [
    "ServeEngine",
    "GenerationResult",
    "MicroBatchService",
    "TripleQueryService",
    "ServiceStats",
    "ShardedTripleService",
    "ShardedServiceStats",
    "ReplicationManager",
    "ReplicaGroup",
    "ReplicaSet",
    "ShardReplica",
    "RWLock",
    "resolve_serve_threads",
    "resolve_replicas",
    "resolve_replica_dispatch",
    "resolve_replica_max_lag",
]
