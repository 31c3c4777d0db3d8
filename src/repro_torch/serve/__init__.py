"""Serving on the GPU: LM generation (the twin of ``repro.serve.engine``)
and the triple-query services, one engine micro-batched or P partitioned
engines behind a scatter-gather router (the twins of
``repro.serve.triple_service``, ``repro.serve.sharded`` and
``repro.serve.concurrency``)."""
from repro_torch.serve.concurrency import RWLock, resolve_serve_threads
from repro_torch.serve.engine import GenerationResult, ServeEngine
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
    "RWLock",
    "resolve_serve_threads",
]
