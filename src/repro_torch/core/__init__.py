"""ITR core on torch: RePair graph compression, succinct encoding, and the
batched triple-query engine with its result cache and mutation overlay.
Module for module the twin of ``repro.core``."""
from repro_torch.core.delta import DeltaOverlay, resolve_delta_budget
from repro_torch.core.digram import DigramCounter, digram_counts, digram_key, incidences
from repro_torch.core.encode import EncodedGrammar, encode
from repro_torch.core.flatten import FlatGrammar, FrontierArena, concat_ragged
from repro_torch.core.grammar import Grammar, Rule
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.core.query import (
    QueryResultView,
    TripleQueryEngine,
    query_oracle,
    result_rows,
)
from repro_torch.core.repair import RepairConfig, RepairStats, compress
from repro_torch.core.result_cache import CacheStats, QueryResultCache, ShardCacheView

__all__ = [
    "Hypergraph",
    "LabelTable",
    "DeltaOverlay",
    "resolve_delta_budget",
    "DigramCounter",
    "digram_counts",
    "digram_key",
    "incidences",
    "Grammar",
    "Rule",
    "RepairConfig",
    "RepairStats",
    "compress",
    "EncodedGrammar",
    "encode",
    "FlatGrammar",
    "FrontierArena",
    "concat_ragged",
    "TripleQueryEngine",
    "QueryResultView",
    "QueryResultCache",
    "CacheStats",
    "ShardCacheView",
    "query_oracle",
    "result_rows",
]
