"""ITR core on torch: RePair graph compression, succinct encoding, and the
batched triple-query engine with its result cache and mutation overlay,
ITR+'s node labels as rank-1 edges, BGP joins and the term dictionary.
Module for module the twin of ``repro.core``."""
from repro_torch.core.bgp import (
    BGPResult,
    SelectivityStats,
    TriplePattern,
    execute_bgp,
    parse_bgp,
    plan_bgp,
)
from repro_torch.core.delta import DeltaOverlay, resolve_delta_budget
from repro_torch.core.digram import DigramCounter, digram_counts, digram_key, incidences
from repro_torch.core.encode import EncodedGrammar, encode
from repro_torch.core.flatten import FlatGrammar, FrontierArena, concat_ragged
from repro_torch.core.grammar import Grammar, Rule
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.core.itr_plus import (
    attach_node_labels,
    dictionary_cost_itr,
    dictionary_cost_itr_plus,
    strip_node_labels,
)
from repro_torch.core.query import (
    QueryResultView,
    TripleQueryEngine,
    query_oracle,
    result_rows,
)
from repro_torch.core.repair import RepairConfig, RepairStats, compress
from repro_torch.core.result_cache import CacheStats, QueryResultCache, ShardCacheView
from repro_torch.core.term_dict import StringSpace, TermDict, resolve_dict_block

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
    "attach_node_labels",
    "strip_node_labels",
    "dictionary_cost_itr",
    "dictionary_cost_itr_plus",
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
    "BGPResult",
    "SelectivityStats",
    "TriplePattern",
    "execute_bgp",
    "parse_bgp",
    "plan_bgp",
    "StringSpace",
    "TermDict",
    "resolve_dict_block",
]
