"""ITR core on torch: RePair graph compression, succinct encoding, and the
batched triple-query engine. Module for module the twin of ``repro.core``."""
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

__all__ = [
    "Hypergraph",
    "LabelTable",
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
    "query_oracle",
    "result_rows",
]
