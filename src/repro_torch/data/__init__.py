"""Data layer: synthetic stand-ins for the paper's datasets, an N-Triples
reader and writer, streaming ingestion into a live engine, the
ITR-compressed GraphStore and the fanout neighbour sampler over its views."""
from repro_torch.data.graph_store import GraphStore
from repro_torch.data.ingest import (
    IngestStats,
    ingest_file,
    ingest_rows,
    iter_tsv,
    resolve_ingest_batch,
    scan_predicates,
)
from repro_torch.data.sampler import NeighborSampler, SampledBatch, SampledBlock
from repro_torch.data.rdf import ParseReport, iter_ntriples, parse_ntriples, write_ntriples
from repro_torch.data.synthetic import rdf_like, version_graph, web_graph

__all__ = [
    "rdf_like",
    "version_graph",
    "web_graph",
    "GraphStore",
    "NeighborSampler",
    "SampledBatch",
    "SampledBlock",
    "ParseReport",
    "iter_ntriples",
    "parse_ntriples",
    "write_ntriples",
    "IngestStats",
    "ingest_file",
    "ingest_rows",
    "iter_tsv",
    "resolve_ingest_batch",
    "scan_predicates",
]
