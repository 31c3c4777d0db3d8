"""Uncompressed N-Triples size model: the denominator of the compression
ratio. A copy of the reference's ``baselines/ntriples.py``."""
from __future__ import annotations


def ntriples_size_bytes(
    triples,
    node_repr_len: int = 24,
    pred_repr_len: int = 28,
) -> int:
    """Serialized ``<s> <p> <o> .\\n`` size with IRI-length models matching the
    paper's converted inputs (all compressors read the same RDF file)."""
    n = len(triples)
    return n * (2 * node_repr_len + pred_repr_len + 6)
