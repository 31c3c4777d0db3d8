"""Streaming RDF ingestion: term rows -> dictionary ids -> a live engine.

The twin of the reference's ``data/ingest.py``. Decoded ``(s, p, o)``
term-string rows stream in (N-Triples through
:func:`repro_torch.data.rdf.iter_ntriples`, or 3-column TSV through
:func:`iter_tsv`); each batch mints its ids on the host through the
target's term dictionary and lands in one ``insert_triples``, which copies
the batch's id rows to the engine's device once.

Per-batch accounting lives in :class:`IngestStats`; malformed input lines
are counted and surfaced (the first few sampled), never silently dropped.

Capacity: node ids may grow without bound (the engine's node universe
grows at its next rebuild), but the predicates are the engine's terminal
labels, fixed when it is built. Size it with :func:`scan_predicates`, or
minting a predicate past it raises mid-ingest. Batches hold
:func:`resolve_ingest_batch` rows (default 4,096).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

from repro_torch.core.term_dict import TermDict
from repro_torch.data.rdf import ParseReport, iter_ntriples

DEFAULT_INGEST_BATCH = 4096


def resolve_ingest_batch(value=None) -> int:
    """Rows per ingest batch: the argument, else 4,096. Values below 1
    clamp to 1."""
    if value is None:
        return DEFAULT_INGEST_BATCH
    return max(1, int(value))


@dataclass
class IngestStats:
    """What one ingestion run did, batch by batch."""

    rows: int = 0              # triples handed to insert_triples
    inserted: int = 0          # triples actually added (dedup excluded)
    statements: int = 0        # well-formed statements seen in the source
    malformed: int = 0         # source lines skipped (see samples)
    malformed_samples: list = field(default_factory=list)
    new_nodes: int = 0         # node terms minted by this run
    new_preds: int = 0         # predicate terms minted by this run
    batches: int = 0
    seconds: float = 0.0

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.seconds if self.seconds > 0 else 0.0

    def as_dict(self) -> dict:
        return {"rows": self.rows, "inserted": self.inserted,
                "statements": self.statements, "malformed": self.malformed,
                "malformed_samples": list(self.malformed_samples),
                "new_nodes": self.new_nodes, "new_preds": self.new_preds,
                "batches": self.batches, "seconds": self.seconds,
                "rows_per_s": self.rows_per_s}


def iter_tsv(source, report: ParseReport | None = None):
    """Stream ``(s, p, o)`` rows from tab-separated lines (terms taken
    verbatim, no N-Triples syntax). Lines without exactly three non-empty
    fields are counted as malformed on `report` and skipped."""
    close = False
    if isinstance(source, (str, os.PathLike)):
        fh = open(source, "r", encoding="utf-8")
        close = True
    else:
        fh = source
    try:
        for line in fh:
            if report is not None:
                report.lines += 1
            stripped = line.rstrip("\r\n")
            if not stripped.strip() or stripped.lstrip().startswith("#"):
                continue
            fields = stripped.split("\t")
            if len(fields) != 3 or not all(f.strip() for f in fields):
                if report is not None:
                    report.record_malformed(stripped)
                continue
            if report is not None:
                report.statements += 1
            yield fields[0], fields[1], fields[2]
    finally:
        if close:
            fh.close()


def _row_iter(path: str, fmt: str, report: ParseReport):
    if fmt == "auto":
        ext = os.path.splitext(os.fspath(path))[1].lower()
        fmt = "tsv" if ext in (".tsv", ".tab") else "ntriples"
    if fmt == "ntriples":
        return iter_ntriples(path, report)
    if fmt == "tsv":
        return iter_tsv(path, report)
    raise ValueError(f"unknown ingest format {fmt!r} (expected 'auto', 'ntriples', or 'tsv')")


def scan_predicates(path, fmt: str = "auto"):
    """One streaming pass over a file: the distinct predicate terms in
    first-seen order and the well-formed statement count, what sizing an
    engine (its predicate count) needs before ingesting into it."""
    report = ParseReport()
    preds: dict[str, None] = {}
    for _, p_t, _ in _row_iter(path, fmt, report):
        preds[p_t] = None
    return list(preds), report.statements


def ingest_rows(target, rows, *, term_dict: TermDict | None = None,
                batch_size: int | None = None, stats: IngestStats | None = None,
                progress=None) -> IngestStats:
    """Stream decoded ``(s, p, o)`` term rows into `target` in batches.

    `target` exposes ``insert_triples`` (an engine, or a ``GraphStore``'s
    engine); term ids mint through ``target.add_node_terms`` /
    ``add_pred_terms`` when it has them, else directly through the
    dictionary. The dictionary is `term_dict` if given, else
    ``target.term_dict``; a target with neither gets a fresh
    :class:`TermDict` attached through ``attach_term_dict``.
    ``progress(stats)`` fires after every batch.
    """
    td = term_dict if term_dict is not None else getattr(target, "term_dict", None)
    if td is None:
        td = TermDict.empty()
        attach = getattr(target, "attach_term_dict", None)
        if attach is None:
            raise ValueError(
                f"{type(target).__name__} has no term dictionary and no "
                "attach_term_dict(); pass term_dict= explicitly")
        attach(td)
    add_nodes = getattr(target, "add_node_terms", None) or td.add_node_terms
    add_preds = getattr(target, "add_pred_terms", None) or td.add_pred_terms
    batch_size = resolve_ingest_batch(batch_size)
    stats = stats if stats is not None else IngestStats()
    t0 = time.perf_counter()

    def flush(batch: list) -> None:
        n0_nodes, n0_preds = td.n_nodes, td.n_preds
        # subjects and objects in one mint call
        node_ids = torch.as_tensor(add_nodes([r[0] for r in batch] + [r[2] for r in batch]),
                                   dtype=torch.int64)
        pred_ids = torch.as_tensor(add_preds([r[1] for r in batch]), dtype=torch.int64)
        n = len(batch)
        rows_t = torch.stack([node_ids[:n], pred_ids, node_ids[n:]], 1)
        stats.inserted += int(target.insert_triples(rows_t))
        stats.rows += n
        stats.batches += 1
        stats.new_nodes += td.n_nodes - n0_nodes
        stats.new_preds += td.n_preds - n0_preds
        stats.seconds = time.perf_counter() - t0
        if progress is not None:
            progress(stats)

    batch: list = []
    for row in rows:
        batch.append(row)
        if len(batch) >= batch_size:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
    stats.seconds = time.perf_counter() - t0
    return stats


def ingest_file(target, path, *, fmt: str = "auto", term_dict: TermDict | None = None,
                batch_size: int | None = None, progress=None) -> IngestStats:
    """Stream one N-Triples (``.nt``) or TSV file into `target`.

    Returns :class:`IngestStats` with the parse's malformed-line count (and
    samples) folded in, so callers see data loss instead of a silently
    smaller graph.
    """
    report = ParseReport()
    stats = ingest_rows(target, _row_iter(path, fmt, report), term_dict=term_dict,
                        batch_size=batch_size, progress=progress)
    stats.statements = report.statements
    stats.malformed = report.malformed
    stats.malformed_samples = list(report.samples)
    return stats
