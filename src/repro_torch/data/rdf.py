"""N-Triples reader and writer with id dictionaries and a streaming iterator.

The twin of the reference's ``data/rdf.py``, host Python with a copy of its
regular expressions. Handles ``<iri>`` terms, ``_:label`` blank nodes and
``"literal"`` objects (plain, ``@lang``-tagged or ``^^<datatype>``-typed);
blank nodes are treated as IRIs for id purposes.

Terms circulate in decoded form: IRIs and blank nodes keep their surface
spelling (``<http://…>``, ``_:b1``), literals keep the surrounding quotes
and any suffix but hold the raw, unescaped body text. ``encode_term`` /
``decode_term`` convert between that form and the escaped on-the-wire
spelling, so parse -> write -> parse is the identity even for literals
holding quotes, backslashes or newlines.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import torch

from repro_torch.device import as_i64, resolve_device

# A blank-node label must not end with '.', so a statement terminator with
# no preceding space ("_:b1.") stays a terminator instead of being
# swallowed into the label.
_BNODE = r"_:[A-Za-z0-9_](?:[A-Za-z0-9_.\-]*[A-Za-z0-9_\-])?"
_TERM = re.compile(
    r'(<[^>]*>|' + _BNODE + r'|"(?:[^"\\]|\\.)*"(?:\^\^<[^>]*>|@[\w-]+)?)'
)

# escaped-literal body: ECHAR escapes plus \uXXXX / \UXXXXXXXX
_UNESCAPE = re.compile(r"\\(u[0-9a-fA-F]{4}|U[0-9a-fA-F]{8}|.)")
_ECHAR_DECODE = {"t": "\t", "b": "\b", "n": "\n", "r": "\r", "f": "\f",
                 '"': '"', "'": "'", "\\": "\\"}
_ECHAR_ENCODE = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\r": "\\r",
                 "\t": "\\t"}
# suffix of a literal term (after the closing quote): datatype or lang tag
_LITERAL = re.compile(r'^"(.*)"(\^\^<[^>]*>|@[\w-]+)?$', re.DOTALL)


@dataclass
class ParseReport:
    """What a parse saw: total lines, parsed statements, and the malformed
    lines that were skipped (count + first few samples), so ingestion can
    surface data loss instead of hiding it."""

    lines: int = 0
    statements: int = 0
    malformed: int = 0
    samples: list = field(default_factory=list)

    _MAX_SAMPLES = 5

    def record_malformed(self, line: str) -> None:
        self.malformed += 1
        if len(self.samples) < self._MAX_SAMPLES:
            self.samples.append(line)

    def as_dict(self) -> dict:
        return {"lines": self.lines, "statements": self.statements,
                "malformed": self.malformed, "samples": list(self.samples)}


def unescape_literal(body: str) -> str:
    """Decode an escaped N-Triples literal body to raw text."""

    def _sub(m: re.Match) -> str:
        esc = m.group(1)
        if esc[0] in "uU" and len(esc) > 1:
            return chr(int(esc[1:], 16))
        try:
            return _ECHAR_DECODE[esc]
        except KeyError:
            raise ValueError(f"invalid literal escape: \\{esc}") from None

    return _UNESCAPE.sub(_sub, body)


def escape_literal(body: str) -> str:
    """Encode raw literal text into its N-Triples escaped spelling."""
    return "".join(_ECHAR_ENCODE.get(ch, ch) for ch in body)


def _split_literal(term: str):
    """Split a literal term into (body, suffix). The suffix (lang tag or
    datatype) never contains a quote, so the split point is the last ``"``."""
    m = _LITERAL.match(term)
    if m is None:
        raise ValueError(f"not a literal term: {term!r}")
    return m.group(1), m.group(2) or ""


def decode_term(term: str) -> str:
    """On-the-wire term -> canonical decoded form (see the module docstring)."""
    if term.startswith('"'):
        body, suffix = _split_literal(term)
        return '"' + unescape_literal(body) + '"' + suffix
    return term


def encode_term(term: str) -> str:
    """Canonical decoded term -> escaped on-the-wire N-Triples spelling."""
    if term.startswith('"'):
        body, suffix = _split_literal(term)
        return '"' + escape_literal(body) + '"' + suffix
    return term


def iter_ntriples(source, report: ParseReport | None = None):
    """Stream decoded ``(s, p, o)`` term-string rows from an N-Triples source
    (a path or any iterable of lines). Lines that do not parse to at least
    three terms are counted (and sampled) on `report` and skipped."""
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
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                continue
            terms = _TERM.findall(stripped)
            if len(terms) < 3:
                if report is not None:
                    report.record_malformed(stripped)
                continue
            if report is not None:
                report.statements += 1
            yield decode_term(terms[0]), decode_term(terms[1]), decode_term(terms[2])
    finally:
        if close:
            fh.close()


def parse_ntriples(path: str, device=None):
    """Returns ``(triples, node_names, pred_names, report)``: the triples an
    ``(n, 3)`` int64 tensor on `device` (``None`` means CUDA), ids minted in
    first-seen order; ``report`` a :class:`ParseReport` whose ``malformed``
    count covers every non-empty, non-comment line that did not parse to
    three terms."""
    dev = resolve_device(device)
    nodes: dict[str, int] = {}
    preds: dict[str, int] = {}
    rows: list[int] = []
    report = ParseReport()
    for s_t, p_t, o_t in iter_ntriples(path, report):
        rows.append(nodes.setdefault(s_t, len(nodes)))
        rows.append(preds.setdefault(p_t, len(preds)))
        rows.append(nodes.setdefault(o_t, len(nodes)))
    triples = torch.tensor(rows, dtype=torch.int64).reshape(-1, 3).to(dev)
    return triples, list(nodes), list(preds), report


def write_ntriples(path: str, triples, node_names=None, pred_names=None) -> None:
    """Write id triples (a tensor or any array-like) as N-Triples,
    re-escaping literal bodies, so parse -> write -> parse round-trips
    adversarial literals."""
    with open(path, "w", encoding="utf-8") as fh:
        for s, p, o in as_i64(triples, "cpu").reshape(-1, 3).tolist():
            s_t = node_names[s] if node_names else f"<http://ex.org/n{s}>"
            p_t = pred_names[p] if pred_names else f"<http://ex.org/p{p}>"
            o_t = node_names[o] if node_names else f"<http://ex.org/n{o}>"
            fh.write(f"{encode_term(s_t)} {encode_term(p_t)} {encode_term(o_t)} .\n")
