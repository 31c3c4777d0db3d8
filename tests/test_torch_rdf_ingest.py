"""The port's N-Triples reader and writer, streaming ingestion, string
query surfaces and ``GraphStore`` against the reference, on the CPU.

``iter_ntriples``, ``parse_ntriples``, ``write_ntriples`` and the literal
escapes equal the reference's on the committed fixture
(``tests/fixtures/small.nt``) and on adversarial literals, files byte for
byte. Ingesting one file into a port engine and into a reference engine
gives the same id triples, dictionary arrays and ``IngestStats``, also
when the overlay budget makes the engines rebuild mid-ingest; string
queries (all eight patterns, unknown terms) and string BGPs (predicate
variables included) equal the reference's and a plain-Python oracle; the
dictionary survives ``rebuild``. ``GraphStore``'s CSR, CSC and edge index,
neighbourhoods and mutations equal the reference's.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data.graph_store as R_gs
import repro.data.ingest as R_ing
import repro.data.rdf as R_rdf
import repro_torch.core as P
import repro_torch.data.graph_store as P_gs
import repro_torch.data.ingest as P_ing
import repro_torch.data.rdf as P_rdf
from repro.data.synthetic import rdf_like
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "small.nt")
PATTERNS = ["spo", "sp?", "s?o", "s??", "?po", "?p?", "??o", "???"]

NODE_POOL = [
    "<http://ex.org/a>", "<http://ex.org/b#frag>", "_:b1", "_:x.y-z", '"plain"',
    '"with "inner" quotes"@en', '"line\nbreak"@en-GB',
    '"tab\there"^^<http://www.w3.org/2001/XMLSchema#string>', '"back\\slash \\ again"',
    '"looks like a terminator . <http://not-a-term>"',
    '"1.5"^^<http://www.w3.org/2001/XMLSchema#double>', '"carriage\rreturn"', '"ünï ✓"@de',
]
PRED_POOL = ["<http://ex.org/p0>", "<http://ex.org/p1>", "<http://ex.org/p2>"]


def _oracle():
    """The fixture as a plain-Python set of term-string triples."""
    triples, nodes, preds, report = R_rdf.parse_ntriples(FIXTURE)
    assert report.malformed == 1
    return {(nodes[s], preds[p], nodes[o]) for s, p, o in triples}


def _answer(oracle, s, p, o):
    return {t for t in oracle if (s is None or t[0] == s) and (p is None or t[1] == p)
            and (o is None or t[2] == o)}


def _rows(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t).reshape(-1, 3)


# -- N-Triples -----------------------------------------------------------------

def test_fixture_parses_as_the_reference(tmp_path):
    want = R_rdf.parse_ntriples(FIXTURE)
    triples, nodes, preds, report = P_rdf.parse_ntriples(FIXTURE, device="cpu")
    assert triples.dtype == torch.int64 and triples.device.type == "cpu"
    np.testing.assert_array_equal(triples.numpy(), want[0])
    assert (nodes, preds, report.as_dict()) == (want[1], want[2], want[3].as_dict())
    ref_report, port_report = R_rdf.ParseReport(), P_rdf.ParseReport()
    assert list(P_rdf.iter_ntriples(FIXTURE, port_report)) == \
        list(R_rdf.iter_ntriples(FIXTURE, ref_report))
    assert port_report.as_dict() == ref_report.as_dict()
    # write -> byte-equal files, and the written file parses back the same
    R_rdf.write_ntriples(str(tmp_path / "ref.nt"), want[0], want[1], want[2])
    P_rdf.write_ntriples(str(tmp_path / "port.nt"), triples, nodes, preds)
    assert (tmp_path / "port.nt").read_bytes() == (tmp_path / "ref.nt").read_bytes()
    again = P_rdf.parse_ntriples(str(tmp_path / "port.nt"), device="cpu")
    assert torch.equal(again[0], triples) and again[1:3] == (nodes, preds)
    P_rdf.write_ntriples(str(tmp_path / "default.nt"), triples)
    R_rdf.write_ntriples(str(tmp_path / "default_ref.nt"), want[0])
    assert (tmp_path / "default.nt").read_bytes() == (tmp_path / "default_ref.nt").read_bytes()


@pytest.mark.parametrize("seed", range(4))
def test_adversarial_literals_round_trip_as_the_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    rows = np.stack([rng.integers(0, len(NODE_POOL), n), rng.integers(0, len(PRED_POOL), n),
                     rng.integers(0, len(NODE_POOL), n)], 1)
    R_rdf.write_ntriples(str(tmp_path / "ref.nt"), rows, NODE_POOL, PRED_POOL)
    P_rdf.write_ntriples(str(tmp_path / "port.nt"), torch.from_numpy(rows), NODE_POOL, PRED_POOL)
    assert (tmp_path / "port.nt").read_bytes() == (tmp_path / "ref.nt").read_bytes()
    got = P_rdf.parse_ntriples(str(tmp_path / "port.nt"), device="cpu")
    want = R_rdf.parse_ntriples(str(tmp_path / "ref.nt"))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert got[1:3] == tuple(want[1:3]) and got[3].malformed == 0
    assert {(got[1][s], got[2][p], got[1][o]) for s, p, o in got[0].tolist()} == \
        {(NODE_POOL[s], PRED_POOL[p], NODE_POOL[o]) for s, p, o in rows.tolist()}


@pytest.mark.parametrize("term", NODE_POOL + ['"a\\"b"', '"@fake-suffix"@en', '"x"^^<http://t>'])
def test_term_codes_equal_reference(term):
    for fn in ("encode_term", "decode_term"):
        try:
            want = getattr(R_rdf, fn)(term)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(P_rdf, fn)(term)
            continue
        assert getattr(P_rdf, fn)(term) == want
    body = term.strip('"')
    assert P_rdf.escape_literal(body) == R_rdf.escape_literal(body)
    assert P_rdf.unescape_literal(P_rdf.escape_literal(body)) == body


def test_escapes_and_reports_as_the_reference():
    assert P_rdf.unescape_literal(r"A\U00000042é\t") == R_rdf.unescape_literal(
        r"A\U00000042é\t") == "ABé\t"
    with pytest.raises(ValueError):
        P_rdf.unescape_literal(r"\q")
    with pytest.raises(ValueError):
        P_rdf.decode_term('"unterminated')
    lines = ["# a comment", "", "<http://a> <http://p> _:b1.", "this is junk",
             "<http://only> <http://two-terms>", '_:a.b-c <http://p> "x\\ny"@en .'] \
        + [f"junk {i}" for i in range(8)]
    ref_report, port_report = R_rdf.ParseReport(), P_rdf.ParseReport()
    assert list(P_rdf.iter_ntriples(lines, port_report)) == \
        list(R_rdf.iter_ntriples(lines, ref_report))
    assert port_report.as_dict() == ref_report.as_dict()
    assert len(port_report.samples) == P_rdf.ParseReport._MAX_SAMPLES


def test_parse_ntriples_refuses_without_a_device_choice_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        P_rdf.parse_ntriples(FIXTURE)


# -- ingestion -----------------------------------------------------------------

def _empty_pair(n_preds=8, delta_budget=None, cache=False):
    g = R.Hypergraph.from_triples(np.zeros((0, 3), dtype=np.int64), 1)
    table = R.LabelTable.terminals([2] * n_preds)
    ref_g, _ = R.compress(g, table)
    port_g, _ = P.compress(P.Hypergraph.from_triples(np.zeros((0, 3)), 1, device="cpu"),
                           P.LabelTable.terminals([2] * n_preds, device="cpu"))
    kw = dict(crossover=0, delta_budget=delta_budget)
    return (R.TripleQueryEngine(ref_g, cache=R.QueryResultCache() if cache else None, **kw),
            P.TripleQueryEngine(port_g, cache=P.QueryResultCache() if cache else None, **kw))


def _same_stats(ref_stats, port_stats):
    want, got = ref_stats.as_dict(), port_stats.as_dict()
    for d in (want, got):
        d.pop("seconds"), d.pop("rows_per_s")
    assert got == want
    assert port_stats.rows_per_s > 0


def _same_dict(ref_td, port_td):
    ref_meta, ref_arrays = ref_td.to_arrays()
    meta, arrays = port_td.to_arrays()
    assert meta == ref_meta and sorted(arrays) == sorted(ref_arrays)
    for k, v in ref_arrays.items():
        assert arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(arrays[k], v)


@pytest.mark.parametrize("batch", [1, 4, 5, None])
def test_fixture_ingest_equals_reference(batch):
    ref, port = _empty_pair()
    want = R_ing.ingest_file(ref, FIXTURE, batch_size=batch)
    got = P_ing.ingest_file(port, FIXTURE, batch_size=batch)
    _same_stats(want, got)
    assert (got.rows, got.inserted, got.statements, got.malformed) == (13, 13, 13, 1)
    np.testing.assert_array_equal(_rows(port.current_triples()), ref.current_triples())
    _same_dict(ref.term_dict, port.term_dict)
    oracle = _oracle()
    for s, p, o in sorted(oracle):
        for pat in PATTERNS:
            q = (s if pat[0] == "s" else None, p if pat[1] == "p" else None,
                 o if pat[2] == "o" else None)
            got_q = port.query_strings(*q)
            assert sorted(got_q) == sorted(ref.query_strings(*q))
            assert set(got_q) == _answer(oracle, *q), (pat, q)


def test_ingest_through_rebuilds_equals_reference(tmp_path):
    ds = rdf_like(120, 400, 3, seed=4)
    names = [f"<http://example.org/resource/{i:06d}>" for i in range(ds.n_nodes)]
    preds = [f"<http://example.org/ontology/p{i}>" for i in range(ds.n_preds)]
    path = str(tmp_path / "g.nt")
    R_rdf.write_ntriples(path, ds.triples, names, preds)
    with open(path, "a") as f:
        f.write("not a triple\n")
    assert P_ing.scan_predicates(path) == R_ing.scan_predicates(path)
    ref, port = _empty_pair(n_preds=ds.n_preds, delta_budget=100, cache=True)
    want = R_ing.ingest_file(ref, path, batch_size=64)
    got = P_ing.ingest_file(port, path, batch_size=64)
    _same_stats(want, got)
    assert port.rebuild_count == ref.rebuild_count > 0
    np.testing.assert_array_equal(_rows(port.current_triples()), ref.current_triples())
    _same_dict(ref.term_dict, port.term_dict)
    logical = {(names[s], preds[p], names[o]) for s, p, o in ds.triples.tolist()}
    for s in names[:40:3]:
        assert set(port.query_strings(s, None, None)) == _answer(logical, s, None, None)
        assert set(port.query_strings(None, None, s)) == _answer(logical, None, None, s)
    # ingesting the same file again dedups at the triple level
    again = P_ing.ingest_file(port, path)
    assert again.inserted == 0 and again.new_nodes == 0 and again.new_preds == 0


def test_string_bgps_equal_reference_and_oracle():
    ref, port = _empty_pair()
    R_ing.ingest_file(ref, FIXTURE)
    P_ing.ingest_file(port, FIXTURE)
    oracle = _oracle()
    knows, works = "<http://ex.org/knows>", "<http://ex.org/worksFor>"
    cases = [[("?x", knows, "?y"), ("?y", knows, "?z")],
             [("<http://ex.org/alice>", "?p", "?o")],
             [("?x", works, "?c"), ("?c", "?p", "?o")],
             ("?x", knows, "?y"),
             [("?x", "<http://no.such/pred>", "?y")],
             [("<http://ex.org/nobody>", "?p", "?o")]]
    for bgp in cases:
        got = port.query_bgp_strings(bgp)
        assert got == ref.query_bgp_strings(bgp)
    rows = port.query_bgp_strings(cases[0])
    want = {(a[0], a[2], b[2]) for a in oracle if a[1] == knows
            for b in oracle if b[1] == knows and b[0] == a[2]}
    assert {(r["?x"], r["?y"], r["?z"]) for r in rows} == want and rows
    rows = port.query_bgp_strings(cases[1])
    assert {(r["?p"], r["?o"]) for r in rows} == \
        {(p, o) for s, p, o in oracle if s == "<http://ex.org/alice>"}
    assert port.query_bgp_strings(cases[4]) == [] and port.query_strings(
        "<http://ex.org/nobody>", None, None) == []
    with pytest.raises(ValueError, match="both predicate and"):
        port.query_bgp_strings([("?x", "?x", "?y")])


def test_unknown_terms_execute_nothing(monkeypatch):
    _, port = _empty_pair()
    P_ing.ingest_file(port, FIXTURE)
    calls = []
    monkeypatch.setattr(port, "_run_batch_view", lambda *a: calls.append(a))
    monkeypatch.setattr(port, "query_scalar", lambda *a: calls.append(a))
    assert port.query_strings("<http://ex.org/nobody>", None, None) == []
    assert port.query_strings(None, "<http://ex.org/nothing>", None) == []
    assert port.query_bgp_strings([("?x", "<http://no.such/pred>", "?y")]) == []
    assert calls == []


def test_engine_requires_a_dictionary_and_keeps_it_across_rebuild():
    ref, port = _empty_pair()
    with pytest.raises(ValueError, match="no term dictionary"):
        port.query_strings("<http://x>", None, None)
    with pytest.raises(ValueError, match="no term dictionary"):
        port.query_bgp_strings([("?x", "<http://p>", "?y")])
    P_ing.ingest_file(port, FIXTURE)
    R_ing.ingest_file(ref, FIXTURE)
    td = port.term_dict
    assert port.rebuild() is True and ref.rebuild() is True
    assert port.term_dict is td
    np.testing.assert_array_equal(_rows(port.current_triples()), ref.current_triples())
    oracle = _oracle()
    for s, p, o in sorted(oracle):
        assert set(port.query_strings(s, None, None)) == _answer(oracle, s, None, None)
        assert set(port.query_strings(None, p, o)) == _answer(oracle, None, p, o)


def test_tsv_rows_and_predicate_capacity(tmp_path):
    lines = ["<http://a>\t<http://p>\t<http://b>", "only\ttwo", "",
             '<http://a>\t<http://p>\t"lit with spaces"', "# comment", "a\t\tb"]
    ref_report, port_report = R_rdf.ParseReport(), P_rdf.ParseReport()
    assert list(P_ing.iter_tsv(lines, port_report)) == list(R_ing.iter_tsv(lines, ref_report))
    assert port_report.as_dict() == ref_report.as_dict()
    path = tmp_path / "g.tsv"
    path.write_text("\n".join(lines) + "\n")
    ref, port = _empty_pair(n_preds=1)
    _same_stats(R_ing.ingest_file(ref, str(path)), P_ing.ingest_file(port, str(path)))
    assert sorted(port.query_strings(None, "<http://p>", None)) == sorted(
        ref.query_strings(None, "<http://p>", None))
    _, small = _empty_pair(n_preds=2)
    with pytest.raises(ValueError, match="predicate ids must be"):
        P_ing.ingest_file(small, FIXTURE)
    with pytest.raises(ValueError, match="unknown ingest format"):
        P_ing.scan_predicates(FIXTURE, fmt="xml")


def test_ingest_rows_contracts():
    class Bare:
        def insert_triples(self, t):
            return len(t)

    with pytest.raises(ValueError, match="attach"):
        P_ing.ingest_rows(Bare(), [("<http://a>", "<http://p>", "<http://b>")])
    td = P.TermDict.empty()
    seen = []
    stats = P_ing.IngestStats()
    rows = [("<http://a>", "<http://p>", "<http://b>"), ("<http://b>", "<http://p>", "<http://c>"),
            ("<http://c>", "<http://p>", "<http://a>")]
    out = P_ing.ingest_rows(Bare(), rows, term_dict=td, batch_size=2, stats=stats,
                            progress=lambda s: seen.append(s.rows))
    assert out is stats and stats.batches == 2 and seen == [2, 3]
    assert (stats.new_nodes, stats.new_preds, stats.inserted) == (3, 1, 3)


def test_resolve_ingest_batch_takes_arguments_only(monkeypatch):
    assert P_ing.resolve_ingest_batch(7) == R_ing.resolve_ingest_batch(7) == 7
    assert P_ing.resolve_ingest_batch(0) == R_ing.resolve_ingest_batch(0) == 1
    monkeypatch.setenv("ITR_" + "INGEST_BATCH", "64")
    assert P_ing.resolve_ingest_batch(None) == 4096 and R_ing.resolve_ingest_batch(None) == 64


# -- GraphStore ----------------------------------------------------------------

def _stores(seed=7):
    ds = rdf_like(80, 300, 3, seed=seed)
    ref = R_gs.GraphStore.from_triples(ds.triples, ds.n_nodes, ds.n_preds)
    port = P_gs.GraphStore.from_triples(torch.from_numpy(ds.triples), ds.n_nodes, ds.n_preds,
                                        device="cpu")
    return ds, ref, port


def _same_views(ref, port):
    for name in ("csr", "csc", "edge_index"):
        got, want = getattr(port, name)(), getattr(ref, name)()
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and g.device == port.device
            np.testing.assert_array_equal(g.numpy(), w)


def _plain_csr(rows, n, by):
    """(indptr, indices) of `rows` grouped by column `by`, each group in row
    order, written out in plain Python."""
    other = 2 - by
    groups = [[] for _ in range(n)]
    for r in rows:
        groups[r[by]].append(r[other])
    indptr = [0]
    for g in groups:
        indptr.append(indptr[-1] + len(g))
    return indptr, [v for g in groups for v in g]


def test_graph_store_views_equal_reference_and_a_plain_sort():
    ds, ref, port = _stores()
    assert port.n_nodes == ref.n_nodes and port.device.type == "cpu"
    assert port.compressed_size_bytes() == ref.compressed_size_bytes()
    _same_views(ref, port)
    rows = port._rank2_rows().tolist()
    assert sorted(map(tuple, rows)) == sorted(map(tuple, ds.triples.tolist()))
    for by, view in ((0, port.csr()), (2, port.csc())):
        assert tuple(t.tolist() for t in view) == _plain_csr(rows, ds.n_nodes, by)
    assert port.csr() is port.csr()  # materialized once


def test_graph_store_point_paths_equal_reference():
    ds, ref, port = _stores()
    vs = [0, 3, 5, 17, 40, 79, 3]
    for a, b in zip(port.neighbors_out_batch(vs), ref.neighbors_out_batch(vs)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(port.neighbors_in_batch(vs), ref.neighbors_in_batch(vs)):
        np.testing.assert_array_equal(a.numpy(), b)
    for v in (0, 5, 60):
        np.testing.assert_array_equal(port.neighbors_out(v).numpy(), ref.neighbors_out(v))
        np.testing.assert_array_equal(port.neighbors_in(v).numpy(), ref.neighbors_in(v))
    s, p, o = (int(x) for x in ds.triples[0])
    for q in ((s, None, None), (None, p, None), (s, p, o)):
        assert sorted(port.triples(*q)) == sorted(ref.triples(*q))
    view = port.triples_batch_view([s, -1], [-1, p], [-1, -1])
    assert view.n_queries == 2 and view.total_results() == \
        ref.triples_batch_view([s, -1], [-1, p], [-1, -1]).total_results()
    assert port.query_cache_stats() is not None


def test_graph_store_mutations_equal_reference():
    ds, ref, port = _stores()
    port.csr(), port.csc(), ref.csr(), ref.csc()
    new = np.array([[0, 0, 79], [79, 1, 0], [5, 2, 5]])
    assert port.insert_triples(torch.from_numpy(new)) == ref.insert_triples(new)
    assert port._csr is None and port._csc is None
    _same_views(ref, port)
    dead = ds.triples[:6]
    assert port.delete_triples(torch.from_numpy(dead)) == ref.delete_triples(dead)
    _same_views(ref, port)
    with pytest.raises(ValueError, match="n_nodes"):
        port.insert_triples([[0, 0, ds.n_nodes]])
    assert port.rebuild() is True and ref.rebuild() is True
    assert port.grammar is port.engine.grammar
    _same_views(ref, port)
    assert port.rebuild() is False
    for v in (0, 5, 79):
        np.testing.assert_array_equal(port.neighbors_out(v).numpy(), ref.neighbors_out(v))
