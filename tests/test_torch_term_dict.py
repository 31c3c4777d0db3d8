"""The port's term dictionary (``repro_torch.core.term_dict``) and its
snapshot files against the reference, on the CPU.

Ids, lookups and ``to_arrays`` (values, dtypes, meta) equal the reference's
for sorted and unsorted input and every block size; so do the append tail,
``compacted()``, ``size_in_bytes`` and the string resolvers.
``save_term_dict`` writes the reference's files byte for byte, each package
opens the other's directory, and corrupt, wrong-kind or escaping
directories raise ``SnapshotError``.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.term_dict as R_td
import repro.persist.snapshot as R_snap
import repro_torch.core.bgp as P_bgp
import repro_torch.core.term_dict as P_td
import repro_torch.persist.snapshot as P_snap
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

_TERMS = ([f"<http://ex.org/node/{i:04d}>" for i in range(60)]
          + [f"_:b{i}" for i in range(10)]
          + ['"plain lit"', '"inner "quotes""@en', '"line\nbreak"',
             '"tab\there"^^<http://t>', '"1.5"^^<http://xsd#double>', '""',
             '"ünïcödé ✓"@de', '"日本語"'])


def _shuffled(seed):
    terms = list(_TERMS)
    np.random.default_rng(seed).shuffle(terms)
    return terms


def _same_arrays(ref_space, port_space):
    ref_meta, ref_arrays = ref_space.to_arrays()
    port_meta, port_arrays = port_space.to_arrays()
    assert port_meta == ref_meta
    assert sorted(port_arrays) == sorted(ref_arrays)
    for name, want in ref_arrays.items():
        got = port_arrays[name]
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)


def _same_space(ref_space, port_space, probes=()):
    assert len(port_space) == len(ref_space)
    assert port_space.n_base == ref_space.n_base and port_space.n_extra == ref_space.n_extra
    assert port_space.terms_in_id_order() == ref_space.terms_in_id_order()
    for t in [*ref_space.terms_in_id_order(), *probes]:
        assert port_space.term_to_id(t) == ref_space.term_to_id(t), t
    assert port_space.size_in_bytes() == ref_space.size_in_bytes()
    _same_arrays(ref_space, port_space)


@pytest.mark.parametrize("block", [2, 3, 8, 16, 64])
@pytest.mark.parametrize("order", ["sorted", "shuffled0", "shuffled1"])
def test_space_equals_reference(order, block):
    terms = sorted(_TERMS) if order == "sorted" else _shuffled(int(order[-1]))
    ref = R_td.StringSpace.from_terms(terms, block=block)
    port = P_td.StringSpace.from_terms(terms, block=block)
    assert (port._ids is None) == (order == "sorted") == (ref._ids is None)
    _same_space(ref, port, probes=["", "<http://ex.org/absent>", "zzz", '"', "_:b", "<"])
    for i, t in enumerate(terms):
        assert port.id_to_term(i) == t and port.term_to_id(t) == i
    for bad in (len(terms), -1):
        with pytest.raises(IndexError):
            port.id_to_term(bad)


def test_empty_space_and_duplicates():
    ref, port = R_td.StringSpace(), P_td.StringSpace()
    _same_space(ref, port, probes=["x", ""])
    ids = port.add_terms(["a", "b", "a"])
    assert isinstance(ids, torch.Tensor) and ids.dtype == torch.int64
    assert ids.tolist() == ref.add_terms(["a", "b", "a"]).tolist() == [0, 1, 0]
    _same_space(ref, port)
    with pytest.raises(ValueError, match="duplicate"):
        P_td.StringSpace.from_terms(["a", "b", "a"])


@pytest.mark.parametrize("block", [4, 16])
def test_append_tail_and_compaction_equal_reference(block):
    base = _shuffled(2)[:30]
    ref = R_td.StringSpace.from_terms(base, block=block)
    port = P_td.StringSpace.from_terms(base, block=block)
    batch = ["zzz", base[3], "aaa", "zzz", "<http://late/1>", base[0]]
    assert port.add_terms(batch).tolist() == ref.add_terms(batch).tolist()
    _same_space(ref, port, probes=["aab"])
    ref_c, port_c = ref.compacted(), port.compacted()
    assert port_c.n_extra == 0 and len(port_c) == len(port)
    _same_space(ref_c, port_c)
    for i in range(len(port)):
        assert port_c.id_to_term(i) == port.id_to_term(i)
    _same_space(ref.compacted(block=3), port.compacted(block=3))


@pytest.mark.parametrize("source", ["reference", "port"])
def test_from_arrays_either_way(source):
    ref = R_td.StringSpace.from_terms(_shuffled(3), block=8)
    port = P_td.StringSpace.from_terms(_shuffled(3), block=8)
    for s in (ref, port):
        s.add_terms(["tail-1", "tail-2"])
    meta, arrays = (ref if source == "reference" else port).to_arrays()
    _same_space(ref, P_td.StringSpace.from_arrays(meta, arrays))
    _same_space(R_td.StringSpace.from_arrays(meta, arrays), port)


def test_front_coding_compresses_shared_prefixes():
    terms = sorted(f"<http://example.org/very/long/common/prefix/{i}>" for i in range(512))
    port = P_td.StringSpace.from_terms(terms, block=16)
    assert port.size_in_bytes() == R_td.StringSpace.from_terms(terms, block=16).size_in_bytes()
    assert port.size_in_bytes() < 0.5 * sum(len(t.encode()) for t in terms)


def test_resolve_dict_block_takes_arguments_only(monkeypatch):
    assert P_td.resolve_dict_block(4) == R_td.resolve_dict_block(4) == 4
    assert P_td.resolve_dict_block(0) == R_td.resolve_dict_block(0) == 2
    assert P_td.resolve_dict_block() == P_td.DEFAULT_BLOCK == 16
    # the port reads no environment (the reference's knob is not ported)
    for name in [k for k in os.environ if k.endswith("DICT_BLOCK")]:
        monkeypatch.delenv(name)
    monkeypatch.setenv("ITR_" + "DICT_BLOCK", "32")
    assert P_td.resolve_dict_block() == 16 and R_td.resolve_dict_block() == 32


# -- TermDict and the resolvers ------------------------------------------------

def _dicts():
    nodes, preds = ["<http://a>", "<http://b>", "<http://p>"], ["<http://p>", "<http://q>"]
    return R_td.TermDict.from_terms(nodes, preds), P_td.TermDict.from_terms(nodes, preds)


def test_term_dict_two_spaces():
    ref, port = R_td.TermDict.empty(), P_td.TermDict.empty()
    for td in (ref, port):
        td.add_node_terms(["<http://x>", "<http://p>"])
        td.add_pred_terms(["<http://p>"])
    assert (port.n_nodes, port.n_preds) == (ref.n_nodes, ref.n_preds) == (2, 1)
    assert port.node_term(1) == port.pred_term(0) == "<http://p>"
    assert port.bytes_per_term() == ref.bytes_per_term() > 0
    assert port.size_in_bytes() == ref.size_in_bytes()
    port_c, ref_c = port.compacted(), ref.compacted()
    assert port_c.node_id("<http://x>") == ref_c.node_id("<http://x>") == 0
    meta, arrays = port.to_arrays()
    ref_meta, ref_arrays = ref.to_arrays()
    assert meta == ref_meta and sorted(arrays) == sorted(ref_arrays)
    back = P_td.TermDict.from_arrays(ref_meta, ref_arrays)
    assert back.nodes.terms_in_id_order() == ref.nodes.terms_in_id_order()


TRIPLE_CASES = [("<http://a>", None, "<http://b>"), (None, "<http://p>", None),
                ("<http://absent>", None, None), (None, "<http://a>", None),
                ("<http://p>", "<http://q>", "<http://p>"), (None, None, None)]


@pytest.mark.parametrize("case", TRIPLE_CASES, ids=range(len(TRIPLE_CASES)))
def test_resolve_string_triple_equals_reference(case):
    ref, port = _dicts()
    assert P_td.resolve_string_triple(port, *case) == R_td.resolve_string_triple(ref, *case)


BGP_CASES = [
    [("?x", "<http://p>", "?y"), ("?y", "?p", "<http://b>")],
    ("?x", "<http://p>", "?y"),
    [("?x", "<http://nope>", "?y")],
    [("?x", 1, "?y"), (np.int64(0), "?q", "<http://a>")],
]


@pytest.mark.parametrize("case", BGP_CASES, ids=range(len(BGP_CASES)))
def test_resolve_string_bgp_equals_reference(case):
    ref, port = _dicts()
    assert P_td.resolve_string_bgp(port, case) == R_td.resolve_string_bgp(ref, case)


@pytest.mark.parametrize("case,exc", [([("?x", "?x", "?y")], ValueError),
                                      ([("?x", "<http://p>")], ValueError),
                                      ([(None, "<http://p>", "?y")], TypeError)])
def test_resolve_string_bgp_rejects_what_the_reference_rejects(case, exc):
    ref, port = _dicts()
    with pytest.raises(exc):
        R_td.resolve_string_bgp(ref, case)
    with pytest.raises(exc):
        P_td.resolve_string_bgp(port, case)
    with pytest.raises(TypeError):
        P_td.resolve_string_triple(port, 3, None, None)


def test_bgp_result_to_terms_equals_reference():
    from repro.core.bgp import BGPResult as RefResult

    ref, port = _dicts()
    rows = np.array([[0, 0], [1, 1], [2, 0]], dtype=np.int64)
    want = R_td.bgp_result_to_terms(ref, RefResult(("?x", "?p"), rows), {"?p"})
    got = P_td.bgp_result_to_terms(port, P_bgp.BGPResult(("?x", "?p"), torch.from_numpy(rows)),
                                   {"?p"})
    assert got == want


# -- snapshot files ------------------------------------------------------------

def _filled():
    ref = R_td.TermDict.from_terms(_shuffled(4), ["<http://p0>", "<http://p1>"])
    port = P_td.TermDict.from_terms(_shuffled(4), ["<http://p0>", "<http://p1>"])
    for td in (ref, port):
        td.add_node_terms(["<http://late>", '"late literal"@en'])
        td.add_pred_terms(["<http://p2>"])
    return ref, port


def _same_dir(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(names)


@pytest.mark.parametrize("kind", ["filled", "empty", "sorted"])
def test_save_term_dict_is_the_reference_byte_for_byte(kind, tmp_path):
    if kind == "filled":
        ref, port = _filled()
    elif kind == "empty":
        ref, port = R_td.TermDict.empty(), P_td.TermDict.empty()
    else:
        terms = sorted(_TERMS)
        ref, port = R_td.TermDict.from_terms(terms, ["<p>"]), P_td.TermDict.from_terms(terms, ["<p>"])
    a = R_snap.save_term_dict(ref, tmp_path / "ref")
    b = P_snap.save_term_dict(port, tmp_path / "port")
    _same_dir(a, b)
    with open(os.path.join(b, "manifest.json")) as f:
        assert json.load(f)["kind"] == "term_dict"
    # each side opens the other's directory
    for opened, want in ((P_snap.load_term_dict(a), ref), (R_snap.load_term_dict(b), port)):
        assert opened.nodes.terms_in_id_order() == want.nodes.terms_in_id_order()
        assert opened.preds.terms_in_id_order() == want.preds.terms_in_id_order()
        for t in want.nodes.terms_in_id_order():
            assert opened.node_id(t) == want.node_id(t)
    P_snap.save_term_dict(P_snap.load_term_dict(a), tmp_path / "again")
    _same_dir(a, tmp_path / "again")


def _corrupt(d, how):
    if how == "flipped_byte":
        blob = os.path.join(d, "nodes_blob.npy")
        raw = bytearray(open(blob, "rb").read())
        raw[-1] ^= 0xFF
        open(blob, "wb").write(bytes(raw))
    elif how == "removed_array":
        os.remove(os.path.join(d, "preds_lcps.npy"))
    elif how == "removed_manifest":
        os.remove(os.path.join(d, "manifest.json"))
    elif how == "wrong_kind":
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump({"format": 1, "checksums": {}}, f)
    elif how == "engine_snapshot_kind":
        m = json.load(open(os.path.join(d, "manifest.json")))
        m.pop("kind")
        json.dump(m, open(os.path.join(d, "manifest.json"), "w"))
    elif how == "escape":
        m = json.load(open(os.path.join(d, "manifest.json")))
        m["checksums"]["../outside.npy"] = 0
        json.dump(m, open(os.path.join(d, "manifest.json"), "w"))
    elif how == "inconsistent":
        m = json.load(open(os.path.join(d, "manifest.json")))
        del m["spaces"]["nodes"]["block"]
        json.dump(m, open(os.path.join(d, "manifest.json"), "w"))


@pytest.mark.parametrize("how", ["flipped_byte", "removed_array", "removed_manifest",
                                 "wrong_kind", "engine_snapshot_kind", "escape",
                                 "inconsistent", "missing_dir"])
def test_a_broken_term_dict_raises(how, tmp_path):
    _, port = _filled()
    d = P_snap.save_term_dict(port, tmp_path / "td")
    if how == "missing_dir":
        d = str(tmp_path / "nowhere")
    else:
        _corrupt(d, how)
    with pytest.raises(P_snap.SnapshotError):
        P_snap.load_term_dict(d)


def test_verify_off_skips_the_checksums(tmp_path):
    _, port = _filled()
    d = P_snap.save_term_dict(port, tmp_path / "td")
    m = json.load(open(os.path.join(d, "manifest.json")))
    m["checksums"] = {k: 0 for k in m["checksums"]}
    json.dump(m, open(os.path.join(d, "manifest.json"), "w"))
    with pytest.raises(P_snap.SnapshotError, match="checksum"):
        P_snap.load_term_dict(d)
    assert P_snap.load_term_dict(d, verify=False).nodes.terms_in_id_order() == \
        port.nodes.terms_in_id_order()


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 40), st.integers(1, 120), st.booleans())
def test_property_space_equals_reference(block, n_terms, shuffle):
    rng = np.random.default_rng(block * 1000 + n_terms)
    terms = [f"<http://t/{i}/{'x' * int(rng.integers(0, 20))}>" for i in range(n_terms)]
    if shuffle:
        rng.shuffle(terms)
    port = P_td.StringSpace.from_terms(terms, block=block)
    for i, t in enumerate(terms):
        assert port.term_to_id(t) == i and port.id_to_term(i) == t
    assert port.term_to_id("<absent>") is None
    _same_space(R_td.StringSpace.from_terms(terms, block=block), port)
    assert P_td.StringSpace.from_arrays(*port.to_arrays()).terms_in_id_order() == terms
