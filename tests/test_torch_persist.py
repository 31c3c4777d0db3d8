"""The port's crash hooks and engine snapshots against the reference, on the
CPU.

Snapshots: on engines built from the same seeded triples, config and
crossover (fresh, with an overlay, after a rebuild, with names, empty), the
port's snapshot directory must equal the reference's file for file and
byte for byte, ``manifest.json`` included. Each package opens the other's
snapshot: answers to all eight patterns, overlay rows, ``crossover``,
``delta_budget``, ``base_edges`` and ``rebuild_count`` agree, and a rebuild
of either opened engine gives the reference's grammar bit for bit. The
reference's contracts of ``tests/test_persist.py`` (mmap and copy, a
mutable opened engine, checksum / missing array / missing manifest /
format gates, atomic overwrite under a crash) run through the port's API,
each held against the reference's outcome. Crash hooks: the injector's
schedule, nesting and parsing as the reference's.
"""
import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro.core as R
import repro.persist.crash as R_crash
import repro.persist.snapshot as R_snap
import repro_torch.core as P
import repro_torch.persist.crash as P_crash
import repro_torch.persist.snapshot as P_snap
from repro_torch.core.repair import RepairConfig as PortConfig
from tests.test_torch_build import assert_same_grammar, port_hypergraph
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

ALL_PATTERNS = [(-1, -1, -1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1),
                (1, 1, -1), (1, -1, 1), (-1, 1, 1), (1, 1, 1)]
N_NODES, N_PREDS = 24, 4
NEW = [N_NODES + 1, 2, 2]  # a triple past the base graph's nodes: never in the base


def _rand_triples(seed, n, n_nodes=N_NODES, n_preds=N_PREDS):
    rng = np.random.default_rng(seed)
    return np.unique(np.stack([rng.integers(0, n_nodes, n), rng.integers(0, n_preds, n),
                               rng.integers(0, n_nodes, n)], axis=1), axis=0)


def _pair(rows, *, config=None, names=None, crossover=2, budget=None):
    """A reference and a port engine over the same triples, config and
    crossover; each with a cache of its own and `_base_edges` set as the
    reference's tests set it."""
    graph = R.Hypergraph.from_triples(rows, N_NODES)
    table = R.LabelTable.terminals(np.full(N_PREDS, 2, dtype=np.int64), names=names)
    ref_g, _ = R.compress(graph, table, config)
    pg, pt = port_hypergraph(graph, table)
    pt.names = names
    port_cfg = None if config is None else PortConfig(**vars(config))
    port_g, _ = P.compress(pg, pt, port_cfg)
    ref = R.TripleQueryEngine(ref_g, config=config, crossover=crossover, delta_budget=budget)
    port = P.TripleQueryEngine(port_g, config=port_cfg, crossover=crossover,
                               delta_budget=budget)
    ref._base_edges = port._base_edges = len(rows)
    return ref, port


def _both(ref, port, method, *args):
    got = getattr(port, method)(*(torch.from_numpy(np.asarray(a)) for a in args))
    want = getattr(ref, method)(*args)
    assert got == want
    return got


def _mutate(ref, port, rows, seed):
    rng = np.random.default_rng(seed)
    _both(ref, port, "insert_triples", np.array([[1, 2, 3], [5, 0, 9], [N_NODES + 2, 1, 0]]))
    _both(ref, port, "delete_triples", rows[rng.choice(len(rows), 4, replace=False)])


def _answers(engine):
    return {pat: sorted((int(lbl), tuple(int(v) for v in nodes))
                        for lbl, nodes in engine.query(*pat)) for pat in ALL_PATTERNS}


def _overlay(engine):
    return [np.asarray(a).tolist() for a in (engine.delta.inserts, engine.delta.tombstones)]


def _scalars(engine):
    return (engine.crossover, engine.delta_budget, engine._base_edges, engine.rebuild_count)


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def _scenario(name):
    rows = _rand_triples(3, 220)
    names = [f"pred{i}" for i in range(N_PREDS)] if name == "names" else None
    ref, port = _pair(rows, config=R.RepairConfig(max_rank=8), names=names)
    if name in ("overlay", "rebuilt", "names"):
        _mutate(ref, port, rows, 1)
    if name == "rebuilt":
        assert ref.rebuild() and port.rebuild()
        _mutate(ref, port, _rand_triples(4, 60), 2)
    return ref, port


SCENARIOS = ["fresh", "overlay", "rebuilt", "names"]


# -- crash hooks -----------------------------------------------------------

@pytest.mark.parametrize("mod", [R_crash, P_crash], ids=["reference", "port"])
def test_schedule_fires_on_exact_hit(mod):
    inj = mod.CrashInjector({"pt": 3})
    inj.visit("pt")
    inj.visit("pt")
    with pytest.raises(mod.CrashPoint) as exc:
        inj.visit("pt")
    assert exc.value.name == "pt" and inj.hits["pt"] == 3
    inj.visit("pt")  # past the scheduled hit: disarmed again
    assert not issubclass(mod.CrashPoint, Exception)


@pytest.mark.parametrize("mod", [R_crash, P_crash], ids=["reference", "port"])
def test_inject_crashes_nests_and_restores(mod):
    assert mod.active_injector() is None
    with mod.inject_crashes({"a": 1}) as outer:
        with mod.inject_crashes({"b": 1}) as inner:
            assert mod.active_injector() is inner
            mod.crash_point("a")  # counts against the inner schedule only
        assert mod.active_injector() is outer
        with pytest.raises(mod.CrashPoint):
            try:
                mod.crash_point("a")
            except Exception:  # noqa: BLE001 - a kill must pass a broad handler
                pytest.fail("CrashPoint caught by `except Exception`")
    assert inner.hits == {"a": 1} and outer.hits == {"a": 1}
    assert mod.active_injector() is None
    mod.crash_point("a")  # disarmed outside all blocks


@pytest.mark.parametrize("spec", ["wal.append:2, snapshot.pre_commit", "", " , ",
                                  "engine.rebuild:1,engine.rebuild:3", "a:0", "x:-2",
                                  "wal.append:two", ":3", "a:1,:2"])
def test_parse_crash_points_as_the_reference(spec):
    try:
        want = R_crash.parse_crash_points(spec)
    except ValueError:
        with pytest.raises(ValueError):
            P_crash.parse_crash_points(spec)
        return
    assert P_crash.parse_crash_points(spec) == want


def test_port_crash_hooks_read_no_environment(monkeypatch):
    monkeypatch.setenv(R_crash._ENV_VAR, "engine.rebuild:1")  # the reference's knob
    P_crash.crash_point("engine.rebuild")  # nothing armed: no crash
    assert P_crash.active_injector() is None


# -- snapshots: bytes and cross-opens ----------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_port_snapshot_is_the_references_byte_for_byte(name, tmp_path):
    ref, port = _scenario(name)
    R_snap.save_snapshot(ref, tmp_path / "ref")
    P_snap.save_snapshot(port, tmp_path / "port")
    _same_dirs(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_side_opens_the_others_snapshot(name, writer, tmp_path):
    ref, port = _scenario(name)
    path = tmp_path / "snap"
    (R_snap if writer == "reference" else P_snap).save_snapshot(
        ref if writer == "reference" else port, path)
    r_open = R_snap.load_snapshot(path)
    p_open = P_snap.load_snapshot(path, device="cpu")
    want = _answers(ref)
    assert _answers(r_open) == want and _answers(p_open) == want
    assert _overlay(p_open) == _overlay(r_open) == _overlay(ref)
    assert _scalars(p_open) == _scalars(r_open) == _scalars(ref)
    assert p_open.config == PortConfig(max_rank=8)
    assert p_open.grammar.table.names == r_open.grammar.table.names
    # a rebuild of either opened engine gives the reference's grammar
    assert p_open.rebuild() == r_open.rebuild()
    assert_same_grammar(r_open.grammar, p_open.grammar)
    assert _answers(p_open) == _answers(r_open) == want
    assert p_open.rebuild_count == r_open.rebuild_count


@pytest.mark.parametrize("name", SCENARIOS)
def test_an_opened_engine_saves_the_same_bytes(name, tmp_path):
    _, port = _scenario(name)
    P_snap.save_snapshot(port, tmp_path / "a")
    P_snap.save_snapshot(P_snap.load_snapshot(tmp_path / "a", device="cpu"), tmp_path / "b")
    _same_dirs(tmp_path / "a", tmp_path / "b")


def _state(engine):
    """Every state tensor of an engine, as host lists."""
    enc, ef = engine.encoded, engine.encoded.label_ef
    parts = {"start": [engine._start_sorted.labels, engine._start_sorted.nodes_flat,
                       engine._start_sorted.offsets],
             "flat": [getattr(engine.flat, n) for n in P.FlatGrammar._ARRAY_FIELDS],
             "k2": [lv.words for lv in enc.incidence.levels],
             "ef": [ef._lows, ef._low_words, ef._upper.words],
             "streams": [enc.fn_stream[0], enc.edge_fn_stream[0], enc.rule_stream[0],
                         enc.fn_lengths, enc.terminal_ranks],
             "overlay": [engine.delta.inserts, engine.delta.tombstones]}
    return {k: [t.tolist() for t in v] for k, v in parts.items()}


@pytest.mark.parametrize("name", ["fresh", "overlay"])
def test_mmap_and_copy_open_the_same_engine(name, tmp_path):
    _, port = _scenario(name)
    P_snap.save_snapshot(port, tmp_path / "snap")
    a = P_snap.load_snapshot(tmp_path / "snap", mmap=True, device="cpu")
    b = P_snap.load_snapshot(tmp_path / "snap", mmap=False, device="cpu")
    assert _state(a) == _state(b) == _state(port)
    assert _scalars(a) == _scalars(b) == _scalars(port)
    assert _answers(a) == _answers(b) == _answers(port)


def test_an_opened_engine_owns_its_memory(tmp_path):
    _, port = _scenario("overlay")
    P_snap.save_snapshot(port, tmp_path / "snap")
    opened = P_snap.load_snapshot(tmp_path / "snap", mmap=True, device="cpu")
    for t in (opened.flat.params, opened._start_sorted.nodes_flat, opened.delta.inserts,
              opened.encoded.incidence.levels[0].words):
        t.zero_()  # would fault on a read-only map, or corrupt the file
    P_snap.load_snapshot(tmp_path / "snap", verify=True, device="cpu")


def test_an_opened_engine_stays_mutable(tmp_path):
    rows = _rand_triples(1, 150)
    ref, port = _pair(rows)
    P_snap.save_snapshot(port, tmp_path / "p")
    R_snap.save_snapshot(ref, tmp_path / "r")
    p_open = P_snap.load_snapshot(tmp_path / "p", device="cpu")
    r_open = R_snap.load_snapshot(tmp_path / "r")
    _both(r_open, p_open, "insert_triples", np.array([[0, 1, 2]]))
    _both(r_open, p_open, "delete_triples", rows[:3])
    assert p_open.rebuild() and r_open.rebuild()
    assert_same_grammar(r_open.grammar, p_open.grammar)
    got = {tuple(r) for r in p_open.current_triples().tolist()}
    assert got == {tuple(map(int, r)) for r in rows[3:]} | {(0, 1, 2)}


def test_the_empty_engine_round_trips(tmp_path):
    ref, port = _pair(np.zeros((0, 3), dtype=np.int64))
    R_snap.save_snapshot(ref, tmp_path / "ref")
    P_snap.save_snapshot(port, tmp_path / "port")
    _same_dirs(tmp_path / "ref", tmp_path / "port")
    for path in (tmp_path / "ref", tmp_path / "port"):
        opened = P_snap.load_snapshot(path, device="cpu")
        assert opened.query(-1, -1, -1) == [] == R_snap.load_snapshot(path).query(-1, -1, -1)


def test_a_budget_in_the_manifest_rebuilds_the_opened_engine(tmp_path):
    rows = _rand_triples(5, 120)
    ref, port = _pair(rows, budget=6)
    P_snap.save_snapshot(port, tmp_path / "snap")
    p_open = P_snap.load_snapshot(tmp_path / "snap", device="cpu")
    r_open = R_snap.load_snapshot(tmp_path / "snap")
    assert p_open.delta_budget == r_open.delta_budget == 6
    batch = np.array([[N_NODES + i, i % N_PREDS, i] for i in range(8)])
    _both(r_open, p_open, "insert_triples", batch)
    assert p_open.rebuild_count == r_open.rebuild_count == 1
    assert_same_grammar(r_open.grammar, p_open.grammar)


# -- snapshots: gates and crashes --------------------------------------------

def _corrupt(path, how):
    if how == "checksum":
        target = os.path.join(path, "flat_params.npy")
        data = bytearray(open(target, "rb").read())
        data[-1] ^= 0x01
        open(target, "wb").write(bytes(data))
    elif how == "missing":
        os.remove(os.path.join(path, "start_labels.npy"))
    elif how == "manifest":
        os.remove(os.path.join(path, P_snap.MANIFEST))
    elif how == "escape":  # a manifest entry that names a file beside the snapshot
        mpath = os.path.join(path, P_snap.MANIFEST)
        manifest = json.load(open(mpath))
        shutil.copy(os.path.join(path, "start_labels.npy"), path + "_outside.npy")
        crc = manifest["checksums"].pop("start_labels.npy")
        manifest["checksums"][f"../{os.path.basename(path)}_outside.npy"] = crc
        json.dump(manifest, open(mpath, "w"))
    else:
        mpath = os.path.join(path, P_snap.MANIFEST)
        manifest = json.load(open(mpath))
        manifest["format"] = 999
        json.dump(manifest, open(mpath, "w"))


@pytest.mark.parametrize("how,match", [("checksum", "checksum"), ("missing", "missing"),
                                       ("manifest", "manifest"), ("format", "format"),
                                       ("escape", "outside the snapshot")])
def test_a_broken_snapshot_raises(how, match, tmp_path):
    ref, port = _pair(_rand_triples(2, 100))
    for side, save in (("ref", R_snap.save_snapshot), ("port", P_snap.save_snapshot)):
        path = str(tmp_path / side)
        save(ref if side == "ref" else port, path)
        _corrupt(path, how)
        if how != "escape":  # the reference follows such a name; the port refuses it
            with pytest.raises(R_snap.SnapshotError, match=match):
                R_snap.load_snapshot(path)
        with pytest.raises(P_snap.SnapshotError, match=match):
            P_snap.load_snapshot(path, device="cpu")
    if how == "checksum":  # opting out of verification opens the corrupt bytes
        P_snap.load_snapshot(tmp_path / "port", verify=False, device="cpu")


def test_an_engine_without_a_grammar_has_nothing_to_save(tmp_path):
    ref, _ = _pair(_rand_triples(2, 80))
    R_snap.save_snapshot(ref, tmp_path / "ref")
    meta = json.load(open(tmp_path / "ref" / R_snap.MANIFEST))
    arrays = {f[:-4]: np.load(tmp_path / "ref" / f) for f in meta["checksums"]}
    bare = P.TripleQueryEngine.from_numpy_state(arrays, meta, device="cpu", cache=None)
    with pytest.raises(P_snap.SnapshotError):
        P_snap.save_snapshot(bare, tmp_path / "bare")
    with pytest.raises(NotImplementedError, match="load_snapshot"):
        bare.base_triples()
    assert not os.path.exists(tmp_path / "bare")


def test_from_state_rejects_an_unsorted_start():
    _, port = _pair(_rand_triples(6, 120))
    g = port.grammar
    start = g.start.gather_edges(torch.argsort(g.start.labels, descending=True, stable=True))
    unsorted = P.Grammar(g.table, start, g.rules)
    with pytest.raises(ValueError, match="label-sorted"):
        P.TripleQueryEngine.from_state(unsorted, port.encoded, port.flat, crossover=0)


@pytest.mark.parametrize("point,hit", [("snapshot.write_arrays", 3),
                                       ("snapshot.pre_commit", 1),
                                       ("snapshot.post_commit", 1)])
def test_a_crash_while_overwriting_as_the_reference(point, hit, tmp_path):
    """The committed snapshot survives a crash before the rename; a ``.tmp``
    orphan is left, and the next save clears it. Both packages, the same
    outcome."""
    rows = _rand_triples(6, 120)
    ref, port = _pair(rows)
    outcomes = []
    for side, engine, snap, crash in (("ref", ref, R_snap, R_crash),
                                      ("port", port, P_snap, P_crash)):
        path = str(tmp_path / side)
        snap.save_snapshot(engine, path)
        engine.insert_triples(np.array([NEW]))
        with pytest.raises(crash.CrashPoint):
            with crash.inject_crashes({point: hit}) as inj:
                snap.save_snapshot(engine, path)
        opened = P_snap.load_snapshot(path, device="cpu")
        outcomes.append((inj.hits, bool(opened.contains_triples([NEW])[0]),
                         os.path.isdir(path + ".tmp")))
        snap.save_snapshot(engine, path)  # the retry clears the leftover .tmp
        assert not os.path.exists(path + ".tmp")
        assert P_snap.load_snapshot(path, device="cpu").contains_triples([NEW])[0]
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][1] == (point == "snapshot.post_commit")
    assert outcomes[1][2] == (point != "snapshot.post_commit")


def test_a_crash_in_rebuild_leaves_the_engine_as_the_reference(tmp_path):
    rows = _rand_triples(7, 150)
    ref, port = _pair(rows)
    _mutate(ref, port, rows, 3)
    before = _answers(port)
    assert before == _answers(ref)
    for engine, crash in ((ref, R_crash), (port, P_crash)):
        with pytest.raises(crash.CrashPoint):
            with crash.inject_crashes({"engine.rebuild": 1}):
                engine.rebuild()
    assert _answers(port) == _answers(ref) == before
    assert port.rebuild_count == ref.rebuild_count == 0
    assert port.delta.size == ref.delta.size > 0
    assert port.rebuild() and ref.rebuild()
    assert port.rebuild_count == ref.rebuild_count == 1
    assert_same_grammar(ref.grammar, port.grammar)
