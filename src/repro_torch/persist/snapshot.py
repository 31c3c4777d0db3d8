"""Versioned, checksummed, mmap-able on-disk engine snapshots, in the
reference's format.

A built :class:`~repro_torch.core.query.TripleQueryEngine` is expensive
(RePair, encoding, flattening, calibration), and all of it is data, so a
cold start should be a read. A snapshot directory holds every array the
engine's hot path touches, each as its own ``.npy`` file, and a manifest::

    manifest.json      scalars + per-file crc32 checksums  (written LAST)
    <name>.npy         one file per array

The format is the reference's (``FORMAT_VERSION`` 1, the same file names,
dtypes and manifest keys), so either package opens what the other wrote,
and the port's snapshot of an engine equal to the reference's is the
reference's byte for byte. The port holds bit-packed words as int64
tensors with uint32 values: the writer casts each file back to the
reference's type (``uint32`` words, ``uint64`` Elias–Fano lows, a 2-D
``bool`` NT matrix, ``int64`` for the rest) and the reader widens.

The manifest doubles as the commit marker: a directory without a parseable
manifest is an aborted write, never a corrupt load. Writes go through
``<path>.tmp`` and one ``os.rename``; a kill mid-write leaves a ``.tmp``
orphan and the previous snapshot intact. Checksums are verified on load by
default, so bit rot raises :class:`SnapshotError` instead of answering
wrongly.

Opening reads the files with numpy (through read-only memory maps with
``mmap=True``), copies each array into a tensor on the engine's device
and rebuilds the grammar by slicing the flat CSR, with one host copy of
its offsets: no δ stream is decoded, nothing is re-encoded, and the
stored crossover is kept (no calibration, so no kernel runs). This module
reads and writes with numpy, json and zlib only.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.core.encode import EncodedGrammar
from repro_torch.core.flatten import FlatGrammar
from repro_torch.core.grammar import Grammar, Rule
from repro_torch.core.hypergraph import Hypergraph, LabelTable
from repro_torch.core.query import _DEFAULT_CACHE, TripleQueryEngine
from repro_torch.core.repair import RepairConfig
from repro_torch.core.succinct import EliasFano, K2Tree
from repro_torch.device import as_i64, resolve_device
from repro_torch.persist.crash import crash_point

FORMAT_VERSION = 1

MANIFEST = "manifest.json"


class SnapshotError(RuntimeError):
    """A snapshot directory is unreadable: missing/unparseable manifest,
    missing arrays, checksum mismatch, or a format this code can't read; or
    an engine that has nothing to save."""


# -- saving ----------------------------------------------------------------

def save_snapshot(engine: TripleQueryEngine, path, *, atomic: bool = True) -> str:
    """Persist `engine` to the directory `path`; returns `path`.

    With ``atomic=True`` (the default) the write goes through
    ``<path>.tmp`` and ``os.rename``, replacing any existing snapshot only
    at the final instant; a caller that stages engine snapshots inside a
    directory it renames itself (the durable sharded service) passes
    ``atomic=False`` to write in place. The delta overlay is saved as it
    is: a snapshot is the full logical state. An engine made by
    ``from_numpy_state`` has no grammar or encoding to save and raises
    :class:`SnapshotError`.
    """
    if engine.grammar is None or engine.encoded is None:
        raise SnapshotError("the engine has no grammar and encoding to save (it was made by "
                            "from_numpy_state from bare arrays)")
    path = os.fspath(path)
    if not atomic:
        _write_engine_dir(engine, path)
        return path
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    _write_engine_dir(engine, tmp)
    crash_point("snapshot.pre_commit")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    crash_point("snapshot.post_commit")
    return path


def _host(t: torch.Tensor, dtype=np.int64) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


def _write_engine_dir(engine: TripleQueryEngine, d: str) -> None:
    """Write one engine's arrays and manifest into (fresh) directory `d`."""
    os.makedirs(d, exist_ok=True)
    enc = engine.encoded
    ef = enc.label_ef
    k2 = enc.incidence
    start = engine._start_sorted  # the order `enc.incidence` indexes
    arrays: dict[str, np.ndarray] = {
        "table_ranks": _host(engine.grammar.table.ranks),
        "start_labels": _host(start.labels),
        "start_nodes": _host(start.nodes_flat),
        "start_offsets": _host(start.offsets),
        "delta_inserts": _host(engine.delta.inserts).reshape(-1, 3),
        "delta_tombstones": _host(engine.delta.tombstones).reshape(-1, 3),
        "enc_terminal_ranks": _host(enc.terminal_ranks),
        "enc_fn_lengths": _host(enc.fn_lengths),
        "ef_lows": _host(ef._lows, np.uint64),
        "ef_low_words": _host(ef._low_words, np.uint32),
        "ef_upper_words": _host(ef._upper.words, np.uint32),
        "fn_words": _host(enc.fn_stream[0], np.uint32),
        "edge_fn_words": _host(enc.edge_fn_stream[0], np.uint32),
        "rule_words": _host(enc.rule_stream[0], np.uint32),
    }
    for name, arr in engine.flat.to_arrays().items():
        arrays[f"flat_{name}"] = arr
    for i, level in enumerate(k2.levels):
        arrays[f"k2_level_{i}"] = _host(level.words, np.uint32)

    checksums: dict[str, int] = {}
    for name, arr in arrays.items():
        fname = f"{name}.npy"
        fpath = os.path.join(d, fname)
        np.save(fpath, np.ascontiguousarray(arr))
        with open(fpath, "rb") as f:
            checksums[fname] = zlib.crc32(f.read())
        # mid-write kill: some arrays on disk, no manifest -> aborted dir
        crash_point("snapshot.write_arrays")

    config = engine.config
    manifest = {
        "format": FORMAT_VERSION,
        "checksums": checksums,
        "n_terminals": int(engine.T),
        "start_n_nodes": int(start.n_nodes),
        "names": engine.grammar.table.names,
        "crossover": int(engine.crossover),
        "delta_budget": None if engine.delta_budget is None else int(engine.delta_budget),
        "base_edges": None if engine._base_edges is None else int(engine._base_edges),
        "rebuild_count": int(engine.rebuild_count),
        "config": None if config is None else asdict(config),
        "encoded": {
            "n_nodes": int(enc.n_nodes),
            "n_edges": int(enc.n_edges),
            "n_fns": int(enc.n_fns),
            "n_rules": int(enc.n_rules),
            "rule_symbol_count": int(enc.rule_symbol_count),
            "fn_bits": int(enc.fn_stream[1]),
            "edge_fn_bits": int(enc.edge_fn_stream[1]),
            "rule_bits": int(enc.rule_stream[1]),
        },
        "ef": {
            "n": int(ef.n), "universe": int(ef.universe), "l": int(ef.l),
            "low_bits": int(ef._low_bits), "upper_n": int(ef._upper.n),
        },
        "k2": {
            "n_rows": int(k2.n_rows), "n_cols": int(k2.n_cols),
            "k": int(k2.k), "h": int(k2.h), "n_points": int(k2.n_points),
            "level_bits": [int(lv.n) for lv in k2.levels],
        },
    }
    # manifest last: its presence is the directory's commit marker
    with open(os.path.join(d, MANIFEST), "w") as f:
        json.dump(manifest, f)


# -- loading ---------------------------------------------------------------

def read_manifest(path) -> dict:
    """Parse and version-check a snapshot manifest (SnapshotError on any
    problem: an unreadable manifest means an uncommitted or corrupt dir)."""
    mpath = os.path.join(os.fspath(path), MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise SnapshotError(f"unreadable snapshot manifest {mpath}: {exc}") from exc
    fmt = manifest.get("format")
    if fmt != FORMAT_VERSION:
        raise SnapshotError(
            f"{mpath}: snapshot format {fmt!r} (this build reads {FORMAT_VERSION})")
    return manifest


def _load_arrays(d: str, manifest: dict, mmap: bool, verify: bool) -> dict:
    out: dict[str, np.ndarray] = {}
    for fname, crc in manifest["checksums"].items():
        if not fname.endswith(".npy") or fname.startswith(".") or os.path.basename(fname) != fname:
            raise SnapshotError(f"manifest names a file outside the snapshot: {fname!r}")
        fpath = os.path.join(d, fname)
        if not os.path.exists(fpath):
            raise SnapshotError(f"snapshot array missing: {fpath}")
        if verify:
            with open(fpath, "rb") as f:
                actual = zlib.crc32(f.read())
            if actual != crc:
                raise SnapshotError(
                    f"checksum mismatch in {fpath}: stored {crc:#010x}, actual {actual:#010x}")
        out[fname[:-len(".npy")]] = np.load(fpath, mmap_mode="r" if mmap else None)
    return out


def load_snapshot(path, *, cache=_DEFAULT_CACHE, mmap: bool = True, verify: bool = True,
                  device=None) -> TripleQueryEngine:
    """Rebuild an engine from a snapshot directory: the cold-start path.

    ``mmap=True`` reads the files through read-only memory maps;
    ``verify=True`` checks each file's crc32 before trusting it. Every
    array is copied into a tensor on `device` (``None`` means CUDA), so the
    engine never aliases the files. `cache` follows ``TripleQueryEngine``
    (default: a fresh ``QueryResultCache()``).
    """
    dev = resolve_device(device)
    d = os.fspath(path)
    manifest = read_manifest(d)
    arrays = _load_arrays(d, manifest, mmap, verify)
    try:
        return _reconstruct(manifest, arrays, cache, dev)
    except (KeyError, ValueError, IndexError, TypeError) as exc:
        raise SnapshotError(f"inconsistent snapshot {d}: {exc}") from exc


def _reconstruct(manifest: dict, arrays: dict, cache, dev) -> TripleQueryEngine:
    T = int(manifest["n_terminals"])
    names = manifest["names"]
    names = list(names) if names is not None else None

    def t(name):  # an int64 copy on the device (the uint words widened)
        return as_i64(arrays[name], dev)

    table = LabelTable(t("table_ranks"), T, names)
    start = Hypergraph(int(manifest["start_n_nodes"]), t("start_labels"), t("start_nodes"),
                       t("start_offsets"))
    flat = FlatGrammar.from_arrays(
        T, {name: arrays[f"flat_{name}"] for name in FlatGrammar._ARRAY_FIELDS}, dev)
    grammar = Grammar(table, start, _rules_from_flat(flat, table))

    e, efm, k2m = manifest["encoded"], manifest["ef"], manifest["k2"]
    label_ef = EliasFano.from_parts(
        efm["n"], efm["universe"], efm["l"], t("ef_lows"), t("ef_upper_words"),
        efm["upper_n"], t("ef_low_words"), efm["low_bits"])
    incidence = K2Tree.from_levels(
        k2m["n_rows"], k2m["n_cols"], k2m["k"], k2m["h"], k2m["n_points"],
        [t(f"k2_level_{i}") for i in range(len(k2m["level_bits"]))], k2m["level_bits"],
        device=dev)
    encoded = EncodedGrammar(
        n_nodes=e["n_nodes"], n_edges=e["n_edges"], n_terminals=T,
        terminal_ranks=t("enc_terminal_ranks"), label_ef=label_ef, incidence=incidence,
        fn_stream=(t("fn_words"), e["fn_bits"]), fn_lengths=t("enc_fn_lengths"),
        n_fns=e["n_fns"], edge_fn_stream=(t("edge_fn_words"), e["edge_fn_bits"]),
        rule_stream=(t("rule_words"), e["rule_bits"]),
        rule_symbol_count=e["rule_symbol_count"], n_rules=e["n_rules"], names=names)

    cfg = manifest["config"]
    engine = TripleQueryEngine.from_state(
        grammar, encoded, flat, crossover=manifest["crossover"], cache=cache,
        delta_budget=manifest["delta_budget"],
        config=None if cfg is None else RepairConfig(**cfg),
        base_edges=manifest["base_edges"], rebuild_count=manifest["rebuild_count"])
    engine.delta.load_rows(t("delta_inserts"), t("delta_tombstones"))
    return engine


def _rules_from_flat(flat: FlatGrammar, table: LabelTable) -> dict[int, Rule]:
    """Rule dict from CSR slices (views of the flat tensors, no stream
    decoding), sliced with host ints from one host copy of the offsets."""
    if flat.n_rules == 0:
        return {}
    parts = (flat.rule_labels, flat.edge_offsets, flat.param_offsets, table.ranks)
    host = torch.cat(parts).tolist()
    lbls, eo, po, ranks = [], [], [], []
    pos = 0
    for col, part in zip((lbls, eo, po, ranks), parts):
        col.extend(host[pos:pos + part.numel()])
        pos += part.numel()
    rules: dict[int, Rule] = {}
    for r, lbl in enumerate(lbls):
        e0, e1 = eo[r], eo[r + 1]
        rhs = Hypergraph(ranks[lbl], flat.edge_labels[e0:e1], flat.params[po[e0]:po[e1]],
                         flat.param_offsets[e0:e1 + 1] - po[e0])
        rules[lbl] = Rule(lbl, ranks[lbl], rhs)
    return rules


# -- term dictionary persistence --------------------------------------------

def save_term_dict(term_dict, path) -> str:
    """Write a :class:`~repro_torch.core.term_dict.TermDict` into directory
    `path`: one ``.npy`` an array and a crc32-checksummed manifest
    (``"kind": "term_dict"``), written last, the reference's files byte for
    byte. The directory is written in place: a caller that needs the write
    to be atomic places it inside a tree it renames."""
    d = os.fspath(path)
    os.makedirs(d, exist_ok=True)
    meta, arrays = term_dict.to_arrays()
    checksums: dict[str, int] = {}
    for name, arr in arrays.items():
        fname = f"{name}.npy"
        fpath = os.path.join(d, fname)
        np.save(fpath, np.ascontiguousarray(arr))
        with open(fpath, "rb") as f:
            checksums[fname] = zlib.crc32(f.read())
    manifest = {"format": FORMAT_VERSION, "kind": "term_dict",
                "spaces": meta, "checksums": checksums}
    with open(os.path.join(d, MANIFEST), "w") as f:
        json.dump(manifest, f)
    return d


def load_term_dict(path, *, verify: bool = True):
    """Inverse of :func:`save_term_dict`; raises :class:`SnapshotError` on a
    missing, corrupt or wrong-kind directory (and, as :func:`load_snapshot`
    does, on a manifest naming a file that is not a bare ``<name>.npy``).
    The arrays load eagerly into host memory: the dictionary lives there."""
    from repro_torch.core.term_dict import TermDict

    d = os.fspath(path)
    manifest = read_manifest(d)
    if manifest.get("kind") != "term_dict":
        raise SnapshotError(f"{d}: not a term-dictionary snapshot")
    arrays = _load_arrays(d, manifest, mmap=False, verify=verify)
    try:
        return TermDict.from_arrays(manifest["spaces"], arrays)
    except (KeyError, ValueError, IndexError, TypeError) as exc:
        raise SnapshotError(f"inconsistent term-dict snapshot {d}: {exc}") from exc
