"""Atomic, async checkpointing with restore onto any device: the twin of
``repro.train.checkpoint``, in its layout.

Layout: ``<dir>/step_<N:08d>/`` holding ``manifest.json`` ({"step",
"leaves": [{"path", "file", "shape", "dtype"}, ...]}) and one
``leaf_<i:05d>.npy`` per leaf. Writes go to ``step_<N>.tmp`` and are
committed by one rename, so a crash mid-save never corrupts the previous
checkpoint. :class:`AsyncCheckpointer` copies to the host on the training
thread and writes on a worker thread, overlapping I/O with compute.

Trees are nested dicts and lists whose leaves are tensors (or numpy
arrays); a dict may hold the port's flat parameter dicts, whose keys are
already ``/``-joined reference paths (``layers/0/w``). Leaves are numbered
in JAX's flatten order of the nested tree: dict keys sorted at each level,
list indices (and a dict's keys ``0..n-1``, which is how a flat path spells
a list) in numeric order, ``None`` leaves (an SGD leaf's moments) dropped.
With that order every ``.npy`` file and the manifest's ``step`` and
``leaves`` equal the reference's for the same state. bfloat16 and float8
leaves are stored as ``uint16`` / ``uint8`` views (``_EXOTIC_VIEWS``), as
the reference stores them.

Deliberate divergence: the reference's manifest also holds ``treedef``,
JAX's serialized tree structure, which cannot be written without JAX. The
port leaves it out; the reference's restore never reads it (it rebuilds the
tree from the paths, as the port does), so each package opens the other's
checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

# npy-serializable stand-ins for the dtypes numpy lacks
_EXOTIC_VIEWS = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
}
_TORCH_EXOTIC = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
                 torch.float8_e5m2: "float8_e5m2"}


def _nest(tree):
    """The tree with every flat dict of ``/``-joined paths nested."""
    if isinstance(tree, (list, tuple)):
        return [_nest(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out: dict = {}
    for key, val in tree.items():
        *parents, last = str(key).split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = _nest(val)
    return out


def _children(node) -> list:
    """(key, child) in JAX's flatten order."""
    if isinstance(node, list):
        return list(enumerate(node))
    keys = list(node)
    if keys and all(k.isdigit() for k in keys) and \
            sorted(int(k) for k in keys) == list(range(len(keys))):
        return [(i, node[str(i)]) for i in range(len(keys))]
    return [(k, node[k]) for k in sorted(keys)]


def flatten(tree) -> list:
    """(path, leaf) of every non-None leaf, in JAX's flatten order."""
    out = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, (dict, list)):
            for key, child in _children(node):
                walk(child, f"{prefix}/{key}" if prefix else str(key))
        else:
            out.append((prefix, node))

    walk(_nest(tree), "")
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to write, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _TORCH_EXOTIC.get(t.dtype)
        if name is not None:
            bits = torch.int16 if _EXOTIC_VIEWS[name] is np.uint16 else torch.uint8
            return t.cpu().view(bits).numpy().view(_EXOTIC_VIEWS[name]), name
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    return (arr.view(_EXOTIC_VIEWS[name]) if name in _EXOTIC_VIEWS else arr), name


def host_copy(tree):
    """The tree with every tensor leaf copied to host memory, the copy
    finished when this returns (the training step may then overwrite the
    device tensors in place)."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Blocking atomic save; returns the committed path."""
    items = flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(items):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None,
                       device=None) -> tuple[Any, int]:
    """Load (tree, step) onto ``device`` (None: CUDA). The tree is rebuilt
    from the manifest's paths as the reference rebuilds it: nested dicts,
    with dicts whose keys are 0..n-1 as lists; leaves are tensors."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    items = []
    for rec in manifest["leaves"]:
        arr = np.require(np.load(os.path.join(path, rec["file"])), requirements="C")
        if rec["dtype"] in _EXOTIC_VIEWS:
            raw = arr.view(_EXOTIC_VIEWS[rec["dtype"]])
            t = torch.from_numpy(raw.view(np.int16) if raw.dtype == np.uint16 else raw)
            t = t.view(getattr(torch, rec["dtype"]))
        else:
            t = torch.from_numpy(arr)
        items.append((rec["path"], t.to(dev)))
    return _unflatten_from_paths(items), manifest["step"]


def _unflatten_from_paths(items):
    root: dict = {}
    for path, leaf in items:
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _listify(root)


def _listify(node):
    """Convert dicts whose keys are 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    keys = list(out.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [out[str(i)] for i in idx]
    return out


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training; keeps the last ``keep`` steps.

    ``save`` finishes its device-to-host copy before it returns: the port's
    optimizer updates parameters in place, so a copy still in flight when
    the next step runs would tear the checkpoint. ``copy_s`` and
    ``write_s`` hold the seconds of each save's host copy (on the caller's
    thread) and of each write (on the worker)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.copy_s: list[float] = []
        self.write_s: list[float] = []

    def save(self, step: int, tree: Any):
        self.wait()
        t0 = time.perf_counter()
        host_tree = host_copy(tree)
        self.copy_s.append(time.perf_counter() - t0)

        def work():
            try:
                t1 = time.perf_counter()
                save_checkpoint(self.directory, step, host_tree)
                self.write_s.append(time.perf_counter() - t1)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
