"""The JAX package's view of every registry cell, computed once in a child
process: its ``_cell_meta`` and ``model_flops``, and on both production
meshes, at full size and reduced, its cells' ``in_specs`` ({_kp_str path:
tuple(spec)}) and per-device argument bytes (each abstract argument's bytes
over the product of the mesh axes its spec names).

A child, because the reference's ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when it is imported, and because another test module of the
same worker may have set a global jax mesh that an abstract production mesh
cannot replace (``tests/test_launch_cells.py`` does). The child restores
``XLA_FLAGS`` right after that import, so its jax starts with one device.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_CHILD = r"""
import json, math, os, sys
saved = os.environ.get("XLA_FLAGS")
from repro.launch.dryrun import _cell_meta
if saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = saved
import jax
from jax.sharding import AbstractMesh, PartitionSpec as P
from repro.configs.registry import all_cells
from repro.launch import steps
from repro.roofline.analysis import model_flops

meshes = json.loads(sys.argv[2])
out = {"meta": {}, "flops": {}, "specs": {}, "bytes": {}}
for a, s in all_cells():
    meta = _cell_meta(a, s)
    out["meta"][f"{a}|{s}"] = meta
    out["flops"][f"{a}|{s}"] = model_flops(a, s, meta)
is_spec = lambda x: isinstance(x, P)
for name, (shape, axes) in meshes.items():
    sizes = dict(zip(axes, shape))
    with jax.sharding.use_abstract_mesh(AbstractMesh(tuple(shape), tuple(axes))):
        for reduced in (False, True):
            for a, s in all_cells():
                cell = steps.build_cell(a, s, reduced=reduced)
                flat, _ = jax.tree_util.tree_flatten_with_path(cell.in_specs, is_leaf=is_spec)
                specs = {steps._kp_str(kp): [list(e) if isinstance(e, tuple) else e
                                             for e in sp] for kp, sp in flat}
                total = 0
                for kp, leaf in jax.tree_util.tree_flatten_with_path(cell.args)[0]:
                    div = 1
                    for e in specs[steps._kp_str(kp)]:
                        for ax in ([e] if isinstance(e, str) else (e or [])):
                            div *= sizes[ax]
                    total += math.prod(leaf.shape) * leaf.dtype.itemsize // div
                key = f"{name}|{int(reduced)}|{a}|{s}"
                out["specs"][key] = specs
                out["bytes"][key] = total
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def as_spec(entries) -> tuple:
    """A spec read back from JSON: lists of axis names become tuples."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@lru_cache(maxsize=1)
def reference_cells(tmp_dir: str) -> dict:
    """{"meta", "flops", "specs", "bytes"} as the module docstring says; keys
    ``arch|shape`` for the first two, ``mesh|reduced|arch|shape`` for the
    others (mesh "16x16" or "2x16x16", reduced 0 or 1)."""
    path = os.path.join(tmp_dir, "reference_cells.json")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, path, json.dumps(MESHES)], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the reference child failed:\n{proc.stderr[-4000:]}")
    with open(path) as fh:
        return json.load(fh)
