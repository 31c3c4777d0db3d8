"""Dry-run of every cell on one card: the twin of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A --shape S]
        [--multi-pod | --both-meshes] [--reduced] [--device cpu] [--out F]

The reference lowers and compiles each of the 40 cells for a 256- or
512-chip TPU mesh and reads XLA's memory and cost analyses. On one card the
dry-run is the one-card meaning of that job. For each cell it

- records the cell's analytic useful work (``model_flops_global``, from
  :func:`_cell_meta`, a copy of the reference's) and, for each production
  mesh asked for, the mesh, its ``n_devices`` and the per-device argument
  bytes that the reference's partition specs imply
  (:func:`repro_torch.launch.steps.cell_specs`, ``memory.argument_bytes``);
- builds the cell on this device (:func:`repro_torch.launch.steps.build_cell`,
  at full size unless ``--reduced``; ``build_s`` is the twin of
  ``lower_s``). A cell that ``build_cell`` refuses because it does not fit
  one card gets ``"ok": false``, its refusal and ``refusal_bytes``, having
  allocated nothing; a cell that runs out of device memory during its step
  gets ``"ok": false`` and the allocator's message under ``out_of_memory``;
- runs two steps (``step_s``: the first, which builds the kernels at first
  use, since ``compile_s`` has no twin, and the second) and one more under
  :func:`repro_torch.roofline.op_cost` (``cost``, ``counted_flops``, the
  twin of ``hlo_flops_global``, ``useful_flops_ratio``, and
  ``unseen_launches``: the hand-written kernels the op count cannot see,
  empty on the CPU, where the wrappers run their plain twins);
- records ``memory.peak_bytes`` (``max_memory_allocated`` over the build
  and the two timed steps, CUDA only; ``step_peak_bytes`` over the steps),
  ``memory.resident_bytes`` (the bytes of the cell's tensors on the device:
  weights, optimizer state, cache, batch), the kernels launched by the
  second step, and ``roofline``: :func:`roofline_terms` with compute =
  model FLOPs over :class:`HW`'s peak, memory = the resident bytes over
  its HBM bandwidth (each resident byte read once a step: a floor where a
  step reads all it holds, as a decode step does, but not where it reads a
  part, as DLRM's lookups read a few rows of their tables) and collective
  0 (one card); ``useful_flops_rate`` = model FLOPs / the second
  step's seconds / the peak, on CUDA only (None on the CPU: a CPU's step is
  no measure of the card).

Each cell is freed before the next. The output is one JSON record per
(cell, mesh), as the reference's, with ``device`` and ``card`` naming what
ran it. Exit 1 if a cell failed for another reason than not fitting.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import time
import traceback

import torch

from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import CellRefused, _gnn_sizes, build_cell, cell_specs
from repro_torch.roofline.analysis import HW, model_flops, roofline_terms
from repro_torch.roofline.op_cost import op_cost


def _cell_meta(arch_id: str, shape_name: str, reduced: bool = False) -> dict:
    """The reference's ``_cell_meta``; with ``reduced``, the same keys at
    the sizes the reduced cell runs (the reduced config, (B, S) = (2,
    min(S, 64)), the GNN sizes of ``_gnn_sizes`` before rounding, a batch
    of 32 and 1,024 candidates)."""
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    cfg = arch.reduced() if reduced else arch.config()
    meta = {"family": arch.family, "kind": shape.kind, **shape.params}
    if arch.family == "lm":
        meta.update(
            n_active_params=cfg.n_active_params(), n_params=cfg.n_params(),
            n_layers=cfg.n_layers, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        )
        if reduced:
            meta.update(global_batch=2, seq_len=min(meta["seq_len"], 64))
    elif arch.family == "gnn":
        meta.update(n_layers=cfg.n_layers, d_hidden=cfg.d_hidden)
        if shape.kind == "minibatch":
            seeds, (f1, f2) = shape.params["batch_nodes"], shape.params["fanouts"]
            meta["n_nodes"] = seeds * (1 + f1 + f1 * f2)
            meta["n_edges"] = seeds * f1 + seeds * f1 * f2
        elif shape.kind == "molecule":
            meta["n_nodes"] = shape.params["batch"] * shape.params["n_nodes"]
            meta["n_edges"] = shape.params["batch"] * shape.params["n_edges"]
        if reduced:
            _, _, meta["d_feat"], _, meta["n_nodes"], meta["n_edges"] = _gnn_sizes(shape, True)
    else:
        meta.update(n_fields=cfg.n_fields, embed_dim=cfg.embed_dim,
                    n_params=cfg.n_params())
        if reduced:
            meta.update(batch=32, n_candidates=1024)
    return meta


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return out[idx] if idx < len(out) else out[0]


def _tensors(obj, seen: set):
    """Every tensor reachable from a cell's arguments: through tuples,
    lists, dicts, modules (parameters and buffers) and dataclasses."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)


def resident_bytes(cell, dev: torch.device) -> int:
    """The bytes of the storages of the cell's tensors on ``dev``, each once."""
    storages = {}
    for t in _tensors((cell.model, cell.args), set()):
        if t.device.type == dev.type and t.numel():
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_FINITE_CHUNK = 1 << 26  # elements checked at a time: a decode step returns its whole cache


def _finite(out) -> bool:
    """Every floating tensor of ``out`` finite, checked a chunk at a time."""
    for t in _tensors(out, set()):
        if t.is_floating_point():
            flat = t.reshape(-1)
            if not all(bool(torch.isfinite(flat[a:a + _FINITE_CHUNK]).all())
                       for a in range(0, flat.numel(), _FINITE_CHUNK)):
                return False
    return True


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak(dev: torch.device, before: int) -> int:
    return torch.cuda.max_memory_allocated(dev) - before


def _device_run(arch_id: str, shape_name: str, reduced: bool, dev: torch.device, seed: int,
                check=None) -> dict:
    """Build the cell on ``dev``, run its steps, measure, free it. On CUDA
    ``peak_bytes`` is the most allocated over the build and the two timed
    steps (or until the step that ran out of memory), ``step_peak_bytes``
    over the two steps alone; the finiteness check, the op count and
    ``check`` come after both readings."""
    cuda = dev.type == "cuda"
    if cuda:
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    res: dict = {}
    cell = out = None
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch_id, shape_name, reduced=reduced, device=dev, seed=seed)
        _sync(dev)
        res["build_s"] = time.perf_counter() - t0
        res["resident_bytes"] = resident_bytes(cell, dev)
        if cuda:
            res["peak_bytes"] = _peak(dev, before)
            torch.cuda.reset_peak_memory_stats(dev)
        steps, launches = [], {}
        for _ in range(2):
            start = dict(_build.launch_counts)
            t0 = time.perf_counter()
            out = cell.run()
            _sync(dev)
            steps.append(time.perf_counter() - t0)
            launches = {k: v - start[k] for k, v in _build.launch_counts.items()
                        if v != start[k]}
        if cuda:
            res["step_peak_bytes"] = _peak(dev, before)
            res["peak_bytes"] = max(res["peak_bytes"], res["step_peak_bytes"])
        res.update(step_s=steps, launches=launches, finite=_finite(out))
        cost = op_cost(cell.run)
        _sync(dev)
        res["cost"] = {"flops": cost.flops, "bytes": cost.bytes}
        res["unseen_launches"] = cost.unseen_launches
        if check is not None:
            res["check"] = check(cell, out)
    except CellRefused as e:
        res.update(refused=str(e), refusal_bytes=e.nbytes)
    except torch.OutOfMemoryError as e:
        res["out_of_memory"] = str(e).splitlines()[0]
        if cuda:
            res["peak_bytes"] = max(res.get("peak_bytes", 0), _peak(dev, before))
    finally:
        cell = out = None
        _free(dev)
    if cuda:
        res.setdefault("peak_bytes", _peak(dev, before))
        res["allocated_bytes_left"] = torch.cuda.memory_allocated(dev) - before
    return res


def run_cell(arch_id: str, shape_name: str, meshes: tuple = (False,), reduced: bool = False,
             device=None, seed: int = 0, check=None) -> list:
    """One record per production mesh in ``meshes`` (each a ``multi_pod``
    flag) for the cell, the cell built and run once on ``device`` (None:
    CUDA); see the module's docstring for the keys. ``check(cell, out)``,
    where given, runs on the last step's output before the cell is freed
    and its result is stored under ``check``."""
    hw = HW()
    dev = resolve_device(device)
    meta = _cell_meta(arch_id, shape_name, reduced)
    mflops = model_flops(arch_id, shape_name, meta)
    run = _device_run(arch_id, shape_name, reduced, dev, seed, check)
    common = {"arch": arch_id, "shape": shape_name, "reduced": reduced,
              "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
              "card": _card(dev), "hw": dataclasses.asdict(hw),
              "ok": "step_s" in run, "model_flops_global": mflops,
              "collectives": {}, "wire_bytes_per_dev": 0.0}
    memory = {k: run[k] for k in ("peak_bytes", "step_peak_bytes", "allocated_bytes_left")
              if k in run}
    for k in ("refused", "refusal_bytes", "out_of_memory"):
        if k in run:
            common[k] = run[k]
    if common["ok"]:
        step = run["step_s"][1]
        counted = run["cost"]["flops"]
        memory["resident_bytes"] = run["resident_bytes"]
        common.update(
            build_s=run["build_s"], step_s=run["step_s"], launches=run["launches"],
            finite=run["finite"], cost=run["cost"], counted_flops=counted,
            useful_flops_ratio=mflops / counted if counted else None,
            unseen_launches=run["unseen_launches"],
            roofline=roofline_terms(mflops, run["resident_bytes"], 0.0, hw),
            useful_flops_rate=mflops / step / hw.peak_flops if dev.type == "cuda" else None)
        if "check" in run:
            common["check"] = run["check"]
    out = []
    for mp in meshes:
        mesh = make_production_mesh(multi_pod=mp)
        _, arg_bytes = cell_specs(arch_id, shape_name, mesh, reduced)
        out.append({**common, "mesh": _mesh_name(mp), "n_devices": mesh.n_devices,
                    "memory": {"argument_bytes": arg_bytes, **memory}})
    return out


def _summary(r: dict) -> str:
    head = f"[{r['arch']} x {r['shape']} x {r['mesh']}] args/dev={r['memory']['argument_bytes']}"
    if "refused" in r:
        return f"{head} refused: {r['refusal_bytes']} bytes"
    if "out_of_memory" in r:
        return f"{head} out of memory: {r['out_of_memory']}"
    if not r["ok"]:
        return f"{head} failed: {r.get('error')}"
    t = r["roofline"]
    return (f"{head} build_s={r['build_s']:.3f} step_s={r['step_s']} "
            f"peak={r['memory'].get('peak_bytes')} resident={r['memory']['resident_bytes']} "
            f"roofline compute={t['compute_s'] * 1e3:.4f}ms memory={t['memory_s'] * 1e3:.4f}ms "
            f"dominant={t['dominant']} useful_flops_rate={r['useful_flops_rate']} "
            f"useful/counted={r['useful_flops_ratio']} unseen={r['unseen_launches']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one-card dry-run: build and run every cell")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write JSON result(s) here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"dry-run on {_card(dev)}; torch {torch.__version__}")
    cells = [(args.arch, args.shape)] if args.arch and args.shape else all_cells()
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    results = []
    for arch_id, shape_name in cells:
        try:
            recs = run_cell(arch_id, shape_name, meshes, args.reduced, dev, args.seed)
        except Exception as e:  # a failure here is a fault of the port: record, go on
            traceback.print_exc()
            recs = [{"arch": arch_id, "shape": shape_name, "mesh": _mesh_name(mp), "ok": False,
                     "memory": {"argument_bytes": None}, "error": f"{type(e).__name__}: {e}"}
                    for mp in meshes]
            _free(dev)
        for r in recs:
            print(_summary(r), flush=True)
        results += recs
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results if len(results) > 1 else results[0], fh, indent=2)
    n_ok = sum(1 for r in results if r["ok"])
    n_ref = sum(1 for r in results if "refused" in r)
    n_oom = sum(1 for r in results if "out_of_memory" in r)
    n_err = sum(1 for r in results if "error" in r)
    print(f"\ndry-run: {n_ok}/{len(results)} records ran, {n_ref} refused, {n_oom} out of "
          f"memory, {n_err} failed; {_card(dev)}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
