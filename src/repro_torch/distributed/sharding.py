"""Logical-axis sharding: the twin of ``repro.distributed.sharding``.

Models name the dimensions of activations and parameters logically; these
rules map the names onto the physical axes of a mesh. The reference lays
its cells out on a TPU pod slice (batch/tokens -> data (x pod), heads /
ffn / experts / vocab -> model, kv sequence -> data and model, edges and
rows -> data and model flattened); the port runs on one card, so here the
rules only describe that layout: the same specs, from which the per-device
bytes of a cell on a production mesh follow.

Port decisions: every function takes its mesh as an argument (a
:class:`repro_torch.launch.mesh.Mesh`, or None for no mesh) instead of
reading an ambient one, and a spec is a plain tuple with the entries of a
``PartitionSpec`` (None, an axis name, or a tuple of axis names); no mesh
gives the empty spec ``()``, as ``P()``. An axis is dropped where the
dimension does not divide by its size (the reference pads nothing either).
"""
from __future__ import annotations

# logical name -> physical mesh axis (or a tuple, for flattened sharding)
LOGICAL_RULES: dict[str, object] = {
    "batch": ("pod", "data"),   # the pod axis (if present) is outer data-parallel
    "seq": None,                # sequence kept unsharded in-layer by default
    "kv_seq": ("data", "model"),  # long-context decode: split-K over free axes
    "seq_model": "model",       # context parallelism: train/prefill q-seq over TP
    "model_dim": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "expert_cap": "data",       # MoE capacity over data, so expert GEMMs do not replicate
    "vocab": "model",
    "edges": ("data", "model"),  # GNN edge lists over the whole pod
    "nodes": ("data", "model"),
    "table_rows": ("data", "model"),  # DLRM embedding rows over all chips
    "wide_batch": ("pod", "data", "model"),  # DLRM batch over every chip
    "fields": None,
}


def _axes(mesh) -> dict | None:
    if mesh is None or not mesh.axis_names:
        return None
    return mesh.shape


def logical_spec(names: tuple, shape: tuple | None = None, mesh=None) -> tuple:
    """Map logical dimension names to a spec valid on ``mesh``."""
    axes_present = _axes(mesh)
    if axes_present is None:
        return ()
    spec = []
    used = set()
    for i, name in enumerate(names):
        if name is None:
            spec.append(None)
            continue
        phys = LOGICAL_RULES.get(name)
        if phys is None:
            spec.append(None)
            continue
        cand = tuple(a for a in ((phys,) if isinstance(phys, str) else phys)
                     if a in axes_present and a not in used)
        if not cand:
            spec.append(None)
            continue
        total = 1
        for a in cand:
            total *= axes_present[a]
        if shape is not None and shape[i] % total != 0:
            # try the largest single axis that divides instead
            cand = tuple(a for a in cand if shape[i] % axes_present[a] == 0)[:1]
            if not cand:
                spec.append(None)
                continue
        used.update(cand)
        spec.append(cand if len(cand) > 1 else cand[0])
    return tuple(spec)


def shard(x, names: tuple, mesh=None):
    """The reference's sharding constraint by logical names: ``x`` itself.
    One card holds the whole tensor, so there is nothing to constrain; with
    a mesh the names must still match x's rank, as the reference asserts."""
    if mesh is not None and len(names) != x.ndim:
        raise ValueError(f"{names} name {len(names)} dims of a tensor of rank {x.ndim}")
    return x


def param_spec(path: str, shape: tuple, mesh=None) -> tuple:
    """The spec of a parameter from its pytree path (the TP layout)."""
    return logical_spec(_param_logical(path, shape), shape, mesh)


def _param_logical(path: str, shape: tuple) -> tuple:
    p = path.lower()
    n = len(shape)

    def pad(tail: tuple) -> tuple:
        return (None,) * (n - len(tail)) + tail  # leading dims = stacked layers

    if "embed" in p or "vocab_in" in p:
        return pad(("vocab", None)) if n >= 2 else (None,) * n
    if "w_vocab" in p or "lm_head" in p:
        return pad((None, "vocab"))
    if "table" in p:
        # hybrid table placement: small tables replicate, big ones row-shard
        if n >= 2 and shape[0] < 100_000:
            return (None,) * n
        return pad(("table_rows", None))
    if "experts" in p or "w_gate_e" in p or "w_up_e" in p or "w_down_e" in p:
        if n >= 3:
            return pad(("experts", None, None))
        return (None,) * n
    if any(k in p for k in ("wq", "wk", "wv", "w_qkv")):
        return pad((None, "heads")) if n >= 2 else (None,) * n
    if "wo" in p:
        return pad(("heads", None)) if n >= 2 else (None,) * n
    if any(k in p for k in ("w_gate", "w_up", "w_in")):
        return pad((None, "ffn")) if n >= 2 else (None,) * n
    if any(k in p for k in ("w_down", "w_out")):
        return pad(("ffn", None)) if n >= 2 else (None,) * n
    return (None,) * n


def zero1_spec(spec: tuple, shape: tuple, mesh=None) -> tuple:
    """The optimizer state's spec: the parameter's, plus 'data' on the first
    free dimension it divides (ZeRO-1 partitioning of m, v and the master
    copy over the data axis)."""
    axes_present = _axes(mesh)
    if axes_present is None or "data" not in axes_present:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    flat_used = set()
    for e in entries:
        for a in (e,) if isinstance(e, str) else (e or ()):
            flat_used.add(a)
    if "data" in flat_used:
        return spec
    d = axes_present["data"]
    for i, e in enumerate(entries):
        if e is None and shape[i] % d == 0:
            entries[i] = "data"
            return tuple(entries)
        if e is not None:
            # try composing data with the existing axis on this dim
            axes = (e,) if isinstance(e, str) else tuple(e)
            total = d
            for a in axes:
                total *= axes_present[a]
            if shape[i] % total == 0:
                entries[i] = tuple(axes) + ("data",)
                return tuple(entries)
    return spec


def spec_bytes(shape: tuple, itemsize: int, spec: tuple, mesh=None) -> int:
    """One device's bytes of a leaf of ``shape`` laid out by ``spec`` on
    ``mesh``: the leaf's bytes over the product of the axes its spec names
    (each sharded dimension divides, so this is exact)."""
    n = itemsize
    for d in shape:
        n *= d
    sizes = _axes(mesh) or {}
    div = 1
    for e in spec:
        for a in (e,) if isinstance(e, str) else (e or ()):
            div *= sizes[a]
    return n // div
