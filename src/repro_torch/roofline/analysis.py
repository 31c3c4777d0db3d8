"""Roofline terms of a cell on one NVIDIA H100: the twin of
``repro.roofline.analysis``.

Three terms per (arch x shape), all in seconds a step:

  compute    = FLOPs / peak FLOP rate
  memory     = bytes / HBM bandwidth
  collective = wire bytes / link bandwidth

:class:`HW` keeps the reference's field names, so the same constants can be
handed to both packages; its defaults are the datasheet figures of the
H100 SXM5 (H100 80GB HBM3, 700 W), not measurements: 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s of HBM3, and 450 GB/s a direction over
NVLink 4 (the field the reference calls ``ici_bw``). On one card there is
no collective, so every wire byte, and the collective term, is 0.

``parse_collectives`` and ``collective_wire_bytes`` read XLA HLO text with
the reference's ring models; they are plain ``re`` and kept as copies so
that the package exports what the reference's does. ``model_flops`` is a
copy of the reference's analytic useful work of a cell.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12     # bf16 dense, tensor cores (datasheet)
    hbm_bw: float = 3.35e12        # bytes/s, HBM3 (datasheet)
    ici_bw: float = 450e9          # bytes/s a direction, NVLink 4 (datasheet)


DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL = re.compile(
    r"=\s*(?P<rtype>.+?)\s+(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(",
)
_SHAPE = re.compile(r"(?P<dt>[a-z0-9]+)\[(?P<dims>[0-9,]*)\]")
_GROUPS_COMPACT = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_EXPL = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE.finditer(type_str):
        dt = m.group("dt")
        if dt not in DTYPE_BYTES:
            continue
        dims = m.group("dims")
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_COMPACT.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_EXPL.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    return default


def parse_collectives(hlo_text: str, n_devices: int) -> dict:
    """Per-collective-type result bytes and modelled wire bytes (a device)."""
    out: dict[str, dict] = {}
    for line in hlo_text.splitlines():
        m = _COLL.search(line)
        if not m:
            continue
        op = m.group("op")
        if "-done(" in line:  # async pairs: count -start, skip the -done
            continue
        rbytes = _shape_bytes(m.group("rtype"))
        n = _group_size(line, n_devices)
        frac = (n - 1) / max(n, 1)
        if op == "all-gather":
            wire = rbytes * frac
        elif op == "all-reduce":
            wire = 2 * rbytes * frac
        elif op == "reduce-scatter":
            wire = rbytes * (n - 1)
        elif op == "all-to-all":
            wire = rbytes * frac
        else:  # collective-permute
            wire = rbytes
        d = out.setdefault(op, {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += rbytes
        d["wire_bytes"] += wire
    return out


def collective_wire_bytes(parsed: dict) -> float:
    return float(sum(d["wire_bytes"] for d in parsed.values()))


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, hw: HW = HW()) -> dict:
    compute = flops_per_dev / hw.peak_flops
    memory = bytes_per_dev / hw.hbm_bw
    collective = wire_bytes_per_dev / hw.ici_bw
    dominant = max(
        [("compute", compute), ("memory", memory), ("collective", collective)],
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_step_s": max(compute, memory, collective),
    }


def model_flops(arch_id: str, shape_name: str, meta: dict) -> float:
    """Analytic useful-work FLOPs a step (the whole step, every device).

    LM: 6·N_active·tokens for training (forward and backward), 2·N_active·tokens
    plus attention for inference. GNN and DLRM: closed forms of the
    published structures."""
    kind = meta["kind"]
    if meta["family"] == "lm":
        n_active = meta["n_active_params"]
        B, S = meta["global_batch"], meta["seq_len"]
        h_kv_dh = meta["n_heads"] * meta["head_dim"]
        if kind == "train":
            tokens = B * S
            attn = 6 * B * meta["n_layers"] * S * S * h_kv_dh  # fwd+bwd, causal halved
            return 6.0 * n_active * tokens + attn
        if kind == "prefill":
            tokens = B * S
            attn = 2 * B * meta["n_layers"] * S * S * h_kv_dh
            return 2.0 * n_active * tokens + attn
        # decode: one token over a seq_len cache
        attn = 4 * B * meta["n_layers"] * S * h_kv_dh
        return 2.0 * n_active * B + attn
    if meta["family"] == "gnn":
        n, e, d_f = meta["n_nodes"], meta["n_edges"], meta["d_feat"]
        L, d = meta["n_layers"], meta["d_hidden"]
        mults = {
            "gcn-cora": 2 * n * d_f * d + 2 * e * d + 2 * L * n * d * d,
            "gatedgcn": L * (10 * n * d * d + 8 * e * d),
            "meshgraphnet": L * (2 * 3 * d * d * e + 2 * 2 * d * d * n) * 2,
            "nequip": L * (e * (11 * d * 9 + 2 * 8 * 32 * d) + 2 * n * d * d * 3),
        }
        fwd = float(mults[arch_id])
        return 3.0 * fwd if kind in ("full_graph", "minibatch", "molecule") else fwd
    # dlrm
    B = meta.get("batch", 1)
    if kind == "retrieval":
        return 2.0 * meta["n_candidates"] * meta["embed_dim"]
    bot = 2 * (13 * 512 + 512 * 256 + 256 * 128)
    f = meta["n_fields"]
    inter = 2 * f * f * meta["embed_dim"]
    d_int = f * (f - 1) // 2 + meta["embed_dim"]
    top = 2 * (d_int * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    fwd = B * float(bot + inter + top)
    return 3.0 * fwd if kind == "train" else fwd
