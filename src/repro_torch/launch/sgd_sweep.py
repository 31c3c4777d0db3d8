"""Where ``sgd_rows``' time goes on one GPU: the kernel over a master of
float32 rows in registered host memory, timed across row sets, host
backings and launch plans, beside a read-only and a write-only pass over
the same rows and the copy engines' rate.

    PYTHONPATH=src python3 src/repro_torch/launch/sgd_sweep.py [--rows N]
        [--backings huge,plain] [--sets sorted,shuffled,contiguous]
        [--variants update:1:cap,update:4:cap,update:4:8,...] [--repeats 10]

A master of ``--rows`` x 128 float32 (default 177,948,416 rows, the
``dlrm-mlperf`` tables: 91.1 GB; a smaller count for a quick run) is
allocated on each backing of ``kernels.embedding_bag.host_empty`` in turn,
registered with the card, read (``host_probe.pages``: its share on huge
pages, its NUMA nodes, and ``page_probe``: the read's time a row at
strides from 512 B to 2 MB), swept and released. Row sets, each of the size a
``train_batch`` step touches: ``sorted``, the distinct rows of a batch of
65,536 drawn per field as ``train_batch`` draws them (the Criteo
cardinalities, scaled to ``--rows``), in ascending order as the step gives
them; ``shuffled``, the same rows in random order; ``contiguous``, as many
consecutive rows. A variant is ``mode:R:blocks`` (``sgd_rows_plan``):
mode ``update`` (at lr = 0: the update's traffic, nothing moves),
``read`` or ``write``; R rows a warp; blocks an SM, or ``cap``
for one warp a group of every slot of the batch, live or not (the first
launch was ``update:1:cap``; the wrapper's is ``update:4:4``, 4 rows a
warp on 4 blocks an SM). ``link_ceiling_ms`` of a row
set is the slower of its fastest read and its fastest write: what the link
allows this access pattern when the two directions overlap perfectly.

It prints one JSON line: the card, the host readings of
``host_probe.host_report``, each instance's occupancy
(``sgd_rows_occupancy``: blocks an SM, registers, rows in flight an SM;
the default persistent variants are those grids at that occupancy), and
for each backing in turn (a backing may
come more than once) its registration seconds,
its pages, the copy engines' GB/s each way on it (4 GiB), the PCIe link
read while the update runs, and the ms and GB/s of each variant on each
row set: the mean of ``--repeats`` launches between CUDA events, after
one warm-up.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.kernels import embedding_bag as eb
from repro_torch.launch import host_probe

FULL_ROWS = 177_948_416  # dlrm-mlperf's padded rows
D = 128
BATCH = 65_536
DEFAULT_VARIANTS = ("update:1:cap", "update:2:cap", "update:4:cap", "update:8:cap",
                    "update:1:8", "update:2:6", "update:4:4", "update:8:2",
                    "read:1:cap", "read:4:cap", "write:1:cap", "write:4:cap")
COPY_BYTES = 4 << 30
PROBE_STRIDES = (1, 8, 128, 4096)  # rows apart: 512 B, 4 KB, 64 KB, 2 MB
PROBE_ROWS = 65_536


def step_rows(rows: int, seed: int, dev) -> torch.Tensor:
    """The distinct rows of one train_batch batch over a table of ``rows``
    rows: per field, BATCH ids uniform over its Criteo cardinality (scaled
    by rows / FULL_ROWS below full size), offset by the field's first row
    in the concatenated, padded table; sorted, int64, on ``dev``."""
    from repro_torch.configs.dlrm_mlperf import config

    cfg = config()
    scale = rows / FULL_ROWS
    counts = [max(1, int(c * scale)) for c in cfg.row_counts]
    padded = [max(1, int(cfg.padded_rows(c) * scale)) for c in cfg.row_counts]
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((BATCH, len(counts)), generator=gen, device=dev, dtype=torch.float64)
    lim = torch.tensor(counts, dtype=torch.float64, device=dev)
    ids = torch.minimum((u * lim).floor(), lim - 1).long()
    ids += torch.tensor(starts, dtype=torch.int64, device=dev)
    return torch.unique(ids)


def row_sets(rows: int, seed: int, names: list, dev) -> dict:
    base = step_rows(rows, seed, dev)
    n = base.numel()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    start = min(rows // 2 // 4096 * 4096, rows - n)
    sets = {"sorted": base,
            "shuffled": base[torch.randperm(n, generator=gen, device=dev)],
            "contiguous": torch.arange(start, start + n, device=dev)}
    return {k: sets[k] for k in names}


def plan_of(variant: str, cap: int, n_sms: int) -> eb.SgdPlan:
    """The launch a variant ``mode:R:blocks an SM`` (or ``:cap``) names."""
    mode, r, per_sm = variant.split(":")
    return eb.sgd_rows_plan(cap, int(r), None if per_sm == "cap" else n_sms * int(per_sm), mode)


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def copy_rates(master: torch.Tensor) -> dict:
    """The copy engines' GB/s each way between the card and the first 4 GiB
    of the registered master (at most its size)."""
    host = master.view(-1).view(torch.uint8)
    n = min(COPY_BYTES, host.numel())
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = {}
    for what, dst, src in (("d2h", host[:n], dev), ("h2d", dev, host[:n])):
        ms = _events_ms(lambda d=dst, s=src: d.copy_(s, non_blocking=True), 3)
        out[f"{what}_GBps"] = n / (ms / 1e3) / 1e9
    return out


def page_probe(master: torch.Tensor, table: torch.Tensor, strides: tuple = PROBE_STRIDES,
               rows: int = PROBE_ROWS, reps: int = 5) -> dict:
    """The read pass of ``sgd_rows`` over PROBE_ROWS master rows ``stride``
    rows apart, for each stride, in ns a row: where the time a row jumps
    with the stride shows the size of the pages through which the card
    reaches the master (rows 512 B apart share a 4 KB page, rows 4 KB apart
    do not). The read pass leaves a consistent master and table as they
    were."""
    dev = table.device
    grads = torch.zeros((rows, master.shape[1]), device=dev)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    out = {}
    for stride in strides:
        n = min(rows, master.shape[0] // stride)
        slots = torch.arange(n, device=dev) * stride
        plan = eb.sgd_rows_plan(n, 1, None, "read")
        ms = _events_ms(lambda s=slots, k=n, p=plan: eb.sgd_rows_cuda(
            master, table, s, grads[:k], torch.tensor(k, device=dev), zero, one, plan=p), reps)
        out[f"{stride * master.shape[1] * 4}B"] = ms * 1e6 / n
    return out


def link_while(fn, launches: int = 60) -> dict:
    """The PCIe link as nvidia-smi and sysfs read it while ``launches``
    enqueued calls of ``fn`` run."""
    for _ in range(launches):
        fn()
    out = {"smi": host_probe.smi("pcie.link.gen.current,pcie.link.width.current"),
           "sysfs": host_probe.pcie_sysfs(host_probe.card_bus_id())}
    torch.cuda.synchronize()
    return out


def wait_for_room(nbytes: int, timeout_s: float = 180.0) -> dict:
    """Wait until MemAvailable leaves host_probe.MARGIN beside ``nbytes``
    (a released master is returned to the host late); the meminfo last
    read."""
    t0 = time.perf_counter()
    while True:
        mem = host_probe.meminfo()
        if mem["MemAvailable"] - host_probe.MARGIN >= nbytes or \
                time.perf_counter() - t0 > timeout_s:
            return {**mem, "waited_s": time.perf_counter() - t0}
        time.sleep(2.0)


def sweep_backing(backing: str, rows: int, sets: dict, variants: list, repeats: int,
                  table: torch.Tensor, grads: torch.Tensor, n_sms: int) -> dict:
    nbytes = rows * D * 4
    res = {"room": wait_for_room(nbytes)}
    master = eb.host_empty((rows, D), backing)
    res["register_s"] = eb.register_host(master)
    try:
        res["pages"] = host_probe.pages(master)
        res["anon_huge_pages"] = host_probe.anon_huge_pages()
        res["copy_engines"] = copy_rates(master)
        res["page_probe_ns_per_row"] = page_probe(master, table)
        zero, one = torch.zeros((), device="cuda"), torch.ones((), device="cuda")
        cap = grads.shape[0]
        res["sets"] = {}
        for name, r in sets.items():
            n = r.numel()
            slots = torch.zeros(cap, dtype=torch.int64, device="cuda")
            slots[:n] = r
            n_t = torch.tensor(n, device="cuda")
            out = {"rows": n, "variants": {}}
            for text in variants:
                plan = plan_of(text, cap, n_sms)
                ms = _events_ms(lambda p=plan: eb.sgd_rows_cuda(
                    master, table, slots, grads, n_t, zero, one, plan=p), repeats)
                ways = 2 if plan.mode == "update" else 1
                out["variants"][text] = {"ms": ms, "GBps": ways * n * D * 4 / (ms / 1e3) / 1e9,
                                         "blocks": plan.blocks}
            v = out["variants"]
            reads = [x["ms"] for k, x in v.items() if k.startswith("read:")]
            writes = [x["ms"] for k, x in v.items() if k.startswith("write:")]
            if reads and writes:
                out["link_ceiling_ms"] = max(min(reads), min(writes))
            upd = [(x["ms"], k) for k, x in v.items() if k.startswith("update:")]
            if upd:
                out["best"] = min(upd)[1]
            if name == "sorted" and upd:
                plan = plan_of(min(upd)[1], cap, n_sms)
                out["link_during_update"] = link_while(lambda p=plan: eb.sgd_rows_cuda(
                    master, table, slots, grads, n_t, zero, one, plan=p))
            res["sets"][name] = out
    finally:
        eb.unregister_host(master)
    del master
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=FULL_ROWS)
    ap.add_argument("--backings", default=",".join(eb.BACKINGS))
    ap.add_argument("--sets", default="sorted,shuffled,contiguous")
    ap.add_argument("--variants", default=",".join(DEFAULT_VARIANTS))
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sgd_sweep: no CUDA device visible")
    torch.cuda.init()
    report = {"device": torch.cuda.get_device_name(0), "host": host_probe.host_report(),
              "rows": args.rows, "repeats": args.repeats}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    report["occupancy"] = {f"{mode}:{r}": eb.sgd_rows_occupancy(r, mode)
                           for mode in eb.SGD_MODES for r in eb.SGD_ROWS_PER_WARP}
    sets = row_sets(args.rows, args.seed, args.sets.split(","), "cuda")
    table = torch.empty((args.rows, D), dtype=torch.bfloat16, device="cuda")
    grads = torch.zeros((BATCH * 26, D), device="cuda")
    report["backings"] = [{"backing": b, **sweep_backing(
        b, args.rows, sets, args.variants.split(","), args.repeats, table, grads, n_sms)}
        for b in args.backings.split(",")]
    print(json.dumps(report))


if __name__ == "__main__":
    main()
