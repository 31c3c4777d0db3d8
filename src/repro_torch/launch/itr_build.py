"""The ITR build's RePair ``compress`` on one GPU, as the importable
``repro_torch`` runs it: what the device Count and Update Count buy end to
end.

    PYTHONPATH=src python3 src/repro_torch/launch/itr_build.py
    PYTHONPATH=<another checkout>/src python3 src/repro_torch/launch/itr_build.py

It makes geo-coordinates-en's hypergraph (``--scale`` 1.0: 50,000 triples,
from ``--seed``) on the card, runs ``compress`` once to warm up (the
kernels build there), then ``--repeats`` times on the host clock around
work that ends in ``torch.cuda.synchronize()``. It prints one JSON line:
the card, the median, quartiles and minimum of the compress seconds and
of the seconds spent inside the digram counter (``DigramCounter``'s
constructor, ``apply_delta``, ``pop_best``, ``peek_pop``, ``push_back``,
host clock, waits on the device included), the grammar's stats, the
kernel launches of one compress, its host syncs (torch's sync debug
mode: a lower bound) and its device busy share (``torch.profiler``:
kernel time over wall time). Run it for two
checkouts in turns (A, B, B, A) to read them on one host; only the public
API is used, so any checkout of the port runs it.
"""
from __future__ import annotations

import argparse
import json
import time
import warnings

import numpy as np
import torch


def _syncs(fn) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _busy_share(fn) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return kernel_us / 1e6 / wall


def _stats(secs: list) -> dict:
    q1, med, q3 = np.percentile(secs, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3), "min": float(min(secs)),
            "runs": secs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    from repro_torch.core import Hypergraph, LabelTable, compress
    from repro_torch.core.digram import DigramCounter
    from repro_torch.data.synthetic import PAPER_DATASETS
    from repro_torch.kernels import ops

    inside = [0.0, 0]  # host seconds inside the counter's methods; calls open

    def timed(f):
        def run(*a, **kw):  # one method may call another: time the outermost
            t0 = time.perf_counter()
            inside[1] += 1
            try:
                return f(*a, **kw)
            finally:
                inside[1] -= 1
                if not inside[1]:
                    inside[0] += time.perf_counter() - t0
        return run

    for name in ("__init__", "apply_delta", "pop_best", "peek_pop", "push_back"):
        setattr(DigramCounter, name, timed(getattr(DigramCounter, name)))

    if not torch.cuda.is_available():
        raise SystemExit("itr_build: no CUDA device visible")
    ds = PAPER_DATASETS["geo-coordinates-en"](scale=args.scale, seed=args.seed)
    graph = Hypergraph.from_triples(ds.triples, ds.n_nodes)
    table = LabelTable.terminals(np.full(ds.n_preds, 2))

    def run():
        return compress(graph, table)

    run()
    torch.cuda.synchronize()
    secs, counter = [], []
    for _ in range(args.repeats):
        inside[0] = 0.0
        t0 = time.perf_counter()
        _, stats = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counter.append(inside[0])
    ops.reset_launch_counts()
    run()
    launches = {k: v for k, v in ops.launch_counts.items() if v}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "repeats": args.repeats,
                      "compress_s": _stats(secs), "counter_s": _stats(counter),
                      "stats": vars(stats), "launches": launches,
                      "host_syncs": _syncs(run), "busy_share": _busy_share(run)}))


if __name__ == "__main__":
    main()
