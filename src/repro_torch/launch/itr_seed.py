"""The ITR query path's S/O seed and warm batches on one GPU, as the
importable ``repro_torch`` runs them: what the fused k²-tree descent buys
end to end.

    PYTHONPATH=src python3 src/repro_torch/launch/itr_seed.py
    PYTHONPATH=<another checkout>/src python3 src/repro_torch/launch/itr_seed.py

It builds the engine for geo-coordinates-en (``--scale`` 1.0: 50,000
triples, from ``--seed``), picks 4,096 queries from the triples, warms
every pattern once, then times ``--repeats`` rounds, each one call of
``incidence.rows_many`` on the s?? batch's subjects and one
``query_batch_view`` of each pattern, on the host clock around work that
ends in ``torch.cuda.synchronize()``. It prints one JSON line: the card,
the median, quartiles and minimum of each, and the host syncs of one
``rows_many`` and one s?? batch (torch's sync debug mode: a lower bound).
Run it for two checkouts in turns (A, B, B, A) to read them on one host;
only the public API is used, so any checkout of the port runs it.
"""
from __future__ import annotations

import argparse
import inspect
import json
import time
import warnings

import numpy as np
import torch

PATTERNS = ("s??", "?p?", "??o", "sp?", "s?o", "?po", "spo")


def _syncs(fn) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _stats(ms: list) -> dict:
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3), "min": float(min(ms))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)

    from repro_torch.core import Hypergraph, LabelTable, TripleQueryEngine, compress, encode
    from repro_torch.data.synthetic import PAPER_DATASETS

    if not torch.cuda.is_available():
        raise SystemExit("itr_seed: no CUDA device visible")
    ds = PAPER_DATASETS["geo-coordinates-en"](scale=args.scale, seed=args.seed)
    pick = ds.triples[np.random.default_rng(args.seed).integers(0, ds.n_triples, args.queries)]
    grammar, _ = compress(Hypergraph.from_triples(ds.triples, ds.n_nodes),
                          LabelTable.terminals(np.full(ds.n_preds, 2)))
    # the cache-less engine, as phase 3 of chip_smoke.py runs it (a tree from
    # before the result cache takes no such arguments)
    bare = {"cache": None, "delta_budget": None} \
        if "cache" in inspect.signature(TripleQueryEngine).parameters else {}
    engine = TripleQueryEngine(grammar, encode(grammar), **bare)
    batches = {pat: [torch.from_numpy(pick[:, i].copy() if pat[i] != "?"
                                      else np.full(args.queries, -1, dtype=np.int64)).cuda()
                     for i in range(3)] for pat in PATTERNS}
    s = batches["s??"][0]
    runs = {"rows_many": lambda: engine.incidence.rows_many(s),
            **{pat: (lambda c=cols: engine.query_batch_view(*c)) for pat, cols in batches.items()}}
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in runs}
    for _ in range(args.repeats):
        for name, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "repeats": args.repeats,
                      "ms": {name: _stats(v) for name, v in ms.items()},
                      "host_syncs": {"rows_many": _syncs(runs["rows_many"]),
                                     "s??": _syncs(runs["s??"])}}))


if __name__ == "__main__":
    main()
