#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ITR on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--scale 1.0] [--queries 4096]

Run from the root of a checkout; it imports the port from ``src/`` and
nothing of the JAX package. Phases:

1. build every CUDA kernel of the main path from ``src/repro_torch/csrc``;
2. hold each kernel against its plain PyTorch twin on the card, exactly
   (integer outputs), on the edge cases of its contract;
3. drive the main path once at full size: geo-coordinates-en (50,000
   triples) -> ``Hypergraph.from_triples`` -> ``compress`` -> ``encode`` ->
   ``TripleQueryEngine`` -> ``query_batch_view`` for all eight patterns,
   every query checked against ``query_oracle`` (a plain scan of the
   triples on the card), with the kernels' launch counts read around it;
4. time each kernel on the inputs the main path gave it, beside its plain
   twin and its least possible time (bytes moved at 3.35 TB/s);
5. break the main path's time down: warm query repeats, the k² seed, the
   initial Count, the device's busy share (``torch.profiler``), the host
   syncs (torch's sync debug mode; a lower bound), and the same build and
   s?? batch with ``device="cpu"`` as a host yardstick.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
Without a CUDA device, or without ``src/repro_torch`` beside it, it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT_OPS_PER_S = 67e12         # H100 SXM rate outside the tensor cores (fp32 table entry)
DEV = "cuda"
PATTERNS = ("s??", "?p?", "??o", "sp?", "s?o", "?po", "spo")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernels(torch, np, seed: int) -> dict:
    """Phase 2: each kernel equals its plain twin on the card, exactly."""
    from repro_torch.core.succinct.bitvector import BitVector
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda
    from repro_torch.kernels.digram_count import digram_pair_counts_cuda

    rng = np.random.default_rng(seed)
    err = {"bitvec_rank": 0, "digram_pair_counts": 0}
    n_cases = 0
    for nbits in (1, 32, 33, 4096, 100_003):
        bits = rng.integers(0, 2, nbits)
        bits[: min(nbits, 64)] = 1  # whole words with the top bit set
        bv = BitVector(torch.from_numpy(bits).to(DEV))
        bv.rank1(torch.zeros(1, dtype=torch.int64, device=DEV))  # builds _rank_words
        words, ranks = bv._rank_words, bv.word_ranks
        for q in (0, 1, 255, 257, 1000, 4097):
            pos = torch.from_numpy(rng.integers(0, nbits + 1, q)).to(DEV)
            if q:
                pos[-1] = nbits  # pos == n
            got = bitvec_rank_cuda(words, ranks, pos)
            want = ref.bitvec_rank_ref(words, ranks, pos)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                _fail(f"bitvec_rank differs from its twin at nbits={nbits} q={q}")
            if q:
                err["bitvec_rank"] = max(err["bitvec_rank"],
                                         int((got - want).abs().max()))
            n_cases += 1
    for k in (1, 2, 7, 64):
        for n in (1, 1001, 4099):
            its = rng.integers(0, 50, (n, k)).astype(np.int32)
            cnts = rng.integers(1, 10, (n, k)).astype(np.int32)
            pad = rng.random((n, k)) < 0.3
            its[pad] = -1
            cnts[pad] = 0
            its_t, cnts_t = torch.from_numpy(its).to(DEV), torch.from_numpy(cnts).to(DEV)
            got = digram_pair_counts_cuda(its_t, cnts_t)
            want = ref.digram_pair_counts_ref(its_t, cnts_t)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.equal(g, w):
                    _fail(f"digram_pair_counts differs from its twin at K={k} N={n}")
                err["digram_pair_counts"] = max(err["digram_pair_counts"],
                                                int((g - w).abs().max()))
            n_cases += 1
    print(f"kernels_vs_plain cases={n_cases} exact=True")
    return err


def drive_main_path(torch, np, seed: int, scale: float, n_queries: int) -> dict:
    """Phase 3: build and query at full size, checked against the oracle."""
    from repro_torch.core import (Hypergraph, LabelTable, TripleQueryEngine, compress,
                                  encode, query_oracle, result_rows)
    from repro_torch.data.synthetic import PAPER_DATASETS
    from repro_torch.kernels import ops

    ds = PAPER_DATASETS["geo-coordinates-en"](scale=scale, seed=seed)
    print(f"dataset geo-coordinates-en scale={scale} triples={ds.n_triples} "
          f"nodes={ds.n_nodes} preds={ds.n_preds}")
    rng = np.random.default_rng(seed)
    pick = ds.triples[rng.integers(0, ds.n_triples, n_queries)]

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    stages = {}
    t0 = time.perf_counter()
    graph = Hypergraph.from_triples(ds.triples, ds.n_nodes)
    table = LabelTable.terminals(np.full(ds.n_preds, 2))
    torch.cuda.synchronize()
    stages["from_triples"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    grammar, stats = compress(graph, table)
    torch.cuda.synchronize()
    stages["compress"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    encoded = encode(grammar)
    torch.cuda.synchronize()
    stages["encode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    engine = TripleQueryEngine(grammar, encoded)
    torch.cuda.synchronize()
    stages["engine"] = time.perf_counter() - t1
    build_s = time.perf_counter() - t0

    views, batches, query_s = {}, {}, {}
    for pat in PATTERNS + ("???",):
        n = 4 if pat == "???" else n_queries
        cols = [torch.from_numpy(pick[:n, i].copy() if pat[i] != "?"
                                 else np.full(n, -1, dtype=np.int64)).to(DEV)
                for i in range(3)]
        t1 = time.perf_counter()
        views[pat] = engine.query_batch_view(*cols)
        torch.cuda.synchronize()
        query_s[pat] = time.perf_counter() - t1
        batches[pat] = cols
    counts = dict(ops.launch_counts)

    print(f"build_s {build_s:.6f} " + " ".join(f"{k}_s={v:.6f}" for k, v in stages.items()))
    print(f"grammar rules={len(grammar.rules)} start_edges={grammar.start.n_edges} "
          f"iterations={stats.iterations} size_units={stats.final_size_units} "
          f"k2_height={encoded.incidence.h}")
    print(f"encoded_bytes {encoded.size_in_bytes()}")
    for name, c in counts.items():
        print(f"launches {name} {c}")
        if c <= 0:
            _fail(f"the main path never launched {name}")

    triples = torch.from_numpy(ds.triples).to(DEV)
    results = {}
    for pat, view in views.items():
        s, p, o = batches[pat]
        q = torch.stack([s, p, o], dim=1)
        uniq = torch.unique(q, dim=0)
        if view.n_entries != uniq.shape[0] or not torch.equal(
                uniq[view.qid_entry], q):
            _fail(f"{pat}: query -> entry map is wrong")
        owner = torch.repeat_interleave(torch.arange(view.n_entries, device=DEV),
                                        view.entry_counts())
        got = result_rows(owner, view.labels, view.nodes, view.offsets)
        want = query_oracle(triples, uniq[:, 0], uniq[:, 1], uniq[:, 2])
        if not torch.equal(got, want):
            _fail(f"{pat}: results differ from the oracle")
        n_q = s.numel()
        total = view.total_results()
        results[pat] = total
        print(f"query {pat} queries={n_q} unique={view.n_entries} results={total} "
              f"us_per_query={query_s[pat] / n_q * 1e6:.3f} oracle_equal=True")
    return {"engine": engine, "graph": graph, "table": table, "counts": counts,
            "batches": batches, "build_s": build_s, "dataset": ds}


def time_kernels(torch, np, main: dict, errs: dict) -> list:
    """Phase 4: each kernel on the inputs the main path gives it."""
    from repro_torch.core.digram import digram_counts
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda
    from repro_torch.kernels.digram_count import digram_pair_counts_cuda

    # capture the inputs of one s?? seed batch and of one initial Count
    calls = {"bitvec_rank": [], "digram_pair_counts": []}
    real_rank, real_pairs = ops.bitvec_rank, ops.digram_pair_counts

    def rec_rank(*a):
        calls["bitvec_rank"].append(a)
        return real_rank(*a)

    def rec_pairs(*a):
        calls["digram_pair_counts"].append(a)
        return real_pairs(*a)

    ops.bitvec_rank, ops.digram_pair_counts = rec_rank, rec_pairs
    try:
        s = main["batches"]["s??"][0]
        main["engine"].incidence.rows_many(s)
        digram_counts(main["graph"], main["table"], cap=64)
    finally:
        ops.bitvec_rank, ops.digram_pair_counts = real_rank, real_pairs
    torch.cuda.synchronize()

    rank_calls = calls["bitvec_rank"]
    pair_calls = calls["digram_pair_counts"]
    for name, fn, twin, cs in (("bitvec_rank", bitvec_rank_cuda, ref.bitvec_rank_ref,
                                rank_calls),
                               ("digram_pair_counts", digram_pair_counts_cuda,
                                ref.digram_pair_counts_ref, pair_calls)):
        for a in cs:
            got, want = fn(*a), twin(*a)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    _fail(f"{name} differs from its twin at main-path shapes")
                if g.numel():
                    errs[name] = max(errs[name], int((g - w).abs().max()))

    rank_bytes = sum(16 * a[2].numel() + min(64 * a[2].numel(), 12 * a[0].numel())
                     for a in rank_calls)
    rank_ops = sum(12 * a[2].numel() for a in rank_calls)
    pair_bytes = sum(8 * a[0].numel() + 12 * a[0].shape[0] * (a[0].shape[1] * (a[0].shape[1] + 1) // 2)
                     for a in pair_calls)
    pair_ops = sum(16 * a[0].shape[0] * (a[0].shape[1] * (a[0].shape[1] + 1) // 2)
                   for a in pair_calls)
    print(f"bitvec_rank main-path shapes: {len(rank_calls)} calls (one s?? seed batch), "
          f"Q per level={[a[2].numel() for a in rank_calls]}, "
          f"W+1 per level={[a[0].numel() for a in rank_calls]}")
    print(f"digram_pair_counts main-path shapes: {len(pair_calls)} calls (one initial Count), "
          f"(N, K)={[tuple(a[0].shape) for a in pair_calls]}")

    out = []
    for name, src, replaces, fn, twin, cs, nbytes, nops in (
            ("bitvec_rank", "src/repro_torch/csrc/bitvec_rank.cu",
             "src/repro/kernels/bitvec_rank.py:33", bitvec_rank_cuda,
             ref.bitvec_rank_ref, rank_calls, rank_bytes, rank_ops),
            ("digram_pair_counts", "src/repro_torch/csrc/digram_count.cu",
             "src/repro/kernels/digram_count.py:39", digram_pair_counts_cuda,
             ref.digram_pair_counts_ref, pair_calls, pair_bytes, pair_ops)):
        def run_kernel(fn=fn, cs=cs):
            for a in cs:
                fn(*a)

        def run_plain(twin=twin, cs=cs):
            for a in cs:
                twin(*a)

        plain_a = _time_ms(torch, run_plain, 20)
        ms_a = _time_ms(torch, run_kernel, 50)
        ms_b = _time_ms(torch, run_kernel, 50)
        plain_b = _time_ms(torch, run_plain, 20)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT_OPS_PER_S * 1e3
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": main["counts"][name], "max_abs_err": errs[name],
                 "ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": None}
        print(f"kernel {name} ms={entry['ms']:.6f} plain_ms={entry['plain_ms']:.6f} "
              f"bound_ms={entry['bound_ms']:.6f} ({entry['bound_by']}, {nbytes} B) "
              f"launches={entry['launches']} library=none")
        out.append(entry)
    return out


def _device_busy(torch, fn) -> tuple[float, float]:
    """(wall seconds, summed device kernel seconds) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return wall, dev_us / 1e6


def _count_syncs(torch, fn) -> int:
    """Host-device synchronisations during one call of fn, as counted by
    torch's CUDA sync debug mode."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def breakdown(torch, main: dict) -> None:
    """Phase 5: where the main path's time goes (warm repeats)."""
    from repro_torch.core import compress
    from repro_torch.core.digram import digram_counts

    engine, batches = main["engine"], main["batches"]
    for pat, cols in batches.items():
        t0 = time.perf_counter()
        engine.query_batch_view(*cols)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"warm query {pat} us_per_query={dt / cols[0].numel() * 1e6:.3f} "
              f"batch_ms={dt * 1e3:.3f}")
    s = batches["s??"][0]
    t0 = time.perf_counter()
    engine.incidence.rows_many(s)
    torch.cuda.synchronize()
    print(f"s?? seed (k2 rows_many, {engine.incidence.h} levels) "
          f"ms={(time.perf_counter() - t0) * 1e3:.3f}")
    t0 = time.perf_counter()
    digram_counts(main["graph"], main["table"], cap=64)
    torch.cuda.synchronize()
    print(f"initial Count (digram_counts) ms={(time.perf_counter() - t0) * 1e3:.3f}")
    for what, fn in (("s?? batch", lambda: engine.query_batch_view(*batches["s??"])),
                     ("?p? batch", lambda: engine.query_batch_view(*batches["?p?"])),
                     ("compress", lambda: compress(main["graph"], main["table"]))):
        wall, dev = _device_busy(torch, fn)
        share = f"{dev / wall:.4f}" if dev > 0 else "not measured"
        syncs = _count_syncs(torch, fn)
        print(f"device busy {what}: wall_s={wall:.6f} kernel_s={dev:.6f} busy_share={share} "
              f"host_syncs={syncs}")

    # the same port code on the host CPU, as a yardstick for the host-bound
    # parts (a CPU time, not a device metric)
    from repro_torch.core import Hypergraph, LabelTable, TripleQueryEngine, encode

    ds = main["dataset"]
    t0 = time.perf_counter()
    grammar, _ = compress(Hypergraph.from_triples(ds.triples, ds.n_nodes, device="cpu"),
                          LabelTable.terminals([2] * ds.n_preds, device="cpu"))
    cpu_engine = TripleQueryEngine(grammar, encode(grammar))
    build_s = time.perf_counter() - t0
    cols = [c.cpu() for c in batches["s??"]]
    t0 = time.perf_counter()
    cpu_engine.query_batch_view(*cols)
    dt = time.perf_counter() - t0
    print(f"host CPU yardstick (same code, device=cpu): build_s={build_s:.6f} "
          f"s?? us_per_query={dt / cols[0].numel() * 1e6:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import ops

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build_s = ops.build_all()
    print(f"kernel_build_s {build_s:.3f}")
    errs = check_kernels(torch, np, args.seed)
    main_res = drive_main_path(torch, np, args.seed, args.scale, args.queries)
    kernels = time_kernels(torch, np, main_res, errs)
    breakdown(torch, main_res)
    if sys.modules.get("jax") is not None or any(
            m == "repro" or m.startswith("repro.") for m in sys.modules):
        _fail("the JAX package or jax was imported")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    print(json.dumps({"kernels": kernels}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
