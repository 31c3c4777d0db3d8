"""lm_serve decode on one GPU with the split decode as planned, unsplit, or
as the importable ``repro_torch`` does it: what the split across blocks
buys end to end and at one layer.

    PYTHONPATH=src python3 src/repro_torch/launch/decode_splits.py plan unsplit unsplit plan
    PYTHONPATH=<another checkout>/src python3 src/repro_torch/launch/decode_splits.py as_is

Modes: ``plan`` (the wrapper's plan), ``unsplit`` (the plan forced to one
split, so no merge runs), ``as_is`` (whatever the imported package does,
for a checkout without a planner). One process serves ``qwen2-1.5b`` at
full width with random weights from ``--seed``, lm_serve's traffic: 8
prompts of 256-2,048 ids, 64 greedy tokens each, a cache of 4,096. For
each mode in the order given it prints one JSON line: decode ms a token
of each of ``--repeats`` generate calls, prefill ms, kernel launches a
generate call, and one decode layer's attention (the first layer of a
decode step, its inputs captured): device time a call from the profiler,
the kernels it traced a call (2 as planned and split, else 1: fewer
means the trace lost launches), and host time a call from CUDA events
around back-to-back calls. Interleave the modes (plan, unsplit, unsplit,
plan) to read them on one host.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

MAX_LEN = 4096
PROMPT_LENS = (256, 2048)
NEW_TOKENS = 64


def _prompts(rng, n: int, vocab: int) -> list:
    return [rng.integers(0, vocab, int(rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))).tolist()
            for _ in range(n)]


def _set_mode(fa, mode: str, plan_splits) -> None:
    if mode == "unsplit":
        fa.plan_splits = lambda *a, **kw: 1
    elif mode == "plan":
        fa.plan_splits = plan_splits
    elif mode != "as_is":
        raise ValueError(f"unknown mode {mode!r}")


def _capture_decode_attention(ops, run) -> tuple:
    """(args, kwargs) of the first ops.flash_attention call of run() with
    one query position (a decode step)."""
    seen = []
    real = ops.flash_attention

    def rec(q, k, v, **kw):
        if not seen and q.shape[2] == 1:
            seen.append(((q, k, v), kw))
        return real(q, k, v, **kw)

    ops.flash_attention = rec
    try:
        run()
    finally:
        ops.flash_attention = real
    return seen[0]


def _layer_ms(ops, args, kw, reps: int = 50) -> tuple[float, float, float]:
    """(device ms a call summed over every kernel it launches, by the
    profiler; kernels the profiler traced a call, to tell a trace that
    lost launches; host ms a call, by CUDA events around reps calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        ops.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ops.flash_attention(*args, **kw)
        torch.cuda.synchronize()
    traced = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in traced)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ops.flash_attention(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return dev_us / reps / 1e3, sum(e.count for e in traced) / reps, start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="+", choices=("plan", "unsplit", "as_is"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_splits needs a CUDA device")
        return 2

    from repro_torch.configs.qwen2_1_5b import config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    plan_splits = getattr(fa, "plan_splits", None)
    if plan_splits is None and set(args.modes) - {"as_is"}:
        raise SystemExit("this repro_torch has no split planner: use the mode as_is")
    model = Transformer.from_config(config(), device="cuda", seed=args.seed)
    prompts = _prompts(np.random.default_rng(args.seed + 4), 8, model.cfg.vocab)
    eng = ServeEngine(model, max_len=MAX_LEN)
    eng.generate(prompts, max_new_tokens=2)  # warm-up: the kernels' build, cuBLAS, allocator
    for mode in args.modes:
        _set_mode(fa, mode, plan_splits)
        decode, prefill = [], []
        for _ in range(args.repeats):
            ops.reset_launch_counts()
            res = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
            torch.cuda.synchronize()
            decode.append(res.decode_ms_per_token)
            prefill.append(res.prefill_ms)
        counts = dict(ops.launch_counts)
        att_args, att_kw = _capture_decode_attention(
            ops, lambda: eng.generate(prompts, max_new_tokens=2))
        dev_ms, traced, host_ms = _layer_ms(ops, att_args, att_kw)
        splits = (fa.planned_splits(*att_args[:2], **att_kw)
                  if hasattr(fa, "planned_splits") else None)
        print(json.dumps({
            "mode": mode, "time": time.strftime("%H:%M:%S"),
            "decode_ms_per_token": decode, "prefill_ms": prefill,
            "launches_per_generate": {n: c / args.repeats for n, c in counts.items() if c},
            "layer": {"q": list(att_args[0].shape), "k": list(att_args[1].shape),
                      "q_offset": att_kw.get("q_offset"), "n_splits": splits,
                      "device_ms": dev_ms, "kernels_traced_per_call": traced,
                      "host_ms": host_ms}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
