#!/usr/bin/env python3
"""Time phases 3f and 3g of ``chip_smoke.py`` at two depths, in turns, in
one process on one card (GPU only).

    python3 scripts/smoke_depth_ab.py

After building the kernels it runs phase 9 (the dry-run) and phases 3-3e,
which 3f and 3g build on, then 3f and 3g four times: at the depth the
script had before phase 9 came (growth in batches of 1,024, 64 string
queries a side, 2 s stress and replica runs, tier checks over 4,096 rows)
and at its own, in the order
old, new, new, old, printing each run's seconds and its parts
(``part_s``). Every check of both phases runs at either depth.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

OLD = dict(GROWTH_BATCH=1024, TIER_STRINGS=64, STRESS_SECONDS=2.0, REPLICA_STRESS_S=2.0,
           TIER_PICKS=(1024, 1024, 2048))


def main() -> int:
    if not torch.cuda.is_available():
        print("smoke_depth_ab: no CUDA device visible", file=sys.stderr)
        return 2
    t = time.perf_counter()
    card = cs._card()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    print("kernel_build_s", ops.build_all(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    part = cs.drive_dryrun(torch, np, 0, card)
    print("phase9 counts", part["counts"], "seconds", part["seconds"], flush=True)
    main_res = cs.drive_main_path(torch, np, 0, 1.0, 4096)
    for f in (cs.drive_scalar_path, cs.drive_mutation_path, cs.drive_snapshot_path,
              cs.drive_bgp_path):
        f(torch, np, main_res, 0)
    print(f"elapsed_s after 3e {time.perf_counter() - t:.3f}", flush=True)
    depth = {"old": OLD, "new": {k: getattr(cs, k) for k in OLD}}
    res = []
    for name in ("old", "new", "new", "old"):
        for k, v in depth[name].items():
            setattr(cs, k, v)
        t0 = time.perf_counter()
        cs.drive_sharded_path(torch, np, main_res, 0)
        t1 = time.perf_counter()
        cs.drive_durable_path(torch, np, main_res, 0)
        t2 = time.perf_counter()
        res.append((name, round(t1 - t0, 3), round(t2 - t1, 3),
                    main_res["sharded_part"]["part_s"], main_res["durable_part"]["part_s"]))
        print(f"AB {name}: 3f {t1 - t0:.3f} s, 3g {t2 - t1:.3f} s; {res[-1][3]}; {res[-1][4]}; "
              f"{card}", flush=True)
    print("AB summary", res, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
