"""A durable writer to be killed: opens a service directory with
:meth:`~repro_torch.persist.service.DurableShardedService.open` and makes
one durable write a batch, reporting each as it is acknowledged.

    PYTHONPATH=src python -m repro_torch.launch.itr_durable --root DIR \\
        --batches BATCHES.npz [--device cuda] [--no-fsync]

``BATCHES.npz`` holds ``rows`` (n, m, 3) int64 and ``kinds`` (n,) with 0 for
``insert_triples`` and 1 for ``delete_triples``. The process prints
``opened <seconds>`` once the tier is recovered, then ``acked <i>`` (flushed)
after write ``i`` returns, and ``done`` at the end. A parent that sends it
``SIGKILL`` mid-stream and then opens the directory must find every
acknowledged batch applied, the batch in flight wholly applied or wholly
absent, and none after it: the write-ahead contract under a real kill.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--device", default=None, help="the tier's device (default CUDA)")
    ap.add_argument("--no-fsync", dest="fsync", action="store_false")
    args = ap.parse_args(argv)

    from repro_torch.persist.service import DurableShardedService

    data = np.load(args.batches)
    rows, kinds = data["rows"], data["kinds"]
    t0 = time.perf_counter()
    svc = DurableShardedService.open(args.root, fsync=args.fsync, rebalance_skew=None,
                                     device=args.device)
    print(f"opened {time.perf_counter() - t0:.3f}", flush=True)
    for i, (batch, kind) in enumerate(zip(rows, kinds)):
        if kind == 0:
            svc.insert_triples(batch)
        else:
            svc.delete_triples(batch)
        print(f"acked {i}", flush=True)
    svc.close()
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
