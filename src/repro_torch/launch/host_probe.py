"""What the host offers DLRM training's float32 master rows: its memory,
its cgroup limit and the card's PCIe link, and whether a plain CPU
tensor of a given size can be registered with the card (pinned and
mapped, through the call DLRM training's master uses:
``kernels.embedding_bag.register_host``) and how long that takes.

    PYTHONPATH=src python3 src/repro_torch/launch/host_probe.py [--register-bytes N]

It prints one JSON line. With ``--register-bytes``, it registers only
when ``MemAvailable`` leaves 4 GiB beside the request and the cgroup
limit allows it, so the probe itself never drives the host out of
memory; then it times the registration, a copy from the card into the
registered memory and one back, and unregisters.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.embedding_bag import register_host, unregister_host

MARGIN = 4 << 30  # bytes left free beside a registration


def meminfo() -> dict:
    """``/proc/meminfo``'s MemTotal and MemAvailable, in bytes."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    return out


def cgroup_memory() -> dict:
    """The cgroup's memory limit and current use in bytes (v2, else v1);
    None where the file is absent or says ``max``."""
    def read(*paths):
        for p in paths:
            try:
                text = Path(p).read_text().strip()
            except OSError:
                continue
            return None if text == "max" else int(text)
        return None

    return {"limit": read("/sys/fs/cgroup/memory.max",
                          "/sys/fs/cgroup/memory/memory.limit_in_bytes"),
            "current": read("/sys/fs/cgroup/memory.current",
                            "/sys/fs/cgroup/memory/memory.usage_in_bytes")}


def rss_bytes() -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return 0


def smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader``, first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0] if out.strip() else ""


def host_report() -> dict:
    return {"meminfo": meminfo(), "cgroup": cgroup_memory(), "rss": rss_bytes(),
            "card": smi("name,power.limit"),
            "pcie": smi("pcie.link.gen.current,pcie.link.width.current,"
                        "pcie.link.gen.max,pcie.link.width.max")}


def try_register(nbytes: int) -> dict:
    """Register ``nbytes`` of a plain CPU tensor with the card, if the host
    leaves room for it; time that, a 4 GiB copy each way, the release."""
    mem, cg = meminfo(), cgroup_memory()
    room = mem["MemAvailable"] - MARGIN
    if cg["limit"] is not None:
        room = min(room, cg["limit"] - (cg["current"] or 0) - MARGIN)
    res = {"bytes": nbytes, "room": room}
    if nbytes > room:
        res["registered"] = False
        return res
    host = torch.empty(nbytes, dtype=torch.uint8)
    try:
        res["register_s"] = register_host(host)
        res["registered"] = True
    except RuntimeError as e:
        res["registered"] = False
        res["error"] = str(e)
    res["meminfo_after"] = meminfo()
    res["rss_after"] = rss_bytes()
    if res["registered"]:
        n = min(nbytes, 4 << 30)
        dev = torch.empty(n, dtype=torch.uint8, device="cuda")
        dev.fill_(1)
        for what, dst, src in (("d2h", host[:n], dev), ("h2d", dev, host[:n])):
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            res[f"{what}_GBps"] = n / (time.perf_counter() - t0) / 1e9
        del dev
        t0 = time.perf_counter()
        unregister_host(host)
        res["unregister_s"] = time.perf_counter() - t0
    del host
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--register-bytes", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_probe: no CUDA device visible")
    torch.cuda.init()
    out = host_report()
    if args.register_bytes:
        out["register"] = try_register(args.register_bytes)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
