"""What the host offers DLRM training's float32 master rows: its memory,
its cgroup limit and the card's PCIe link, the conditions that decide how
the card reaches host memory (the transparent-huge-page mode, the card's
NUMA node, an IOMMU), and whether a plain CPU tensor of a given size can
be registered with the card (pinned and mapped, through the call DLRM
training's master uses: ``kernels.embedding_bag.register_host``) and how
long that takes. :func:`pages` reads where a registered tensor's pages
ended up: the share on huge pages and the NUMA nodes they sit on.

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


def _read(path) -> str | None:
    try:
        return Path(path).read_text()
    except OSError:
        return None


def thp_mode(root: str = "/sys/kernel/mm/transparent_hugepage") -> dict | None:
    """The transparent-huge-page modes, e.g. {"enabled": "madvise", "defrag":
    "madvise"} (the bracketed word of each file); None where the host has
    no such directory."""
    out = {}
    for key in ("enabled", "defrag"):
        text = _read(Path(root, key))
        if text is not None and "[" in text:
            out[key] = text.split("[", 1)[1].split("]", 1)[0]
    return out or None


def sysfs_bus_id(bus_id: str) -> str | None:
    """nvidia-smi's PCI bus id ("00000000:18:00.0") as sysfs names the
    device ("0000:18:00.0"); None where it is no such id ("[N/A]")."""
    parts = bus_id.strip().lower().split(":")
    try:
        return f"{int(parts[0], 16):04x}:{parts[1]}:{parts[2]}" if len(parts) == 3 else None
    except ValueError:
        return None


def card_bus_id() -> str | None:
    """The first card's PCI address as sysfs names it: nvidia-smi's, else
    the CUDA device's own properties'; None where neither says."""
    got = sysfs_bus_id(smi("pci.bus_id"))
    props = torch.cuda.get_device_properties(0)
    if got is None and all(hasattr(props, k) for k in ("pci_domain_id", "pci_bus_id",
                                                       "pci_device_id")):
        got = f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
    return got


def card_numa_node(bus: str | None, root: str = "/sys/bus/pci/devices") -> int | None:
    """The NUMA node of the PCI device ``bus`` (sysfs' form); None where
    sysfs does not say (-1 there means no affinity)."""
    text = _read(Path(root, bus, "numa_node")) if bus else None
    return int(text) if text is not None and text.strip() else None


def pcie_sysfs(bus: str | None, root: str = "/sys/bus/pci/devices") -> dict | None:
    """The link's current and greatest speed and width as sysfs reads them
    for the PCI device ``bus``; None where absent."""
    if not bus:
        return None
    dev = Path(root, bus)
    out = {k: t.strip() for k in ("current_link_speed", "current_link_width",
                                  "max_link_speed", "max_link_width")
           if (t := _read(dev / k)) is not None}
    return out or None


def iommu(root: str = "/sys/class/iommu") -> list | None:
    """The IOMMUs the kernel registered (an empty list: none); None where
    sysfs has no such class."""
    path = Path(root)
    return sorted(p.name for p in path.iterdir()) if path.is_dir() else None


def anon_huge_pages(path: str = "/proc/self/smaps_rollup") -> int | None:
    """The process's anonymous memory on transparent huge pages, in bytes."""
    text = _read(path)
    if text is None:
        return None
    for line in text.splitlines():
        if line.startswith("AnonHugePages:"):
            return int(line.split()[1]) * 1024
    return None


def pages(t, smaps: str = "/proc/self/smaps", numa_maps: str = "/proc/self/numa_maps") -> dict:
    """Where the pages of the CPU tensor ``t`` lie, over the mappings that
    hold it: ``huge_bytes`` on transparent huge pages (smaps'
    AnonHugePages) and ``huge_share`` of ``t``'s bytes, and ``numa_bytes``,
    the bytes on each NUMA node (numa_maps' N<node>= pages), each None
    where its file is absent; ``address`` its first byte's."""
    start = t.data_ptr()
    nbytes = t.numel() * t.element_size()
    out = {"bytes": nbytes, "address": start, "huge_bytes": None, "huge_share": None,
           "numa_bytes": None}
    text = _read(smaps)
    if text is None:
        return out
    vmas, huge, inside = set(), 0, False
    for line in text.splitlines():
        head = line.split(maxsplit=1)[0] if line.strip() else ""
        if "-" in head and not head.endswith(":"):
            lo, hi = (int(x, 16) for x in head.split("-"))
            inside = lo < start + nbytes and start < hi
            if inside:
                vmas.add(lo)
        elif inside and head == "AnonHugePages:":
            huge += int(line.split()[1]) * 1024
    out["huge_bytes"] = huge
    out["huge_share"] = huge / nbytes if nbytes else None
    text = _read(numa_maps)
    if text is None:
        return out
    nodes: dict = {}
    for line in text.splitlines():
        fields = line.split()
        if not fields or int(fields[0], 16) not in vmas:
            continue
        kb = next((int(f.split("=")[1]) for f in fields if f.startswith("kernelpagesize_kB=")), 4)
        for f in fields[1:]:
            if f[0] == "N" and "=" in f and f[1:f.index("=")].isdigit():
                node = int(f[1:f.index("=")])
                nodes[node] = nodes.get(node, 0) + int(f.split("=")[1]) * kb * 1024
    out["numa_bytes"] = nodes
    return out


def host_report() -> dict:
    bus = card_bus_id()
    return {"meminfo": meminfo(), "cgroup": cgroup_memory(), "rss": rss_bytes(),
            "card": smi("name,power.limit"),
            "pcie": smi("pcie.link.gen.current,pcie.link.width.current,"
                        "pcie.link.gen.max,pcie.link.width.max"),
            "pcie_sysfs": pcie_sysfs(bus), "bus_id": bus, "card_numa_node": card_numa_node(bus),
            "thp": thp_mode(), "iommu": iommu(), "anon_huge_pages": anon_huge_pages(),
            "kernel": (_read("/proc/version") or "").strip() or None}


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
