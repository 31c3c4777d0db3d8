"""``sgd_rows``' launch plan and the host memory of the master, on the CPU.

The kernel cannot run here. ``walk`` below follows its loop over the
grid that ``sgd_rows_plan`` gives the wrapper; these tests hold that grid
to covering every slot below n_unique exactly once and none past it, over
random plans, and ``SgdPlan.strides`` to the walk's longest warp. The host
readings of ``launch/host_probe.py`` are read from files written here.
"""
import mmap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as eb
from repro_torch.launch import host_probe
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def walk(plan: eb.SgdPlan, cap: int, n_unique: int) -> list:
    """The slots each warp of ``plan``'s grid updates, in its order, as
    ``sgd_rows_kernel`` walks them (warp w: groups w, w + warps, ... of R
    consecutive slots below min(n_unique, cap)): a list of lists, one a
    warp."""
    n, r = min(n_unique, cap), plan.rows_per_warp
    warps = plan.blocks * (eb.SGD_THREADS // 32)
    return [[s for g in range(w, -(-n // r), warps) for s in range(g * r, min(g * r + r, n))]
            for w in range(warps)]


@pytest.mark.parametrize("seed", range(24))
def test_the_walk_covers_each_live_slot_once(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 5000))
    n_unique = int(rng.choice([0, 1, cap, cap + 7, rng.integers(0, cap + 1)]))
    r = int(rng.choice(eb.SGD_ROWS_PER_WARP))
    blocks = None if seed % 4 == 0 else int(rng.integers(1, 140 * 8))
    plan = eb.sgd_rows_plan(cap, r, blocks)
    warps = walk(plan, cap, n_unique)
    assert len(warps) == plan.blocks * eb.SGD_THREADS // 32
    slots = sorted(s for w in warps for s in w)
    assert slots == list(range(min(n_unique, cap)))
    for w in warps:  # a warp's groups: R consecutive slots each, in order
        assert w == sorted(w)
    longest = max(-(-len(w) // r) for w in warps)
    assert plan.strides(min(n_unique, cap)) == longest
    if blocks is None:  # a warp for every group: none strides
        assert longest <= 1


@pytest.mark.parametrize("cap,r,blocks,want", [
    (1_703_936, 1, None, 212_992),  # one warp a slot: the launch before the redesign
    (1_703_936, 4, None, 53_248),   # the default
    (1_703_936, 4, 528, 528),       # persistent: 4 blocks on each of 132 SMs
    (1_703_936, 8, 1056, 1056),
    (100, 4, 528, 4),               # no more blocks than groups need
    (1, 8, 528, 1),
    (1, 8, 0, 1),
])
def test_plan_grid(cap, r, blocks, want):
    assert eb.sgd_rows_plan(cap, r, blocks).blocks == want


def test_the_wrappers_plan_is_four_rows_a_warp_on_a_resident_grid():
    """``sgd_rows_cuda`` launches SGD_R rows a warp on SGD_BLOCKS_AN_SM[SGD_R]
    blocks on each SM; at a train_batch step's 622,363 rows on 132 SMs each
    warp takes at most 37 groups. Without ``blocks`` a plan covers every
    slot."""
    assert eb.SGD_R == 4 and eb.SGD_BLOCKS_AN_SM[eb.SGD_R] == 4
    plan = eb.sgd_rows_plan(1_703_936, eb.SGD_R, 132 * eb.SGD_BLOCKS_AN_SM[eb.SGD_R])
    assert plan == eb.SgdPlan(4, 528, "update") and plan.strides(622_363) == 37
    assert eb.sgd_rows_plan(1_703_936) == eb.SgdPlan(4, 53_248, "update")


def test_the_plan_constants_are_the_sources():
    """SGD_R and SGD_BLOCKS_AN_SM mirror csrc/embedding_bag.cu's SGD_R and
    sgd_blocks_an_sm (its launch bounds), which the grid relies on being
    resident at once."""
    src = (Path(eb.__file__).parent.parent / "csrc" / "embedding_bag.cu").read_text()
    assert f"constexpr int SGD_R = {eb.SGD_R};" in src
    b = eb.SGD_BLOCKS_AN_SM
    assert f"return R == 1 ? {b[1]} : R == 2 ? {b[2]} : R == 4 ? {b[4]} : {b[8]};" in src
    assert set(b) == set(eb.SGD_ROWS_PER_WARP)


@pytest.mark.parametrize("r,want", [(1, 663), (2, 332), (4, 166), (8, 83)])
def test_strides_of_the_large_chip_case(r, want):
    """The persistent grids of chip_smoke's 700,000-slot case on 132 SMs."""
    plan = eb.sgd_rows_plan(800_000, r, 132)
    assert plan.blocks == 132 and plan.strides(700_000) == want
    assert eb.sgd_rows_plan(800_000, r).strides(700_000) == 1


def test_plan_refuses_what_the_source_has_no_instance_of():
    with pytest.raises(ValueError, match="rows_per_warp"):
        eb.sgd_rows_plan(100, 3)
    with pytest.raises(ValueError, match="mode"):
        eb.sgd_rows_plan(100, 4, 528, "scatter")


@pytest.mark.parametrize("backing", eb.BACKINGS)
@pytest.mark.parametrize("shape", [(1000, 128), (3, 5), (0, 128)])
def test_host_empty_gives_a_writable_contiguous_float32_tensor(backing, shape):
    t = eb.host_empty(shape, backing)
    assert t.shape == shape and t.dtype == torch.float32 and t.is_contiguous()
    if t.numel() and backing == "huge":
        assert t.data_ptr() % eb.HUGE_PAGE == 0
    t.fill_(3.0)
    assert float(t.sum()) == 3.0 * t.numel()
    with pytest.raises(ValueError, match="backing"):
        eb.host_empty(shape, "hugetlbfs")


def test_host_empty_keeps_its_mapping_alive():
    t = eb.host_empty((2048, 128))[5:9]
    import gc
    gc.collect()
    t.fill_(1.0)
    assert float(t.sum()) == 4 * 128
    assert hasattr(mmap, "MADV_HUGEPAGE")


def test_host_readings_from_sysfs_files(tmp_path):
    thp = tmp_path / "thp"
    thp.mkdir()
    (thp / "enabled").write_text("always [madvise] never\n")
    (thp / "defrag").write_text("always defer defer+madvise [madvise] never\n")
    assert host_probe.thp_mode(str(thp)) == {"enabled": "madvise", "defrag": "madvise"}
    pci = tmp_path / "pci" / "0000:18:00.0"
    pci.mkdir(parents=True)
    (pci / "numa_node").write_text("1\n")
    (pci / "current_link_speed").write_text("32.0 GT/s PCIe\n")
    (pci / "current_link_width").write_text("16\n")
    assert host_probe.sysfs_bus_id("00000000:18:00.0") == "0000:18:00.0"
    assert host_probe.sysfs_bus_id("[N/A]") is None
    assert host_probe.card_numa_node("0000:18:00.0", str(tmp_path / "pci")) == 1
    assert host_probe.card_numa_node(None, str(tmp_path / "pci")) is None
    assert host_probe.pcie_sysfs(None) is None
    assert host_probe.pcie_sysfs("0000:18:00.0", str(tmp_path / "pci")) == {
        "current_link_speed": "32.0 GT/s PCIe", "current_link_width": "16"}
    iommu = tmp_path / "iommu"
    iommu.mkdir()
    assert host_probe.iommu(str(iommu)) == []
    (iommu / "dmar0").mkdir()
    assert host_probe.iommu(str(iommu)) == ["dmar0"]
    (tmp_path / "rollup").write_text("Rss:  100 kB\nAnonHugePages:  4096 kB\n")
    assert host_probe.anon_huge_pages(str(tmp_path / "rollup")) == 4096 * 1024


def test_pages_reads_the_mappings_that_hold_a_tensor(tmp_path):
    t = torch.zeros(1 << 20)  # 4 MiB
    lo = t.data_ptr() - 4096
    hi = lo + (8 << 20)
    smaps = (f"1000-2000 rw-p 00000000 00:00 0\nSize: 4 kB\nAnonHugePages: 0 kB\n"
             f"{lo:x}-{hi:x} rw-p 00000000 00:00 0\nSize: 8192 kB\n"
             f"AnonHugePages:   2048 kB\nVmFlags: rd wr hg\n")
    numa = (f"1000 default anon=1 N0=1 kernelpagesize_kB=4\n"
            f"{lo:x} default anon=1025 dirty=1025 N0=1000 N1=25 kernelpagesize_kB=4\n")
    (tmp_path / "smaps").write_text(smaps)
    (tmp_path / "numa").write_text(numa)
    got = host_probe.pages(t, str(tmp_path / "smaps"), str(tmp_path / "numa"))
    assert got == {"bytes": 4 << 20, "address": t.data_ptr(), "huge_bytes": 2 << 20,
                   "huge_share": 0.5,
                   "numa_bytes": {0: 1000 * 4096, 1: 25 * 4096}}
