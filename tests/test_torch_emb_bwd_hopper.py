"""The one-pass ``embedding_bag_backward`` kernel's plain twins, on the CPU.

The kernel finds the runs of equal sorted ids itself: each chunk of sorted
positions counts its run heads, and a scan over the chunks (decoupled
look-back on the card) gives each chunk its first slot and the chunk where a
run that continues into it began. ``ref.bag_chunk_scan_ref`` is that scan;
it must give ``bag_runs``' slots and n_unique on every input. The sums keep
the two-pass kernels' order of additions (each run's piece in a chunk from
zero in sorted order, a cut run's pieces added in chunk order), which
``ref.embedding_bag_backward_split_ref`` reproduces; it is held bit for bit
against a loop over positions written out here, within the card's
``EMB_BWD_TOL`` (rtol 1e-5, atol 1e-5 x max|want|: float32 sums in another
order) of the plain twin, and within the same of ``jax.vjp`` of the
reference's ``embedding_bag_ref`` (as ``test_torch_dlrm_train.py`` holds the
plain twin, whose small sums allow 1e-6 absolute; here a skewed row sums
2,400 terms, in another order than XLA's scatter). The CUDA wrappers refuse
what the kernel does not take before any launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import embedding_bag as eb
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

EMB_BWD_TOL = dict(rtol=1e-5, scaled=1e-5)
EBB_DONE = 2**40  # the kernel's count of a cut run once all its chunks are in


def _close(got, want, rtol, scaled):
    lim = scaled * float(want.abs().max()) + rtol * want.abs()
    return bool(((got - want).abs() <= lim).all())


def _ids(case: str, rng, chunk: int) -> torch.Tensor:
    """Flattened (B, L) ids of a named case."""
    if case == "skewed":  # Criteo's small tables: most ids on a few rows
        idx = rng.choice([0, 1, 2, 3, 5, 40, 977], size=(3000, 2), p=[.4, .25, .15, .1, .05, .03, .02])
    elif case == "padded":
        idx = rng.integers(0, 50, (700, 3))
        idx[rng.random(idx.shape) < 0.4] = -1
        idx[:5] = -1
    elif case == "all_padding":
        idx = np.full((300, 2), -1)
    elif case == "one_id_long":  # one id over more than 1,000 chunks
        idx = np.full((1001 * chunk + 77, 1), 6)
        idx[rng.random(idx.shape) < 0.01] = 2
        idx[rng.random(idx.shape) < 0.01] = 9
    else:  # uniform
        idx = rng.integers(0, 100_000, (2000, 4))
    return torch.from_numpy(idx)


CASES = ["skewed", "padded", "all_padding", "one_id_long", "uniform"]


@pytest.mark.parametrize("chunk", [32, 64, 256])
@pytest.mark.parametrize("case", CASES)
def test_chunk_scan_gives_bag_runs_slots(case, chunk):
    """Per-chunk head counts and first slots give every sorted position
    ``bag_runs``' slot, and their total its n_unique."""
    idx = _ids(case, np.random.default_rng(len(case) + chunk), chunk)
    ids, _, slot, n_unique = ref.bag_runs(idx)
    heads, first_slot, run_chunk, n_scan = ref.bag_chunk_scan_ref(ids, chunk)
    n_chunks = -(-ids.numel() // chunk)
    assert heads.shape == first_slot.shape == run_chunk.shape == (n_chunks,)
    assert int(n_scan) == int(n_unique) == int(heads.sum())
    assert torch.equal(ref.bag_chunk_slots_ref(ids, chunk), slot)
    starts = torch.arange(n_chunks) * chunk
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    head = ((ids >= 0) & (ids != prev)).long()
    assert torch.equal(first_slot, slot[starts] + 1 - head[starts])
    if case == "one_id_long":
        assert n_chunks > 1000


@pytest.mark.parametrize("chunk", [32, 256])
@pytest.mark.parametrize("case", CASES)
def test_chunk_scan_finds_where_a_cut_run_began(case, chunk):
    """For a chunk whose first id continues the run before it, the scan's
    run_chunk is the chunk that holds that run's head."""
    idx = _ids(case, np.random.default_rng(7 * chunk + len(case)), chunk)
    ids, _, _, _ = ref.bag_runs(idx)
    _, _, run_chunk, _ = ref.bag_chunk_scan_ref(ids, chunk)
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    head_pos = torch.where((ids >= 0) & (ids != prev), torch.arange(ids.numel()), -1)
    last_head = head_pos.cummax(0).values  # each position's run's head
    starts = torch.arange(0, ids.numel(), chunk)
    cont = (ids[starts] >= 0) & (prev[starts] == ids[starts])
    assert torch.equal(run_chunk[cont], last_head[starts[cont]] // chunk)
    if case == "one_id_long":
        assert int(cont.sum()) > 900


def _pieces_loop(indices, grad_out, combiner, chunk):
    """The kernels' order of additions as a loop over sorted positions:
    each run's piece in a chunk summed from zero in order, a cut run's
    pieces added in chunk order at the end."""
    n, d = indices.numel(), grad_out.shape[1]
    ids, perm, slot, n_unique = ref.bag_runs(indices)
    bag = perm // max(indices.shape[1], 1)
    g = grad_out.float()[bag]
    if combiner == "mean":
        g = g / (indices >= 0).sum(dim=1).clamp(min=1).float()[bag, None]
    grads = torch.zeros((n, d))
    ids_l, slot_l = ids.tolist(), slot.tolist()
    cut = {}  # slot -> its pieces in chunk order
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        seg = acc = None
        for q in range(c0, c1):
            if ids_l[q] < 0:
                continue
            if seg is None:
                seg, acc = q, torch.zeros(d)
            acc = acc + g[q]
            if q + 1 < c1 and ids_l[q + 1] == ids_l[q]:
                continue
            s = slot_l[seg]
            begun_before = seg == c0 and c0 > 0 and ids_l[c0 - 1] == ids_l[c0]
            goes_on = q + 1 == c1 and c1 < n and ids_l[c1] == ids_l[q]
            if begun_before or goes_on:
                cut.setdefault(s, []).append(acc)
            else:
                grads[s] = acc
            seg = None
    for s, pieces in cut.items():
        total = pieces[0]
        for p in pieces[1:]:
            total = total + p
        grads[s] = total
    return grads, int(n_unique)


@pytest.mark.parametrize("chunk", [1, 5, 32, 256])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_twin_is_the_kernels_order_of_additions(chunk, combiner, dtype):
    rng = np.random.default_rng(chunk + len(combiner) + len(dtype))
    idx = rng.integers(0, 6, (150, 3))
    idx[rng.random(idx.shape) < 0.2] = -1
    idx[:, 0] = 4  # a run of 150+ entries, cut by every chunk size
    g = torch.from_numpy(rng.normal(size=(150, 5)).astype(np.float32)).to(getattr(torch, dtype))
    want, n = _pieces_loop(torch.from_numpy(idx), g, combiner, chunk)
    rows, grads, n_unique = ref.embedding_bag_backward_split_ref(torch.from_numpy(idx), g,
                                                                 combiner, chunk)
    assert int(n_unique) == n
    assert torch.equal(grads[:n], want[:n])


@pytest.mark.parametrize("chunk", [32, 128, 256, 512])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("case", ["skewed", "padded", "one_id_long"])
def test_split_twin_within_tolerance_of_the_plain_twin(case, combiner, chunk):
    rng = np.random.default_rng(3 * chunk + len(case))
    idx = _ids(case, rng, 32)
    idx = idx.reshape(-1, 2) if idx.numel() % 2 == 0 else idx
    g = torch.from_numpy(rng.normal(size=(idx.shape[0], 16)).astype(np.float32)).bfloat16()
    r1, g1, n1 = ref.embedding_bag_backward_ref(idx, g, combiner)
    r2, g2, n2 = ref.embedding_bag_backward_split_ref(idx, g, combiner, chunk)
    n = int(n1)
    assert int(n2) == n and torch.equal(r1[:n], r2[:n])
    assert _close(g2[:n], g1[:n], **EMB_BWD_TOL)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("case", ["skewed", "padded"])
def test_split_twin_matches_jax_vjp(case, combiner):
    """The kernels' order of additions, scattered to dense, against the vjp
    of the reference's ``embedding_bag_ref`` on a float32 table."""
    rng = np.random.default_rng(len(case) * 5 + len(combiner))
    idx = _ids(case, rng, 32).numpy()
    n_rows, d = int(idx.max()) + 1 if (idx >= 0).any() else 1, 8
    table = rng.normal(size=(n_rows, d)).astype(np.float32)
    ct = rng.normal(size=(idx.shape[0], d)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jref.embedding_bag_ref(t, jnp.asarray(idx), combiner),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(ct))
    rows, grads, n_unique = ref.embedding_bag_backward_split_ref(
        torch.from_numpy(idx), torch.from_numpy(ct), combiner, 32)
    n = int(n_unique)
    dense = np.zeros((n_rows, d), np.float32)
    dense[rows[:n].numpy()] = grads[:n].numpy()
    assert _close(torch.from_numpy(dense), torch.from_numpy(np.array(want)), **EMB_BWD_TOL)


@pytest.mark.parametrize("ks,ke", [(0, 1), (0, 2), (3, 4), (5, 40), (0, 1100)])
def test_cut_run_counts_reach_done_only_with_the_last_chunk(ks, ke):
    """The kernel's arrivals at a cut run's count (the beginning chunk adds
    EBB_DONE + ks + 1, each later chunk 1, the ending chunk -(ke + 1) more),
    in any order: the sum, mod 2^64, equals EBB_DONE after the last arrival
    and at no arrival before it."""
    adds = {ks: EBB_DONE + ks + 1, **{j: 1 for j in range(ks + 1, ke)}, ke: -ke}
    rng = np.random.default_rng(ks + ke)
    for _ in range(20):
        order = rng.permutation(list(adds))
        total = 0
        for i, j in enumerate(order):
            total = (total + adds[int(j)]) % 2**64
            assert (total == EBB_DONE) == (i == len(order) - 1)


@pytest.mark.parametrize("chunk,ring,ok", [
    (256, 32, True), (32, 16, True), (1024, 64, True), (512, 64, True),
    (0, 32, False), (48, 32, False), (4096, 64, False), (1056, 32, False), (8192, 32, False),
    (256, 30, False), (256, 0, False),
    (256, 128, False), (256, 8, False)])
def test_backward_plan_checks(chunk, ring, ok):
    if ok:
        plan = eb.BackwardPlan(chunk, ring)
        assert plan.stage_rows * eb.BACKWARD_STAGES == ring
    else:
        with pytest.raises(ValueError):
            eb.BackwardPlan(chunk, ring)


SMEM_A_BLOCK = 227 * 1024  # the most shared memory a block may have on sm_90


def _block_bytes(chunk, ring, id_bytes, slab_bytes):
    """The one-pass kernel's shared bytes a block (ebb_block_bytes): for each
    of its 4 warps a barrier a stage, two chunks' perm and ids, the ring's
    denominators and rows."""
    r16 = lambda b: -(-b // 16) * 16  # noqa: E731
    rs = ring // eb.BACKWARD_STAGES
    return 4 * (8 * eb.BACKWARD_STAGES + 16 * chunk + r16(2 * chunk * id_bytes)
                + r16(4 * eb.BACKWARD_STAGES * rs) + eb.BACKWARD_STAGES * rs * slab_bytes)


# (ring, slab bytes) of each instance: float32 in 16-byte and scalar pieces,
# bfloat16 in 16-byte, 8-byte and scalar pieces, bfloat16 16-byte at 16 and 64
BACKWARD_INSTANCES = [(32, 512), (32, 128), (32, 256), (32, 256), (32, 64), (16, 256), (64, 256)]


@pytest.mark.parametrize("id_bytes", [4, 8])
def test_the_largest_chunk_fits_every_instance(id_bytes):
    """BACKWARD_MAX_CHUNK mirrors the source's EBB_MAX_CHUNK, and every
    instance's block fits the card's shared memory at that chunk, so a plan
    the wrapper accepts is one the card can launch; twice that chunk would
    not fit the largest instance."""
    from pathlib import Path

    src = (Path(eb.__file__).parent.parent / "csrc" / "embedding_bag.cu").read_text()
    assert f"constexpr int EBB_MAX_CHUNK = {eb.BACKWARD_MAX_CHUNK};" in src
    assert f"constexpr int EBB_STAGES = {eb.BACKWARD_STAGES};" in src
    top = eb.BACKWARD_MAX_CHUNK
    for ring, slab in BACKWARD_INSTANCES:
        assert _block_bytes(top, ring, id_bytes, slab) <= SMEM_A_BLOCK
    assert _block_bytes(2 * top, 32, 8, 512) > SMEM_A_BLOCK


def test_backward_path_by_width_type_and_alignment():
    f32 = torch.zeros((4, 128))
    bf = torch.zeros((4, 128), dtype=torch.bfloat16)
    assert eb.backward_path(f32) == eb.backward_path(bf) == "16-byte"
    assert eb.backward_path(torch.zeros((4, 12), dtype=torch.bfloat16)) == "8-byte"
    assert eb.backward_path(torch.zeros((4, 12))) == "16-byte"
    assert eb.backward_path(torch.zeros((4, 5))) == "scalar"
    buf = torch.zeros(4 * 128 + 8, dtype=torch.bfloat16)
    assert eb.backward_path(buf[1:1 + 512].view(4, 128)) == "scalar"
    assert eb.backward_path(buf[4:4 + 512].view(4, 128)) == "8-byte"
    buf = torch.zeros(4 * 128 + 8)
    assert eb.backward_path(buf[1:1 + 512].view(4, 128)) == "scalar"


def _sorted_args():
    ids, perm = torch.sort(torch.tensor([3, 1, -1, 3, 2, 1], dtype=torch.int32))
    return ids, perm, torch.zeros((6, 8)), 1


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA device"),
    ("ids 2-D", ValueError, r"ids \(n,\)"),
    ("ids int16", ValueError, r"ids \(n,\)"),
    ("perm int32", ValueError, r"perm \(n,\) int64"),
    ("perm length", ValueError, r"perm \(n,\) int64"),
    ("grad rows", ValueError, "B \\* bag_len == n"),
    ("grad float64", ValueError, "float32 or"),
    ("bag_len", ValueError, "B \\* bag_len == n"),
    ("plan", ValueError, "multiple of 32"),
    ("two-pass plan", ValueError, "takes no plan"),
])
def test_one_pass_wrappers_refuse(case, exc, match):
    """The one-pass route's wrappers raise on what the kernel does not take,
    before any launch; a CPU tensor is refused, never sent to a twin."""
    ids, perm, g, bag_len = _sorted_args()
    calls = {
        "cpu": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm, g, bag_len),
        "ids 2-D": lambda: eb.embedding_bag_backward_sorted_cuda(ids[None], perm, g, bag_len),
        "ids int16": lambda: eb.embedding_bag_backward_sorted_cuda(ids.short(), perm, g, bag_len),
        "perm int32": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm.int(), g, bag_len),
        "perm length": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm[:5], g, bag_len),
        "grad rows": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm, g[:5], bag_len),
        "grad float64": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm, g.double(),
                                                                      bag_len),
        "bag_len": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm, g, 2),
        "plan": lambda: eb.embedding_bag_backward_sorted_cuda(ids, perm, g, bag_len,
                                                              plan=eb.BackwardPlan(40)),
        "two-pass plan": lambda: eb.embedding_bag_backward_cuda(
            torch.zeros((6, 1), dtype=torch.int32), g, plan=eb.BackwardPlan(), two_pass=True),
    }
    with pytest.raises(exc, match=match):
        calls[case]()
