"""The tensor-core ``dot_interaction`` kernel's arithmetic, on the CPU.

The kernel itself runs only on a GPU (``chip_smoke.py`` holds it against
both twins there). Here the pieces it is built from are pinned in Python:
its store map (``ref.tc_store_map``: which accumulator entry of which m16n8
tile goes to which output column), its tiling twin
(``ref.dot_interaction_tc_ref``: F padded to 16-row tiles, float32 sums one
16-wide k-step at a time, scattered through the map) against the plain twin
and the reference's ``_interact``, and its launch plan
(``kernels.dot_interaction.tc_plan``) and dispatch.

Tolerances: the tiling twin against the plain twin at rtol = atol = 1e-5,
in float32 on bfloat16-valued inputs (the products are exact; only the
order of the float32 sums differs). Against ``_interact`` as
``tests/test_torch_kernels_recsys.py``'s bf16 test: 1e-4, a sum of D
float32 products in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.dlrm import _interact
from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import (SMEM_CAP, TC_SAMPLES, tc_plan, tc_smem,
                                                 uses_tensor_cores)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_SM = 132  # an H100's SMs


def _bf16_valued(rng, shape) -> torch.Tensor:
    """float32 values that bfloat16 holds exactly."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float()


# ---------------------------------------------------------------- the store map
@pytest.mark.parametrize("f", range(2, 65))
def test_store_map_writes_each_output_once_from_below_the_diagonal(f):
    cols = ref.tc_store_map(f).numpy()
    mts = -(-f // 16)
    assert cols.shape == (mts, 2 * mts, 32, 4)
    # the m16n8 accumulator layout, written out again here
    mt, nt, lane, r = np.meshgrid(np.arange(mts), np.arange(2 * mts), np.arange(32),
                                  np.arange(4), indexing="ij")
    i = 16 * mt + lane // 4 + 8 * (r // 2)
    j = 8 * nt + 2 * (lane % 4) + r % 2
    kept = cols >= 0
    p = f * (f - 1) // 2
    assert np.array_equal(np.sort(cols[kept]), np.arange(p))  # each output exactly once
    assert (i[kept] < f).all() and (j[kept] < i[kept]).all()  # no pad row or column, no diagonal
    ii, jj = np.tril_indices(f, -1)
    assert np.array_equal(ii[cols[kept]], i[kept]) and np.array_equal(jj[cols[kept]], j[kept])
    # every entry j < i < F is kept, and only in a tile the kernel computes
    assert np.array_equal(kept, (j < i) & (i < f))
    computed = 8 * nt < np.minimum(16 * mt + 15, f - 1)
    assert not (kept & ~computed).any()


@pytest.mark.parametrize("f,tiles", [(2, 1), (16, 2), (17, 4), (27, 6), (32, 6), (33, 10),
                                     (64, 20)])
def test_computed_tiles(f, tiles):
    """Tiles the kernel computes: those with an entry below the diagonal
    (6 of 8 at DLRM's F = 27, 48 mma over D = 128)."""
    kept_tiles = (ref.tc_store_map(f) >= 0).any(dim=3).any(dim=2)
    mts = -(-f // 16)
    mt, nt = np.meshgrid(np.arange(mts), np.arange(2 * mts), indexing="ij")
    computed = 8 * nt < np.minimum(16 * mt + 15, f - 1)
    assert np.array_equal(kept_tiles.numpy(), computed)
    assert int(computed.sum()) == tiles


# ---------------------------------------------------------------- the tiling twin
@pytest.mark.parametrize("b", [1, 5, 513])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("f", [2, 17, 27, 32])
def test_tc_twin_matches_plain_twin(f, d, b):
    rng = np.random.default_rng(f * 1000 + d + b)
    x = _bf16_valued(rng, (b, f, d))
    got = ref.dot_interaction_tc_ref(x)
    want = ref.dot_interaction_ref(x)
    assert got.dtype == torch.float32 and got.shape == (b, f * (f - 1) // 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_tc_twin_pads_d_to_whole_k_steps():
    """D = 24 (not a k-step multiple, the SIMT kernel's case) zero-pads to 32."""
    x = _bf16_valued(np.random.default_rng(3), (7, 27, 24))
    torch.testing.assert_close(ref.dot_interaction_tc_ref(x), ref.dot_interaction_ref(x),
                               rtol=1e-5, atol=1e-5)


def test_tc_twin_matches_reference_interact():
    """DLRM's shape in bfloat16: the twin keeps float32, as `_interact` does
    (bf16 products are exact in float32, the sums differ only in order)."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(128, 27, 128)), jnp.bfloat16)
    t_x = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = ref.dot_interaction_tc_ref(t_x)
    want = np.asarray(_interact(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- the launch plan
def _walk(plan, b):
    """(block, first sample, samples) of every group, as the kernel's
    persistent blocks take them: block k groups k, k + blocks, ..."""
    for block in range(plan.blocks):
        for g in range(block, plan.groups, plan.blocks):
            s0 = g * plan.samples
            yield block, s0, min(plan.samples, b - s0)


@pytest.mark.parametrize("b", [0, 1, 5, 511, 512, 513, 262_144])
def test_plan_covers_every_sample_once(b):
    plan = tc_plan(b, 27, 128, N_SM)
    seen = np.zeros(b, dtype=np.int64)
    for block, s0, n in _walk(plan, b):
        assert 0 <= block < plan.blocks and 1 <= n <= plan.samples
        seen[s0:s0 + n] += 1
    assert (seen == 1).all()
    assert plan.smem <= SMEM_CAP and plan.blocks <= plan.groups
    assert plan.threads == 32 * plan.samples


@pytest.mark.parametrize("f,d", [(2, 16), (27, 16), (27, 128), (27, 512), (27, 1024),
                                 (27, 1792), (64, 128), (100, 256), (4, 4096)])
@pytest.mark.parametrize("b", [1, 512, 262_144])
def test_plan_fits_shared_memory(f, d, b):
    plan = tc_plan(b, f, d, N_SM)
    assert plan.smem == tc_smem(f, d, plan.samples, plan.stages) <= SMEM_CAP
    assert 1 <= plan.samples <= TC_SAMPLES and 1 <= plan.stages <= 3


def test_plan_refuses_a_sample_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tc_plan(8, 27, 8192, N_SM)


def test_plan_at_dlrm_shapes():
    """serve_bulk: groups of 8 through a ring of 3, one block an SM (110 KB
    in flight an SM); serve_p99's 512 samples still reach every SM."""
    bulk = tc_plan(262_144, 27, 128, N_SM)
    assert (bulk.samples, bulk.stages, bulk.blocks) == (8, 3, N_SM)
    in_flight = (bulk.stages - 1) * bulk.samples * 27 * 128 * 2  # bytes a block
    assert in_flight * bulk.blocks / N_SM >= 20_000
    p99 = tc_plan(512, 27, 128, N_SM)
    assert p99.blocks >= N_SM
    assert p99.samples * p99.groups >= 512


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("dtype,d,tc", [(torch.bfloat16, 128, True), (torch.bfloat16, 16, True),
                                        (torch.bfloat16, 24, False), (torch.bfloat16, 0, False),
                                        (torch.float32, 128, False)])
def test_tensor_core_dispatch(dtype, d, tc):
    x = torch.zeros((3, 27, d), dtype=dtype)
    assert uses_tensor_cores(x) is tc


def test_misaligned_bf16_takes_the_simt_kernel():
    flat = torch.zeros(1 + 3 * 27 * 128, dtype=torch.bfloat16)
    x = flat[1:].view(3, 27, 128)  # contiguous, 2 bytes past a 16-byte boundary
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert not uses_tensor_cores(x)
