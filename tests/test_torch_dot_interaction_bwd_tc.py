"""The tensor-core ``dot_interaction_backward`` kernel's arithmetic, on the CPU.

The kernel itself runs only on a GPU (``chip_smoke.py`` holds it against
both twins there). Here the pieces it is built from are pinned in Python:
the exact split of S = G + Gᵀ into three bfloat16 terms
(``ref.bf16_split``), the tiling twin (``ref.dot_interaction_backward_tc_ref``:
F padded to 16-row tiles, the three terms' products summed in float32 one
k-step at a time, one rounding) against the plain twin and ``jax.vjp`` of
the reference's ``_interact``, the inputs on which only an exact split is
right (``ref.split_decisive_case``), and the launch plan
(``kernels.dot_interaction.tc_backward_plan``) and dispatch.

Tolerances: the tiling twin against the plain twin as ``chip_smoke.py``'s
``DOT_BWD_TOL`` holds the kernel: |got - want| <= 1e-5 max|want| + rtol
|want|, rtol 2^-7 in bfloat16 (the float32 sums differ in order, then
each is rounded once to bfloat16, so the two can straddle one rounding)
and 1e-5 in float32 on bfloat16-valued inputs. Against ``_interact``'s vjp
as ``tests/test_torch_dlrm_train.py``'s bf16 test: 2^-6 (|G X| + |Gᵀ X|) +
1e-6 (JAX rounds G X and Gᵀ X to bfloat16 and adds them in bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.dlrm import _interact
from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import (SMEM_CAP, TC_SAMPLES, backward_uses_tensor_cores,
                                                 tc_backward_plan, tc_backward_smem)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_SM = 132  # an H100's SMs
TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}  # (rtol, x max|want|)


def _close(got, want, dtype) -> bool:
    rtol, scaled = TOL[dtype]
    want = want.float()
    lim = scaled * float(want.abs().max()) + rtol * want.abs()
    return bool(((got.float() - want).abs() <= lim).all())


def _inputs(seed, b, f, d, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)).to(dtype)
    dz = torch.from_numpy(rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32))
    return x, dz


# ---------------------------------------------------------------- the split
def _values(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        v = rng.normal(size=20_000)
    elif kind == "wide":  # every binade from 2^-100 to 2^100, both signs
        v = rng.normal(size=20_000) * np.exp2(rng.integers(-100, 101, 20_000))
    elif kind == "full_significand":  # 24 significant bits each
        v = (1 + rng.integers(0, 2 ** 23, 20_000) / 2 ** 23) * np.exp2(
            rng.integers(-30, 31, 20_000)) * rng.choice([-1, 1], 20_000)
    elif kind == "powers_of_two":
        v = np.exp2(np.arange(-120, 121)) * rng.choice([-1, 1], 241)
    else:  # zeros
        v = np.array([0.0, -0.0] * 8)
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide", "full_significand", "powers_of_two",
                                  "zeros"])
def test_split_is_exact(kind):
    v = _values(kind)
    hi, mid, lo = ref.bf16_split(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    assert torch.equal(hi, v.to(torch.bfloat16))  # hi is v rounded to nearest
    # each term lies below half of the last bit of the one before it
    assert (mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all()
    assert (lo.double().abs() <= mid.double().abs() * 2.0 ** -8).all()
    if kind in ("powers_of_two", "zeros"):
        assert not mid.float().any() and not lo.float().any()


def test_split_keeps_non_finite_values_in_hi():
    v = torch.tensor([float("inf"), -float("inf"), float("nan"), 3.4e38])
    hi, mid, lo = ref.bf16_split(v)
    assert torch.isinf(hi[:2]).all() and torch.isnan(hi[2])
    assert not mid.float().any() and not lo.float().any()
    assert torch.isinf(hi[3])  # above bfloat16's largest value: rounds to inf


# ---------------------------------------------------------------- the tiling twin
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 5, 129])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("f", [27, 13, 2])
def test_tc_twin_matches_plain_twin(f, d, b, dtype):
    x, dz = _inputs(f * 1000 + d + b, b, f, d)
    x = x.to(dtype)  # bfloat16 values either way
    got = ref.dot_interaction_backward_tc_ref(x, dz)
    want = ref.dot_interaction_backward_ref(x, dz)
    assert got.dtype == dtype and got.shape == x.shape
    assert _close(got, want, dtype)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("f", [27, 13, 2])
def test_tc_twin_matches_interact_vjp(f, d):
    """DLRM's ``_interact`` on bfloat16 fields: the reference's cotangent
    is bfloat16, and so is the twin's."""
    rng = np.random.default_rng(f + d)
    b = 8
    x = jnp.asarray(rng.normal(size=(b, f, d)).astype(np.float32)).astype(jnp.bfloat16)
    dz = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    _, vjp = jax.vjp(_interact, x)
    (want,) = vjp(jnp.asarray(dz))
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = ref.dot_interaction_backward_tc_ref(xt, torch.from_numpy(dz))
    assert got.dtype == torch.bfloat16
    g = np.zeros((b, f, f))
    ii, jj = np.tril_indices(f, -1)
    g[:, ii, jj] = dz
    xf = np.asarray(x.astype(jnp.float32), dtype=np.float64)
    scale = np.abs(g @ xf) + np.abs(g.transpose(0, 2, 1) @ xf)
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (err <= 2.0 ** -6 * scale + 1e-6).all(), float((err - 2.0 ** -6 * scale).max())


def test_tc_twin_pads_the_last_k_step_with_zeros_not_the_next_sample():
    """A non-finite field of one sample stays out of every other sample's
    gradient (the kernel masks the rows past F that its tile reads)."""
    x, dz = _inputs(11, 3, 27, 16)
    x[1, 0, 0] = float("inf")
    got = ref.dot_interaction_backward_tc_ref(x, dz)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()
    assert not torch.isfinite(got[1]).all()


# ---------------------------------------------------------------- the decisive case
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("f", [27, 13, 3])
def test_lo_decides_the_split_decisive_case(f, d):
    """On ``split_decisive_case`` the exact split gives the plain twin's dX
    bit for bit, and the split without lo gives 0 where dX is not, so the
    check that holds the kernel rejects it."""
    x, dz = ref.split_decisive_case(64, f, d, torch.Generator().manual_seed(f * d))
    want = ref.dot_interaction_backward_ref(x, dz)
    exact = ref.dot_interaction_backward_tc_ref(x, dz)
    no_lo = ref.dot_interaction_backward_tc_ref(x, dz, terms=2)
    assert torch.equal(exact, want) and _close(exact, want, torch.bfloat16)
    assert not _close(no_lo, want, torch.bfloat16)
    assert (want.float().abs().amax(dim=(1, 2)) > 0).all()  # every sample has a gradient
    assert not no_lo.float().any()
    # the two entries of each sample: a splits with lo = 0, -(a + δ) into the
    # same hi and mid with lo = -δ
    nz = dz != 0
    assert (nz.sum(dim=1) == 2).all()
    vals = dz[nz].view(-1, 2)
    h0, m0, l0 = ref.bf16_split(vals[:, 0])
    h1, m1, l1 = ref.bf16_split(-vals[:, 1])
    assert torch.equal(h0, h1) and torch.equal(m0, m1)
    assert ((l0.float() == 0) ^ (l1.float() == 0)).all()


# ---------------------------------------------------------------- the launch plan
def _walk(plan, b):
    """(block, first sample, samples) of every group, as the kernel's
    persistent blocks take them: block k groups k, k + blocks, ..."""
    for block in range(plan.blocks):
        for g in range(block, plan.groups, plan.blocks):
            s0 = g * plan.samples
            yield block, s0, min(plan.samples, b - s0)


@pytest.mark.parametrize("b", [0, 1, 5, 511, 512, 513, 65_536])
def test_backward_plan_covers_every_sample_once(b):
    plan = tc_backward_plan(b, 27, 128, N_SM)
    seen = np.zeros(b, dtype=np.int64)
    for block, s0, n in _walk(plan, b):
        assert 0 <= block < plan.blocks and 1 <= n <= plan.samples
        seen[s0:s0 + n] += 1
    assert (seen == 1).all()
    assert plan.smem <= SMEM_CAP and plan.blocks <= plan.groups
    assert plan.threads == 32 * plan.samples


@pytest.mark.parametrize("f,d", [(2, 16), (13, 16), (27, 16), (27, 128), (27, 512), (64, 128),
                                 (70, 16), (100, 256), (4, 4096)])
@pytest.mark.parametrize("b", [1, 512, 65_536])
def test_backward_plan_fits_shared_memory(f, d, b):
    plan = tc_backward_plan(b, f, d, N_SM)
    assert plan.smem == tc_backward_smem(f, d, plan.samples, plan.stages) <= SMEM_CAP
    assert 1 <= plan.samples <= TC_SAMPLES and 1 <= plan.stages <= 3


@pytest.mark.parametrize("f,d", [(27, 8192), (400, 16)])
def test_backward_plan_refuses_a_sample_that_does_not_fit(f, d):
    with pytest.raises(ValueError, match="shared memory"):
        tc_backward_plan(8, f, d, N_SM)


def test_backward_smem_is_rows_and_dz_a_slot():
    """A slot: 8 samples of 27 rows and 5 tail rows of 272 bytes, then 8 x
    351 floats of dz and a lead of up to 3, in 16-byte units."""
    assert tc_backward_smem(27, 128, 8, 1) == (8 * 27 + 5) * 272 + (8 * 351 + 6) // 4 * 16
    assert tc_backward_smem(27, 128, 8, 3) == 3 * tc_backward_smem(27, 128, 8, 1)


def test_backward_plan_at_train_batch():
    """train_batch (B = 65,536): groups of 8 through a ring of 3, one block
    an SM, two groups (133 KB) in flight an SM."""
    plan = tc_backward_plan(65_536, 27, 128, N_SM)
    assert (plan.samples, plan.stages, plan.blocks, plan.threads) == (8, 3, N_SM, 256)
    in_flight = (plan.stages - 1) * plan.samples * (27 * 128 * 2 + 351 * 4)
    assert in_flight >= 100_000


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("dtype,d,tc", [(torch.bfloat16, 128, True), (torch.bfloat16, 16, True),
                                        (torch.bfloat16, 24, False), (torch.bfloat16, 0, False),
                                        (torch.float32, 128, False), (torch.float32, 16, False)])
def test_backward_dispatch(dtype, d, tc):
    x = torch.zeros((3, 27, d), dtype=dtype)
    assert backward_uses_tensor_cores(x, torch.zeros((3, 351))) is tc


@pytest.mark.parametrize("which", ["x", "dz"])
def test_misaligned_inputs_take_the_simt_backward(which):
    x, dz = torch.zeros((3, 27, 128), dtype=torch.bfloat16), torch.zeros((3, 351))
    if which == "x":
        x = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)[1:].view(3, 27, 128)
        assert x.data_ptr() % 16 == 2
    else:
        dz = torch.zeros(1 + dz.numel())[1:].view(3, 351)
        assert dz.data_ptr() % 16 == 4
    assert x.is_contiguous() and dz.is_contiguous()
    assert not backward_uses_tensor_cores(x, dz)
