"""The port's recsys kernel twins against the JAX package's, on the CPU.

``embedding_bag_ref`` and ``dot_interaction_ref`` of ``repro_torch.kernels``
are held against the reference's pure-jnp oracles (``repro.kernels.ref``)
and its Pallas kernels (``repro.kernels.ops``, interpret mode off-TPU), on
the sweeps of ``tests/test_kernels.py``, with inputs made by numpy from a
seed. The CUDA kernels themselves run only on a GPU (``chip_smoke.py``);
here the tests check that their wrappers refuse what they do not take.

Tolerances: float32 at rtol/atol 1e-5 (embedding bag) and 1e-4 (dot
interaction, a sum of D products in another order), as the reference's
own sweeps; bfloat16 outputs within one bfloat16 rounding (rtol 2**-7)
where float32 sums are rounded to bfloat16 after summing in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.dlrm import _interact
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dot_interaction import dot_interaction_cuda
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ROUND = dict(rtol=2**-7, atol=1e-6)


def _bags(rng, v, b, l, pad=0.2):
    idx = rng.integers(0, v, (b, l))
    idx[rng.random((b, l)) < pad] = -1  # ragged bags
    return idx.astype(np.int32)


# ---------------------------------------------------------------- embedding bag
@pytest.mark.parametrize("v,d,b,l", [(1000, 64, 256, 1), (5000, 128, 128, 8), (64, 256, 256, 3)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_twin_matches_reference(v, d, b, l, combiner):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = _bags(rng, v, b, l)
    got = ref.embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx), combiner)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), combiner=combiner)
    kern = jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx), combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **F32)


@pytest.mark.parametrize("l", [1, 3])
def test_embedding_bag_twin_bf16_table(l):
    """bf16 table: one row per bag is a copy, exact; more rows are summed in
    float32 and rounded once, within one bf16 rounding of the reference."""
    rng = np.random.default_rng(5)
    table = jnp.asarray(rng.normal(size=(500, 128)), jnp.bfloat16)
    idx = _bags(rng, 500, 128, l, pad=0.0 if l == 1 else 0.2)
    t_table = torch.from_numpy(np.array(table.astype(jnp.float32))).to(torch.bfloat16)
    got = ref.embedding_bag_ref(t_table, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.embedding_bag_ref(table.astype(jnp.float32), jnp.asarray(idx)))
    kern = np.asarray(jops.embedding_bag(table, jnp.asarray(idx)).astype(jnp.float32))
    if l == 1:
        np.testing.assert_array_equal(got.float().numpy(), want)
        np.testing.assert_array_equal(got.float().numpy(), kern)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_ROUND)
        np.testing.assert_allclose(got.float().numpy(), kern, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b", [0, 1, 257])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_embedding_bag_twin_any_batch_and_index_type(b, index_dtype):
    rng = np.random.default_rng(b)
    table = rng.normal(size=(300, 20)).astype(np.float32)  # D not a multiple of 8
    idx = _bags(rng, 300, b, 4)
    if b:
        idx[0] = -1  # an empty bag: 0 for sum and mean
    got = ref.embedding_bag_ref(torch.from_numpy(table),
                                torch.from_numpy(idx).to(index_dtype), "mean")
    assert got.shape == (b, 20)
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), combiner="mean")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if b:
        assert not got[0].any()


def test_embedding_bag_twin_rejects_unknown_combiner():
    with pytest.raises(ValueError, match="combiner"):
        ref.embedding_bag_ref(torch.zeros(4, 2), torch.zeros((1, 1), dtype=torch.int64), "max")


# ---------------------------------------------------------------- dot interaction
@pytest.mark.parametrize("b,f,d", [(128, 27, 128), (256, 8, 64), (128, 4, 16)])
def test_dot_interaction_twin_matches_reference(b, f, d):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    got = ref.dot_interaction_ref(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (b, f * (f - 1) // 2)
    want = jref.dot_interaction_ref(jnp.asarray(x))
    kern = jops.dot_interaction(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,f,d", [(128, 27, 128), (256, 8, 64)])
def test_dot_interaction_twin_bf16_keeps_float32(b, f, d):
    """bf16 input: the twin, like DLRM's `_interact`, returns float32 (the
    products of bf16 values are exact in float32, the sums differ only in
    order); the Pallas kernel rounds its sums to bf16."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(b, f, d)), jnp.bfloat16)
    t_x = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = ref.dot_interaction_ref(t_x)
    assert got.dtype == torch.float32
    want = np.asarray(_interact(x))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    kern = np.asarray(jops.dot_interaction(x).astype(jnp.float32))
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), kern, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,f", [(0, 27), (1, 27), (3, 2), (129, 5), (4, 1)])
def test_dot_interaction_twin_any_batch(b, f):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, f, 16)).astype(np.float32)
    got = ref.dot_interaction_ref(torch.from_numpy(x))
    assert got.shape == (b, f * (f - 1) // 2)
    ii, jj = np.tril_indices(f, -1)
    want = np.einsum("bfd,bgd->bfg", x, x)[:, ii, jj]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- dispatch and wrappers
def test_cpu_dispatch_takes_the_twins_and_counts_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    idx = torch.from_numpy(_bags(rng, 50, 10, 2))
    torch.testing.assert_close(ops.embedding_bag(table, idx, "mean"),
                               ref.embedding_bag_ref(table, idx, "mean"), rtol=0, atol=0)
    x = torch.from_numpy(rng.normal(size=(3, 5, 8)).astype(np.float32))
    torch.testing.assert_close(ops.dot_interaction(x), ref.dot_interaction_ref(x),
                               rtol=0, atol=0)
    assert ops.launch_counts["embedding_bag"] == 0
    assert ops.launch_counts["dot_interaction"] == 0


@pytest.mark.parametrize("case,err", [
    ("cpu_tensors", ValueError),
    ("float16_table", TypeError),
    ("float_indices", TypeError),
    ("int16_indices", TypeError),
    ("mean_typo", ValueError),
    ("one_dim_indices", ValueError),
])
def test_embedding_bag_cuda_refuses(case, err):
    table = torch.zeros((4, 8))
    idx = torch.zeros((2, 1), dtype=torch.int32)
    args = {
        "cpu_tensors": (table, idx, "sum"),
        "float16_table": (table.half(), idx, "sum"),
        "float_indices": (table, idx.float(), "sum"),
        "int16_indices": (table, idx.to(torch.int16), "sum"),
        "mean_typo": (table, idx, "avg"),
        "one_dim_indices": (table, idx[:, 0], "sum"),
    }[case]
    with pytest.raises(err):
        embedding_bag_cuda(*args)


@pytest.mark.parametrize("case,err", [
    ("cpu_tensor", ValueError),
    ("float16", TypeError),
    ("int32", TypeError),
    ("two_dim", ValueError),
])
def test_dot_interaction_cuda_refuses(case, err):
    x = torch.zeros((2, 4, 8))
    arg = {"cpu_tensor": x, "float16": x.half(), "int32": x.int(), "two_dim": x[0]}[case]
    with pytest.raises(err):
        dot_interaction_cuda(arg)


def test_build_registers_every_source():
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    assert {"embedding_bag", "dot_interaction"} <= set(_build.launch_counts)
