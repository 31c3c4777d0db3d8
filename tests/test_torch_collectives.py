"""The port's receiver-partitioned aggregation and its loader helpers
(``repro_torch.distributed.collectives``) against the JAX package's, on the
CPU.

``partition_edges`` and ``validate_partitioning`` equal the reference's bit
for bit (values and dtypes). ``partitioned_segment_sum`` equals the
reference's single-device result (``tests/test_partitioned_agg.py``'s case,
a ``segment_sum``) within rtol 1e-6 and atol 1e-6 x max|want| (float32
sums in another order), on partitioned edges with their padding, on
receivers outside [0, n_nodes) (dropped by both), and on 1-D messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcoll
from repro_torch.distributed import (partition_edges, partitioned_segment_sum,
                                     validate_partitioning)
from repro_torch.kernels import ops
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, SCALED = 1e-6, 1e-6


def _edges(seed: int, n: int, e: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("n,e,shards", [(64, 500, 8), (63, 500, 8), (10, 37, 4), (5, 3, 8),
                                        (1000, 20000, 16), (8, 0, 2), (7, 50, 1)])
def test_partition_edges_equals_the_reference_bit_for_bit(n, e, shards):
    s, r = _edges(n * 7 + e, n, e)
    got, want = partition_edges(s, r, n, shards), jcoll.partition_edges(s, r, n, shards)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ps, pr, mask = got
    assert validate_partitioning(pr, n, shards) == jcoll.validate_partitioning(pr, n, shards)
    assert sorted(zip(ps[mask].tolist(), pr[mask].tolist())) == sorted(
        zip(s.tolist(), r.tolist()))


@pytest.mark.parametrize("seed", range(4))
def test_validate_partitioning_equals_the_reference(seed):
    n, shards = 64, 8
    s, r = _edges(seed, n, 300)
    _, pr, _ = partition_edges(s, r, n, shards)
    cases = [pr, pr[::-1].copy(), np.roll(pr, 1), np.sort(r)[:296], r[:296]]
    for case in cases:
        assert validate_partitioning(case, n, shards) == jcoll.validate_partitioning(
            case, n, shards)
    assert validate_partitioning(pr, n, shards) and not validate_partitioning(pr[::-1], n, shards)


def _want(msgs: np.ndarray, recv: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(jcoll.partitioned_segment_sum(jnp.asarray(msgs),
                                                    jnp.asarray(recv.astype(np.int32)), n))


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    atol = SCALED * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("d", [1, 4, 16])
@pytest.mark.parametrize("shards", [1, 8])
def test_partitioned_segment_sum_equals_the_references_single_device_result(d, shards):
    rng = np.random.default_rng(d * 10 + shards)
    n = 64
    s, r = _edges(d + shards, n, 248)
    ps, pr, mask = partition_edges(s, r, n, shards)
    x = rng.normal(size=(n, d)).astype(np.float32)
    msgs = np.where(mask[:, None], x[np.maximum(ps, 0)], 0.0).astype(np.float32)
    ops.reset_launch_counts()
    got = partitioned_segment_sum(torch.from_numpy(msgs), torch.from_numpy(pr), n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    _close(got, _want(msgs, pr, n))
    want = np.zeros((n, d))
    np.add.at(want, r, x[s].astype(np.float64))
    _close(got, want)
    assert not any(ops.launch_counts.values())  # the CPU runs the plain twin


def test_receivers_outside_the_nodes_are_dropped_as_segment_sum_drops_them():
    rng = np.random.default_rng(5)
    n = 8
    msgs = rng.normal(size=(16, 4)).astype(np.float32)
    recv = rng.integers(0, n, 16)
    recv[[1, 4, 9]] = [-1, n, n + 5]
    got = partitioned_segment_sum(torch.from_numpy(msgs), torch.from_numpy(recv), n)
    _close(got, _want(msgs, recv, n))
    keep = (recv >= 0) & (recv < n)
    want = np.zeros((n, 4))
    np.add.at(want, recv[keep], msgs[keep].astype(np.float64))
    _close(got, want)


def test_one_dimensional_messages_give_a_one_dimensional_sum():
    rng = np.random.default_rng(6)
    n = 12
    recv = rng.integers(0, n, 40)
    ones = np.ones(40, np.float32)
    got = partitioned_segment_sum(torch.from_numpy(ones), torch.from_numpy(recv), n)
    assert got.shape == (n,)
    _close(got, _want(ones, recv, n))
    assert torch.equal(got, torch.from_numpy(np.bincount(recv, minlength=n).astype(np.float32)))


def test_receivers_may_come_as_numpy_and_shapes_are_checked():
    msgs = torch.ones(5, 3)
    got = partitioned_segment_sum(msgs, np.array([0, 0, 1, 2, 2]), 3)
    assert torch.equal(got, torch.tensor([[2.0] * 3, [1.0] * 3, [2.0] * 3]))
    with pytest.raises(ValueError):
        partitioned_segment_sum(msgs, np.array([0, 1]), 3)
    with pytest.raises(ValueError):
        partitioned_segment_sum(torch.ones(2, 2, 2), np.array([0, 1]), 3)


def test_the_references_single_device_route_is_segment_sum():
    # the reference's single-device route is segment_sum (collectives.py:57-59)
    msgs = jnp.asarray(np.random.default_rng(1).normal(size=(16, 4)), jnp.float32)
    recv = jnp.asarray(np.random.default_rng(2).integers(0, 8, 16), jnp.int32)
    np.testing.assert_allclose(np.asarray(jcoll.partitioned_segment_sum(msgs, recv, 8)),
                               np.asarray(jax.ops.segment_sum(msgs, recv, num_segments=8)),
                               rtol=1e-6)
