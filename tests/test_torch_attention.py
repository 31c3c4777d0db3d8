"""The port's flash-attention twin against the JAX package's, on the CPU.

``repro_torch.kernels.ops.flash_attention`` (on a CPU tensor, the plain
twin ``flash_attention_ref``) is held against the Pallas kernel
(``repro.kernels.ops.flash_attention``, interpret mode off-TPU) on every
case of the reference's attention sweeps, and against the reference's
oracle ``attention_ref`` where the Pallas kernel refuses the shape (lengths
that are not block multiples, one query row, more queries than keys). The
CUDA kernel runs only on a GPU (``chip_smoke.py``); here its wrapper is
checked to refuse what it does not take. Inputs are made by numpy from a
seed.

Tolerances are the reference sweep's (``tests/test_kernels.py::_tol``):
rtol/atol 1e-5 in float32 (summation order), 2e-2 in bfloat16 (p is
rounded to bfloat16 against a different running max).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda

F32 = dict(rtol=1e-5, atol=1e-5)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else F32


def _qkv(seed, b, hq, hkv, sq, sk, d, dtype=jnp.float32):
    """The same inputs for both packages: jnp arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.normal(size=shape), dtype)
              for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tensors = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in arrays]
    return arrays, tensors


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------ the reference's sweeps, vs Pallas
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 4, 4, 128, 128, 64),     # MHA square
    (2, 8, 2, 128, 128, 64),     # GQA 4:1
    (1, 4, 1, 64, 256, 32),      # MQA decode-ish (Sq < Sk)
    (1, 2, 2, 256, 256, 128),
])
def test_twin_matches_pallas_sweep(b, hq, hkv, sq, sk, d, dtype):
    (q, k, v), (tq, tk, tv) = _qkv(0, b, hq, hkv, sq, sk, d, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("window", [None, 64, 128])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_twin_matches_pallas_window_softcap(window, softcap):
    (q, k, v), (tq, tk, tv) = _qkv(1, 1, 4, 2, 256, 256, 64)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window, softcap=softcap)
    want = jops.flash_attention(q, k, v, causal=True, window=window, softcap=softcap,
                                block_q=64, block_k=64)
    _close(got, want, F32)


def test_twin_matches_pallas_noncausal():
    (q, k, v), (tq, tk, tv) = _qkv(2, 1, 2, 2, 128, 128, 32)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = jops.flash_attention(q, k, v, causal=False, block_q=64, block_k=64)
    _close(got, want, F32)


def test_twin_matches_pallas_explicit_scale():
    (q, k, v), (tq, tk, tv) = _qkv(3, 1, 6, 2, 64, 128, 16, jnp.bfloat16)
    got = ops.flash_attention(tq, tk, tv, sm_scale=0.3)
    want = jops.flash_attention(q, k, v, sm_scale=0.3, block_q=64, block_k=64)
    _close(got, want, _tol(jnp.bfloat16))


# --------------------------------------- what Pallas refuses, vs the jnp oracle
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window", [
    (2, 6, 2, 77, 333, 8, None),     # neither length a block multiple
    (1, 4, 2, 130, 130, 16, 40),     # ragged square with a window
    (3, 6, 2, 1, 97, 24, None),      # one query row (decode)
    (1, 4, 2, 100, 50, 32, None),    # Sq > Sk: the first 50 rows see no key
    (1, 2, 1, 5, 1, 8, None),        # a single key
])
def test_twin_matches_oracle_on_any_length(b, hq, hkv, sq, sk, d, window):
    (q, k, v), (tq, tk, tv) = _qkv(4, b, hq, hkv, sq, sk, d)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    want = jref.attention_ref(q, k, v, causal=True, window=window)
    _close(got, want, F32)
    if sq > sk:
        assert torch.equal(got[:, :, :sq - sk], torch.zeros_like(got[:, :, :sq - sk]))


@pytest.mark.parametrize("sq,q_offset,window", [(1, 0, None), (1, 40, None), (1, 96, 16),
                                                (17, 30, None), (8, 0, 3)])
def test_q_offset_equals_the_sliced_right_aligned_call(sq, q_offset, window):
    """Rows at positions q_offset.. against a longer cache == the same rows
    right-aligned against the cache cut to q_offset + Sq keys."""
    (_, k, v), (tq, tk, tv) = _qkv(5, 2, 6, 2, sq, 97, 16)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    cut = q_offset + sq
    sliced = ops.flash_attention(tq, tk[:, :, :cut], tv[:, :, :cut], causal=True,
                                 window=window)
    torch.testing.assert_close(got, sliced, **F32)
    want = jref.attention_ref(jnp.asarray(tq.numpy()), k[:, :, :cut], v[:, :, :cut],
                              causal=True, window=window)
    _close(got, want, F32)


def test_strided_views_equal_contiguous_inputs():
    """The model hands (B, S, H, D) memory over as (B, H, S, D) views."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 9, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    got = ops.flash_attention(*views, q_offset=31)
    want = ops.flash_attention(*[x.contiguous() for x in views], q_offset=31)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_empty_lengths():
    q = torch.zeros((1, 2, 0, 8))
    kv = torch.zeros((1, 1, 5, 8))
    assert ops.flash_attention(q, kv, kv).shape == (1, 2, 0, 8)
    q = torch.ones((1, 2, 3, 8))
    kv = torch.zeros((1, 1, 0, 8))
    assert torch.equal(ops.flash_attention(q, kv, kv), torch.zeros((1, 2, 3, 8)))


# ---------------------------------------------------------------- the wrapper
def test_cpu_dispatch_takes_the_twin_and_counts_no_launch():
    ops.reset_launch_counts()
    _, (tq, tk, tv) = _qkv(7, 1, 2, 1, 4, 4, 8)
    ops.flash_attention(tq, tk, tv)
    assert ops.launch_counts["flash_attention"] == 0


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim_256+", "head_dim_odd",
                                  "groups", "window", "softcap", "cpu_tensor"])
def test_cuda_wrapper_refuses(case):
    q = torch.zeros((1, 4, 3, 16))
    kv = torch.zeros((1, 2, 5, 16))
    kw = {}
    err = ValueError
    if case == "dtype":
        q, kv, err = q.half(), kv.half(), TypeError
    elif case == "mixed_dtype":
        kv, err = kv.bfloat16(), TypeError
    elif case == "head_dim_256+":
        q, kv = torch.zeros((1, 4, 3, 264)), torch.zeros((1, 2, 5, 264))
    elif case == "head_dim_odd":
        q, kv = torch.zeros((1, 4, 3, 12)), torch.zeros((1, 2, 5, 12))
    elif case == "groups":
        kv = torch.zeros((1, 3, 5, 16))
    elif case == "window":
        kw = dict(window=0)
    elif case == "softcap":
        kw = dict(softcap=-1.0)
    with pytest.raises(err):
        flash_attention_cuda(q, kv, kv, **kw)
