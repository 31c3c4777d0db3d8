"""The backward of the port's ``flash_attention`` against the JAX package,
on the CPU.

The Pallas kernel has no backward: the reference differentiates its plain
attention (``repro.kernels.ref.attention_ref``) with JAX. The port's
backward twin, ``ref.flash_attention_backward_ref`` (what the CUDA kernels
``flash_attention_bwd_dkdv`` / ``_dq`` / ``_delta`` compute), is held
against ``jax.vjp`` of ``attention_ref`` and against torch autograd of the
forward twin ``ref.flash_attention_ref``, over GQA groups, windows,
soft-caps, query offsets and rows that see no key; so is the CPU autograd
path, ``ops.flash_attention`` on tensors that require grad
(``ops.FlashAttention``). Inputs are seeded numpy draws.

Tolerances: float32 at rtol 1e-5 with atol 1e-5 * max(max|want|, 1) per
tensor (the same products summed in another order; inputs are of unit
scale). bfloat16 against the float32 twin at 2^-6 * max(max|want|, 1): the
twin rounds the inputs to bfloat16, p to bfloat16 before dV (the forward's
rounding point) and dS to bfloat16 before dK and dQ (the A operand of the
tensor-core kernels' two products; ``round_ds``), and each gradient once.
The witness (neither p nor dS rounded) pins where each rounding acts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, Hq, Hkv, Sq, Sk, D, keywords)
CASES = {
    "mha": (2, 2, 2, 9, 9, 8, {}),
    "gqa6": (1, 6, 1, 20, 20, 16, {}),
    "gqa7_window": (1, 7, 1, 24, 24, 8, dict(window=5)),
    "cap": (2, 4, 2, 17, 17, 16, dict(softcap=2.0)),
    "cap_window": (1, 4, 2, 19, 19, 8, dict(softcap=1.5, window=4)),
    "longer_keys": (1, 4, 2, 7, 23, 8, {}),
    "not_causal": (1, 2, 1, 6, 11, 8, dict(causal=False)),
}
# cases jax.vjp cannot express (attention_ref fixes q_offset = Sk - Sq): checked
# against torch autograd of the forward twin
OFFSET_CASES = {
    "offset_past_keys": (1, 4, 2, 10, 12, 8, dict(q_offset=6)),  # rows past Sk
    "offset_negative": (1, 2, 2, 8, 8, 8, dict(q_offset=-3)),    # rows that see no key
    "window_one": (1, 3, 1, 9, 9, 16, dict(window=1, q_offset=0)),
}


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    do = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    return q, k, v, do


def _close(got, want, rtol=1e-5, scaled=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # a gradient that is 0 in exact arithmetic (a row seeing one key) comes out
    # of dS = p (dP - delta) as rounding noise: the scale is at least 1
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scaled * max(np.abs(want).max(), 1.0))


def _twin(q, k, v, do, kw):
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = ref.flash_attention_lse_ref(*t[:3], **kw)
    return ref.flash_attention_backward_ref(*t[:3], out, lse, t[3], **kw)


def _jax_grads(q, k, v, do, kw):
    jkw = {key: kw[key] for key in ("causal", "window", "softcap") if key in kw}
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(do))


def _autograd(q, k, v, do, kw, fn):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*t, **kw)
    out.backward(torch.from_numpy(do))
    return [x.grad for x in t]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_twin_equals_jax_vjp(case):
    *shape, kw = CASES[case]
    q, k, v, do = _inputs(*shape)
    for got, want in zip(_twin(q, k, v, do, kw), _jax_grads(q, k, v, do, kw)):
        _close(got.numpy(), want)


def test_an_earlier_offset_equals_jax_on_the_keys_it_can_see():
    """q_offset below Sk - Sq: the causal mask hides the keys past the last
    row, so attention_ref over the keys cut there is the same function."""
    q, k, v, do = _inputs(1, 4, 2, 6, 20, 8, seed=3)
    kw = dict(q_offset=9)
    got = _twin(q, k, v, do, kw)
    want = _jax_grads(q, k[:, :, :15], v[:, :, :15], do, {})
    _close(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g[:, :, :15].numpy(), w)
        assert not g[:, :, 15:].any()


@pytest.mark.parametrize("case", sorted(CASES) + sorted(OFFSET_CASES))
def test_backward_twin_and_the_cpu_autograd_path_equal_autograd_of_the_forward(case):
    *shape, kw = {**CASES, **OFFSET_CASES}[case]
    q, k, v, do = _inputs(*shape, seed=1)
    want = _autograd(q, k, v, do, kw, ref.flash_attention_ref)
    for got in (_twin(q, k, v, do, kw), _autograd(q, k, v, do, kw, ops.flash_attention)):
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_cpu_autograd_path_equals_jax(case):
    *shape, kw = CASES[case]
    q, k, v, do = _inputs(*shape, seed=2)
    got = _autograd(q, k, v, do, kw, ops.flash_attention)
    for g, w in zip(got, _jax_grads(q, k, v, do, kw)):
        _close(g.numpy(), w)


@pytest.mark.parametrize("case", ["gqa7_window", "offset_negative", "offset_past_keys"])
def test_lse_is_the_log_sum_exp_of_the_visible_scores(case):
    b, hq, hkv, sq, sk, d, kw = {**CASES, **OFFSET_CASES}[case]
    q, k, v, _ = _inputs(b, hq, hkv, sq, sk, d)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = ref.flash_attention_lse_ref(*t, **kw)
    torch.testing.assert_close(out, ref.flash_attention_ref(*t, **kw), rtol=0, atol=0)
    off = kw.get("q_offset", sk - sq)
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, hq // hkv, axis=1)) / np.sqrt(d)
    qp, kp = np.arange(sq)[:, None] + off, np.arange(sk)[None, :]
    mask = (qp >= kp) & ((kp > qp - kw["window"]) if "window" in kw else True)
    with np.errstate(divide="ignore"):  # the rows that see no key: log 0, then +inf
        want = np.where(mask.any(-1), np.log(np.where(mask, np.exp(s), 0.0).sum(-1)), np.inf)
    np.testing.assert_allclose(lse.numpy(), np.broadcast_to(want, lse.shape), rtol=1e-5)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)


def test_bfloat16_twin_is_the_float32_one_rounded():
    q, k, v, do = _inputs(1, 6, 2, 33, 33, 16, seed=4)
    kw = dict(softcap=3.0)
    want = _twin(q, k, v, do, kw)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    out, lse = ref.flash_attention_lse_ref(*t[:3], **kw)
    got = ref.flash_attention_backward_ref(*t[:3], out, lse, t[3], **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), w.numpy(), rtol=0.0, scaled=2.0 ** -6)
    # the witness (p unrounded) differs from the twin by p's rounding only
    wit = ref.flash_attention_backward_ref(*t[:3], out, lse, t[3], round_p=False, **kw)
    assert torch.equal(wit[0], got[0]) and torch.equal(wit[1], got[1])


def _bf16_twin(q, k, v, do, kw, **rounding):
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    out, lse = ref.flash_attention_lse_ref(*t[:3], **kw)
    return ref.flash_attention_backward_ref(*t[:3], out, lse, t[3], **rounding, **kw)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(OFFSET_CASES))
def test_round_ds_changes_nothing_in_float32(case):
    *shape, kw = {**CASES, **OFFSET_CASES}[case]
    t = [torch.from_numpy(x) for x in _inputs(*shape, seed=5)]
    out, lse = ref.flash_attention_lse_ref(*t[:3], **kw)
    for a, b in zip(ref.flash_attention_backward_ref(*t[:3], out, lse, t[3], **kw),
                    ref.flash_attention_backward_ref(*t[:3], out, lse, t[3], round_ds=False,
                                                     round_p=False, **kw)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(OFFSET_CASES))
def test_bfloat16_twin_with_ds_rounded_stays_near_the_float32_twin(case):
    *shape, kw = {**CASES, **OFFSET_CASES}[case]
    q, k, v, do = _inputs(*shape, seed=6)
    for g, w in zip(_bf16_twin(q, k, v, do, kw), _twin(q, k, v, do, kw)):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), w.numpy(), rtol=0.0, scaled=2.0 ** -6)


@pytest.mark.parametrize("case", ["gqa6", "cap", "offset_negative"])
def test_the_witness_differs_from_the_twin_where_the_rounding_bites(case):
    """The witness (neither p nor dS rounded) and the twin: dv differs by p's
    rounding only, dq and dk by dS's only, and both are in use."""
    *shape, kw = {**CASES, **OFFSET_CASES}[case]
    q, k, v, do = _inputs(*shape, seed=7)
    twin = _bf16_twin(q, k, v, do, kw)
    no_p = _bf16_twin(q, k, v, do, kw, round_p=False)
    no_ds = _bf16_twin(q, k, v, do, kw, round_ds=False)
    wit = _bf16_twin(q, k, v, do, kw, round_p=False, round_ds=False)
    assert torch.equal(no_p[0], twin[0]) and torch.equal(no_p[1], twin[1])
    assert torch.equal(no_ds[2], twin[2]) and torch.equal(wit[2], no_p[2])
    assert torch.equal(wit[0], no_ds[0]) and torch.equal(wit[1], no_ds[1])
    assert not torch.equal(no_p[2], twin[2])
    assert not torch.equal(no_ds[0], twin[0]) and not torch.equal(no_ds[1], twin[1])


def test_serving_and_no_grad_calls_take_the_plain_forward(monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 5, 5, 8))
    calls = []
    monkeypatch.setattr(ops.FlashAttention, "apply", lambda *a: calls.append(a))
    ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    assert not calls
    ops.flash_attention(q, k, v)
    assert len(calls) == 1


def test_empty_shapes_give_zero_gradients():
    q = torch.zeros((1, 2, 0, 8), requires_grad=True)
    k = torch.randn((1, 1, 4, 8), requires_grad=True)
    v = torch.randn((1, 1, 4, 8), requires_grad=True)
    ops.flash_attention(q, k, v).sum().backward()
    assert k.grad.abs().sum() == 0 and v.grad.abs().sum() == 0 and q.grad.shape == q.shape
