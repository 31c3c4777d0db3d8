"""The port's gradient compression against the JAX package's, on the CPU.

``int8`` must equal the reference bit for bit (the codes, the scale, the
decoded gradients and the residual); ``topk`` the same selected indices,
in the same order, and the same values, residual and decoded gradients,
also where magnitudes tie (the rule: ties go to the lower index, as
``jax.lax.top_k`` breaks them). ``k`` is the reference's floor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.compression as ref
from repro_torch.train import compression as comp
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"embed_h/w": (37, 16), "layers/0/A/b": (16,), "readout/w": (16, 7), "s": (1,)}


def _grads(seed, scale=1.0, zero=()):
    rng = np.random.default_rng(seed)
    out = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    for k in zero:
        out[k][:] = 0
    return out


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _bits(x):
    return np.asarray(x).view(np.uint32 if np.asarray(x).dtype == np.float32 else np.uint8)


@pytest.mark.parametrize("seed,scale,zero", [(0, 1.0, ()), (1, 1e-3, ("s",)),
                                             (2, 50.0, ("layers/0/A/b",))])
def test_int8_equals_the_reference_bit_for_bit(seed, scale, zero):
    g, r = _grads(seed, scale, zero), _grads(seed + 10, scale * 0.01)
    wire, dec, res = comp.compress_int8(_t(g), _t(r))
    jwire, jdec, jres = ref.compress_int8(_j(g), _j(r))
    for k in SHAPES:
        q, scale_t = wire[k]
        assert q.dtype == torch.int8 and scale_t.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jwire[k][0]))
        np.testing.assert_array_equal(_bits(scale_t.numpy()), _bits(jwire[k][1]))
        np.testing.assert_array_equal(_bits(dec[k].numpy()), _bits(jdec[k]))
        np.testing.assert_array_equal(_bits(res[k].numpy()), _bits(jres[k]))
    assert comp.wire_bytes(wire) == ref.wire_bytes(jwire)


def test_int8_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, scale = comp.quantize_int8(g)
    jq, _ = ref.quantize_int8(jnp.asarray(g.numpy()))
    assert float(scale) == 1.0 and q.tolist() == [127, 0, 2, 2, 0, -2] == np.asarray(jq).tolist()


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3, 1.0])
def test_topk_equals_the_reference_on_distinct_magnitudes(frac):
    g, r = _grads(3), _grads(4, 0.1)
    wire, dec, res = comp.compress_topk(_t(g), _t(r), frac)
    jwire, jdec, jres = ref.compress_topk(_j(g), _j(r), frac)
    for k in SHAPES:
        n = int(np.prod(SHAPES[k]))
        assert wire[k][0].numel() == max(int(n * frac), 1)  # a floor
        assert wire[k][1].dtype == torch.int32
        np.testing.assert_array_equal(wire[k][1].numpy(), np.asarray(jwire[k][1]))
        np.testing.assert_array_equal(_bits(wire[k][0].numpy()), _bits(jwire[k][0]))
        np.testing.assert_array_equal(_bits(dec[k].numpy()), _bits(jdec[k]))
        np.testing.assert_array_equal(_bits(res[k].numpy()), _bits(jres[k]))
    assert comp.wire_bytes(wire) == ref.wire_bytes(jwire)


@pytest.mark.parametrize("k_frac", [0.1, 0.25, 0.5])
def test_topk_ties_go_to_the_lower_index(k_frac):
    g = np.array([1.0, -2.0, 2.0, 1.0, -1.0, 0.5, 2.0, -2.0, 1.0, 0.0, -0.0, 0.5, 1.0, -1.0,
                  2.0, 0.5, 0.0, 1.0, -2.0, 0.5], np.float32)
    zero = np.zeros_like(g)
    wire, _, _ = comp.compress_topk({"g": torch.from_numpy(g)}, {"g": torch.from_numpy(zero)},
                                    k_frac)
    jwire, _, _ = ref.compress_topk({"g": jnp.asarray(g)}, {"g": jnp.asarray(zero)}, k_frac)
    k = max(int(g.size * k_frac), 1)
    rule = sorted(range(g.size), key=lambda i: (-abs(g[i]), i))[:k]
    assert wire["g"][1].tolist() == rule == np.asarray(jwire["g"][1]).tolist()


def test_compress_gradients_factors():
    g, r = _t(_grads(5)), _t(_grads(6, 0.0))
    cfg = comp.CompressionConfig
    out, res, f = comp.compress_gradients(g, r, cfg())
    assert out is g and res is r and f == ref.compress_gradients({}, {}, ref.CompressionConfig())[2]
    for codec, frac in (("int8", 0.01), ("topk", 0.01), ("topk", 0.2)):
        _, _, f = comp.compress_gradients(g, r, cfg(codec, frac))
        _, _, jf = ref.compress_gradients(_j(_grads(5)), _j(_grads(6, 0.0)),
                                          ref.CompressionConfig(codec, frac))
        assert f == jf
    with pytest.raises(ValueError):
        comp.compress_gradients(g, r, cfg("fp4"))
    assert comp.init_residual(g)["readout/w"].dtype == torch.float32


# the reference's error-feedback cases, with the port's codec
def test_int8_error_feedback_preserves_signal():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))}
    res = comp.init_residual(g)
    total_true, total_dec = torch.zeros(64, 64), torch.zeros(64, 64)
    for _ in range(10):
        _, dec, res = comp.compress_int8(g, res)
        total_true += g["w"]
        total_dec += dec["w"]
    assert float((total_true - (total_dec + res["w"])).abs().max()) < 1e-4


def test_topk_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(1000,)).astype(np.float32))}
    res = comp.init_residual(g)
    total_true, total_dec = torch.zeros(1000), torch.zeros(1000)
    for _ in range(20):
        wire, dec, res = comp.compress_topk(g, res, frac=0.05)
        total_true += g["w"]
        total_dec += dec["w"]
    assert float((total_true - (total_dec + res["w"])).abs().max()) < 1e-4
    assert wire["w"][0].shape == (50,)

