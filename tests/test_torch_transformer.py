"""The port's LM serving path against the JAX package's, on the CPU.

``repro_torch.models.transformer`` and ``repro_torch.serve`` are held
against ``repro.models.transformer`` and ``repro.serve.engine`` on the same
parameters (the reference's ``init_params`` pytree, with its zero norms and
biases replaced by numpy draws so they count) and the same token ids. On
the CPU the port's attention is the plain twin of its ``flash_attention``
kernel; the reference's prompts here are short enough for its einsum
branch.

Tolerances: float32 logits and cache at rtol/atol 1e-5 (matmul and
summation order). bfloat16 at atol 0.1 on logits of unit scale and 0.05 on
the cache: both packages round every activation to bfloat16 but in other
places (the reference's einsum rounds normalised probabilities, the port
rounds p before normalising; XLA and torch round the SiLU and the products
differently), and two layers compound that to a few bfloat16 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import qwen2_1_5b as tcfg
from repro_torch.configs import registry as treg
from repro_torch.launch import steps
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.serve import GenerationResult, ServeEngine
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=0.0, atol=0.1)
BF16_CACHE = dict(rtol=0.0, atol=0.05)


def _port_cfg(ref_cfg) -> TransformerConfig:
    fields = dataclasses.asdict(ref_cfg)
    fields["dtype"] = "bfloat16" if ref_cfg.dtype == jnp.bfloat16 else "float32"
    return TransformerConfig(**fields)


def _ref_cfg(dtype=jnp.float32):
    return dataclasses.replace(jreg.get_arch("qwen2-1.5b").reduced(), dtype=dtype)


def _params(cfg, seed=0):
    """init_params as numpy, with norms and biases drawn so they matter."""
    params = jax.tree.map(np.array, jtf.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for group in (params, params["layers"]):
        for name in list(group):
            if name.startswith(("ln_", "b")):
                group[name] = (rng.normal(size=group[name].shape) * 0.1).astype(group[name].dtype)
    return params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _np(t: torch.Tensor):
    return t.float().numpy()


def _j(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches_the_reference(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(3, 5, 48)) * 3, dtype)
    g = jnp.asarray(rng.normal(size=48) * 0.1, dtype)
    want = jcommon.rms_norm(x, g)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = tcommon.rms_norm(torch.from_numpy(_j(x)).to(tdt), torch.from_numpy(_j(g)).to(tdt))
    assert got.dtype == tdt
    tol = F32 if dtype == jnp.float32 else dict(rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(_np(got), _j(want), **tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_the_reference(dtype, theta):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 7, 6, 16)), dtype)
    pos = np.broadcast_to(np.arange(100, 107), (2, 7))
    want = jcommon.rope(x, jnp.asarray(pos), theta)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = tcommon.apply_rope(torch.from_numpy(_j(x)).to(tdt),
                            *tcommon.rope_tables(torch.from_numpy(pos.copy()), 16, theta))
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == jnp.float32 else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(_np(got), _j(want), **tol)
    # the halves rotate as pairs, not interleaved neighbours
    one = torch.zeros((1, 1, 1, 16))
    one[..., 0] = 1.0
    turned = tcommon.apply_rope(one, *tcommon.rope_tables(torch.tensor([1]), 16, theta))
    assert turned[..., 8] == pytest.approx(np.sin(1.0)) and turned[..., 1] == 0.0


# ---------------------------------------------------------------- the model
def _models(dtype=jnp.float32, seed=0):
    cfg = _ref_cfg(dtype)
    params = _params(cfg, seed)
    return cfg, params, Transformer.from_numpy_params(params, _port_cfg(cfg), device="cpu")


def test_forward_logits_match_the_reference():
    cfg, params, model = _models()
    toks = _tokens(cfg, 2, 19)
    want = jtf.forward_logits(params, jnp.asarray(toks), cfg)
    got = model.forward_logits(torch.from_numpy(toks))
    assert got.shape == (2, 19, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _check_prefill_decode(dtype, logit_tol, cache_tol, steps_=4):
    cfg, params, model = _models(dtype, seed=3)
    toks = _tokens(cfg, 3, 11, seed=3)
    max_len = 24
    want, jcache = jtf.prefill_step(params, jnp.asarray(toks), cfg, max_len=max_len)
    got, cache = model.prefill_step(torch.from_numpy(toks), max_len=max_len)
    assert got.shape == (3, cfg.vocab) and got.dtype == torch.float32
    assert cache[0].shape == (cfg.n_layers, 3, max_len, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), _j(want), **logit_tol)
    for c, jc in zip(cache, jcache):
        np.testing.assert_allclose(_np(c), _j(jc), **cache_tol)
    rng = np.random.default_rng(4)
    for t in range(steps_):
        nxt = rng.integers(0, cfg.vocab, 3).astype(np.int32)
        want, jcache = jtf.decode_step(params, jcache, jnp.asarray(nxt), 11 + t, cfg)
        got, same = model.decode_step(cache, torch.from_numpy(nxt), 11 + t)
        assert same is cache  # written in place
        np.testing.assert_allclose(got.numpy(), _j(want), **logit_tol)
        for c, jc in zip(cache, jcache):
            np.testing.assert_allclose(_np(c), _j(jc), **cache_tol)


def test_prefill_and_decode_match_the_reference_float32():
    _check_prefill_decode(jnp.float32, F32, F32)


def test_prefill_and_decode_match_the_reference_bfloat16():
    _check_prefill_decode(jnp.bfloat16, BF16_LOGITS, BF16_CACHE)


def test_decode_rejects_an_index_outside_the_cache():
    _, _, model = _models()
    _, cache = model.prefill_step(torch.zeros((1, 3), dtype=torch.int64), max_len=4)
    with pytest.raises(ValueError, match="outside"):
        model.decode_step(cache, torch.zeros(1, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill_step(torch.zeros((1, 5), dtype=torch.int64), max_len=4)


def test_head_order_is_kv_major():
    """q head h reads kv head h // group: zeroing kv head 1's values changes
    only the outputs of q heads group..2*group-1 (Hkv = 2 here)."""
    cfg, params, _ = _models(seed=5)
    params["layers"]["wv"][:, :, cfg.head_dim:] = 0.0  # kv head 1 reads zeros
    params["layers"]["bv"][:, cfg.head_dim:] = 0.0
    model = Transformer.from_numpy_params(params, _port_cfg(cfg), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=5))
    seen = {}

    def spy(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        seen.setdefault("out", out)
        return out

    from repro_torch.kernels import ops
    orig = ops.flash_attention
    ops.flash_attention = spy
    try:
        model.forward_logits(toks)
    finally:
        ops.flash_attention = orig
    group = cfg.n_heads // cfg.n_kv_heads
    out = seen["out"]
    assert torch.count_nonzero(out[:, group:]) == 0
    assert torch.count_nonzero(out[:, :group]) > 0


def test_from_config_shapes_scales_and_seed():
    cfg = tcfg.reduced()
    a = Transformer.from_config(cfg, device="cpu", seed=1)
    b = Transformer.from_config(cfg, device="cpu", seed=1)
    c = Transformer.from_config(cfg, device="cpu", seed=2)
    ref = jax.eval_shape(lambda: jtf.init_params(_ref_cfg(), jax.random.PRNGKey(0)))
    flat = {**{k: v for k, v in ref.items() if k != "layers"}, **ref["layers"]}
    for name, spec in flat.items():
        assert tuple(getattr(a, name).shape) == spec.shape, name
    assert torch.equal(a.wq, b.wq) and not torch.equal(a.wq, c.wq)
    assert torch.count_nonzero(a.ln_attn) == torch.count_nonzero(a.bq) == 0
    assert float(a.wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert float(a.embed.std()) == pytest.approx(0.02, rel=0.1)
    assert sum(p.numel() for p in a.parameters()) == cfg.n_params() + cfg.n_layers * (
        cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim  # + the QKV biases


def test_from_numpy_params_rejects_wrong_shapes():
    cfg, params, _ = _models()
    params["layers"]["wq"] = params["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        Transformer.from_numpy_params(params, _port_cfg(cfg), device="cpu")


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("eos", [None, "first"])
def test_generate_greedy_equals_the_reference(eos):
    cfg, params, model = _models(seed=6)
    prompts = [[5, 6, 7], [8, 9, 10, 11, 12, 13], [200]]  # uneven: left padding
    eos_id = None
    if eos == "first":  # a token the reference really emits, so stopping is exercised
        eos_id = int(JServeEngine(params, cfg, max_len=32).generate(
            prompts, max_new_tokens=3).tokens[0, 1])
    want = JServeEngine(params, cfg, max_len=32, eos_id=eos_id).generate(
        prompts, max_new_tokens=8)
    got = ServeEngine(model, max_len=32, eos_id=eos_id).generate(prompts, max_new_tokens=8)
    assert isinstance(got, GenerationResult)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.n_generated, want.n_generated)
    assert got.prefill_ms >= 0.0 and got.decode_ms_per_token >= 0.0
    if eos_id is not None:
        assert got.n_generated[0] == 2


def test_generate_rejects_too_long_requests():
    _, _, model = _models()
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(model, max_len=8).generate([[1, 2, 3]], max_new_tokens=6)


def test_temperature_sampling_is_seeded():
    _, _, model = _models(seed=7)
    eng = ServeEngine(model, max_len=32)
    a = eng.generate([[1, 2], [3]], max_new_tokens=6, temperature=1.0, seed=3)
    b = eng.generate([[1, 2], [3]], max_new_tokens=6, temperature=1.0, seed=3)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < model.cfg.vocab)).all()


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_configs_equal_the_reference(which):
    ref_cfg = getattr(jreg.get_arch("qwen2-1.5b"), which)()
    assert getattr(tcfg, which)() == _port_cfg(ref_cfg)


def test_qwen2_parameter_count():
    assert tcfg.config().n_params() == jreg.get_arch("qwen2-1.5b").config().n_params() \
        == 1_777_030_656


def test_registry_lm_shapes_equal_the_reference():
    assert {k: (s.kind, s.params) for k, s in treg.LM_SHAPES.items()} == \
        {k: (s.kind, s.params) for k, s in jreg.LM_SHAPES.items()}
    lm = [a for a, spec in jreg.ARCHS.items() if spec.family == "lm"]
    assert len(lm) == 5
    assert [a for a, spec in treg.ARCHS.items() if spec.family == "lm"] == lm  # the same order
    for arch_id in lm:
        arch = treg.get_arch(arch_id)
        assert arch.family == jreg.get_arch(arch_id).family == "lm"
        assert arch.shapes is treg.LM_SHAPES


# ---------------------------------------------------------------- cells
def _params_of(model: Transformer) -> dict:
    """The module's weights as the reference's pytree."""
    top = ("embed", "ln_final", "w_vocab")
    named = {n: jnp.asarray(p.float().numpy()) for n, p in model.named_parameters()}
    return {**{k: named[k] for k in top},
            "layers": {k: v for k, v in named.items() if k not in top}}


def test_build_cell_prefill_reduced_matches_the_reference():
    cell = steps.build_cell("qwen2-1.5b", "prefill_32k", reduced=True, device="cpu", seed=2)
    (tokens,) = cell.args
    assert tokens.shape == (2, 64)
    logits, cache = cell.run()
    assert logits.shape == (2, 256) and cache[0].shape[2] == 64
    want, _ = jtf.prefill_step(_params_of(cell.model), jnp.asarray(tokens.numpy()),
                               _ref_cfg())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **F32)


def test_build_cell_decode_reduced_matches_the_reference():
    cell = steps.build_cell("qwen2-1.5b", "decode_32k", reduced=True, device="cpu", seed=2)
    cache, tokens, index = cell.args
    assert index == 63 and tokens.shape == (2,)
    assert cache[0].shape == (2, 2, 64, 2, 8) and cache[0].dtype == torch.float32
    assert not torch.equal(cache[0], cache[1]) and float(cache[0].std()) == \
        pytest.approx(1.0, rel=0.1)
    jcache = tuple(jnp.asarray(c.numpy()) for c in cache)
    want, _ = jtf.decode_step(_params_of(cell.model), jcache, jnp.asarray(tokens.numpy()),
                              index, _ref_cfg())
    logits, _ = cell.run()
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **F32)


def test_build_cell_batch_override_and_train():
    cell = steps.build_cell("qwen2-1.5b", "decode_32k", reduced=True, device="cpu", batch=3)
    assert cell.args[1].shape == (3,)
    cell = steps.build_cell("qwen2-1.5b", "train_4k", reduced=True, device="cpu", batch=3)
    model, opt_state, tokens, targets = cell.args
    assert tokens.shape == targets.shape == (3, 64)
    loss, _ = cell.run()
    assert np.isfinite(float(loss)) and int(opt_state["step"]) == 1
