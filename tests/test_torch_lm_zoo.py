"""The rest of the LM zoo on the port against the JAX package, on the CPU:
Gemma-2 (alternating local/global attention, soft-caps, post-norms),
OLMoE and phi-3.5-MoE (the grouped-dispatch MoE FFN) and yi-34b.

Each reduced model is built from the reference's ``init_params`` pytree
(its zero norms and biases replaced by numpy draws so they count; Gemma-2's
leaves stacked (L/2, 2)) and held against ``repro.models.transformer`` on
the same token ids. Prompts are 19–24 tokens, so Gemma-2's window of 8
cuts; the reference's prompts stay in its einsum branch. The reference's
own oracles (published parameter counts, decode against teacher forcing)
run through the port's registry and API.

Tolerances: float32 logits and cache at rtol/atol 1e-5 (matmul and
summation order). bfloat16 (Gemma-2 and yi only; the MoE archs are held in
bfloat16 layer by layer in ``tests/test_torch_moe.py``, since a top-k
choice that flips on a rounding moves a token a long way) at
``BF16_LOGITS`` / ``BF16_CACHE`` of ``tests/test_torch_transformer.py``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ServeEngine
from tests import test_models as ref_models
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_transformer import (BF16_CACHE, BF16_LOGITS, F32, _j, _np, _params,
                                          _port_cfg, _tokens)

ZOO = ["gemma2-9b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "yi-34b"]
MODULES = {"gemma2-9b": "gemma2_9b", "olmoe-1b-7b": "olmoe",
           "phi3.5-moe-42b-a6.6b": "phi35_moe", "yi-34b": "yi_34b"}
BF16_ARCHS = ["gemma2-9b", "yi-34b"]


def _ref_cfg(arch, dtype=jnp.float32):
    return dataclasses.replace(jreg.get_arch(arch).reduced(), dtype=dtype)


def _models(arch, dtype=jnp.float32, seed=0):
    cfg = _ref_cfg(arch, dtype)
    params = _params(cfg, seed)
    return cfg, params, Transformer.from_numpy_params(params, _port_cfg(cfg), device="cpu")


def _flat_layers(cfg, a):
    """A reference layer leaf or cache, (L/2, 2, ...) when alternating, as
    the port's (L, ...)."""
    a = np.asarray(a.astype(jnp.float32) if hasattr(a, "astype") else a)
    return a.reshape((cfg.n_layers,) + a.shape[len(cfg.layers_leading):])


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", ZOO)
def test_configs_equal_the_reference(arch, which):
    ref_cfg = getattr(jreg.get_arch(arch), which)()
    mod = __import__(f"repro_torch.configs.{MODULES[arch]}", fromlist=["x"])
    assert getattr(mod, which)() == getattr(treg.get_arch(arch), which)() == _port_cfg(ref_cfg)


@pytest.mark.parametrize("arch", ZOO)
def test_parameter_counts_and_layout_equal_the_reference(arch):
    for which in ("config", "reduced"):
        ref_cfg = getattr(jreg.get_arch(arch), which)()
        cfg = getattr(treg.get_arch(arch), which)()
        assert cfg.n_params() == ref_cfg.n_params()
        assert cfg.n_active_params() == ref_cfg.n_active_params()
        assert cfg.alternating == ref_cfg.alternating == (arch == "gemma2-9b")
        assert cfg.layers_leading == ref_cfg.layers_leading


def test_the_reference_published_counts_on_the_port(monkeypatch):
    monkeypatch.setattr(ref_models, "get_arch", treg.get_arch)
    ref_models.test_full_configs_param_counts()


# ---------------------------------------------------------------- weights
@pytest.mark.parametrize("arch", ZOO)
def test_from_numpy_params_carries_the_reference_pytree(arch):
    cfg, params, model = _models(arch, seed=1)
    names = {n for n, _ in model.named_parameters()}
    assert names == {*params["layers"], "embed", "ln_final", "w_vocab"}
    for name, leaf in params["layers"].items():
        got = getattr(model, name).numpy()
        assert got.shape[0] == cfg.n_layers
        if cfg.alternating:  # layer 2 i + sub is the reference's [i, sub]
            for i in range(cfg.n_layers // 2):
                for sub in range(2):
                    np.testing.assert_array_equal(got[2 * i + sub], leaf[i, sub])
        else:
            np.testing.assert_array_equal(got, leaf)
    assert [model.window(l) for l in range(cfg.n_layers)] == (
        [cfg.local_window, None] * (cfg.n_layers // 2) if cfg.alternating
        else [None] * cfg.n_layers)


@pytest.mark.parametrize("arch", ZOO)
def test_from_config_shapes_and_scales(arch):
    cfg = treg.get_arch(arch).reduced()
    model = Transformer.from_config(cfg, device="cpu", seed=1)
    ref = jax.eval_shape(lambda: jtf.init_params(_ref_cfg(arch), jax.random.PRNGKey(0)))
    assert {n for n, _ in model.named_parameters()} == \
        {*ref["layers"], "embed", "ln_final", "w_vocab"}
    for name, spec in ref["layers"].items():
        want = (cfg.n_layers,) + spec.shape[len(cfg.layers_leading):]
        assert tuple(getattr(model, name).shape) == want, name
    if cfg.n_experts:
        d, f = cfg.d_model, cfg.d_ff
        for name, scale in (("router", d ** -0.5), ("w_gate_e", d ** -0.5),
                            ("w_down_e", f ** -0.5)):
            assert float(getattr(model, name).std()) == pytest.approx(scale, rel=0.15), name
    if cfg.post_norms:
        assert torch.count_nonzero(model.ln_attn_post) == torch.count_nonzero(
            model.ln_mlp_post) == 0


# ---------------------------------------------------------------- the models
@pytest.mark.parametrize("arch", ZOO)
def test_forward_logits_match_the_reference(arch):
    cfg, params, model = _models(arch, seed=2)
    toks = _tokens(cfg, 2, 24, seed=2)
    want = jtf.forward_logits(params, jnp.asarray(toks), cfg)
    got = model.forward_logits(torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if cfg.final_softcap is not None:
        assert float(got.abs().max()) < cfg.final_softcap


def _check_prefill_decode(arch, dtype, logit_tol, cache_tol, steps_=4):
    cfg, params, model = _models(arch, dtype, seed=3)
    toks = _tokens(cfg, 3, 20, seed=3)
    max_len = 32
    want, jcache = jtf.prefill_step(params, jnp.asarray(toks), cfg, max_len=max_len)
    got, cache = model.prefill_step(torch.from_numpy(toks), max_len=max_len)
    assert cache[0].shape == (cfg.n_layers, 3, max_len, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), _j(want), **logit_tol)
    for c, jc in zip(cache, jcache):
        np.testing.assert_allclose(_np(c), _flat_layers(cfg, jc), **cache_tol)
    rng = np.random.default_rng(4)
    for t in range(steps_):
        nxt = rng.integers(0, cfg.vocab, 3).astype(np.int32)
        want, jcache = jtf.decode_step(params, jcache, jnp.asarray(nxt), 20 + t, cfg)
        got, same = model.decode_step(cache, torch.from_numpy(nxt), 20 + t)
        assert same is cache
        np.testing.assert_allclose(got.numpy(), _j(want), **logit_tol)
        for c, jc in zip(cache, jcache):
            np.testing.assert_allclose(_np(c), _flat_layers(cfg, jc), **cache_tol)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_match_the_reference_float32(arch):
    _check_prefill_decode(arch, jnp.float32, F32, F32)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_prefill_and_decode_match_the_reference_bfloat16(arch):
    _check_prefill_decode(arch, jnp.bfloat16, BF16_LOGITS, BF16_CACHE)


def test_gemma2_attention_gets_its_window_and_cap():
    """Even layers attend through the window, odd ones globally, all with
    the soft-cap; a 20-token prompt is past the window, so it cuts."""
    cfg, _, model = _models("gemma2-9b", seed=5)
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw)
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        full = model.forward_logits(torch.from_numpy(_tokens(cfg, 1, 20, seed=5)))
    finally:
        ops.flash_attention = real
    assert [(kw["window"], kw["softcap"]) for kw in seen] == [(8, 50.0), (None, 50.0)]
    wide = Transformer(dataclasses.replace(model.cfg, local_window=64),
                       {n: p.data for n, p in model.named_parameters()})
    assert not torch.allclose(wide.forward_logits(
        torch.from_numpy(_tokens(cfg, 1, 20, seed=5))), full)


# ---------------------------------------------------------------- oracles
def _port_tf_mod() -> types.SimpleNamespace:
    """The reference's functional API over the port's model, for its
    oracles: ``params`` is the port's Transformer, the cache its tuple."""

    def init_params(cfg, key):
        ref_cfg = jtf.TransformerConfig(**{**dataclasses.asdict(cfg), "dtype": {
            "float32": jnp.float32, "bfloat16": jnp.bfloat16}[cfg.dtype]})
        params = jax.tree.map(np.array, jtf.init_params(ref_cfg, key))
        return Transformer.from_numpy_params(params, cfg, device="cpu")

    def forward_logits(model, tokens, cfg):
        return model.forward_logits(torch.from_numpy(np.asarray(tokens))).numpy()

    def init_cache(cfg, batch, max_len):
        return ("unallocated", batch, max_len)

    def decode_step(model, cache, tokens, cur_index, cfg):
        if cache[0] == "unallocated":
            cache = model.init_cache(*cache[1:])
        logits, cache = model.decode_step(cache, torch.from_numpy(np.asarray(tokens)),
                                          int(cur_index))
        return logits.numpy(), cache

    return types.SimpleNamespace(init_params=init_params, forward_logits=forward_logits,
                                 init_cache=init_cache, decode_step=decode_step)


@pytest.mark.parametrize("oracle", ["test_decode_matches_teacher_forcing",
                                    "test_moe_decode_matches_teacher_forcing"])
def test_the_reference_teacher_forcing_oracles_on_the_port(oracle, monkeypatch):
    monkeypatch.setattr(ref_models, "get_arch", treg.get_arch)
    monkeypatch.setattr(ref_models, "tf_mod", _port_tf_mod())
    getattr(ref_models, oracle)()


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ZOO)
def test_generate_greedy_equals_the_reference(arch):
    cfg, params, model = _models(arch, seed=6)
    prompts = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], [200]]
    want = JServeEngine(params, cfg, max_len=32).generate(prompts, max_new_tokens=10)
    got = ServeEngine(model, max_len=32).generate(prompts, max_new_tokens=10)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.n_generated, want.n_generated)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_generate_refuses_a_batch_that_breaks_the_group_rule(arch):
    _, _, model = _models(arch)
    prompts = [[1] * 30, [2] * 30, [3] * 30]  # 90 tokens: above moe_group 64, not a multiple
    with pytest.raises(ValueError, match="90 tokens"):
        ServeEngine(model, max_len=48).generate(prompts, max_new_tokens=2)
    ok = ServeEngine(model, max_len=48).generate([[1] * 32, [2] * 32], max_new_tokens=2)
    assert ok.tokens.shape == (2, 2)  # 64 tokens: one group


# ---------------------------------------------------------------- cells
def _params_of(model: Transformer, cfg) -> dict:
    """The module's weights as the reference's pytree, (L/2, 2) leaves
    when alternating."""
    top = ("embed", "ln_final", "w_vocab")
    named = {n: p.float().numpy() for n, p in model.named_parameters()}
    lead = cfg.layers_leading
    return {**{k: jnp.asarray(named[k]) for k in top},
            "layers": {k: jnp.asarray(v.reshape(lead + v.shape[1:]))
                       for k, v in named.items() if k not in top}}


@pytest.mark.parametrize("arch", ZOO)
def test_build_cell_prefill_reduced_matches_the_reference(arch):
    cell = steps.build_cell(arch, "prefill_32k", reduced=True, device="cpu", seed=2)
    (tokens,) = cell.args
    assert tokens.shape == (2, 64)
    logits, cache = cell.run()
    cfg = _ref_cfg(arch)
    assert logits.shape == (2, cfg.vocab) and cache[0].shape[:3] == (cfg.n_layers, 2, 64)
    want, _ = jtf.prefill_step(_params_of(cell.model, cfg), jnp.asarray(tokens.numpy()), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ZOO)
def test_build_cell_decode_reduced_matches_the_reference(arch):
    cell = steps.build_cell(arch, "decode_32k", reduced=True, device="cpu", seed=2)
    cache, tokens, index = cell.args
    cfg = _ref_cfg(arch)
    assert index == 63 and tokens.shape == (2,)
    assert cache[0].shape == (cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim)
    jcache = tuple(jnp.asarray(c.numpy().reshape(cfg.layers_leading + c.shape[1:]))
                   for c in cache)
    want, _ = jtf.decode_step(_params_of(cell.model, cfg), jcache,
                              jnp.asarray(tokens.numpy()), index, cfg)
    logits, _ = cell.run()
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ZOO)
def test_build_cell_train_still_raises(arch, monkeypatch):
    """The reduced train cell trains; the full-size one does not fit one
    card and raises naming its bytes, before anything is allocated."""
    cell = steps.build_cell(arch, "train_4k", reduced=True, device="cpu")
    loss, metrics = cell.run()
    assert np.isfinite(float(loss)) and float(metrics["grad_norm"]) > 0
    monkeypatch.setattr(Transformer, "from_config",
                        lambda *a, **k: pytest.fail("allocated before refusing"))
    want = f"{steps.lm_state_bytes(treg.get_arch(arch).config()):,} bytes"
    with pytest.raises(ValueError, match=want):
        steps.build_cell(arch, "train_4k", device="cpu")


def test_build_cell_cuts_and_the_group_rule():
    cell = steps.build_cell("phi3.5-moe-42b-a6.6b", "decode_32k", reduced=True, device="cpu",
                            batch=3, layers=1)
    assert cell.model.cfg.n_layers == 1 and cell.args[0][0].shape[:2] == (1, 3)
    with pytest.raises(ValueError, match="96 tokens"):  # above moe_group 64, not a multiple
        steps.build_cell("olmoe-1b-7b", "decode_32k", reduced=True, device="cpu", batch=96)
    with pytest.raises(ValueError, match="LM cells only"):
        steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu", layers=1)
