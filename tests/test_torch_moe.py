"""The port's MoE FFN (``repro_torch.models.transformer.moe_ffn``) against
the reference's ``_moe_ffn`` alone, on identical inputs, on the CPU.

The routing must equal the reference's exactly: the router logits bit for
bit in bfloat16 (asserted first, so that a routing failure says where it
comes from), the experts chosen (``jax.lax.top_k``'s, read from the
reference's own call), each slot's position (counted here in plain Python
over the reference's choice, in flat (token, slot) order) and so the
drops. Cases: random routers, every token routed to one expert (drops),
two identical router columns (ties go to the lower index), groups smaller
than the token count, the decode's group of the whole batch, and token
counts that break the group rule (``ValueError``; the reference's reshape
fails on them too).

XLA's CPU backend has no bfloat16 x bfloat16 -> float32 dot for the
reference's expert einsum (``necd,edf->necf``), so in bfloat16 the
reference runs with the operands of its float32-accumulating einsums cast
to float32: the same products, summed in float32.

Tolerances: float32 y at rtol/atol 1e-5, aux at rtol 1e-5 (summation
order). bfloat16 y at rtol 2**-7, atol 2**-10: one bfloat16 step, since
the float32 sums of the expert products and of the k weighted slots run in
another order and may round one step apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.models import transformer as ttf
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_transformer import _port_cfg

MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
Y_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2 ** -7, atol=2 ** -10)}


class _Proxy:
    """A module with some attributes replaced."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._base, name)


def _f32_einsum(spec, *ops, preferred_element_type=None, **kw):
    if preferred_element_type == jnp.float32:
        ops = [o.astype(jnp.float32) for o in ops]
    return jnp.einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)


def _reference(x, p, cfg, monkeypatch):
    """The reference's (y, aux) and the experts its top_k chose."""
    seen = []

    def top_k(a, k):
        out = jax.lax.top_k(a, k)
        seen.append(out[1])
        return out

    monkeypatch.setattr(jtf, "jax", _Proxy(jax, lax=_Proxy(jax.lax, top_k=top_k)))
    monkeypatch.setattr(jtf, "jnp", _Proxy(jnp, einsum=_f32_einsum))
    y, aux = jtf._moe_ffn(x, p, cfg)
    monkeypatch.undo()
    return np.asarray(y.astype(jnp.float32)), float(aux), np.asarray(seen[0])


def _positions(idx: np.ndarray) -> np.ndarray:
    """Each slot's count of earlier slots of its group with its expert, in
    flat (token, slot) order."""
    pos = np.zeros_like(idx)
    for i, group in enumerate(idx):
        taken = {}
        for t, slots in enumerate(group):
            for j, e in enumerate(slots):
                pos[i, t, j] = taken.get(int(e), 0)
                taken[int(e)] = pos[i, t, j] + 1
    return pos


def _weights(cfg, rng) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {"router": rng.normal(size=(d, e)) * d ** -0.5,
            "w_gate_e": rng.normal(size=(e, d, f)) * d ** -0.5,
            "w_up_e": rng.normal(size=(e, d, f)) * d ** -0.5,
            "w_down_e": rng.normal(size=(e, f, d)) * f ** -0.5}


def _hold(arch, dtype, x, w, monkeypatch, **cfg_over) -> dict:
    """Run both on x (B, S, d) and the weights w (numpy), rounded once to
    the dtype; assert logits, routing, y and aux equal. Returns the
    routing."""
    jdt, tdt = DTYPES[dtype]
    cfg = dataclasses.replace(jreg.get_arch(arch).reduced(), dtype=jdt, **cfg_over)
    pcfg = _port_cfg(cfg)
    jx, jw = jnp.asarray(x, jdt), {k: jnp.asarray(v, jdt) for k, v in w.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt) for k, v in jw.items()}
    B, S, d = x.shape
    g = min(cfg.moe_group, B * S)
    c = max(int(cfg.top_k * g / cfg.n_experts * cfg.capacity_factor), cfg.top_k)
    assert ttf.moe_group_size(pcfg, B * S) == g and ttf.moe_capacity(pcfg, g) == c
    # the router logits first, bit for bit in bfloat16
    j_logits = np.asarray(jnp.einsum("ngd,de->nge", jx.reshape(-1, g, d), jw["router"])
                          .astype(jnp.float32))
    t_logits = ttf.moe_logits(tx.reshape(-1, g, d), tw["router"]).numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(t_logits, j_logits)
    y, aux, idx = _reference(jx, jw, cfg, monkeypatch)
    _, t_idx = ttf.moe_route(torch.from_numpy(t_logits), cfg.top_k)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(ttf.moe_positions(t_idx, cfg.n_experts).numpy(),
                                  _positions(idx))
    t_y, t_aux = ttf.moe_ffn(tx, tw["router"], tw["w_gate_e"], tw["w_up_e"], tw["w_down_e"],
                             pcfg)
    assert t_y.shape == x.shape and t_y.dtype == tdt and t_aux.dtype == torch.float32
    np.testing.assert_allclose(t_y.float().numpy(), y, **Y_TOL[dtype])
    assert float(t_aux) == pytest.approx(aux, rel=1e-5)
    return {"idx": idx, "keep": _positions(idx) < c, "capacity": c}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_the_reference(arch, dtype, monkeypatch):
    cfg = jreg.get_arch(arch).reduced()
    rng = np.random.default_rng(1)
    _hold(arch, dtype, rng.normal(size=(2, 32, cfg.d_model)), _weights(cfg, rng), monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_token_to_one_expert_drops_the_same_slots(dtype, monkeypatch):
    cfg = jreg.get_arch("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(2)
    x = np.abs(rng.normal(size=(1, 64, cfg.d_model)))
    w = _weights(cfg, rng)
    w["router"][:, 3] = 1.0  # every token's first choice: expert 3
    r = _hold("olmoe-1b-7b", dtype, x, w, monkeypatch)
    assert (r["idx"][..., 0] == 3).all()
    assert r["keep"][..., 0].sum() == r["capacity"] < 64  # the rest of its slots dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_go_to_the_lower_index(dtype, monkeypatch):
    cfg = jreg.get_arch("phi3.5-moe-42b-a6.6b").reduced()  # 4 experts, top 2
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(size=(2, 16, cfg.d_model)))
    w = _weights(cfg, rng)
    v = np.abs(rng.normal(size=cfg.d_model))
    w["router"][:] = np.stack([v, -v, 0.5 * v, 0.5 * v], axis=1)  # 0 first, then 2 = 3
    r = _hold("phi3.5-moe-42b-a6.6b", dtype, x, w, monkeypatch)
    assert (r["idx"] == [0, 2]).all()


def test_groups_smaller_than_the_tokens(monkeypatch):
    cfg = jreg.get_arch("olmoe-1b-7b").reduced()  # moe_group 64: 4 groups of 64
    rng = np.random.default_rng(4)
    r = _hold("olmoe-1b-7b", "float32", rng.normal(size=(2, 128, cfg.d_model)),
              _weights(cfg, rng), monkeypatch, capacity_factor=0.75)
    assert r["idx"].shape[:2] == (4, 64) and not r["keep"].all()


def test_a_decode_step_groups_the_whole_batch(monkeypatch):
    cfg = jreg.get_arch("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(5)
    r = _hold("olmoe-1b-7b", "float32", rng.normal(size=(12, 1, cfg.d_model)),
              _weights(cfg, rng), monkeypatch)
    assert r["idx"].shape[:2] == (1, 12) and r["capacity"] == max(int(2 * 12 / 8 * 1.25), 2)


@pytest.mark.parametrize("shape", [(3, 30), (1, 65), (130, 1)])
def test_token_counts_that_break_the_group_rule_raise(shape):
    ref_cfg = jreg.get_arch("olmoe-1b-7b").reduced()
    cfg = _port_cfg(ref_cfg)
    rng = np.random.default_rng(6)
    w = _weights(ref_cfg, rng)
    x = rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)
    with pytest.raises(TypeError):  # the reference's reshape into groups fails
        jtf._moe_ffn(jnp.asarray(x), {k: jnp.asarray(v, jnp.float32) for k, v in w.items()},
                     ref_cfg)
    tw = {k: torch.from_numpy(v).float() for k, v in w.items()}
    with pytest.raises(ValueError, match=f"{shape[0] * shape[1]} tokens"):
        ttf.moe_ffn(torch.from_numpy(x), *tw.values(), cfg)
