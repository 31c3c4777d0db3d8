"""LM training on the port against the JAX package, on the CPU.

``Transformer.forward_loss`` and its gradients against
``jax.value_and_grad(repro.models.transformer.forward_loss)`` for the five
reduced configs (and qwen2 at S = 1,024, which takes the reference's
``_flash_jnp`` branch); ``chunked_cross_entropy`` against the reference's
with ignored (-100) targets and a soft-cap; one whole ``train_4k`` step
(two micro-batches accumulated in float32, AdamW, the schedule) against
the reference cell's jitted ``train_step``; the MoE's float32-summing
product's gradient (``BmmF32``); the training script ``repro_torch.launch.train``'s
checkpoints against the reference's bytes and its restore. Parameters are
the reference's ``init_params`` pytree with its zero norms and biases
replaced by numpy draws; tokens are numpy draws.

Tolerances (float32): the loss at rtol 1e-5; every leaf's gradient within
1e-4 * its max|g| (products and sums in another order through a dozen
matmuls, remat and the chunked loss); a step's parameters, master copy and
moments within 1e-4 * the leaf's max (AdamW divides by sqrt(v), which
magnifies a gradient's relative error where g is small).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import BmmF32, Transformer, _bmm_f32
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_transformer import _params, _port_cfg, _tokens

ARCHS = ["qwen2-1.5b", "gemma2-9b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "yi-34b"]
UNFIT = {"gemma2-9b": "203,184,199,680", "olmoe-1b-7b": "138,381,926,400",
         "phi3.5-moe-42b-a6.6b": "837,450,547,200", "yi-34b": "687,778,344,960"}
LOSS_RTOL = 1e-5
GRAD_SCALED = 1e-4


def _ref_cfg(arch, **kw):
    return dataclasses.replace(jreg.get_arch(arch).reduced(), **kw)


def _model(cfg, params):
    return Transformer.from_numpy_params(params, _port_cfg(cfg), device="cpu").requires_grad_()


def _paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): np.asarray(v)
            for kp, v in flat}


def _leaf_close(got: torch.Tensor, want, scaled=GRAD_SCALED, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=scaled * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _hold_loss_and_grads(cfg, params, tokens, targets):
    want_loss, want_g = jax.value_and_grad(jtf.forward_loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), jnp.asarray(targets), cfg)
    loss, grads = steps.lm_grads(_model(cfg, params), torch.from_numpy(tokens),
                                 torch.from_numpy(targets), 1)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    want_g = _paths(want_g)
    assert list(grads) == list(want_g)  # the reference's paths, in its leaf order
    for path, g in grads.items():
        _leaf_close(g, want_g[path], what=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_its_gradients_equal_the_reference(arch):
    cfg = _ref_cfg(arch)
    params = _params(cfg, seed=1)
    tokens = _tokens(cfg, 2, 32, seed=2)
    targets = _tokens(cfg, 2, 32, seed=3)
    targets[0, :5] = -100  # ignored positions
    _hold_loss_and_grads(cfg, params, tokens, targets)


def test_forward_loss_at_a_length_that_takes_the_reference_flash_branch():
    cfg = _ref_cfg("qwen2-1.5b", n_layers=2, ce_chunk=256)
    assert 1024 > cfg.attn_chunk_q and 1024 % cfg.attn_chunk_q == 0
    _hold_loss_and_grads(cfg, _params(cfg, seed=4), _tokens(cfg, 1, 1024, seed=5),
                         _tokens(cfg, 1, 1024, seed=6))


def test_forward_loss_without_remat_is_the_same():
    cfg = _ref_cfg("gemma2-9b")
    params = _params(cfg, seed=7)
    tok, tgt = (torch.from_numpy(_tokens(cfg, 2, 16, seed=s)) for s in (8, 9))
    a = _model(cfg, params)
    b = Transformer.from_numpy_params(params, _port_cfg(dataclasses.replace(cfg, remat="none")),
                                      device="cpu").requires_grad_()
    la, ga = steps.lm_grads(a, tok, tgt, 1)
    lb, gb = steps.lm_grads(b, tok, tgt, 1)
    assert torch.equal(la, lb) and all(torch.equal(ga[k], gb[k]) for k in ga)
    with pytest.raises(ValueError, match="remat"):
        Transformer.from_numpy_params(params, _port_cfg(dataclasses.replace(cfg, remat="dots")),
                                      device="cpu").forward_loss(tok, tgt)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_chunked_cross_entropy_equals_the_reference(softcap):
    rng = np.random.default_rng(10)
    h = rng.normal(size=(3, 32, 12)).astype(np.float32)
    w = rng.normal(size=(12, 50)).astype(np.float32)
    t = rng.integers(0, 50, (3, 32)).astype(np.int32)
    t[1, 3:20] = -100
    t[2, :] = -100

    def jloss(h_, w_):
        return jcommon.chunked_cross_entropy(h_, w_, jnp.asarray(t), chunk=8, softcap=softcap)

    want, (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = tcommon.chunked_cross_entropy(th, tw, torch.from_numpy(t), chunk=8, softcap=softcap)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    _leaf_close(th.grad, gh, scaled=1e-5)
    _leaf_close(tw.grad, gw, scaled=1e-5)
    # every target ignored: loss 0 and zero gradients, as loss_sum / max(count, 1)
    none = torch.full((3, 32), -100)
    th.grad = None
    zero = tcommon.chunked_cross_entropy(th, tw, none, chunk=8, softcap=softcap)
    zero.backward()
    assert float(zero) == 0.0 and not th.grad.any()
    with pytest.raises(ValueError, match="multiple"):
        tcommon.chunked_cross_entropy(th, tw, torch.from_numpy(t), chunk=12)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b", "olmoe-1b-7b"])
def test_a_train_4k_step_equals_the_reference_cell(arch, monkeypatch):
    """Two micro-batches: the reference cell at its full config's accumulation
    path, its config overridden to the reduced one and GRAD_ACCUM to 2."""
    monkeypatch.setitem(jsteps.GRAD_ACCUM, arch, 2)
    cfg = _ref_cfg(arch)
    jcell = jsteps.build_cell(arch, "train_4k", reduced=False,
                              overrides=dataclasses.asdict(cfg))
    params = _params(cfg, seed=11)
    tokens, targets = _tokens(cfg, 4, 32, seed=12), _tokens(cfg, 4, 32, seed=13)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt_state = jopt.init_opt_state(jparams, jopt.AdamWConfig())
    new_p, new_opt, want_loss, want_m = jax.jit(jcell.fn)(
        jparams, jopt_state, jnp.asarray(tokens), jnp.asarray(targets))

    model = _model(cfg, params)
    opt_state = topt.init_opt_state(model.leaves(), topt.AdamWConfig())
    loss, metrics = steps.lm_train_step(model, opt_state, torch.from_numpy(tokens),
                                        torch.from_numpy(targets), topt.AdamWConfig(), n_micro=2)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=1e-4)
    assert float(metrics["lr"]) == pytest.approx(float(want_m["lr"]), rel=1e-6)
    assert int(opt_state["step"]) == int(new_opt["step"]) == 1
    want_p = _paths(new_p)
    for path, p in model.leaves().items():
        _leaf_close(p, want_p[path], what=path)
    for name in ("master", "m", "v"):
        want = _paths(new_opt[name])
        for path, t in opt_state[name].items():
            _leaf_close(t, want[path], what=f"{name}/{path}")


def test_lm_grads_checks_the_split():
    cfg = _ref_cfg("qwen2-1.5b")
    model = _model(cfg, _params(cfg))
    tok = torch.from_numpy(_tokens(cfg, 3, 16))
    with pytest.raises(ValueError, match="micro-batches"):
        steps.lm_grads(model, tok, tok, 2)


def test_the_bf16_float32_product_has_its_gradient():
    rng = np.random.default_rng(14)
    a32 = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    b32 = torch.from_numpy(rng.normal(size=(3, 16, 7)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 5, 7)).astype(np.float32))
    for dt in (torch.bfloat16, torch.float32):
        a = a32.to(dt).requires_grad_()
        b = b32.to(dt).requires_grad_()
        out = _bmm_f32(a, b)
        assert out.dtype == torch.float32
        out.backward(g)
        # the float32 product's gradient, each rounded once to its operand's dtype
        af, bf = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
        torch.bmm(af, bf).backward(g)
        assert a.grad.dtype == dt and torch.equal(a.grad, af.grad.to(dt))
        assert b.grad.dtype == dt and torch.equal(b.grad, bf.grad.to(dt))
    with torch.no_grad():  # serving records nothing
        assert _bmm_f32(a, b).grad_fn is None
    assert isinstance(_bmm_f32(a, b).grad_fn, BmmF32._backward_cls)


def test_leaves_are_the_reference_paths_and_views():
    cfg = _ref_cfg("gemma2-9b")
    params = _params(cfg, seed=15)
    model = _model(cfg, params)
    leaves = model.leaves()
    want = _paths(params)
    assert list(leaves) == list(want)
    for path, t in leaves.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[path])
    with torch.no_grad():  # a leaf is a view: updating it updates the model
        leaves["layers/wq"][0, 1].fill_(3.0)  # the reference's [i, sub] is layer 2 i + sub
    assert bool((model.wq[1] == 3.0).all()) and not bool((model.wq[0] == 3.0).any())


# ---------------------------------------------------------------- cells
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_cells_train(arch):
    cell = steps.build_cell(arch, "train_4k", reduced=True, device="cpu", seed=1)
    model, opt_state, tokens, targets = cell.args
    assert tokens.shape == targets.shape == (2, 64) and int(tokens.max()) < model.cfg.vocab
    before = {k: v.detach().clone() for k, v in model.leaves().items()}
    losses = [float(cell.run()[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and int(opt_state["step"]) == 3
    assert all(not torch.equal(before[k], v) for k, v in model.leaves().items())


@pytest.mark.parametrize("arch", sorted(UNFIT))
def test_full_size_train_cells_that_do_not_fit_refuse_with_their_bytes(arch, monkeypatch):
    monkeypatch.setattr(Transformer, "from_config",
                        lambda *a, **k: pytest.fail("allocated before refusing"))
    with pytest.raises(ValueError, match=UNFIT[arch]):
        steps.build_cell(arch, "train_4k", device="cpu")


def test_train_cell_batch_must_split_into_micro_batches(monkeypatch):
    monkeypatch.setattr(Transformer, "from_config",
                        lambda *a, **k: pytest.fail("allocated before refusing"))
    with pytest.raises(ValueError, match="4 micro-batches"):
        steps.build_cell("qwen2-1.5b", "train_4k", device="cpu", batch=6)
    assert steps.lm_state_bytes(jreg.get_arch("qwen2-1.5b").config()) == 20 * 1_777_088_000


# ---------------------------------------------------------------- the training script
def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def test_checkpoint_files_equal_the_reference_with_alternating_leaves(tmp_path):
    cfg = _ref_cfg("gemma2-9b", dtype=jnp.bfloat16)
    params = _params(cfg, seed=16)
    model = _model(cfg, params)
    opt_state = topt.init_opt_state(model.leaves(), topt.AdamWConfig())
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=17))
    steps.lm_train_step(model, opt_state, tok, tok, topt.AdamWConfig(), n_micro=1)
    tstate = {"params": model.leaves(), "opt_state": opt_state}
    flat = dict(ck.flatten(tstate))
    jstate = jax.tree.map(jnp.asarray, ck._nest({k: (v.detach().float().numpy().astype(
        jnp.bfloat16) if v.dtype == torch.bfloat16 else v.detach().numpy())
        for k, v in flat.items()}))
    r_path = jck.save_checkpoint(str(tmp_path / "ref"), 1, jstate)
    p_path = ck.save_checkpoint(str(tmp_path / "port"), 1, tstate)
    assert _files(r_path) == _files(p_path)
    r_man = json.load(open(os.path.join(r_path, "manifest.json")))
    p_man = json.load(open(os.path.join(p_path, "manifest.json")))
    r_man.pop("treedef")
    assert r_man == p_man
    wq = next(rec for rec in p_man["leaves"] if rec["path"] == "params/layers/wq")
    assert wq["shape"][:2] == [1, 2] and wq["dtype"] == "bfloat16"


def test_the_training_script_saves_restores_and_continues(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--arch", "gemma2-9b", "--reduced", "--steps", "2", "--ckpt", d, "--device", "cpu"]
    first = ttrain.main(argv)
    assert first["start_step"] == 0 and len(first["losses"]) == 2
    saved, step = ck.restore_checkpoint(d, device="cpu")
    assert step == 2 and ck.latest_step(d) == 2
    second = ttrain.main(argv)
    assert second["start_step"] == 2 and ck.latest_step(d) == 4
    out = capsys.readouterr().out
    assert "restored step 2; data offset 4" in out and "step 3: loss=" in out
    # the restored state is the saved one: the second run's state at step 2
    cell = steps.build_cell("gemma2-9b", "train_4k", reduced=True, device="cpu")
    state = {"params": cell.model.leaves(), "opt_state": cell.args[1]}
    assert ttrain.restore_into(state, d) == 4
    again, _ = ck.restore_checkpoint(d, device="cpu")
    for (pa, a), (pb, b) in zip(ck.flatten(again), ck.flatten(state)):
        assert pa == pb and torch.equal(a, b.detach())
    assert [p for p, _ in ck.flatten(saved)] == [p for p, _ in ck.flatten(state)]


def test_materialize_is_the_reference_formula():
    cell = steps.build_cell("qwen2-1.5b", "train_4k", reduced=True, device="cpu")
    leaves, opt_state = cell.model.leaves(), cell.args[1]
    ttrain.materialize(leaves, opt_state, torch.Generator().manual_seed(0))
    for path, t in leaves.items():
        fan = t.shape[0] if t.dim() else 1
        want = 0.02 / max(fan, 1) ** 0.5 + 0.01
        assert float(t.detach().float().std()) == pytest.approx(want, rel=0.3), path
    assert all(not t.any() for _, t in ck.flatten(opt_state))
