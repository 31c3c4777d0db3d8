"""The port's MeshGraphNet against the JAX package's ``meshgraphnet_apply``,
on the CPU, where ``csr_spmm`` runs as its plain twin.

The same parameters (the reference's ``meshgraphnet_init``), node and
edge features and edges, padded with -1 senders and receivers, go
through both. Tolerances: the forward at rtol 1e-5 and atol 1e-5; the
loss of the reference cell's ``loss_fn`` at rtol 1e-5 and every gradient
within 1e-4 x its leaf's max|g| (float32 sums in another order: the
reference's ``segment_sum`` against a CSR over edge ids).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import meshgraphnet as jcfg
from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import gnn as jgnn
from repro_torch.configs import meshgraphnet as tcfg
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models.gnn import EdgeCSR, MeshGraphNet, gnn_loss
from repro_torch.train.checkpoint import flatten
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, E, D_NODE, D_EDGE, D_OUT = 40, 160, 12, 8, 3


def _inputs(seed, n=N, e=E, d_node=D_NODE):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    s[:3] = r[:3]                 # self loops
    s[-20:] = -1                  # masked edges ...
    r[-12:] = -1                  # ... and edges -1 at both ends, as a padded batch's
    return (rng.normal(size=(n, d_node)).astype(np.float32),
            rng.normal(size=(e, D_EDGE)).astype(np.float32), s, r)


def _models(cfg, seed=0, d_node=D_NODE):
    params = jgnn.meshgraphnet_init(cfg, jax.random.PRNGKey(seed), d_node, D_EDGE, D_OUT)
    return params, MeshGraphNet.from_numpy_params(jax.tree.map(np.asarray, params), cfg,
                                                  device="cpu")


def _ref_loss_fn():
    """The reference GNN cell's own ``loss_fn`` for reduced meshgraphnet at
    minibatch_lg (256 nodes, 256 edges, 16 features)."""
    fn = jsteps.build_cell("meshgraphnet", "minibatch_lg", reduced=True).fn
    free = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return free["loss_fn"]


def test_config_and_registry_match_the_reference():
    assert dataclasses.asdict(tcfg.config()) == dataclasses.asdict(jcfg.config())
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    arch, ref_arch = treg.get_arch("meshgraphnet"), jreg.get_arch("meshgraphnet")
    assert (arch.family, set(arch.shapes)) == (ref_arch.family, set(ref_arch.shapes))
    for name, shape in arch.shapes.items():
        assert (shape.kind, shape.params) == (ref_arch.shapes[name].kind,
                                              ref_arch.shapes[name].params)
    assert dataclasses.asdict(arch.config()) == dataclasses.asdict(ref_arch.config())


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_meshgraphnet_apply(which, seed):
    cfg = getattr(jcfg, which)()
    params, model = _models(getattr(tcfg, which)(), seed)
    x, ef, s, r = _inputs(seed)
    want = jax.jit(lambda p: jgnn.meshgraphnet_apply(p, x, ef, s, r, N, cfg))(params)
    got = model(*(torch.from_numpy(a) for a in (x, ef, s, r)))
    assert got.shape == (N, D_OUT)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_the_reference_loss_fn(masked):
    cfg = tcfg.reduced()
    n = e = 256
    params, model = _models(cfg, 2, d_node=16)
    x, ef, s, r = _inputs(3 + masked, n, e, 16)
    rng = np.random.default_rng(5)
    b = {"x": x, "ef": ef, "senders": s.astype(np.int32), "receivers": r.astype(np.int32),
         "y": rng.normal(size=(n, D_OUT)).astype(np.float32)}
    if masked:
        b["seed_mask"] = rng.random(n) < 0.3
    loss, grads = jax.jit(jax.value_and_grad(_ref_loss_fn()))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    batch["csr"] = EdgeCSR.from_receivers(batch["receivers"], n)
    leaves = model.leaves()
    got = gnn_loss(model, batch)
    got_grads = torch.autograd.grad(got, list(leaves.values()))
    assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
    want = dict(flatten(jax.tree.map(np.asarray, grads)))
    assert list(want) == list(leaves)
    for path, g in zip(leaves, got_grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_from_numpy_params_round_trips_in_leaf_order():
    cfg = tcfg.reduced()
    params, model = _models(cfg, 4)
    want = flatten(jax.tree.map(np.asarray, params))
    got = model.leaves()
    assert [p for p, _ in want] == list(got)
    assert list(got)[:2] == ["blocks/0/edge_mlp/0/b", "blocks/0/edge_mlp/0/w"]
    assert list(got)[-6:] == [f"enc_node/{j}/{k}" for j in range(3) for k in ("b", "w")]
    for p, w in want:
        np.testing.assert_array_equal(got[p].detach().numpy(), w, err_msg=p)


def test_from_config_shapes_and_trainable_weights():
    cfg = tcfg.config()
    model = MeshGraphNet.from_config(cfg, 602, D_EDGE, D_OUT, device="cpu", seed=3)
    ref = jax.eval_shape(lambda: jgnn.meshgraphnet_init(jcfg.config(), jax.random.PRNGKey(0),
                                                        602, D_EDGE, D_OUT))
    want = flatten(ref)
    got = model.leaves()
    assert [p for p, _ in want] == list(got)
    for p, w in want:
        assert tuple(got[p].shape) == w.shape and got[p].requires_grad, p
    assert len(got) == 2 * 3 * (2 * cfg.n_layers + 3)
    w = got["blocks/0/edge_mlp/0/w"].detach()
    assert w.shape == (384, 128) and float(w.std()) == pytest.approx(384 ** -0.5, rel=0.05)
    assert float(got["dec/2/b"].detach().abs().max()) == 0.0
    other = MeshGraphNet.from_config(cfg, 602, D_EDGE, D_OUT, device="cpu", seed=4)
    assert not torch.equal(w, other.leaves()["blocks/0/edge_mlp/0/w"])


def test_one_aggregation_a_block_goes_through_csr_spmm(monkeypatch):
    cfg = tcfg.reduced()
    _, model = _models(cfg)
    x, ef, s, r = _inputs(6)
    calls = []
    real = ops.csr_spmm
    monkeypatch.setattr(ops, "csr_spmm", lambda x, a: calls.append(tuple(x.shape)) or real(x, a))
    out = model(*(torch.from_numpy(a) for a in (x, ef, s, r)))
    assert calls == [(E, cfg.d_hidden)] * cfg.n_layers  # edges into nodes, 32 wide
    torch.autograd.grad(out.sum(), list(model.leaves().values()))
    assert calls[cfg.n_layers:] == [(N, cfg.d_hidden)] * cfg.n_layers  # the transposed CSR
