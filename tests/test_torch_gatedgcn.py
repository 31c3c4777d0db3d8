"""The port's GatedGCN against the JAX package's ``gatedgcn_apply``, on the
CPU, where ``csr_spmm`` runs as its plain twin.

The same parameters (the reference's ``gatedgcn_init``), features and
edges, padded with -1 senders and receivers and with edges on a dummy
node, go through both. Tolerances: the forward at rtol 1e-5 and atol
1e-5 x max|out|, every gradient at rtol 1e-4 and atol 1e-5 x its max|g|
(float32 sums in another order: the reference's ``segment_sum`` against a
CSR over edge ids).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gatedgcn as jcfg
from repro.configs import registry as jreg
from repro.models import gnn as jgnn
from repro_torch.configs import gatedgcn as tcfg
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models.gnn import EdgeCSR, GatedGCN, GatedGCNConfig, gatedgcn_loss
from repro_torch.train.checkpoint import flatten
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, E, D_IN, D_EDGE, N_OUT = 40, 160, 12, 4, 5


def _inputs(seed, n=N, e=E):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - 1, e)
    r = rng.integers(0, n - 1, e)
    s[-20:] = -1          # masked edges
    r[-10:] = -1          # dropped by segment_sum
    s[:12], r[:12] = n - 1, n - 1  # padding on a dummy node
    return (rng.normal(size=(n, D_IN)).astype(np.float32),
            rng.normal(size=(e, D_EDGE)).astype(np.float32), s, r,
            rng.normal(size=(n, N_OUT)).astype(np.float32))


def _models(cfg, seed=0):
    params = jgnn.gatedgcn_init(cfg, jax.random.PRNGKey(seed), D_IN, D_EDGE, N_OUT)
    np_params = jax.tree.map(np.asarray, params)
    return params, GatedGCN.from_numpy_params(np_params, cfg, device="cpu")


def _close(got, want, rtol, scaled):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scaled * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_and_every_gradient_match_the_reference(seed):
    cfg = GatedGCNConfig(n_layers=2, d_hidden=70)
    params, model = _models(cfg, seed)
    x, ef, s, r, w = _inputs(seed)

    def jloss(p):
        out = jgnn.gatedgcn_apply(p, jnp.asarray(x), jnp.asarray(ef), jnp.asarray(s),
                                  jnp.asarray(r), N, cfg)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(torch.from_numpy(x), torch.from_numpy(ef), torch.from_numpy(s),
                torch.from_numpy(r))
    _close(out.detach().numpy(), jout, 1e-5, 1e-5)
    leaves = model.leaves()
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(leaves.values()))
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    assert list(want) == list(leaves)  # the reference's leaf order
    for (path, g) in zip(leaves, grads):
        _close(g.numpy(), want[path], 1e-4, 1e-5)


def test_edge_csr_aggregation_equals_index_add():
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.integers(-1, N, E))
    r[:30] = N - 1  # one heavy row
    m = torch.from_numpy(rng.normal(size=(E, 70)).astype(np.float32)).requires_grad_(True)
    csr = EdgeCSR.from_receivers(r, N)
    keep = r >= 0
    want = torch.zeros(N, 70, dtype=torch.float64).index_add_(0, r[keep], m.double()[keep])
    got = csr.agg(m)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)
    g = torch.from_numpy(rng.normal(size=(N, 70)).astype(np.float32))
    (dm,) = torch.autograd.grad((got * g).sum(), m)
    want_dm = torch.where(keep[:, None], g[r.clamp(min=0)], 0.0)
    assert torch.equal(dm, want_dm)  # one entry a row: the gradient is a copy
    assert csr.fwd.col.tolist() == [e for v in range(N)
                                    for e in torch.nonzero(r == v).reshape(-1).tolist()]
    assert csr.bwd.row_lengths().tolist() == keep.long().tolist()


def test_aggregations_go_through_csr_spmm(monkeypatch):
    cfg = GatedGCNConfig(n_layers=3, d_hidden=8)
    _, model = _models(cfg)
    x, ef, s, r, _ = _inputs(5)
    calls = []
    real = ops.csr_spmm
    monkeypatch.setattr(ops, "csr_spmm", lambda x, a: calls.append(a.n_rows) or real(x, a))
    out = model(*(torch.from_numpy(a) for a in (x, ef, s, r)))
    assert calls == [N] * 6  # the gate's denominator and the messages, each layer
    torch.autograd.grad(out.sum(), list(model.leaves().values()))
    assert calls[6:] == [E] * 6  # the same kernel on the transposed CSR


def test_loss_matches_the_examples_loss():
    cfg = GatedGCNConfig(n_layers=2, d_hidden=16)
    params, model = _models(cfg)
    x, ef, s, r, _ = _inputs(7)
    rng = np.random.default_rng(7)
    y = rng.integers(0, N_OUT, N)
    mask = rng.random(N) < 0.3
    logits = jgnn.gatedgcn_apply(params, x, ef, s, r, N, cfg)
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1)[:, 0]
    wm = jnp.asarray(mask, jnp.float32)
    want = float((nll * wm).sum() / jnp.maximum(wm.sum(), 1))
    batch = {k: torch.from_numpy(v) for k, v in
             dict(x=x, ef=ef, senders=s, receivers=r, y=y, mask=mask).items()}
    batch["csr"] = EdgeCSR.from_receivers(batch["receivers"], N)
    assert float(gatedgcn_loss(model, batch).detach()) == pytest.approx(want, rel=1e-5)


def test_from_config_shapes_and_leaf_paths():
    cfg = GatedGCNConfig(n_layers=12, d_hidden=6)
    model = GatedGCN.from_config(cfg, D_IN, D_EDGE, N_OUT, device="cpu", seed=1)
    params = jgnn.gatedgcn_init(cfg, jax.random.PRNGKey(0), D_IN, D_EDGE, N_OUT)
    want = flatten(jax.tree.map(np.asarray, params))
    got = model.leaves()
    assert [p for p, _ in want] == list(got)
    for p, w in want:
        assert tuple(got[p].shape) == w.shape and got[p].requires_grad, p
    assert torch.equal(got["layers/3/ln_h/0"], torch.ones(6))
    assert torch.equal(got["layers/3/ln_h/1"], torch.zeros(6))
    other = GatedGCN.from_config(cfg, D_IN, D_EDGE, N_OUT, device="cpu", seed=2)
    assert not torch.equal(got["layers/0/A/w"], other.leaves()["layers/0/A/w"])


def test_registry_matches_the_reference():
    arch, ref_arch = treg.get_arch("gatedgcn"), jreg.get_arch("gatedgcn")
    assert (arch.family, set(arch.shapes)) == (ref_arch.family, set(ref_arch.shapes))
    for name, shape in arch.shapes.items():
        assert (shape.kind, shape.params) == (ref_arch.shapes[name].kind,
                                              ref_arch.shapes[name].params)
    assert dataclasses.asdict(arch.config()) == dataclasses.asdict(ref_arch.config())
    assert dataclasses.asdict(arch.reduced()) == dataclasses.asdict(ref_arch.reduced())
    assert dataclasses.asdict(tcfg.config()) == dataclasses.asdict(jcfg.config())
