"""The port's NequIP against the JAX package's ``nequip_apply``, on the
CPU, where ``csr_spmm`` runs as its plain twin.

The same parameters (the reference's ``nequip_init``), species, positions
and edges go through both, with a self pair (rel = 0: the 1e-12 inside
the norm, ``maximum(r, 1e-6)`` and the envelope's clip) and padded edges
(-1 at one or both ends). Tolerances: the forward at rtol 1e-5 and atol
1e-5; the loss of the reference cell's ``loss_fn`` at rtol 1e-5 and
every gradient within 1e-4 x its leaf's max|g|; the reference's own E(3)
property (``tests/test_models.py``) on the port at rtol and atol 1e-4,
with a shear that must break it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import nequip as jcfg
from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import gnn as jgnn
from repro_torch.configs import nequip as tcfg
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn import EdgeCSR, NequIP, gnn_loss
from repro_torch.train.checkpoint import flatten
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, E, SPECIES = 30, 120, 64


def _inputs(seed, n=N, e=E):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    s[:2] = r[:2]                 # self pairs: rel = 0
    s[-16:] = -1                  # masked edges ...
    r[-8:] = -1                   # ... and edges -1 at both ends, as a padded batch's
    pos = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)  # some pairs past 5 A
    return rng.integers(0, SPECIES, n), pos, s, r


def _models(cfg, seed=0):
    params = jgnn.nequip_init(cfg, jax.random.PRNGKey(seed), SPECIES)
    return params, NequIP.from_numpy_params(jax.tree.map(np.asarray, params), cfg,
                                            device="cpu")


def _ref_loss_fn():
    """The reference GNN cell's own ``loss_fn`` for reduced nequip at
    minibatch_lg (256 nodes, 256 edges)."""
    fn = jsteps.build_cell("nequip", "minibatch_lg", reduced=True).fn
    free = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return free["loss_fn"]


def test_config_and_registry_match_the_reference():
    assert dataclasses.asdict(tcfg.config()) == dataclasses.asdict(jcfg.config())
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    arch, ref_arch = treg.get_arch("nequip"), jreg.get_arch("nequip")
    assert (arch.family, set(arch.shapes)) == (ref_arch.family, set(ref_arch.shapes))
    assert dataclasses.asdict(arch.config()) == dataclasses.asdict(ref_arch.config())


def test_radial_basis_and_traceless_part_match_the_reference():
    cfg = tcfg.config()
    r = np.array([0.0, 1e-12, 1e-6, 0.3, 2.5, 4.999, 5.0, 7.5], np.float32)
    np.testing.assert_allclose(tgnn._rbf(torch.from_numpy(r), cfg).numpy(),
                               np.asarray(jgnn._rbf(jnp.asarray(r), jcfg.config())),
                               rtol=1e-5, atol=1e-5)
    m = np.random.default_rng(0).normal(size=(5, 4, 3, 3)).astype(np.float32)
    got = tgnn._sym_traceless(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgnn._sym_traceless(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.trace(got, axis1=-2, axis2=-1), 0.0, atol=1e-6)


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_nequip_apply(which, seed):
    cfg = getattr(jcfg, which)()
    params, model = _models(getattr(tcfg, which)(), seed)
    species, pos, s, r = _inputs(seed)
    args = tuple(jnp.asarray(a) for a in (species, pos, s, r))
    want = jax.jit(lambda p: jgnn.nequip_apply(p, *args, N, cfg))(params)
    got = model(*(torch.from_numpy(a) for a in (species, pos, s, r)))
    assert got.shape == (N, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_the_reference_loss_fn(masked):
    cfg = tcfg.reduced()
    n = e = 256
    params, model = _models(cfg, 2)
    species, pos, s, r = _inputs(3 + masked, n, e)
    rng = np.random.default_rng(5)
    b = {"species": species.astype(np.int32), "pos": pos, "senders": s.astype(np.int32),
         "receivers": r.astype(np.int32), "y": rng.normal(size=(n, 1)).astype(np.float32)}
    if masked:
        b["seed_mask"] = rng.random(n) < 0.3
    loss, grads = jax.jit(jax.value_and_grad(_ref_loss_fn()))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    batch["species"] = batch["species"].long()
    batch["csr"] = EdgeCSR.from_receivers(batch["receivers"], n)
    leaves = model.leaves()
    got = gnn_loss(model, batch)
    got_grads = torch.autograd.grad(got, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
    want = dict(flatten(jax.tree.map(np.asarray, grads)))
    assert list(want) == list(leaves)
    for path, g in zip(leaves, got_grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)
    # the last layer's vector and tensor mixes reach no output: zero in both
    last = cfg.n_layers - 1
    for k in ("self1", "self2"):
        assert not want[f"layers/{last}/{k}"].any()


def test_from_numpy_params_round_trips_in_leaf_order():
    params, model = _models(tcfg.config(), 4)
    want = flatten(jax.tree.map(np.asarray, params))
    got = model.leaves()
    assert [p for p, _ in want] == list(got)
    assert list(got)[:3] == ["embed", "layers/0/mix0", "layers/0/rad0/0/b"]
    assert list(got)[-4:] == ["out/0/b", "out/0/w", "out/1/b", "out/1/w"]
    for p, w in want:
        np.testing.assert_array_equal(got[p].detach().numpy(), w, err_msg=p)


def test_from_config_shapes_and_trainable_weights():
    cfg = tcfg.config()
    model = NequIP.from_config(cfg, SPECIES, device="cpu", seed=3)
    ref = jax.eval_shape(lambda: jgnn.nequip_init(jcfg.config(), jax.random.PRNGKey(0),
                                                  SPECIES))
    want = flatten(ref)
    got = model.leaves()
    assert [p for p, _ in want] == list(got)
    for p, w in want:
        assert tuple(got[p].shape) == w.shape and got[p].requires_grad, p
    assert float(got["embed"].detach().std()) == pytest.approx(0.5, rel=0.1)
    assert tuple(got["layers/4/rad2/1/w"].shape) == (32, 96)


def _rotated(pos, seed):
    r = np.random.default_rng(seed)
    q, _ = np.linalg.qr(r.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return (pos @ q.T + r.normal(size=(3,))).astype(np.float32)


def test_port_keeps_the_reference_e3_property_and_a_shear_breaks_it():
    """``tests/test_models.py::test_nequip_equivariance_property`` run on the
    port: energies invariant under rotations plus translations; a shear
    (not an isometry) must move them past the same tolerance."""
    _, model = _models(tcfg.reduced(), 3)
    species, pos, s, r = _inputs(7)

    def energies(p):
        with torch.no_grad():
            return model(*(torch.from_numpy(a) for a in (species, p, s, r))).numpy()

    base = energies(pos)
    for seed in range(3):
        np.testing.assert_allclose(energies(_rotated(pos, seed)), base, rtol=1e-4, atol=1e-4)
    shear = np.eye(3, dtype=np.float32)
    shear[0, 1] = 0.5
    moved = energies(pos @ shear.T)
    assert not np.allclose(moved, base, rtol=1e-4, atol=1e-4)


def test_one_aggregation_a_layer_goes_through_csr_spmm(monkeypatch):
    cfg = tcfg.reduced()
    _, model = _models(cfg)
    species, pos, s, r = _inputs(6)
    calls = []
    real = ops.csr_spmm
    monkeypatch.setattr(ops, "csr_spmm", lambda x, a: calls.append(tuple(x.shape)) or real(x, a))
    out = model(*(torch.from_numpy(a) for a in (species, pos, s, r)))
    width = 13 * cfg.d_hidden  # scalars C + vectors 3C + tensors 9C
    assert calls == [(E, width)] * cfg.n_layers
    torch.autograd.grad(out.sum(), list(model.leaves().values()), allow_unused=True)
    assert calls[cfg.n_layers:] == [(N, width)] * cfg.n_layers  # the transposed CSR


def test_the_cell_trains_its_unused_last_mixes_with_zero_gradients():
    cell = steps.build_cell("nequip", "molecule", reduced=True, device="cpu")
    model = cell.model
    last = model.cfg.n_layers - 1
    before = model.leaves()[f"layers/{last}/self1"].detach().clone()
    loss, met = cell.run()
    assert np.isfinite(float(loss)) and float(met["grad_norm"]) > 0
    assert torch.equal(cell.args[1]["m"][f"layers/{last}/self1"],
                       torch.zeros_like(before))
    # only the weight decay moved it
    torch.testing.assert_close(model.leaves()[f"layers/{last}/self1"].detach(),
                               before * (1 - float(met["lr"]) * 0.1), rtol=1e-6, atol=0)
