"""The port's GNN cells of every (arch, shape) pair against the JAX
package's, on the CPU.

Three train steps of each running pair's reduced ``build_cell`` (GCN,
GatedGCN, MeshGraphNet and NequIP at full_graph_sm, minibatch_lg and
molecule, GCN also at ogb_products) against three steps of the reference
cell's own ``train_step`` on the same batch and parameters; the sizes of
``_gnn_sizes``; the three ``ogb_products`` cells that do not fit one card;
and the batches of the minibatch and molecule kinds.

Tolerances, as ``tests/test_torch_gnn.py`` holds gcn-cora: step losses at
rtol 1e-6; the gradient norm at rtol 1e-5; Adam moments at rtol 1e-5 with
atol 1e-5 x the leaf's largest entry (float32 sums in another order);
parameters within atol 2 x (sum of the learning rates so far), since a
near-zero gradient whose sign differs between the two sums moves one
Adam entry by up to 2 lr a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.configs import registry as treg
from repro_torch.data import graphs
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.gnn import EdgeCSR, gnn_loss
from repro_torch.train.checkpoint import flatten
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

GNN_ARCHS = ("gcn-cora", "gatedgcn", "meshgraphnet", "nequip")
UNFIT = ("gatedgcn", "meshgraphnet", "nequip")  # at ogb_products
RUNNING = [(a, s) for a in GNN_ARCHS for s in treg.GNN_SHAPES
           if not (s == "ogb_products" and a in UNFIT)]
_REF_KEYS = ("senders", "receivers", "x", "ef", "species", "pos", "y", "seed_mask",
             "graph_ids")


def _ref_batch(batch: dict) -> dict:
    """The port cell's batch as the reference cell takes it: int32 ids."""
    out = {}
    for k in _REF_KEYS:
        if k in batch:
            v = batch[k].numpy()
            out[k] = jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
    return out


# ---------------------------------------------------------------- sizes
@pytest.mark.parametrize("shape", list(treg.GNN_SHAPES))
@pytest.mark.parametrize("reduced", [False, True])
def test_gnn_sizes_match_the_reference_for_every_kind(shape, reduced):
    got = steps._gnn_sizes(treg.GNN_SHAPES[shape], reduced)
    assert got[:4] == jsteps._gnn_sizes(jreg.GNN_SHAPES[shape], reduced)
    assert got[0] == -(-got[4] // 256) * 256 and got[1] == -(-got[5] // 256) * 256


def test_minibatch_and_molecule_sizes():
    assert steps._gnn_sizes(treg.GNN_SHAPES["minibatch_lg"], False) == (
        169_984, 168_960, 602, 41, 169_984, 168_960)
    assert steps._gnn_sizes(treg.GNN_SHAPES["molecule"], False) == (
        3_840, 8_192, 16, 1, 3_840, 8_192)


# ---------------------------------------------------------------- three steps
@pytest.mark.parametrize("arch,shape", RUNNING)
def test_three_train_steps_match_the_reference_train_step(arch, shape):
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu", seed=3)
    model, opt_state, batch = cell.args
    jcell = jsteps.build_cell(arch, shape, reduced=True)
    treedef = jax.tree_util.tree_structure(jcell.args[0])
    assert [p for p, _ in flatten(jcell.args[0])] == list(model.leaves())
    assert set(_ref_batch(batch)) == set(jcell.args[2])
    for k, spec in jcell.args[2].items():
        assert tuple(batch[k].shape) == spec.shape, k
    # copies: the port's step updates its parameters in place, and a jitted
    # step may still be reading its inputs when that step starts
    params = treedef.unflatten([jnp.array(p.detach().numpy(), copy=True)
                                for p in model.leaves().values()])
    jstate = j_init_opt_state(params, JAdamWConfig())
    jbatch = _ref_batch(batch)
    jfn = jax.jit(jcell.fn)
    sum_lr = 0.0
    for step in range(1, 4):
        params, jstate, jloss, jmet = jfn(params, jstate, jbatch)
        loss, met = cell.run()
        sum_lr += float(jmet["lr"])
        assert float(loss) == pytest.approx(float(jloss), rel=1e-6, abs=1e-30)
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5,
                                                        abs=1e-30)
        assert np.isfinite(float(met["grad_norm"]))
        ms = dict(flatten(jstate["m"]))
        vs = dict(flatten(jstate["v"]))
        ps = dict(flatten(params))
        for path, p in model.leaves().items():
            for name, want in (("m", ms[path]), ("v", vs[path])):
                np.testing.assert_allclose(opt_state[name][path].numpy(), want, rtol=1e-5,
                                           atol=1e-5 * float(np.abs(want).max()),
                                           err_msg=f"{name} {path} step {step}")
            np.testing.assert_allclose(p.detach().numpy(), ps[path], rtol=0, atol=2 * sum_lr,
                                       err_msg=f"{path} step {step}")


@pytest.mark.parametrize("arch", ["gcn-cora", "gatedgcn"])
def test_one_class_molecule_cells_move_by_weight_decay_alone(arch):
    """At molecule the classification archs have one class: the log-softmax
    of one logit is 0, so loss and gradients are 0 and only AdamW's weight
    decay (leaves of 2 or more dimensions) moves the weights."""
    cell = steps.build_cell(arch, "molecule", reduced=True, device="cpu")
    model = cell.model
    before = {k: p.detach().clone() for k, p in model.leaves().items()}
    loss, met = cell.run()
    assert float(loss) == 0.0 and float(met["grad_norm"]) == 0.0
    for k, p in model.leaves().items():
        assert torch.isfinite(p).all()
        if p.dim() >= 2:
            want = before[k] * (1 - float(met["lr"]) * 0.1)
            torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(p.detach(), before[k])


@pytest.mark.parametrize("arch,shape", RUNNING)
def test_only_nequips_last_mixes_are_out_of_the_loss(arch, shape):
    """``train_step`` gives a leaf the loss does not reach a zero gradient,
    as ``jax.grad`` does. The only such leaves are NequIP's last layer's
    vector and tensor mixes, whose outputs no energy reads; any other would
    be a wiring fault that trains on weight decay alone."""
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu")
    model, _, batch = cell.args
    leaves = model.leaves()
    grads = torch.autograd.grad(gnn_loss(model, batch), list(leaves.values()),
                                allow_unused=True)
    unreached = {k for k, g in zip(leaves, grads) if g is None}
    last = treg.get_arch(arch).reduced().n_layers - 1
    want = {f"layers/{last}/self1", f"layers/{last}/self2"} if arch == "nequip" else set()
    assert unreached == want


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch,gb", [("gatedgcn", "17,320,611,840"),
                                     ("meshgraphnet", "95,015,927,808"),
                                     ("nequip", "71,261,945,856")])
@pytest.mark.parametrize("reduced", [False, True])
def test_ogb_products_cells_that_do_not_fit_refuse_before_drawing(arch, gb, reduced,
                                                                  monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("the cell drew its graph before refusing")

    monkeypatch.setattr(steps, "node_graph", no_draw)
    monkeypatch.setattr(steps, "_gnn_model", no_draw)
    with pytest.raises(ValueError, match=f"does not fit one card.*{gb} bytes"):
        steps.build_cell(arch, "ogb_products", reduced=reduced, device="cpu")


def test_gcn_at_ogb_products_is_not_refused():
    assert steps._refuse_unfit("gcn-cora", treg.GNN_SHAPES["ogb_products"]) is None
    for arch in UNFIT:  # every other shape fits
        for shape in ("full_graph_sm", "minibatch_lg", "molecule"):
            steps._refuse_unfit(arch, treg.GNN_SHAPES[shape])


# ---------------------------------------------------------------- the kinds' batches
def test_reduced_minibatch_graph_is_the_reference_scale():
    g = steps._minibatch_graph(treg.GNN_SHAPES["minibatch_lg"], True, "cpu", 0)
    assert g["x"].shape == (87, 16) and g["indptr"].shape == (88,)
    assert g["indices"].numel() == 43_153 == int(g["indptr"][-1])
    assert int(g["y"].min()) >= 0 and int(g["y"].max()) < 41


@pytest.mark.parametrize("arch,shape", RUNNING)
def test_padded_edges_are_minus_one_and_reach_no_csr_row(arch, shape):
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu")
    b = cell.args[2]
    s, r = b["senders"], b["receivers"]
    real = s >= 0
    n_real = int(real.sum())
    assert 0 < n_real < s.numel() and not real[n_real:].any()  # padding at the end
    assert torch.equal(real, r >= 0)  # a padded edge is -1 at both ends
    csr = b["graph"].fwd if arch == "gcn-cora" else b["csr"].fwd
    assert csr.col.numel() == n_real  # no row holds a padded edge
    if shape == "minibatch_lg":
        assert int(b["seed_mask"].sum()) == 1  # one seed when reduced
    if shape == "molecule":
        assert n_real == 2 * 64 and int(b["graph_ids"].max()) == 1  # two whole molecules
    n_nodes = int(max(s.max(), r.max())) + 1
    if "x" in b:
        assert float(b["x"][n_nodes:].abs().max()) == 0.0
    if arch in ("gatedgcn", "meshgraphnet"):
        assert float(b["ef"][n_real:].abs().max()) == 0.0
    ops.reset_launch_counts()
    loss, _ = cell.run()
    assert np.isfinite(float(loss)) and ops.launch_counts["csr_spmm"] == 0  # the CPU twin


def test_sampled_batch_pads_and_marks_the_seeds():
    g = graphs.node_graph(300, 3_000, 4, 5, real_nodes=300, real_edges=3_000,
                          generator=torch.Generator().manual_seed(0))
    indptr, indices = graphs.csc(g["senders"], g["receivers"], 300)
    assert torch.equal(indptr.diff(), torch.bincount(g["receivers"], minlength=300))
    from repro_torch.data import NeighborSampler
    sampler = NeighborSampler(indptr, indices, (5, 3))
    gen = torch.Generator().manual_seed(1)
    seeds = torch.tensor([3, 7, 11, 200])
    b = graphs.sampled_batch(sampler, seeds, {"x": g["x"], "y": g["y"]}, 4 * 21, 4 * 20, gen)
    ids = b["node_ids"]
    n = ids.numel()
    assert torch.equal(b["x"][:n], g["x"][ids]) and (b["y"][n:] == -1).all()
    assert torch.equal(ids[b["seed_mask"][:n]], seeds)
    real = b["senders"] >= 0
    # every sampled edge is an edge of the graph, read in the compacted ids
    keys = set((g["senders"] * 300 + g["receivers"]).tolist())
    got = ids[b["senders"][real]] * 300 + ids[b["receivers"][real]]
    assert set(got.tolist()) <= keys
    with pytest.raises(ValueError, match="exceeds"):
        graphs.sampled_batch(sampler, seeds, {}, 5, 5, gen)


def test_molecule_batch_at_full_size():
    shape = treg.GNN_SHAPES["molecule"]
    cell = steps.build_cell("nequip", "molecule", device="cpu", seed=0)
    b = cell.args[2]
    s, r, gid = b["senders"], b["receivers"], b["graph_ids"]
    assert s.shape == (8_192,) and b["pos"].shape == (3_840, 3)
    assert int(s.min()) >= 0 and int(r.min()) >= 0  # neither padded
    assert torch.equal(gid, torch.arange(3_840) // 30)
    assert torch.equal(gid[s], gid[r])  # edges stay within their molecule
    assert torch.equal(torch.bincount(gid[r], minlength=128), torch.full((128,), 64))
    # one edge each way per pair: the edge set is symmetric
    assert torch.equal(torch.sort(s * 3840 + r).values, torch.sort(r * 3840 + s).values)
    assert int((s == r).sum()) > 0  # self pairs are drawn, and run
    assert int(b["species"].max()) < graphs.N_SPECIES
    assert shape.params["n_edges"] == 64
    csr = b["csr"]
    assert isinstance(csr, EdgeCSR) and int(csr.fwd.row_lengths().max()) <= 64
    loss, met = cell.run()
    assert np.isfinite(float(loss)) and np.isfinite(float(met["grad_norm"]))
