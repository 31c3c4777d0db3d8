"""The port's GCN training path against the JAX package's, on the CPU.

``repro_torch.models.gnn`` (aggregation through ``csr_spmm``'s twin) is
held against ``repro.models.gnn.gcn_apply``, its loss and gradients
against ``jax.value_and_grad`` of the reference GNN cell's ``loss_fn``, and
three train steps of the port's ``build_cell`` against three steps of the
reference cell's ``train_step``, with inputs made by numpy from a seed and
handed to both.

Tolerances: forward, loss and gradients at rtol/atol 1e-5 (float32 sums in
another order: a CSR sum against ``segment_sum``); step losses at 1e-6
relative; Adam moments at rtol 1e-5 with atol 1e-5 x the leaf's largest
entry; parameters within atol 2 x (sum of the learning rates so far): a
near-zero gradient whose sign differs between the two sums can move one
Adam entry by up to 2 lr a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as jcfg
from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import gnn as jgnn
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.configs import gcn_cora as tcfg
from repro_torch.configs import registry as treg
from repro_torch.data.graphs import node_graph
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.gnn import GCN, Graph, node_loss
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)


def _graph(rng, n, e, pad_frac=0.2, oor=0):
    senders, receivers = rng.integers(0, n, e), rng.integers(-oor, n + oor, e)
    senders[rng.random(e) < pad_frac] = -1
    return senders.astype(np.int32), receivers.astype(np.int32)


def _params_np(tree):
    return {"layers": [{k: np.asarray(p[k]) for k in ("w", "b")} for p in tree["layers"]]}


def _ref_loss_fn():
    """The reference GNN cell's own ``loss_fn`` (closed over by its
    ``train_step``), for reduced gcn-cora at full_graph_sm: 256 nodes."""
    fn = jsteps.build_cell("gcn-cora", "full_graph_sm", reduced=True).fn
    free = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return free["loss_fn"]


# ---------------------------------------------------------------- configs
def test_config_and_shapes_match_the_reference():
    assert dataclasses.asdict(tcfg.config()) == dataclasses.asdict(jcfg.config())
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    arch, ref_arch = treg.get_arch("gcn-cora"), jreg.get_arch("gcn-cora")
    assert arch.family == ref_arch.family == "gnn"
    assert set(arch.shapes) == set(ref_arch.shapes) == set(jreg.GNN_SHAPES)
    for name, shape in arch.shapes.items():
        assert (shape.kind, shape.params) == (ref_arch.shapes[name].kind,
                                              ref_arch.shapes[name].params)


@pytest.mark.parametrize("shape", ["full_graph_sm", "ogb_products"])
@pytest.mark.parametrize("reduced", [False, True])
def test_gnn_sizes_match_the_reference(shape, reduced):
    spec = treg.get_arch("gcn-cora").shapes[shape]
    got = steps._gnn_sizes(spec, reduced)
    assert got[:4] == jsteps._gnn_sizes(jreg.get_arch("gcn-cora").shapes[shape], reduced)
    if not reduced:
        assert got[4:] == (spec.params["n_nodes"], spec.params["n_edges"])


def test_ogb_products_sizes():
    spec = treg.get_arch("gcn-cora").shapes["ogb_products"]
    assert steps._gnn_sizes(spec, False) == (2_449_152, 61_859_328, 100, 47,
                                             2_449_029, 61_859_140)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_gcn_forward_matches_gcn_apply(which):
    cfg = getattr(jcfg, which)()
    rng = np.random.default_rng(1)
    n, e, d_in, n_out = 90, 500, 12, 5
    senders, receivers = _graph(rng, n, e, oor=3)
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    params = jgnn.gcn_init(cfg, jax.random.PRNGKey(4), d_in, n_out)
    want = jgnn.gcn_apply(params, jnp.asarray(x), jnp.asarray(senders), jnp.asarray(receivers),
                          n, cfg)
    model = GCN.from_numpy_params(_params_np(params), getattr(tcfg, which)(), device="cpu")
    graph = Graph.from_edges(torch.from_numpy(senders), torch.from_numpy(receivers), n)
    got = model(torch.from_numpy(x), graph)
    assert got.shape == (n, n_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def test_graph_degree_matches_the_reference():
    rng = np.random.default_rng(2)
    n = 64
    senders, receivers = _graph(rng, n, 400, oor=2)
    valid = (senders >= 0).astype(np.float32)
    deg = jax.ops.segment_sum(jnp.asarray(valid), jnp.asarray(receivers), num_segments=n) + 1.0
    graph = Graph.from_edges(torch.from_numpy(senders), torch.from_numpy(receivers), n)
    np.testing.assert_allclose(graph.inv_sqrt[:, 0].numpy(), np.asarray(jax.lax.rsqrt(deg)),
                               rtol=1e-6)


def test_from_config_shapes_and_trainable_weights():
    model = GCN.from_config(tcfg.config(), 1433, 7, device="cpu", seed=3)
    ref = jgnn.gcn_init(jcfg.config(), jax.random.PRNGKey(0), 1433, 7)
    assert [tuple(p.shape) for p in model.leaves().values()] == [
        tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(ref)]
    assert list(model.leaves()) == ["layers/0/b", "layers/0/w", "layers/1/b", "layers/1/w"]
    assert all(p.requires_grad for p in model.parameters())
    assert float(model.w[0].detach().std()) == pytest.approx(1433 ** -0.5, rel=0.05)


# ---------------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradients_match_the_reference_loss_fn(masked):
    cfg = jcfg.reduced()
    n, e, d, c = 256, 256, 16, 7
    rng = np.random.default_rng(5 + masked)
    senders, receivers = _graph(rng, n, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(-1, c, n).astype(np.int32)  # -1 labels read as class 0
    batch = {"senders": senders, "receivers": receivers, "x": x, "y": y}
    if masked:
        batch["seed_mask"] = rng.random(n) < 0.3
    params = jgnn.gcn_init(cfg, jax.random.PRNGKey(6), d, c)
    loss, grads = jax.value_and_grad(_ref_loss_fn())(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    model = GCN.from_numpy_params(_params_np(params), tcfg.reduced(), device="cpu")
    graph = Graph.from_edges(torch.from_numpy(senders), torch.from_numpy(receivers), n)
    mask = torch.from_numpy(batch["seed_mask"]) if masked else None
    got = node_loss(model(torch.from_numpy(x), graph), torch.from_numpy(y).long(), mask)
    leaves = model.leaves()
    got_grads = torch.autograd.grad(got, list(leaves.values()))
    np.testing.assert_allclose(float(got.detach()), float(loss), **F32)
    for (path, g), want in zip(zip(leaves, got_grads), jax.tree_util.tree_leaves(grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **F32, err_msg=path)


def test_seed_mask_of_nothing_divides_by_one():
    logits, y = torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int64)
    assert float(node_loss(logits, y, torch.zeros(4, dtype=torch.bool))) == 0.0


# ---------------------------------------------------------------- the train cell
def _cell_graph_np(spec, reduced, seed):
    """The cell's edges, drawn again from its generator (seed + 1)."""
    n, e, d, c, real_n, real_e = steps._gnn_sizes(spec, reduced)
    g = node_graph(n, e, d, c, real_nodes=real_n, real_edges=real_e,
                   generator=torch.Generator().manual_seed(seed + 1))
    return {k: v.numpy() for k, v in g.items()}


def test_three_train_steps_match_the_reference_train_step():
    seed = 4
    cell = steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu", seed=seed)
    model, opt_state, batch = cell.args
    g = _cell_graph_np(treg.get_arch("gcn-cora").shapes["full_graph_sm"], True, seed)
    assert torch.equal(Graph.from_edges(torch.from_numpy(g["senders"]),
                                        torch.from_numpy(g["receivers"]), 256).fwd.col,
                       batch["graph"].fwd.col)
    np.testing.assert_array_equal(g["x"], batch["x"].numpy())

    jcell = jsteps.build_cell("gcn-cora", "full_graph_sm", reduced=True)
    params = {"layers": [{"w": jnp.asarray(model.w[i].detach().numpy()),
                          "b": jnp.asarray(model.b[i].detach().numpy())} for i in range(2)]}
    jstate = j_init_opt_state(params, JAdamWConfig())
    jbatch = {"senders": jnp.asarray(g["senders"], jnp.int32),
              "receivers": jnp.asarray(g["receivers"], jnp.int32),
              "x": jnp.asarray(g["x"]), "y": jnp.asarray(g["y"], jnp.int32)}
    sum_lr = 0.0
    for step in range(1, 4):
        params, jstate, jloss, jmet = jcell.fn(params, jstate, jbatch)
        loss, met = cell.run()
        sum_lr += float(jmet["lr"])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), **F32)
        assert int(opt_state["step"]) == int(jstate["step"]) == step
        for path, p in model.leaves().items():
            _, i, k = path.split("/")
            for name in ("m", "v"):
                want = np.asarray(jstate[name]["layers"][int(i)][k])
                np.testing.assert_allclose(opt_state[name][path].numpy(), want, rtol=1e-5,
                                           atol=1e-5 * float(np.abs(want).max()),
                                           err_msg=f"{name} {path} step {step}")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["layers"][int(i)][k]),
                                       rtol=0, atol=2 * sum_lr, err_msg=f"{path} step {step}")
            np.testing.assert_array_equal(p.detach().numpy(), opt_state["master"][path].numpy())


def test_train_cell_steps_count_no_launch_on_the_cpu():
    ops.reset_launch_counts()
    cell = steps.build_cell("gcn-cora", "ogb_products", reduced=True, device="cpu")
    loss, metrics = cell.run()
    assert np.isfinite(float(loss)) and set(metrics) == {"lr", "grad_norm"}
    assert ops.launch_counts["csr_spmm"] == 0


def test_full_graph_cell_refuses_a_batch_override():
    with pytest.raises(ValueError, match="LM cells only"):
        steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu", batch=4)


# ---------------------------------------------------------------- the graphs
def test_node_graph_padding_and_degree_law():
    g = node_graph(4096, 40_960, 8, 5, real_nodes=4000, real_edges=40_000,
                   generator=torch.Generator().manual_seed(0))
    assert g["x"].shape == (4096, 8) and g["y"].shape == (4096,)
    assert float(g["x"][4000:].abs().max()) == 0.0 and (g["y"][4000:] == -1).all()
    assert int(g["y"][:4000].min()) >= 0 and int(g["y"][:4000].max()) < 5
    assert (g["senders"][40_000:] == -1).all()
    s, r = g["senders"][:40_000], g["receivers"][:40_000]
    assert int(s.min()) >= 0 and int(s.max()) < 4000 and int(r.min()) >= 0 and int(r.max()) < 4000
    in_deg = torch.bincount(r, minlength=4000)
    # symmetric: every pair is an edge each way, so out-degree is in-degree
    assert torch.equal(torch.bincount(s, minlength=4000), in_deg)
    assert torch.equal(torch.sort(s * 4000 + r).values, torch.sort(r * 4000 + s).values)
    # Chung-Lu at beta = 3: the top node expects E / sum_i (i + 1) ** -0.5,
    # about 320 here, against a mean of 10
    assert 200 < int(in_deg.max()) < 450
