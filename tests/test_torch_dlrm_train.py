"""The port's DLRM training path against the JAX package's, on the CPU.

Inputs are made by numpy from a seed; the reference's parameters are
carried across with ``DLRM.from_numpy_params(..., master=True)`` and read
back with ``DLRM.numpy_params``. The kernels run as their plain twins here.
None of the reference's Pallas kernels has a gradient (``jax.vjp`` cannot
linearise them), so the backward twins are held against ``jax.vjp`` of the
reference's plain functions: ``embedding_bag_ref``, ``dot_interaction_ref``
and DLRM's ``_interact``.

Tolerances, each with its reason:

- float32 loss and gradients: rtol 1e-5, atol 1e-5 x the leaf's largest
  |gradient| (the same float32 arithmetic, summed in another order: the
  port sums a row's gradient in sorted order and the interaction's
  gradient as one (G + Gᵀ) X product; XLA scatters and takes two products);
- the backward twins in float32: rtol 1e-5, atol 1e-6 (the same, at
  smaller sums);
- the interaction's bfloat16 gradient: |port - jax| <= 2^-6 (|G X| + |Gᵀ X|)
  + 1e-6 per element. JAX rounds G X and Gᵀ X to bfloat16 and adds them in
  bfloat16, three roundings of at most 2^-8 relative each; the port rounds
  the float32 sum once. The bound is 1.5 x 2^-7 of the terms' magnitudes;
  2^-6 leaves room for the float32 sums;
- three train steps: loss, lr and grad_norm within 1e-5 relative; MLP
  leaves within 2 x the summed learning rate (an AdamW step moves an entry
  by about lr, so two runs whose gradients differ in the last bits can
  differ by at most one step each, as in the GCN test); the tables' master
  rows within 1e-6 (an SGD step moves a row by lr x clip x g, 3e-6 x |g| at
  the first steps, so float32 differences in g land far below that); rows
  no batch touched equal bit for bit;
- one bfloat16 step at the reduced widths: the fields are bfloat16, and the
  bottom MLP's float32 output, computed in another order, can round to the
  neighbouring bfloat16 value (2^-8 relative), as in test_torch_dlrm.py;
  so the loss within 1e-3 relative, grad_norm within 1e-2 relative (the
  bfloat16 cotangents differ by up to 2^-7 relative, above), the tables'
  master rows within 1e-6 (lr x the gradient's difference) and the MLP
  leaves within 2 x lr, as above.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as jcfg
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import dlrm as jdlrm
from repro.train import optimizer as jopt
from repro_torch.configs import dlrm_mlperf as tcfg
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dot_interaction import dot_interaction_backward_cuda
from repro_torch.kernels.embedding_bag import (embedding_bag_backward_cuda, mapped_ptr,
                                               sgd_rows_cuda)
from repro_torch.launch import steps
from repro_torch.models.dlrm import DLRM, dlrm_grads, dlrm_loss
from repro_torch.train import optimizer as topt
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-6)


def _params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jdlrm.dlrm_init(cfg, jax.random.PRNGKey(seed)))


def _batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, r, b) for r in cfg.row_counts], 1).astype(np.int32)
    labels = (rng.random(b) < 0.5).astype(np.float32)
    return dense, sparse, labels


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _table_grads(cfg, rows, grads, n_unique):
    """The compact table gradient scattered to the reference's per-table
    dense layout."""
    padded = [cfg.padded_rows(r) for r in cfg.row_counts]
    dense = np.zeros((sum(padded), cfg.embed_dim), np.float32)
    n = int(n_unique)
    dense[rows[:n].numpy()] = grads[:n].numpy()
    starts = np.concatenate([[0], np.cumsum(padded)])
    return {f"table_{i}": dense[starts[i]:starts[i + 1]] for i in range(len(padded))}


def _model(cfg, params):
    return DLRM.from_numpy_params(params, cfg, device="cpu", master=True)


# ---------------------------------------------------------------- loss, gradients
def test_dlrm_loss_matches_the_reference():
    cfg = jcfg.reduced()
    params = _params(cfg, 1)
    dense, sparse, labels = _batch(cfg, 32, 1)
    loss, lookup = dlrm_loss(_model(tcfg.reduced(), params), *_t(dense, sparse, labels))
    want = jdlrm.dlrm_loss(params, dense, sparse, labels, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    assert lookup.emb.requires_grad and lookup.bags.shape == (32 * 26, 1)


def test_logit_loss_is_stable_at_large_logits():
    from repro_torch.models.dlrm import logit_loss

    z = torch.tensor([-200.0, -30.0, 0.0, 30.0, 200.0])
    y = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    want = np.mean(np.maximum(z.numpy(), 0) - z.numpy() * y.numpy()
                   + np.log1p(np.exp(-np.abs(z.numpy()))))
    assert np.isfinite(float(logit_loss(z, y)))
    np.testing.assert_allclose(float(logit_loss(z, y)), want, rtol=1e-6)


def test_gradients_match_jax_grad_with_repeated_ids():
    cfg = jcfg.reduced()
    params = _params(cfg, 2)
    dense, sparse, labels = _batch(cfg, 32, 2)
    model = _model(tcfg.reduced(), params)
    loss, grads = dlrm_grads(model, *_t(dense, sparse, labels))
    want_loss, want = jax.value_and_grad(jdlrm.dlrm_loss)(params, dense, sparse, labels, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert list(grads) == list(model.leaves())
    table = grads["tables"]
    n = int(table.n_unique)
    distinct = {(i, int(v)) for i in range(26) for v in sparse[:, i]}
    assert n == len(distinct) < 32 * 26  # the reduced tables repeat ids
    assert torch.equal(table.rows[:n], table.rows[:n].sort().values)
    for i, g in _table_grads(cfg, table.rows, table.grads, table.n_unique).items():
        w = np.asarray(want["tables"][i])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=i)
    for path, g in grads.items():
        if path == "tables":
            continue
        key, i, k = path.split("/")
        w = np.asarray(want[key][int(i)][k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=path)


def test_global_norm_counts_only_live_rows():
    rows = torch.tensor([3, 5, -7, 9])
    grads = torch.tensor([[1.0, 2.0], [2.0, 0.0], [float("nan"), 1e30], [5.0, 5.0]])
    sparse = topt.SparseRows(rows, grads, torch.tensor(2))
    dense = {"w": torch.tensor([[3.0]])}
    got = topt.global_norm({**dense, "tables": sparse})
    np.testing.assert_allclose(float(got), np.sqrt(9 + 1 + 4 + 4), rtol=1e-7)


# ---------------------------------------------------------------- backward twins
def _bags(rng, b, bag_len, n_rows, padding):
    idx = rng.integers(0, n_rows, (b, bag_len))
    if padding:
        idx[rng.random((b, bag_len)) < 0.3] = -1
        idx[0] = -1  # an empty bag
    return idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("bag_len,padding", [(1, False), (3, True), (8, True)])
def test_embedding_bag_backward_ref_matches_jax_vjp(dtype, combiner, bag_len, padding):
    """The compact gradient, scattered to dense, equals the vjp of the
    reference's ``embedding_bag_ref`` (a float32 table, its bag sums cast to
    the gradient's dtype, as DLRM casts its rows)."""
    rng = np.random.default_rng(bag_len * 7 + len(combiner) + len(dtype))
    n_rows, d, b = 23, 8, 40
    idx = _bags(rng, b, bag_len, n_rows, padding)
    table = rng.normal(size=(n_rows, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ct = rng.normal(size=(b, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jref.embedding_bag_ref(t, jnp.asarray(idx), combiner).astype(jdt),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(ct).astype(jdt))
    g_out = torch.from_numpy(np.array(jnp.asarray(ct).astype(jdt).astype(jnp.float32)))
    g_out = g_out.to(getattr(torch, dtype))
    rows, grads, n_unique = ops.embedding_bag_backward(torch.from_numpy(idx), g_out, combiner,
                                                       n_rows)
    n = int(n_unique)
    valid = np.unique(idx[idx >= 0])
    assert n == len(valid) and rows[:n].tolist() == valid.tolist()
    assert bool((rows[n:] == -1).all()) and not bool(grads[n:].any())
    assert grads.dtype == torch.float32 and grads.shape == (b * bag_len, d)
    dense = np.zeros((n_rows, d), np.float32)
    dense[valid] = grads[:n].numpy()
    np.testing.assert_allclose(dense, np.asarray(want), **F32)


@pytest.mark.parametrize("chunk", [1, 2, 5, 256])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_backward_split_twin_keeps_the_rows(chunk, combiner):
    """The kernel's order of additions (runs cut into chunks, a cut run's
    pieces added in chunk order) gives the plain twin's rows and sums: long
    runs of one id, padding, single-entry runs."""
    rng = np.random.default_rng(chunk)
    idx = _bags(rng, 300, 4, 6, True)
    idx[:, 0] = 2  # a run of 300+ entries, cut by every chunk size
    g = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    r1, g1, n1 = ref.embedding_bag_backward_ref(torch.from_numpy(idx), g, combiner)
    r2, g2, n2 = ref.embedding_bag_backward_split_ref(torch.from_numpy(idx), g, combiner, chunk)
    n = int(n1)
    assert int(n2) == n and torch.equal(r1, r2)
    torch.testing.assert_close(g2[:n], g1[:n], rtol=1e-5, atol=1e-5)


def test_embedding_bag_backward_ref_refuses_ids_past_the_table():
    with pytest.raises(ValueError, match="outside"):
        ref.embedding_bag_backward_ref(torch.tensor([[0], [7]]), torch.ones(2, 3), "sum", 7)


@pytest.mark.parametrize("f,b,d", [(27, 6, 16), (5, 9, 7), (2, 3, 4)])
def test_dot_interaction_backward_ref_matches_jax_vjp_float32(f, b, d):
    rng = np.random.default_rng(f)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    dz = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    _, vjp = jax.vjp(jref.dot_interaction_ref, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dz))
    got = ops.dot_interaction_backward(torch.from_numpy(x), torch.from_numpy(dz))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [27, 13])
def test_dot_interaction_backward_ref_matches_interact_vjp_bfloat16(f):
    """DLRM's ``_interact`` on bfloat16 fields: the reference's cotangent is
    bfloat16, and so is the twin's."""
    rng = np.random.default_rng(f)
    b, d = 8, 32
    x = jnp.asarray(rng.normal(size=(b, f, d)).astype(np.float32)).astype(jnp.bfloat16)
    dz = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    out, vjp = jax.vjp(jdlrm._interact, x)
    (want,) = vjp(jnp.asarray(dz))
    assert out.dtype == jnp.float32 and want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = ops.dot_interaction_backward(xt, torch.from_numpy(dz))
    assert got.dtype == torch.bfloat16
    # the two terms G X and Gᵀ X in float64, for the tolerance's scale
    g = np.zeros((b, f, f))
    ii, jj = np.tril_indices(f, -1)
    g[:, ii, jj] = dz
    xf = np.asarray(x.astype(jnp.float32), dtype=np.float64)
    scale = np.abs(g @ xf) + np.abs(g.transpose(0, 2, 1) @ xf)
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (err <= 2.0 ** -6 * scale + 1e-6).all(), float((err - 2.0 ** -6 * scale).max())


@pytest.mark.parametrize("clip_on", [False, True])
def test_sgd_rows_ref_matches_the_reference_sgd_leaf(clip_on):
    """The reference's SGD leaf on a dense gradient that is zero off the
    touched rows against ``sgd_rows_ref`` on those rows: the touched rows
    equal bit for bit, and the others do not move."""
    rng = np.random.default_rng(int(clip_on))
    n_rows, d = 40, 6
    w = rng.normal(size=(n_rows, d)).astype(np.float32)
    touched = np.sort(rng.choice(n_rows, 11, replace=False))
    g = np.zeros_like(w)
    g[touched] = rng.normal(size=(11, d)).astype(np.float32) * (50.0 if clip_on else 0.01)
    cfg = jopt.AdamWConfig(sgd_paths=("tables",), lr=1e-2, warmup_steps=2)
    state = jopt.init_opt_state({"tables": jnp.asarray(w)}, cfg)
    new, new_state, met = jopt.adamw_update({"tables": jnp.asarray(w)}, {"tables": jnp.asarray(g)},
                                            state, cfg)
    clip = min(1.0, cfg.grad_clip / (float(met["grad_norm"]) + 1e-9))
    assert (clip < 1.0) == clip_on
    cap = 16  # slots past n_unique hold anything
    rows = torch.full((cap,), 99, dtype=torch.int64)
    rows[:11] = torch.from_numpy(touched)
    grads = torch.full((cap, d), float("nan"))
    grads[:11] = torch.from_numpy(g[touched])
    master = torch.from_numpy(w.copy())
    table = torch.from_numpy(w.copy()).to(torch.bfloat16)
    lr = torch.tensor(float(met["lr"]), dtype=torch.float32)
    clip_t = torch.clamp(torch.tensor(cfg.grad_clip) / (torch.tensor(float(met["grad_norm"]))
                                                        + 1e-9), max=1.0)
    ref.sgd_rows_ref(master, table, rows, grads, torch.tensor(11), lr, clip_t)
    np.testing.assert_array_equal(master.numpy(), np.asarray(new_state["master"]["tables"]))
    np.testing.assert_array_equal(master.numpy(), np.asarray(new["tables"]))
    assert torch.equal(table, master.to(torch.bfloat16))
    untouched = np.setdiff1d(np.arange(n_rows), touched)
    np.testing.assert_array_equal(master.numpy()[untouched], w[untouched])


# ---------------------------------------------------------------- the cell
def test_three_train_steps_match_the_reference_train_step():
    seed = 3
    cell = steps.build_cell("dlrm-mlperf", "train_batch", reduced=True, device="cpu", seed=seed)
    model, opt_state, dense, sparse, labels = cell.args
    cfg = jcfg.reduced()
    assert dense.shape == (32, 13) and sparse.shape == (32, 26) and labels.shape == (32,)
    assert set(labels.unique().tolist()) <= {0.0, 1.0}
    assert opt_state["master"]["tables"] is model.master
    assert opt_state["m"]["tables"] is None and opt_state["v"]["tables"] is None
    params = jax.tree_util.tree_map(jnp.asarray, model.numpy_params())
    master0 = model.master.clone()
    jcell = jsteps.build_cell("dlrm-mlperf", "train_batch", reduced=True)
    jstate = jopt.init_opt_state(params, jopt.AdamWConfig(sgd_paths=("tables",)))
    jargs = (jnp.asarray(dense.numpy()), jnp.asarray(sparse.numpy()), jnp.asarray(labels.numpy()))
    touched = np.unique((sparse + model.row_offsets).numpy())
    untouched = np.setdiff1d(np.arange(model.table.shape[0]), touched)
    sum_lr = 0.0
    for step in range(1, 4):
        params, jstate, jloss, jmet = jcell.fn(params, jstate, *jargs)
        loss, met = cell.run()
        sum_lr += float(jmet["lr"])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
        assert int(opt_state["step"]) == int(jstate["step"]) == step
        got = model.numpy_params()
        for key in ("bot", "top"):
            for i, layer in enumerate(got[key]):
                for k in ("b", "w"):
                    np.testing.assert_allclose(layer[k], np.asarray(params[key][i][k]), rtol=0,
                                               atol=2 * sum_lr, err_msg=f"{key}/{i}/{k} {step}")
        for name, t in got["tables"].items():
            np.testing.assert_allclose(t, np.asarray(params["tables"][name]), rtol=0, atol=1e-6,
                                       err_msg=f"{name} step {step}")
        assert torch.equal(model.table, model.master)  # float32 tables: the master itself
        assert torch.equal(model.master[untouched], master0[untouched])
    assert not torch.equal(model.master[touched], master0[touched])


def test_one_bfloat16_step_matches_the_reference():
    cfg = dataclasses.replace(jcfg.reduced(), compute_dtype="bfloat16")
    params = _params(cfg, 5)
    dense, sparse, labels = _batch(cfg, 32, 5)
    model = DLRM.from_numpy_params(params, dataclasses.replace(tcfg.reduced(),
                                                               compute_dtype="bfloat16"),
                                   device="cpu", master=True)
    assert model.table.dtype == torch.bfloat16
    assert torch.equal(model.table, model.master.to(torch.bfloat16))
    opt_cfg = topt.AdamWConfig(sgd_paths=("tables",))
    state = topt.init_opt_state(model.leaves(), opt_cfg, master={"tables": model.master})
    loss, met = steps.dlrm_train_step(model, state, *_t(dense, sparse, labels), opt_cfg)

    jopt_cfg = jopt.AdamWConfig(sgd_paths=("tables",))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jloss, jgrads = jax.value_and_grad(jdlrm.dlrm_loss)(jparams, dense, sparse, labels, cfg)
    new, _, jmet = jopt.adamw_update(jparams, jgrads, jopt.init_opt_state(jparams, jopt_cfg),
                                     jopt_cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-2)
    got = model.numpy_params()
    for name, t in got["tables"].items():
        np.testing.assert_allclose(t, np.asarray(new["tables"][name]), rtol=0, atol=1e-6,
                                   err_msg=name)
    lr = float(jmet["lr"])
    for key in ("bot", "top"):
        for i, layer in enumerate(got[key]):
            for k in ("b", "w"):
                np.testing.assert_allclose(layer[k], np.asarray(new[key][i][k]), rtol=0,
                                           atol=2 * lr, err_msg=f"{key}/{i}/{k}")
    assert torch.equal(model.table, model.master.to(torch.bfloat16))


def test_train_cell_counts_no_launch_on_the_cpu_and_checks_ids():
    ops.reset_launch_counts()
    cell = steps.build_cell("dlrm-mlperf", "train_batch", reduced=True, device="cpu")
    loss, metrics = cell.run()
    assert np.isfinite(float(loss)) and set(metrics) == {"lr", "grad_norm"}
    assert not any(ops.launch_counts.values())
    model, opt_state, dense, sparse, labels = cell.args
    bad = sparse.clone()
    bad[0, 5] = model.cfg.row_counts[5] + 1000  # past its field's padded rows
    with pytest.raises(ValueError, match="outside"):
        steps.dlrm_train_step(model, opt_state, dense, bad, labels,
                              topt.AdamWConfig(sgd_paths=("tables",)))


def test_train_batch_labels_are_a_seeded_coin():
    cfg = tcfg.reduced()
    a = steps.dlrm_train_batch(cfg, 4000, torch.Generator().manual_seed(7))
    b = steps.dlrm_train_batch(cfg, 4000, torch.Generator().manual_seed(7))
    serve = steps.dlrm_batch(cfg, 4000, torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0], serve[0]) and torch.equal(a[1], serve[1])
    assert a[2].dtype == torch.float32 and set(a[2].unique().tolist()) == {0.0, 1.0}
    assert abs(float(a[2].mean()) - steps.LABEL_RATE) < 0.05


def test_train_master_is_the_serve_table_in_float32():
    """``from_config(master=True)`` draws the same table as serving and keeps
    the float32 values it rounded."""
    cfg = dataclasses.replace(tcfg.reduced(), compute_dtype="bfloat16")
    serve = DLRM.from_config(cfg, device="cpu", seed=4)
    train = DLRM.from_config(cfg, device="cpu", seed=4, master=True)
    assert serve.master is None and train.master.dtype == torch.float32
    assert torch.equal(serve.table, train.table)
    assert torch.equal(train.table, train.master.to(torch.bfloat16))
    for a, b in zip(serve.leaves().values(), train.leaves().values()):
        assert torch.equal(a, b)
    train.release_master()
    assert train.master is None


def test_serving_records_no_autograd_graph():
    model = DLRM.from_config(tcfg.reduced(), device="cpu")
    assert all(p.requires_grad for k, p in model.leaves().items() if k != "tables")
    dense, sparse = steps.dlrm_batch(model.cfg, 8, torch.Generator().manual_seed(0))
    out = model(dense, sparse)
    _, fields = model.fields(dense, sparse)
    assert out.grad_fn is None and not out.requires_grad and fields.grad_fn is None


# ---------------------------------------------------------------- the wrappers
@pytest.mark.parametrize("case,exc,match", [
    ("bwd cpu", ValueError, "CUDA device"),
    ("bwd int16", TypeError, "int32 or int64"),
    ("bwd float64", TypeError, "float32 or bfloat16"),
    ("bwd combiner", ValueError, "combiner"),
    ("bwd shapes", ValueError, r"\(B, L\)"),
    ("dot cpu", ValueError, "CUDA device"),
    ("dot dz", ValueError, "dz must be"),
    ("dot float64", TypeError, "float32 or bfloat16"),
    ("sgd cpu", ValueError, "CUDA device"),
    ("sgd master", TypeError, "float32 master"),
    ("unregistered", ValueError, "not registered"),
])
def test_training_wrappers_refuse(case, exc, match):
    """The CUDA wrappers raise on what their kernels do not take, before any
    launch; a CPU tensor is refused, never sent to a twin."""
    idx, g = torch.zeros((4, 1), dtype=torch.int32), torch.zeros((4, 8))
    x, dz = torch.zeros((2, 5, 8)), torch.zeros((2, 10))
    t = torch.zeros((6, 8))
    sgd = (t.clone(), t, torch.zeros(3, dtype=torch.int64), torch.zeros(3, 8),
           torch.tensor(1), torch.tensor(0.1), torch.tensor(1.0))
    calls = {
        "bwd cpu": lambda: embedding_bag_backward_cuda(idx, g),
        "bwd int16": lambda: embedding_bag_backward_cuda(idx.short(), g),
        "bwd float64": lambda: embedding_bag_backward_cuda(idx, g.double()),
        "bwd combiner": lambda: embedding_bag_backward_cuda(idx, g, "max"),
        "bwd shapes": lambda: embedding_bag_backward_cuda(idx[:3], g),
        "dot cpu": lambda: dot_interaction_backward_cuda(x, dz),
        "dot dz": lambda: dot_interaction_backward_cuda(x, dz[:, :9]),
        "dot float64": lambda: dot_interaction_backward_cuda(x.double(), dz),
        "sgd cpu": lambda: sgd_rows_cuda(*sgd),
        "sgd master": lambda: sgd_rows_cuda(sgd[0].double(), *sgd[1:]),
        "unregistered": lambda: mapped_ptr(t),
    }
    with pytest.raises(exc, match=match):
        calls[case]()


def test_mapped_pointer_of_a_view_inside_a_registration(monkeypatch):
    """A view of registered host memory is read by the card at its own
    address (unified addressing); a range that runs past the registration,
    or memory outside every registration, is refused."""
    from repro_torch.kernels import embedding_bag as eb

    whole = torch.zeros((12, 4))
    master = whole[:10]
    monkeypatch.setitem(eb._registered, master.data_ptr(), master.numel() * 4)
    assert mapped_ptr(master) == master.data_ptr()
    assert mapped_ptr(master[3:7]) == master.data_ptr() + 3 * 4 * 4
    with pytest.raises(ValueError, match="not registered"):
        mapped_ptr(whole[8:12])
    with pytest.raises(ValueError, match="not registered"):
        mapped_ptr(torch.zeros((10, 4)))


def test_host_probe_reads_the_host():
    """The probe's readings on this host, without nvidia-smi: memory, the
    huge-page mode and share, where a tensor's pages lie; each reading of
    a file the host does not have is None."""
    from repro_torch.kernels.embedding_bag import host_empty
    from repro_torch.launch import host_probe

    mem = host_probe.meminfo()
    assert 0 < mem["MemAvailable"] <= mem["MemTotal"]
    assert set(host_probe.cgroup_memory()) == {"limit", "current"}
    assert host_probe.rss_bytes() > 0
    thp = host_probe.thp_mode()
    assert thp is None or thp["enabled"] in ("always", "madvise", "never")
    assert host_probe.thp_mode("/nonexistent") is None
    assert host_probe.anon_huge_pages() is None or host_probe.anon_huge_pages() >= 0
    assert host_probe.anon_huge_pages("/nonexistent") is None
    io = host_probe.iommu()
    assert io is None or all(isinstance(name, str) for name in io)
    assert host_probe.iommu("/nonexistent") is None
    assert host_probe.card_numa_node("0000:18:00.0", "/nonexistent") is None
    assert host_probe.pcie_sysfs("0000:18:00.0", "/nonexistent") is None
    t = host_empty((1024, 128))
    t.fill_(1.0)
    got = host_probe.pages(t)
    assert got["bytes"] == t.numel() * 4
    if got["huge_bytes"] is not None:
        assert 0 <= got["huge_bytes"] and 0 <= got["huge_share"] <= 1.0 + 1e-9
    if got["numa_bytes"] is not None:
        assert sum(got["numa_bytes"].values()) >= t.numel() * 4
    assert host_probe.pages(t, "/nonexistent")["huge_share"] is None


def test_host_master_is_a_contiguous_float32_tensor():
    """``_host_master`` on the CPU: an unregistered, contiguous (n, d)
    float32 tensor on the master's backing, which the model keeps."""
    from repro_torch.models import dlrm as tdlrm

    master, secs = tdlrm._host_master(1000, 16, torch.device("cpu"))
    assert master.shape == (1000, 16) and master.dtype == torch.float32
    assert master.is_contiguous() and master.device.type == "cpu" and secs == 0.0
    master[:] = 2.5
    assert float(master.sum()) == 2.5 * 16_000
