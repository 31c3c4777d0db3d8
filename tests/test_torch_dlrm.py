"""The port's DLRM serving path against the JAX package's, on the CPU.

Configs and shapes must equal the reference's. ``DLRM.from_numpy_params``
carries ``dlrm_init``'s parameters across and must give ``dlrm_apply``'s
logits; the kernels run as their plain twins here. Tolerances: float32
rtol/atol 1e-5 (the same float32 arithmetic in another summation order);
bfloat16 fields are exact where they are copies of table rows, and logits
computed from bf16 fields are held at rtol/atol 1e-3 (the float32 bottom
MLP output rounds to bf16 and can land on the other side of a rounding
boundary, one bf16 step of 2**-8 relative in one field).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as jcfg
from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import dlrm as jdlrm
from repro_torch.configs import dlrm_mlperf as tcfg
from repro_torch.configs import registry as treg
from repro_torch.launch import steps
from repro_torch.models import dlrm as tdlrm
from repro_torch.models.common import MLP
from repro_torch.models.dlrm import DLRM
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL_BF16 = dict(name="dlrm-small-bf16", embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16, 1),
                  compute_dtype="bfloat16", row_counts=tuple(range(3, 29)))


def _np_params(cfg, seed=0):
    params = jdlrm.dlrm_init(cfg, jax.random.PRNGKey(seed))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, r, b) for r in cfg.row_counts], 1).astype(np.int32)
    return dense, sparse


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_configs_equal_the_reference(which):
    ours, theirs = getattr(tcfg, which)(), getattr(jcfg, which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.n_params() == theirs.n_params()
    assert ours.n_fields == theirs.n_fields == 27
    assert [ours.padded_rows(r) for r in ours.row_counts] == \
        [theirs.padded_rows(r) for r in theirs.row_counts]


def test_full_config_sizes():
    cfg = tcfg.config()
    rows = sum(cfg.padded_rows(r) for r in cfg.row_counts)
    assert rows == 177_948_416 < 2**31
    assert rows * cfg.embed_dim * 2 == 45_554_794_496  # bytes in bf16
    assert max(cfg.row_counts) * cfg.embed_dim > 2**31  # element offsets need int64


def test_registry_matches_the_reference():
    arch, ref_arch = treg.get_arch("dlrm-mlperf"), jreg.get_arch("dlrm-mlperf")
    assert arch.family == ref_arch.family == "recsys"
    assert set(arch.shapes) == set(ref_arch.shapes)
    for name, shape in arch.shapes.items():
        assert (shape.kind, shape.params) == (ref_arch.shapes[name].kind,
                                              ref_arch.shapes[name].params)
    assert dataclasses.asdict(arch.config()) == dataclasses.asdict(ref_arch.config())
    assert list(treg.ARCHS) == list(jreg.ARCHS)  # the reference's ten archs, in its order


# ---------------------------------------------------------------- MLP
@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_matches_mlp_apply(final_act):
    key = jax.random.PRNGKey(3)
    layers = jcommon.mlp_params(key, [13, 32, 16, 4])
    x = np.random.default_rng(3).normal(size=(8, 13)).astype(np.float32)
    want = jcommon.mlp_apply(layers, jnp.asarray(x), act=jax.nn.relu, final_act=final_act)
    mlp = MLP([{"w": torch.from_numpy(np.array(p["w"])), "b": torch.from_numpy(np.array(p["b"]))}
               for p in layers], final_act=final_act)
    got = mlp(torch.from_numpy(x)).detach()  # trainable weights: the output records a graph
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if final_act:
        assert (got.numpy() >= 0).all()


def test_mlp_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    mlp = MLP.init([64, 512, 8], generator=gen, device=torch.device("cpu"))
    assert [tuple(w.shape) for w in mlp.w] == [(64, 512), (512, 8)]
    assert all(not b.any() for b in mlp.b)
    assert abs(float(mlp.w[0].std()) - 64 ** -0.5) < 0.01


# ---------------------------------------------------------------- DLRM forward
def test_dlrm_matches_dlrm_apply_float32():
    cfg = jcfg.reduced()
    params, pnp = _np_params(cfg)
    model = DLRM.from_numpy_params(pnp, tcfg.reduced(), device="cpu")
    dense, sparse = _batch(cfg, 32)
    want = jdlrm.dlrm_apply(params, jnp.asarray(dense), jnp.asarray(sparse), cfg)
    got = model(torch.from_numpy(dense), torch.from_numpy(sparse))
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # int64 ids give the same logits
    got64 = model(torch.from_numpy(dense), torch.from_numpy(sparse).long())
    torch.testing.assert_close(got64, got, rtol=0, atol=0)


def test_dlrm_matches_dlrm_apply_bfloat16():
    cfg = jdlrm.DLRMConfig(**SMALL_BF16)
    params, pnp = _np_params(cfg, seed=1)
    model = DLRM.from_numpy_params(pnp, tdlrm.DLRMConfig(**SMALL_BF16), device="cpu")
    assert model.table.dtype == torch.bfloat16
    dense, sparse = _batch(cfg, 32, seed=1)
    want = jdlrm.dlrm_apply(params, jnp.asarray(dense), jnp.asarray(sparse), cfg)
    got = model(torch.from_numpy(dense), torch.from_numpy(sparse))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    # the 26 embedding fields are bf16 copies of the table rows, bit for bit
    _, fields = model.fields(torch.from_numpy(dense), torch.from_numpy(sparse))
    want_emb = np.stack([np.asarray(params["tables"][f"table_{i}"][sparse[:, i]]
                                    .astype(jnp.bfloat16).astype(jnp.float32))
                         for i in range(cfg.n_sparse)], axis=1)
    np.testing.assert_array_equal(fields[:, 1:].float().numpy(), want_emb)


def test_dlrm_row_offsets_address_each_field():
    cfg = tcfg.reduced()
    model = DLRM.from_config(cfg, device="cpu", seed=0)
    padded = [cfg.padded_rows(r) for r in cfg.row_counts]
    assert model.row_offsets.dtype == torch.int32
    assert model.row_offsets.tolist() == list(np.cumsum([0] + padded[:-1]))
    dense, sparse = (torch.from_numpy(a) for a in _batch(cfg, 4))
    _, fields = model.fields(dense, sparse)
    for i in range(cfg.n_sparse):
        rows = model.table[model.row_offsets[i] + sparse[:, i].long()]
        torch.testing.assert_close(fields[:, 1 + i], rows, rtol=0, atol=0)


def test_from_config_is_seeded_and_chunked(monkeypatch):
    cfg = tcfg.reduced()
    monkeypatch.setattr(tdlrm, "_INIT_CHUNK_ROWS", 100)  # several chunks per table
    a = DLRM.from_config(cfg, device="cpu", seed=0)
    b = DLRM.from_config(cfg, device="cpu", seed=0)
    torch.testing.assert_close(a.table, b.table, rtol=0, atol=0)
    c = DLRM.from_config(cfg, device="cpu", seed=1)
    assert not torch.equal(a.table, c.table)
    assert a.table.dtype == torch.float32
    assert a.table.shape == (sum(cfg.padded_rows(r) for r in cfg.row_counts), cfg.embed_dim)
    assert abs(float(a.table.std()) - cfg.embed_dim ** -0.5) < 0.02
    # every row of every chunk was drawn: no row keeps torch.empty's contents
    norms = a.table.norm(dim=1)
    assert bool(torch.isfinite(norms).all()) and float(norms.min()) > 0.2
    assert float(norms.max()) < 3.0
    bf = DLRM.from_config(tdlrm.DLRMConfig(**SMALL_BF16), device="cpu")
    assert bf.table.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["table_shape", "layer_count", "layer_shape"])
def test_from_numpy_params_rejects_wrong_shapes(bad):
    cfg = jcfg.reduced()
    _, pnp = _np_params(cfg)
    if bad == "table_shape":
        pnp["tables"]["table_3"] = pnp["tables"]["table_3"][:-1]
    elif bad == "layer_count":
        pnp["top"] = pnp["top"][:-1]
    else:
        pnp["bot"][0]["w"] = pnp["bot"][0]["w"][:, :-1]
    with pytest.raises(ValueError):
        DLRM.from_numpy_params(pnp, tcfg.reduced(), device="cpu")


def test_forward_rejects_wrong_batch_shapes():
    model = DLRM.from_config(tcfg.reduced(), device="cpu")
    dense, sparse = (torch.from_numpy(a) for a in _batch(tcfg.reduced(), 4))
    with pytest.raises(ValueError, match="dense"):
        model(dense[:, :5], sparse)
    with pytest.raises(ValueError, match="sparse"):
        model(dense, sparse[:3])


@pytest.mark.parametrize("bad", ["negative", "next_field", "past_the_end"])
def test_forward_rejects_ids_outside_their_field(bad):
    """With the tables concatenated, an out-of-field id would read another
    field's row (or past the end); the model raises instead."""
    cfg = tcfg.reduced()
    model = DLRM.from_config(cfg, device="cpu")
    dense, sparse = (torch.from_numpy(a) for a in _batch(cfg, 4))
    field, value = {"negative": (3, -1),
                    "next_field": (3, cfg.padded_rows(cfg.row_counts[3])),
                    "past_the_end": (25, cfg.padded_rows(cfg.row_counts[25]) + 7)}[bad]
    good = sparse.clone()
    good[:, field] = cfg.padded_rows(cfg.row_counts[field]) - 1  # the last padded row is valid
    model(dense, good)
    sparse[2, field] = value
    with pytest.raises(ValueError, match="outside"):
        model(dense, sparse)
    with pytest.raises(ValueError, match="outside"):
        model.fields(dense, sparse)


# ---------------------------------------------------------------- retrieval
def test_retrieval_scores_match_the_reference():
    rng = np.random.default_rng(9)
    query = rng.normal(size=(128,)).astype(np.float32)
    cands = rng.normal(size=(4096, 128)).astype(np.float32)
    want_v, want_i = jdlrm.retrieval_scores(jnp.asarray(query), jnp.asarray(cands), k=100)
    got_v, got_i = tdlrm.retrieval_scores(torch.from_numpy(query), torch.from_numpy(cands), k=100)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- cells
@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk", "retrieval_cand"])
def test_build_cell_on_the_cpu(shape):
    cell = steps.build_cell("dlrm-mlperf", shape, reduced=True, device="cpu", seed=0)
    out = cell.run()
    if shape == "retrieval_cand":
        values, idx = out
        assert values.shape == idx.shape == (100,)
        assert cell.args[1].shape == (1024, 16)
        assert torch.all(values[:-1] >= values[1:])
        return
    dense, sparse = cell.args
    assert dense.shape == (32, 13) and sparse.shape == (32, 26) and sparse.dtype == torch.int32
    rows = torch.tensor(tcfg.reduced().row_counts)
    assert bool((sparse >= 0).all()) and bool((sparse < rows).all())
    assert out.shape == (32,) and bool(torch.isfinite(out).all())
    again = steps.build_cell("dlrm-mlperf", shape, reduced=True, device="cpu", seed=0)
    torch.testing.assert_close(again.run(), out, rtol=0, atol=0)


def test_build_cell_shapes_at_full_size_without_building():
    assert steps._r256(1_000_000) == 1_000_192
    shapes = treg.get_arch("dlrm-mlperf").shapes
    assert shapes["serve_p99"].params["batch"] == 512
    assert shapes["serve_bulk"].params["batch"] == 262_144


def test_dlrm_batch_covers_every_row_range():
    cfg = tcfg.reduced()
    dense, sparse = steps.dlrm_batch(cfg, 4000, torch.Generator().manual_seed(2))
    assert dense.dtype == torch.float32
    assert sparse.max(dim=0).values.tolist() == [r - 1 for r in cfg.row_counts]
    assert sparse.min(dim=0).values.tolist() == [0] * cfg.n_sparse


def test_build_cell_train_builds_and_unknown_shape_raises():
    """The train_batch cell builds (its steps are held against the reference
    in test_torch_dlrm_train.py); an unknown shape still raises."""
    cell = steps.build_cell("dlrm-mlperf", "train_batch", reduced=True, device="cpu")
    model, opt_state, dense, sparse, labels = cell.args
    assert cell.model is model and model.master is opt_state["master"]["tables"]
    assert (dense.shape, sparse.shape, labels.shape) == ((32, 13), (32, 26), (32,))
    with pytest.raises(KeyError):
        steps.build_cell("dlrm-mlperf", "decode_32k", reduced=True, device="cpu")
