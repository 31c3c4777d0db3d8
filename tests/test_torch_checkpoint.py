"""The port's checkpoints against the JAX package's, on the CPU.

One training state (parameters, AdamW state with SGD leaves whose moments
are None, an error-feedback residual) of GCN and of a 12-layer GatedGCN is
held by both packages with the same values. Saved at the same step, every
``.npy`` file must be equal byte for byte and the manifests equal apart
from the reference's ``treedef``, which the port does not write; each
package must restore the other's checkpoint to the same values. The
reference's own crash case runs on the port's functions; its dtype case
and the keep-last-3 rule have port twins.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.train.checkpoint as ref
import tests.test_train_serve as ref_suite
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro_torch.models.gnn import GCN, GatedGCN, GatedGCNConfig, GCNConfig
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.array(x), tree,
                        is_leaf=lambda x: x is None)


def _states(arch):
    """(reference state, port state) with equal values."""
    rng = np.random.default_rng(7)
    key = jax.random.PRNGKey(0)
    if arch == "gcn":
        cfg = GCNConfig(n_layers=3, d_hidden=5)
        jparams = jgnn.gcn_init(cfg, key, 6, 3)
        model = GCN.from_numpy_params(_np_tree(jparams), cfg, device="cpu")
        sgd = ()
    else:
        cfg = GatedGCNConfig(n_layers=12, d_hidden=4)
        jparams = jgnn.gatedgcn_init(cfg, key, 6, 2, 3)
        model = GatedGCN.from_numpy_params(_np_tree(jparams), cfg, device="cpu")
        sgd = ("embed_e",)
    jcfg, tcfg = jopt.AdamWConfig(sgd_paths=sgd), topt.AdamWConfig(sgd_paths=sgd)
    jopt_state = jopt.init_opt_state(jparams, jcfg)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), jparams)
    jparams, jopt_state, _ = jopt.adamw_update(jparams, grads, jopt_state, jcfg)
    jres = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), jparams)
    jstate = {"params": jparams, "opt_state": jopt_state, "residual": jres}

    leaves = model.leaves()
    opt = topt.init_opt_state(leaves, tcfg)
    flat = dict(ck.flatten(_np_tree(jstate)))  # reference values by path
    with torch.no_grad():
        for k, p in leaves.items():
            p.copy_(torch.from_numpy(flat[f"params/{k}"]))
        opt["step"].copy_(torch.from_numpy(flat["opt_state/step"]))
        for name in ("master", "m", "v"):
            for k, t in opt[name].items():
                if t is not None:
                    t.copy_(torch.from_numpy(flat[f"opt_state/{name}/{k}"]))
    res = {k: torch.from_numpy(flat[f"residual/{k}"].copy()) for k in leaves}
    return jstate, {"params": leaves, "opt_state": opt, "residual": res}


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


@pytest.mark.parametrize("arch", ["gcn", "gatedgcn"])
def test_files_equal_the_reference_and_restore_both_ways(arch, tmp_path):
    jstate, tstate = _states(arch)
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    r_path = ref.save_checkpoint(rdir, 100, jstate)
    p_path = ck.save_checkpoint(pdir, 100, tstate)
    assert _files(r_path) == _files(p_path)
    r_man = json.load(open(os.path.join(r_path, "manifest.json")))
    p_man = json.load(open(os.path.join(p_path, "manifest.json")))
    assert "treedef" in r_man and "treedef" not in p_man
    r_man.pop("treedef")
    assert r_man == p_man
    if arch == "gatedgcn":  # numeric layer order, not lexicographic
        paths = [rec["path"] for rec in p_man["leaves"] if rec["path"].startswith("params/layers")]
        assert paths.index("params/layers/2/A/b") < paths.index("params/layers/10/A/b")
        assert not any(rec["path"].startswith("opt_state/m/embed_e") for rec in p_man["leaves"])

    want = dict(ck.flatten(_np_tree(jstate)))
    got, step = ck.restore_checkpoint(rdir, device="cpu")  # the port opens the reference's
    assert step == 100
    got = dict(ck.flatten(got))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(v).dtype and np.array_equal(got[k].numpy(), v), k
    back, step = ref.restore_checkpoint(pdir)  # and the reference opens the port's
    assert step == 100
    flat_back, _ = jax.tree_util.tree_flatten_with_path(back)
    assert len(flat_back) == len(want)
    for (kp, v), (k, w) in zip(flat_back, want.items()):
        assert "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp) == k
        np.testing.assert_array_equal(np.asarray(v), w)


def test_flatten_spells_the_port_paths():
    tree = {"layers": [{"b": 1, "w": 2}, {"b": 3, "w": 4}], "x": {"y": [5]}}
    assert dict(ck.flatten(tree)) == {"layers/0/b": 1, "layers/0/w": 2, "layers/1/b": 3,
                                    "layers/1/w": 4, "x/y/0": 5}


@pytest.mark.parametrize("n_layers", [3, 11])
def test_flatten_orders_layers_numerically(n_layers):
    flat = {f"layers/{i}/w": i for i in range(n_layers)}
    flat["a/b"], flat["z"] = -1, None
    got = ck.flatten({"p": flat})
    assert [p for p, _ in got] == ["p/a/b"] + [f"p/layers/{i}/w" for i in range(n_layers)]


def test_exotic_dtypes_round_trip_both_ways(tmp_path):
    base = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    names = {"bf16": "bfloat16", "fp8_e4m3": "float8_e4m3fn", "fp8_e5m2": "float8_e5m2"}
    port_tree = {k: torch.from_numpy(base).to(getattr(torch, n)) for k, n in names.items()}
    port_tree["plain"] = torch.from_numpy(base)
    ck.save_checkpoint(str(tmp_path / "p"), 3, port_tree)
    got, step = ck.restore_checkpoint(str(tmp_path / "p"), device="cpu")
    assert step == 3
    for k, t in port_tree.items():
        assert got[k].dtype == t.dtype
        bits = torch.int16 if t.element_size() == 2 else (
            torch.uint8 if t.element_size() == 1 else torch.int32)
        assert torch.equal(got[k].view(bits), t.view(bits)), k
    back, _ = ref.restore_checkpoint(str(tmp_path / "p"))
    for k, n in names.items():
        assert back[k].dtype == getattr(ml_dtypes, n)
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      base.astype(getattr(ml_dtypes, n)).view(np.uint8))
    ref_tree = {k: base.astype(getattr(ml_dtypes, n)) for k, n in names.items()}
    ref.save_checkpoint(str(tmp_path / "r"), 4, ref_tree)
    got, _ = ck.restore_checkpoint(str(tmp_path / "r"), device="cpu")
    for k, n in names.items():
        assert got[k].dtype == getattr(torch, n)
        assert torch.equal(got[k], port_tree[k]), k
    ck.save_checkpoint(str(tmp_path / "n"), 5, ref_tree)  # numpy leaves of those dtypes
    assert _files(str(tmp_path / "n" / "step_00000005")) == _files(
        str(tmp_path / "r" / "step_00000004"))


def test_reference_crash_case_on_the_port(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_suite, "save_checkpoint", ck.save_checkpoint)
    monkeypatch.setattr(ref_suite, "latest_step", ck.latest_step)
    monkeypatch.setattr(ref_suite, "restore_checkpoint",
                        lambda d, step=None: ck.restore_checkpoint(d, step, device="cpu"))
    ref_suite.test_checkpoint_crash_leaves_tmp_and_previous_survives(tmp_path, monkeypatch)


def test_async_checkpointer_keeps_the_last_3(tmp_path):
    saver, want = ck.AsyncCheckpointer(str(tmp_path / "p")), ref.AsyncCheckpointer(
        str(tmp_path / "r"))
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "r")
    for step in (5, 10, 15, 20, 25):
        saver.save(step, {"w": torch.full((3,), float(step))})
        want.save(step, {"w": jnp.full((3,), float(step))})
    saver.wait()
    want.wait()
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "r")) == [
        "step_00000015", "step_00000020", "step_00000025"]
    assert ck.latest_step(str(tmp_path / "p")) == 25


def test_async_save_copies_before_an_in_place_step(tmp_path):
    params = {"w": torch.arange(100_000, dtype=torch.float32)}
    saver = ck.AsyncCheckpointer(str(tmp_path))
    saver.save(1, {"params": params})
    params["w"].add_(1.0)  # the next step writes the parameters in place at once
    saver.wait()
    got, _ = ck.restore_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(got["params"]["w"], torch.arange(100_000, dtype=torch.float32))


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path), device="cpu")
    assert ck.latest_step(str(tmp_path / "nothing")) is None


def test_async_checkpointer_times_each_copy_and_write(tmp_path):
    saver = ck.AsyncCheckpointer(str(tmp_path))
    for step in (1, 2, 3):
        saver.save(step, {"w": torch.full((1000,), float(step))})
    saver.wait()
    assert len(saver.copy_s) == len(saver.write_s) == 3
    assert all(v >= 0 for v in saver.copy_s + saver.write_s)
