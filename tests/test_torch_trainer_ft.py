"""The port's Trainer with checkpoints, failure injection and gradient
compression against the JAX package's, on the CPU.

Both trainers take the same steps on one quadratic loss (its gradients are
elementwise, so equal in both packages): the logs must agree at rtol 1e-5
(the optimizer's tolerance in ``tests/test_torch_train.py``) with each
codec, with a checkpoint directory whose manifests must then be equal
apart from ``treedef``, and through a failure and a restore. The
reference's restart, failure and compressed-convergence cases have port
twins here (their bodies call JAX).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import AdamWConfig as JAdamW
from repro.train import CompressionConfig as JComp
from repro.train import FailureInjector as JInjector
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JConfig
from repro.train import WorkerFailure as JFailure
from repro_torch.models.gnn import EdgeCSR, GatedGCN, GatedGCNConfig, gatedgcn_loss
from repro_torch.train import (AdamWConfig, CompressionConfig, FailureInjector, Trainer,
                               TrainerConfig, WorkerFailure, data_skip_offset, latest_step,
                               restore_checkpoint)
from repro_torch.train.checkpoint import flatten
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TARGET = {"a/w": np.array([[1.0, -2.0, 0.5], [3.0, 0.25, -1.5]], np.float32),
          "b": np.array([0.5, -4.0, 2.0, 8.0], np.float32)}
START = {"a/w": np.zeros((2, 3), np.float32), "b": np.full(4, 1.0, np.float32)}


def _port(cfg, injector=None):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in START.items()}
    target = {k: torch.from_numpy(v) for k, v in TARGET.items()}

    def loss(batch):
        return sum(((params[k] - target[k]) ** 2 * batch).sum() for k in params)

    return Trainer(loss, params, cfg, failure_injector=injector)


def _ref(cfg, injector=None):
    def loss(p, batch):
        return jnp.sum((p["a"]["w"] - TARGET["a/w"]) ** 2 * batch) + \
            jnp.sum((p["b"] - TARGET["b"]) ** 2 * batch)

    params = {"a": {"w": jnp.asarray(START["a/w"])}, "b": jnp.asarray(START["b"])}
    return JTrainer(loss, params, cfg, failure_injector=injector)


def _data(torch_side):
    i = 0
    while True:
        v = np.float32(1.0 + 0.25 * (i % 4))
        yield torch.tensor(v) if torch_side else jnp.asarray(v)
        i += 1


def _configs(tmp_path, codec, **kw):
    opt = dict(lr=0.05, warmup_steps=2, total_steps=40, weight_decay=0.1)
    common = dict(total_steps=12, checkpoint_every=4, log_every=2, **kw)
    return (TrainerConfig(checkpoint_dir=str(tmp_path / "port"), opt=AdamWConfig(**opt),
                          compression=CompressionConfig(codec, 0.3), **common),
            JConfig(checkpoint_dir=str(tmp_path / "ref"), opt=JAdamW(**opt),
                    compression=JComp(codec, 0.3), **common))


def _same_logs(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert [set(r) for r in got] == [set(r) for r in want]
    for g, w in zip(got, want):
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as fh:
        man = json.load(fh)
    man.pop("treedef", None)
    return man


@pytest.mark.parametrize("codec", ["none", "int8", "topk"])
def test_logs_and_checkpoints_equal_the_reference(codec, tmp_path):
    pcfg, rcfg = _configs(tmp_path, codec)
    got = _port(pcfg).run(_data(True))
    want = _ref(rcfg).run(_data(False))
    _same_logs(got, want)
    steps = sorted(os.listdir(tmp_path / "port"))
    assert steps == sorted(os.listdir(tmp_path / "ref")) == [
        "step_00000004", "step_00000008", "step_00000012"]
    for s in steps:
        assert _manifest(tmp_path / "port" / s) == _manifest(tmp_path / "ref" / s)
    assert any(r["path"].startswith("residual/") for r in
               _manifest(tmp_path / "port" / steps[-1])["leaves"]) == (codec != "none")


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_failure_and_restore_equal_the_reference(codec, tmp_path):
    pcfg, rcfg = _configs(tmp_path, codec)
    logs = []
    for make, cfg, failure, torch_side in ((_port, pcfg, WorkerFailure, True),
                                          (_ref, rcfg, JFailure, False)):
        injector = (FailureInjector if torch_side else JInjector)({7: [0]})
        data = _data(torch_side)
        with pytest.raises(failure) as err:
            make(cfg, injector).run(data)
        assert err.value.step == 7
        fresh = make(cfg)
        assert fresh.maybe_restore() and fresh.step == 4
        logs.append(fresh.run(data, steps=cfg.total_steps - fresh.step))
    _same_logs(*logs)


def test_restore_copies_into_the_live_tensors(tmp_path):
    cfg, _ = _configs(tmp_path, "int8")
    first = _port(cfg)
    first.run(_data(True), steps=4)
    saved, _ = restore_checkpoint(cfg.checkpoint_dir, 4, device="cpu")
    fresh = _port(cfg)
    live = dict(fresh.params)
    masters = dict(fresh.opt_state["master"])
    res = dict(fresh.residual)
    assert fresh.maybe_restore()
    for k, t in live.items():  # the same tensors, now holding the checkpoint
        assert fresh.params[k] is t and fresh.opt_state["master"][k] is masters[k]
        assert fresh.residual[k] is res[k]
        assert torch.equal(t.detach(), dict(flatten(saved["params"]))[k])
        assert torch.equal(res[k], dict(flatten(saved["residual"]))[k])
        assert torch.equal(t.detach(), first.params[k].detach())
    assert int(fresh.opt_state["step"]) == 4


# ---------------------------------------------------------------- port twins
def _gatedgcn_batch(seed, n=30, e=90):
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.integers(0, n, e))
    return {"x": torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)),
            "ef": torch.zeros(e, 4), "senders": torch.from_numpy(rng.integers(-1, n, e)),
            "receivers": r, "y": torch.from_numpy(rng.integers(0, 3, n)),
            "mask": torch.from_numpy(rng.random(n) < 0.5), "csr": EdgeCSR.from_receivers(r, n)}


def test_checkpoint_restart_resumes_training(tmp_path):
    cfg = GatedGCNConfig(n_layers=3, d_hidden=16)
    batch = _gatedgcn_batch(0)
    tc = TrainerConfig(total_steps=6, checkpoint_every=3, log_every=2,
                       checkpoint_dir=str(tmp_path))
    m1 = GatedGCN.from_config(cfg, 6, 4, 3, device="cpu", seed=0)
    t1 = Trainer(lambda b: gatedgcn_loss(m1, b), m1.leaves(), tc)
    t1.run(iter(lambda: batch, None), steps=6)
    assert latest_step(str(tmp_path)) == 6
    m2 = GatedGCN.from_config(cfg, 6, 4, 3, device="cpu", seed=1)
    t2 = Trainer(lambda b: gatedgcn_loss(m2, b), m2.leaves(), tc)
    assert t2.maybe_restore() and t2.step == 6
    for k, p in m2.leaves().items():  # the module itself holds the saved weights
        assert torch.equal(p.detach(), m1.leaves()[k].detach()), k
    t2.run(iter(lambda: batch, None), steps=2)
    assert t2.step == 8
    saved, _ = restore_checkpoint(str(tmp_path), 6, device="cpu")
    leaf = next(iter(dict(flatten(saved["params"]))))
    np.testing.assert_allclose(dict(flatten(saved["params"]))[leaf].numpy(),
                               m1.leaves()[leaf].detach().numpy())


def test_failure_inject_and_recover(tmp_path):
    def make(injector=None):
        w = torch.nn.Parameter(torch.tensor([4.0]))
        tc = TrainerConfig(total_steps=20, checkpoint_every=5, log_every=5,
                           checkpoint_dir=str(tmp_path),
                           opt=AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0))
        return Trainer(lambda b: ((w - b) ** 2).sum(), {"w": w}, tc, failure_injector=injector)

    data = iter(lambda: torch.tensor([1.0]), None)
    with pytest.raises(WorkerFailure):
        make(FailureInjector({12: [0]})).run(data)
    assert latest_step(str(tmp_path)) == 10
    t2 = make()
    assert t2.maybe_restore() and t2.step == 10
    assert data_skip_offset(t2.step, global_batch=8) == 80
    t2.run(data, steps=10)
    assert t2.step == 20


def test_compressed_training_converges():
    w = torch.nn.Parameter(torch.tensor([5.0, -3.0, 2.0]))
    tc = TrainerConfig(total_steps=120, log_every=40, checkpoint_dir=None,
                       opt=AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0),
                       compression=CompressionConfig(codec="int8"))
    Trainer(lambda _: (w ** 2).sum(), {"w": w}, tc).run(iter(lambda: 0, None))
    assert float((w.detach() ** 2).sum()) < 1e-2
