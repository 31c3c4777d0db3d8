"""The port's AdamW and step loop against the JAX package's, on the CPU.

``repro_torch.train.optimizer`` updates in place where the reference
returns new trees; both are fed the same parameters and gradients, made by
numpy from a seed, and must give the same parameters, master copy,
moments, step, learning rate and gradient norm. ``Trainer`` is held
against ``repro.train.loop.Trainer`` on one quadratic loss.

Tolerances: float32 at rtol 1e-5 and atol 1e-6 (the same arithmetic in
the same order; XLA may contract a multiply-add into one rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import Trainer, TrainerConfig
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"emb/table": (10, 4), "mlp/b": (4,), "mlp/w": (4, 3)}


def _tree(flat):
    """The reference's pytree of the flat {path: array} dict."""
    return {"emb": {"table": jnp.asarray(flat["emb/table"])},
            "mlp": {"b": jnp.asarray(flat["mlp/b"]), "w": jnp.asarray(flat["mlp/w"])}}


def _flat(tree):
    return {"emb/table": tree["emb"]["table"], "mlp/b": tree["mlp"]["b"],
            "mlp/w": tree["mlp"]["w"]}


@pytest.mark.parametrize("step", [0, 1, 37, 100, 101, 5000, 9999, 10_000, 20_000])
def test_schedule_matches_the_reference(step):
    cfg = topt.AdamWConfig()
    got = topt.schedule(torch.tensor(step, dtype=torch.int32), cfg)
    want = jopt.schedule(jnp.asarray(step, jnp.int32), jopt.AdamWConfig())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip off, clip on
@pytest.mark.parametrize("sgd", [(), ("emb",)])
def test_adamw_update_matches_the_reference_over_5_steps(grad_scale, sgd):
    rng = np.random.default_rng(int(grad_scale * 100) + len(sgd))
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, sgd_paths=sgd)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, sgd_paths=sgd)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = topt.init_opt_state(params, tcfg)
    jparams = _tree(init)
    jstate = jopt.init_opt_state(jparams, jcfg)
    assert all((state["m"][k] is None) == ("emb" in sgd and k.startswith("emb")) for k in SHAPES)
    for _ in range(5):
        grads = {k: (rng.normal(size=s) * grad_scale).astype(np.float32)
                 for k, s in SHAPES.items()}
        met = topt.adamw_update(params, {k: torch.from_numpy(g) for k, g in grads.items()},
                                state, tcfg)
        jparams, jstate, jmet = jopt.adamw_update(jparams, _tree(grads), jstate, jcfg)
        assert int(state["step"]) == int(jstate["step"])
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(_flat(jparams)[k]), **TOL,
                                       err_msg=k)
            np.testing.assert_allclose(state["master"][k].numpy(),
                                       np.asarray(_flat(jstate["master"])[k]), **TOL)
            for name in ("m", "v"):
                want = _flat(jstate[name])[k]
                if want is None:
                    assert state[name][k] is None
                else:
                    np.testing.assert_allclose(state[name][k].numpy(), np.asarray(want), **TOL)


def test_adamw_update_decays_only_matrices():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=1, weight_decay=0.5)
    params = {"b": torch.ones(3), "w": torch.ones(2, 2)}
    state = topt.init_opt_state(params, cfg)
    topt.adamw_update(params, {k: torch.zeros_like(p) for k, p in params.items()}, state, cfg)
    assert params["b"].tolist() == [1.0] * 3  # zero gradient, no decay
    assert params["w"].tolist() == [[0.5] * 2] * 2  # 1 - lr * wd * 1


# ---------------------------------------------------------------- the loop
def _quadratic_pair():
    target = np.array([1.0, -2.0, 0.5], np.float32)
    start = np.zeros(3, np.float32)
    tw = torch.nn.Parameter(torch.from_numpy(start.copy()))

    def tloss(batch):
        return ((tw - torch.from_numpy(target)) ** 2 * batch).sum()

    def jloss(params, batch):
        return jnp.sum((params["w"] - jnp.asarray(target)) ** 2 * batch)

    return tw, tloss, {"w": jnp.asarray(start)}, jloss


def test_trainer_logs_the_reference_keys_and_values():
    opt = dict(lr=0.1, warmup_steps=1, total_steps=10)
    tw, tloss, jparams, jloss = _quadratic_pair()
    data = [np.float32(1.0 + 0.5 * i) for i in range(6)]
    got = Trainer(tloss, {"w": tw}, TrainerConfig(log_every=2, opt=topt.AdamWConfig(**opt))
                  ).run(iter(torch.tensor(d) for d in data), steps=5)
    want = JTrainer(jloss, jparams, JTrainerConfig(log_every=2, opt=jopt.AdamWConfig(**opt))
                    ).run(iter(jnp.asarray(d) for d in data), steps=5)
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4, 5]
    for g, w in zip(got, want):
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)

