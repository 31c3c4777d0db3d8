"""The port's fault-tolerance runtime (host-only copies of the reference's
classes) against the JAX package's: the reference's own cases run on the
port's classes, and both packages give the same answers on one schedule."""
import pytest

import repro.train.fault_tolerance as ref
import tests.test_train_serve as ref_suite
from repro_torch.train import fault_tolerance as ft
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", ["test_straggler_detector", "test_heartbeat_monitor",
                                  "test_elastic_plan"])
def test_reference_cases_on_the_port(case, monkeypatch):
    for name in ("StragglerDetector", "HeartbeatMonitor", "ElasticPlan"):
        monkeypatch.setattr(ref_suite, name, getattr(ft, name))
    getattr(ref_suite, case)()


def test_straggler_flags_equal_the_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.0, 1.0, 3.5, 1.0, 2.5, 1.2, 9.0, 1.0]
    port, want = ft.StragglerDetector(warmup_steps=3), ref.StragglerDetector(warmup_steps=3)
    assert [port.observe(i % 3, t) for i, t in enumerate(times)] == \
        [want.observe(i % 3, t) for i, t in enumerate(times)]
    assert port.flagged == want.flagged and port._ewma == want._ewma


def test_heartbeat_and_injector_equal_the_reference():
    port, want = ft.HeartbeatMonitor(timeout_s=5), ref.HeartbeatMonitor(timeout_s=5)
    for w, t in [(0, 0.0), (1, 1.0), (2, 2.0), (0, 6.5)]:
        port.beat(w, now=t)
        want.beat(w, now=t)
    for now in (4.0, 6.5, 8.0, 20.0):
        assert port.dead_workers(now=now) == want.dead_workers(now=now)
    sched = {3: [0], 7: [1, 2]}
    assert [ft.FailureInjector(sched).failures_at(s) for s in range(9)] == \
        [ref.FailureInjector(sched).failures_at(s) for s in range(9)]
    assert ft.FailureInjector().failures_at(0) == []


@pytest.mark.parametrize("n,model", [(240, 16), (16, 16), (17, 4), (3, 4)])
def test_elastic_plan_and_skip_offset_equal_the_reference(n, model):
    try:
        want = ref.ElasticPlan(n, model).new_mesh_shape()
    except RuntimeError:
        with pytest.raises(RuntimeError):
            ft.ElasticPlan(n, model).new_mesh_shape()
    else:
        assert ft.ElasticPlan(n, model).new_mesh_shape() == want
    assert ft.data_skip_offset(n, model) == ref.data_skip_offset(n, model)
