"""Fault-tolerance runtime: straggler detection, failure handling policy,
elastic re-meshing. A host-only copy of ``repro.train.fault_tolerance``,
with its behaviour: the mechanisms are real, and failure events are
injected through the :class:`FailureInjector` that tests and examples use.

The operative loop at scale: detect (heartbeat timeout or step-time EWMA
outlier) -> decide (evict / wait) -> recover (restore the latest atomic
checkpoint onto the surviving devices, skipping consumed data
deterministically).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    """EWMA step-time monitor: a worker whose step time exceeds
    `threshold` × the fleet EWMA is flagged (then evicted or rebalanced)."""

    alpha: float = 0.1
    threshold: float = 2.0
    warmup_steps: int = 5
    _ewma: float | None = None
    _steps: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, worker_id: int, step_time_s: float) -> bool:
        self._steps += 1
        if self._ewma is None:
            self._ewma = step_time_s
            return False
        is_straggler = (
            self._steps > self.warmup_steps
            and step_time_s > self.threshold * self._ewma
        )
        if is_straggler:
            self.flagged.append((worker_id, step_time_s, self._ewma))
        else:
            # stragglers do not poison the fleet estimate
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_time_s
        return is_straggler


@dataclass
class HeartbeatMonitor:
    """Tracks worker liveness; `dead_workers` after `timeout_s` of silence."""

    timeout_s: float = 30.0
    _last: dict = field(default_factory=dict)

    def beat(self, worker_id: int, now: float | None = None):
        self._last[worker_id] = time.monotonic() if now is None else now

    def dead_workers(self, now: float | None = None) -> list:
        now = time.monotonic() if now is None else now
        return [w for w, t in self._last.items() if now - t > self.timeout_s]


class FailureInjector:
    """Deterministic failure schedule for tests/examples: fail worker w at
    step s. Stands in for the hardware events we cannot produce here."""

    def __init__(self, schedule: dict[int, list[int]] | None = None):
        self.schedule = schedule or {}

    def failures_at(self, step: int) -> list[int]:
        return self.schedule.get(step, [])


@dataclass
class ElasticPlan:
    """Re-mesh decision after losing nodes: the largest (data × model) grid
    that fits the survivors while keeping the model axis intact (TP degree
    must not change without resharding params — which elastic restore also
    supports, but keeping it avoids a full reshard)."""

    n_devices: int
    model_axis: int

    def new_mesh_shape(self) -> tuple[int, int]:
        data = self.n_devices // self.model_axis
        if data < 1:
            raise RuntimeError(
                f"cannot keep model={self.model_axis} with {self.n_devices} devices"
            )
        return (data, self.model_axis)


def data_skip_offset(step: int, global_batch: int) -> int:
    """Deterministic data-stream offset after restore: consumed samples are
    skipped exactly, so a restart never re-trains on seen batches."""
    return step * global_batch
