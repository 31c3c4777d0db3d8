"""Production mesh definitions: the twin of ``repro.launch.mesh``.

The reference lays each cell out on a TPU v5e pod slice, (data=16,
model=16) = 256 chips, or on two of them with a leading ``pod`` axis
(outer data-parallel over the data-centre network). The port runs on one
card, so a mesh here is a value and not a device grid: its axis names and
sizes, from which :mod:`repro_torch.distributed.sharding` derives the
reference's partition specs and the per-device bytes they imply.

Port decision: the reference's ``auto_mesh``, ``set_global_mesh`` and
``resolve_in_shardings`` bridge jax versions (axis types, the ambient mesh,
shardings for ``jax.jit``); nothing in the port needs them, so they have
no twin, and every function that reads a mesh takes it as an argument.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, in order, as a jax mesh's ``shape``."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh() -> Mesh:
    """The single-device mesh of smoke tests and examples."""
    return Mesh(("data", "model"), (1, 1))
