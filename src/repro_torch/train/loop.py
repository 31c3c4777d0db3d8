"""The training loop: the twin of ``repro.train.loop``'s ``Trainer`` and
``TrainerConfig``, cut to the step loop.

A step computes the loss, the gradients of every parameter
(``torch.autograd.grad``) and one :func:`adamw_update` in place. The
reference jits a pure ``loss_fn(params, batch)``; here ``loss_fn(batch)``
reads a module's own parameters, the tensors that ``params`` names and the
optimizer updates in place. Checkpoints, gradient compression and failure
injection are not ported yet (ROADMAP.md queue A, item 16) and raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch

from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_dir: str | None = None  # not ported: anything but None raises
    log_every: int = 10
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    compression: str = "none"  # the reference's CompressionConfig.codec; only "none"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue A, item 16: "
                               "checkpoints, gradient compression and fault tolerance)")


def train_step(loss_fn: Callable, params: dict[str, torch.Tensor], opt_state: dict,
               batch, cfg: AdamWConfig) -> tuple:
    """Loss, gradients and one AdamW update in place; returns (loss,
    metrics) as tensors on the device, with no host sync."""
    loss = loss_fn(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    metrics = adamw_update(params, dict(zip(params, grads)), opt_state, cfg)
    return loss.detach(), metrics


class Trainer:
    """loss_fn(batch) -> scalar from the tensors of ``params`` (a dict of
    path -> parameter); data: an iterator of batches."""

    def __init__(self, loss_fn: Callable, params: dict[str, torch.Tensor],
                 cfg: TrainerConfig, failure_injector=None):
        if cfg.checkpoint_dir is not None:
            raise _not_ported("checkpoint_dir")
        if cfg.compression != "none":
            raise _not_ported(f"gradient compression {cfg.compression!r}")
        if failure_injector is not None:
            raise _not_ported("a failure injector")
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.params = params
        self.opt_state = init_opt_state(params, cfg.opt)
        self.step = 0
        self.metrics_log: list[dict] = []

    def run(self, data: Iterator, steps: int | None = None) -> list[dict]:
        """Take ``steps`` steps (default ``total_steps``); log {"step",
        "loss", "sec_per_step", "lr", "grad_norm"} every ``log_every`` steps
        and at the last one. ``float(loss)`` ends each step's clock, as the
        reference's does."""
        steps = steps if steps is not None else self.cfg.total_steps
        end = self.step + steps
        while self.step < end:
            batch = next(data)
            t0 = time.monotonic()
            loss, metrics = train_step(self.loss_fn, self.params, self.opt_state, batch,
                                       self.cfg.opt)
            loss = float(loss)
            dt = time.monotonic() - t0
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == end:
                self.metrics_log.append({
                    "step": self.step, "loss": loss, "sec_per_step": dt,
                    "lr": float(metrics["lr"]), "grad_norm": float(metrics["grad_norm"])})
        return self.metrics_log
