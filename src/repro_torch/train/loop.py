"""The training loop: the twin of ``repro.train.loop``'s ``TrainerConfig``,
``Trainer`` and ``WorkerFailure``, with checkpoint/restart, straggler
hooks, failure injection and gradient compression.

A step computes the loss, the gradients of every parameter
(``torch.autograd.grad``; zero for a parameter the loss does not reach),
compresses them with error feedback when the config asks for a codec,
and applies one :func:`adamw_update` in place.
The reference jits a pure ``loss_fn(params, batch)``; here
``loss_fn(batch)`` reads a module's own parameters, the tensors that
``params`` names and the optimizer updates in place. So a restore copies
the checkpoint into those tensors, and into the optimizer state and the
residual, where the reference rebinds its pytrees: a rebound dict would
leave the module training on stale weights.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch

from repro_torch.train.checkpoint import (AsyncCheckpointer, flatten, latest_step,
                                          restore_checkpoint)
from repro_torch.train.compression import CompressionConfig, compress_gradients, init_residual
from repro_torch.train.fault_tolerance import FailureInjector, StragglerDetector
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    log_every: int = 10
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)


def train_step(loss_fn: Callable, params: dict[str, torch.Tensor], opt_state: dict,
               batch, cfg: AdamWConfig, residual: dict | None = None,
               compression: CompressionConfig | None = None) -> tuple:
    """Loss, gradients, their compression (with a codec; the residual is
    updated in place) and one AdamW update in place; returns (loss,
    metrics) as tensors on the device, with no host sync."""
    loss = loss_fn(batch)
    # a leaf the loss does not reach (NequIP's last vector and tensor mixes)
    # gets a zero gradient, as jax.grad gives it
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True, materialize_grads=True)))
    if compression is not None and compression.codec != "none":
        grads, new_res, _ = compress_gradients(grads, residual, compression)
        with torch.no_grad():
            for k, r in new_res.items():
                residual[k].copy_(r)
    metrics = adamw_update(params, grads, opt_state, cfg)
    return loss.detach(), metrics


@torch.no_grad()
def _copy_into(dst: dict, src: dict, what: str) -> None:
    """Copy each tensor of ``src`` into the tensor of ``dst`` at its path."""
    if set(dst) != set(src):
        raise ValueError(f"the checkpoint's {what} has paths {sorted(set(src) ^ set(dst))} "
                         "that the trainer's do not match")
    for k, t in dst.items():
        if t is not None:
            t.copy_(src[k])


class Trainer:
    """loss_fn(batch) -> scalar from the tensors of ``params`` (a dict of
    path -> parameter); data: an iterator of batches."""

    def __init__(self, loss_fn: Callable, params: dict[str, torch.Tensor],
                 cfg: TrainerConfig, failure_injector: FailureInjector | None = None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.params = params
        self.opt_state = init_opt_state(params, cfg.opt)
        self.residual = init_residual(params) if cfg.compression.codec != "none" else None
        self.step = 0
        self.straggler = StragglerDetector()
        self.injector = failure_injector
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir, cfg.keep_checkpoints) \
            if cfg.checkpoint_dir else None
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------- restart
    def maybe_restore(self) -> bool:
        if not self.cfg.checkpoint_dir:
            return False
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return False
        dev = next(iter(self.params.values())).device
        state, step = restore_checkpoint(self.cfg.checkpoint_dir, step, device=dev)
        _copy_into(self.params, dict(flatten(state["params"])), "params")
        opt = state["opt_state"]
        with torch.no_grad():
            self.opt_state["step"].copy_(opt["step"])
        for name in ("master", "m", "v"):
            live = {k: t for k, t in self.opt_state[name].items() if t is not None}
            _copy_into(live, dict(flatten(opt.get(name, {}))), f"opt_state/{name}")
        if self.residual is not None and "residual" in state:
            _copy_into(self.residual, dict(flatten(state["residual"])), "residual")
        self.step = step
        return True

    def _save(self):
        if self.ckpt is None:
            return
        state = {"params": self.params, "opt_state": self.opt_state}
        if self.residual is not None:
            state["residual"] = self.residual
        self.ckpt.save(self.step, state)

    # ---------------------------------------------------------------- run
    def run(self, data: Iterator, steps: int | None = None) -> list[dict]:
        """Take ``steps`` steps (default ``total_steps``); log {"step",
        "loss", "sec_per_step", "lr", "grad_norm"} every ``log_every`` steps
        and at the last one, save every ``checkpoint_every`` steps and at
        the end. ``float(loss)`` ends each step's clock, as the reference's
        does. An injected failure drains the checkpointer, then raises
        :class:`WorkerFailure`."""
        steps = steps if steps is not None else self.cfg.total_steps
        end = self.step + steps
        while self.step < end:
            if self.injector and self.injector.failures_at(self.step):
                # failure event: drain in-flight checkpoint I/O so recovery
                # sees the last *committed* step, then surface the failure
                if self.ckpt is not None:
                    self.ckpt.wait()
                raise WorkerFailure(self.step)
            batch = next(data)
            t0 = time.monotonic()
            loss, metrics = train_step(self.loss_fn, self.params, self.opt_state, batch,
                                       self.cfg.opt, self.residual, self.cfg.compression)
            loss = float(loss)
            dt = time.monotonic() - t0
            self.straggler.observe(0, dt)
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == end:
                self.metrics_log.append({
                    "step": self.step, "loss": loss, "sec_per_step": dt,
                    "lr": float(metrics["lr"]), "grad_norm": float(metrics["grad_norm"])})
            if self.cfg.checkpoint_dir and self.step % self.cfg.checkpoint_every == 0:
                self._save()
        if self.ckpt is not None:
            self._save()
            self.ckpt.wait()
        return self.metrics_log


class WorkerFailure(RuntimeError):
    def __init__(self, step):
        super().__init__(f"injected worker failure at step {step}")
        self.step = step
