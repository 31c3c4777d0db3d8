"""AdamW with a float32 master copy: the twin of ``repro.train.optimizer``'s
``AdamWConfig``, ``schedule``, ``init_opt_state`` and ``adamw_update``.

Port decision: the reference's functions are pure (they return new
parameters and a new state); here ``adamw_update`` updates the parameters,
the master copy, the moments and the step counter in place, with no host
sync. The order of the arithmetic is the reference's, which
``torch.optim.AdamW`` does not follow: the step is counted before the
schedule reads it (so the first learning rate is 3e-6 by default), the
gradients are clipped by the global norm of all of them, ``eps`` is added
after ``sqrt(v / b2c)``, and weight decay applies only to parameters of
two or more dimensions, on the float32 master. Leaves whose path contains
one of ``sgd_paths`` take plain SGD and keep no moments.

An SGD leaf may take its gradient as :class:`SparseRows`, the rows a batch
touched (DLRM's tables): it then updates only those rows, through
``ops.sgd_rows``, which is exact, since SGD moves a row whose gradient is
zero by ``lr * 0``. Such a leaf's master may be a store the caller owns
(``init_opt_state(..., master=)``: DLRM's float32 rows in host memory).

Parameters are a dict from the reference's pytree paths (``layers/0/w``)
to tensors, in its leaf order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    sgd_paths: tuple = ()  # path substrings optimized with plain SGD (no moments)


@dataclass(frozen=True)
class SparseRows:
    """A gradient by row: the first ``n_unique`` slots of ``rows`` (cap,)
    int64 name distinct rows of the leaf and those of ``grads`` (cap, D)
    float32 hold their gradients; every other row's gradient is zero.
    ``n_unique`` is a 0-dim int64 tensor on the device, so the buffers are
    sized from an upper bound and nothing is read back; slots at or past
    it hold anything and count as zero."""
    rows: torch.Tensor
    grads: torch.Tensor
    n_unique: torch.Tensor

    def square_sum(self) -> torch.Tensor:
        live = torch.arange(self.grads.shape[0], device=self.grads.device) < self.n_unique
        return torch.where(live, self.grads.square().sum(dim=1), 0.0).sum()


def _is_sgd(path: str, cfg: AdamWConfig) -> bool:
    return any(s in path for s in cfg.sgd_paths)


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac; float32, on step's device."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params: dict[str, torch.Tensor], cfg: AdamWConfig,
                   master: dict[str, torch.Tensor] | None = None) -> dict:
    """{"step": 0-dim int32, "master": float32 copies, "m", "v": float32
    zeros (None for SGD leaves)}, on the parameters' device. ``master`` maps
    paths to float32 stores that stand for those leaves' copies (taken as
    they are, not copied)."""
    dev = next(iter(params.values())).device
    given = master or {}
    with torch.no_grad():
        master = {k: given[k] if k in given else p.detach().to(torch.float32, copy=True)
                  for k, p in params.items()}

    def moments():
        return {k: None if _is_sgd(k, cfg) else torch.zeros(p.shape, dtype=torch.float32,
                                                             device=p.device)
                for k, p in params.items()}

    return {"step": torch.zeros((), dtype=torch.int32, device=dev), "master": master,
            "m": moments(), "v": moments()}


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(g.square_sum() if isinstance(g, SparseRows)
                          else g.to(torch.float32).square().sum() for g in grads.values()))


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict, opt_state: dict,
                 cfg: AdamWConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``; returns
    {"lr", "grad_norm"} as 0-dim tensors on the device."""
    step = opt_state["step"].add_(1)
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, t)
    b2c = 1 - torch.pow(cfg.b2, t)
    for path, p in params.items():
        g = grads[path]
        mast, m, v = opt_state["master"][path], opt_state["m"][path], opt_state["v"][path]
        if isinstance(g, SparseRows):
            if m is not None:
                raise ValueError(f"{path}: a gradient by row needs an SGD leaf (sgd_paths)")
            ops.sgd_rows(mast, p, g.rows, g.grads, g.n_unique, lr, clip)
            continue
        gf = g.to(torch.float32) * clip
        if m is None:  # plain SGD leaf
            upd = lr * gf
        else:
            m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * gf.square())
            upd = lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if cfg.weight_decay and p.dim() >= 2:
                upd = upd + lr * cfg.weight_decay * mast
        mast.sub_(upd)
        p.copy_(mast)
    return {"lr": lr, "grad_norm": gnorm}
