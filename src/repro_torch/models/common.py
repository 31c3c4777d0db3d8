"""Shared model building blocks: the twin of ``repro.models.common``, cut to
what the ported models use (``dense_init``, the MLP of ``mlp_params`` /
``mlp_apply``, ``layer_norm``, ``rms_norm``, and the reference's ``rope`` split into
``rope_tables`` and ``apply_rope`` so a forward computes the tables once for
all layers).

Weights keep the reference's layout, ``w`` of shape (in, out) applied as
``x @ w + b``, so parameters carried over from the JAX package need no
transpose.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """(d_in, d_out) float32 normal weights times 1/sqrt(d_in)."""
    return torch.randn(d_in, d_out, generator=generator, device=device) / math.sqrt(d_in)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``layer_norm`` formula: (x - mean) * rsqrt(var + eps)
    * gamma + beta over the last axis, in float32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma) over the last axis, in float32,
    cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """theta^(-i/half) for i < half, float32 as numpy computes it, kept on
    the device so a forward makes no host-to-device copy (and no sync)."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(freqs).to(device)


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 10000.0) -> tuple:
    """(cos, sin) of the rotary angles at positions (..., S), at frequencies
    theta^(-2i/dim) computed in float32 by numpy, shaped (..., S, 1, dim / 2)
    to broadcast over heads."""
    ang = positions[..., None].float() * _rope_freqs(dim // 2, theta, positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, D) by the tables of :func:`rope_tables`: the two
    halves of D as pairs, (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin), in
    float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class MLP(nn.Module):
    """``x @ w + b`` per layer with ReLU between layers, and after the last
    one too when ``final_act`` (``mlp_apply``). The weights are trainable
    leaves (:meth:`leaves`); a serving caller runs it under
    ``torch.no_grad()``, so serving records no autograd graph."""

    def __init__(self, layers: list[dict], final_act: bool = False):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in layers])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in layers])
        self.final_act = final_act

    def leaves(self, prefix: str) -> dict[str, torch.Tensor]:
        """The parameters under the reference's pytree paths below
        ``prefix``, in its leaf order (``<prefix>/0/b``, ``<prefix>/0/w``, ...)."""
        return {f"{prefix}/{i}/{k}": getattr(self, k)[i]
                for i in range(len(self.w)) for k in ("b", "w")}

    @classmethod
    def init(cls, sizes, *, generator: torch.Generator, device: torch.device,
             final_act: bool = False) -> "MLP":
        """``mlp_params``: fp32 ``dense_init`` weights and zero biases."""
        layers = [{"w": dense_init(d_in, d_out, generator=generator, device=device),
                   "b": torch.zeros(d_out, device=device)}
                  for d_in, d_out in zip(sizes[:-1], sizes[1:])]
        return cls(layers, final_act=final_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.w) - 1
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = torch.addmm(b, x, w)
            if i < last or self.final_act:
                x = torch.relu(x)
        return x
