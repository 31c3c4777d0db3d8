"""Shared model building blocks: the twin of ``repro.models.common``, cut to
what the ported models use (``dense_init`` and the MLP of ``mlp_params`` /
``mlp_apply``).

Weights keep the reference's layout, ``w`` of shape (in, out) applied as
``x @ w + b``, so parameters carried over from the JAX package need no
transpose.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """(d_in, d_out) float32 normal weights times 1/sqrt(d_in)."""
    return torch.randn(d_in, d_out, generator=generator, device=device) / math.sqrt(d_in)


class MLP(nn.Module):
    """``x @ w + b`` per layer with ReLU between layers, and after the last
    one too when ``final_act`` (``mlp_apply``). Weights are frozen: the port
    serves, it does not train yet."""

    def __init__(self, layers: list[dict], final_act: bool = False):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(p["w"], requires_grad=False) for p in layers])
        self.b = nn.ParameterList([nn.Parameter(p["b"], requires_grad=False) for p in layers])
        self.final_act = final_act

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
