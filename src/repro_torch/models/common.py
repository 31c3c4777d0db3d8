"""Shared model building blocks: the twin of ``repro.models.common``, cut to
what the ported models use (``dense_init``, the MLP of ``mlp_params`` /
``mlp_apply``, ``layer_norm``, ``rms_norm``, ``chunked_cross_entropy``, and
the reference's ``rope`` split into ``rope_tables`` and ``apply_rope`` so a
forward computes the tables once for all layers).

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


def _chunk_logits(hc: torch.Tensor, w: torch.Tensor, softcap: float | None) -> tuple:
    """float32 logits of the rows hc (B, c, D) against w (D, V) float32:
    (raw, capped), the same tensor without a soft-cap."""
    raw = hc.float() @ w
    return raw, raw if softcap is None else softcap * torch.tanh(raw / softcap)


class _ChunkedCrossEntropy(torch.autograd.Function):
    """The loss of :func:`chunked_cross_entropy`; its backward recomputes
    each chunk's logits from h and w_vocab (the same values), so no chunk's
    (B, c, V) float32 logits outlive the chunk, and sums w_vocab's gradient
    over the chunks in float32, rounding it once."""

    @staticmethod
    def forward(ctx, h, w_vocab, targets, chunk, softcap):
        w = w_vocab.float()
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.int64, device=h.device)
        for c0 in range(0, h.shape[1], chunk):
            _, logits = _chunk_logits(h[:, c0:c0 + chunk], w, softcap)
            tc = targets[:, c0:c0 + chunk]
            mask = tc != -100
            tgt = logits.gather(-1, tc.clamp_min(0).long()[..., None])[..., 0]
            nll = torch.where(mask, torch.logsumexp(logits, dim=-1) - tgt, 0.0)
            loss_sum = loss_sum + nll.sum()
            count = count + mask.sum()
        denom = count.clamp_min(1).float()
        ctx.save_for_backward(h, w_vocab, targets, denom)
        ctx.chunk, ctx.softcap = chunk, softcap
        return loss_sum / denom

    @staticmethod
    def backward(ctx, grad):
        h, w_vocab, targets, denom = ctx.saved_tensors
        chunk, softcap = ctx.chunk, ctx.softcap
        w = w_vocab.float()
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        scale = grad.float() / denom
        d = h.shape[-1]
        for c0 in range(0, h.shape[1], chunk):
            hc = h[:, c0:c0 + chunk].float()
            _, logits = _chunk_logits(hc, w, softcap)
            tc = targets[:, c0:c0 + chunk]
            mask = tc != -100
            dlog = torch.softmax(logits, dim=-1)
            dlog.scatter_add_(-1, tc.clamp_min(0).long()[..., None],
                              torch.full(tc.shape + (1,), -1.0, device=h.device))
            dlog.mul_((mask.float() * scale)[..., None])
            if softcap is not None:
                dlog.mul_(1.0 - (logits / softcap).square())
            dh[:, c0:c0 + chunk] = (dlog @ w.T).to(h.dtype)
            dw.addmm_(hc.reshape(-1, d).T, dlog.reshape(-1, w.shape[1]))
        return dh, dw.to(w_vocab.dtype), None, None, None


def chunked_cross_entropy(h: torch.Tensor, w_vocab: torch.Tensor, targets: torch.Tensor, *,
                          chunk: int = 256, softcap: float | None = None) -> torch.Tensor:
    """The reference's token cross-entropy without (B, S, V) logits at once:
    h (B, S, D), w_vocab (D, V), targets (B, S) integers, -100 ignored.
    Positions go ``chunk`` at a time (S must be a multiple of min(chunk,
    S)); a chunk's logits are float32 products of h and w_vocab in float32,
    soft-capped as ``softcap * tanh(z / softcap)`` where set. Returns the
    float32 mean of logsumexp - logit[target] over the targets that count,
    loss_sum / max(count, 1). Differentiable in h and w_vocab; the backward
    recomputes each chunk's logits rather than keeping them."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    return _ChunkedCrossEntropy.apply(h, w_vocab, targets, chunk, softcap)
