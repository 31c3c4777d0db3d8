"""Gradient compression with error feedback: the twin of
``repro.train.compression``, over dicts of path -> tensor.

Two codecs, applied to the gradients before the optimizer (and, with more
than one worker, before the all-reduce):

* int8 quantization: per-tensor absmax scale, ~4x wire reduction vs fp32;
* top-k sparsification: keep the k largest-magnitude entries per tensor
  (values + int32 indices), Deep-Gradient-Compression style.

Both keep an *error-feedback* residual: the untransmitted remainder is
added back into the next step's gradient.

Port decisions. ``int8`` keeps the reference's float32 order of operations
(``torch.round`` rounds half to even as ``jnp.round`` does), so ``q``,
``scale`` and the residual equal the reference's bit for bit. ``topk``
keeps ``k = max(int(n * frac), 1)``, the floor the reference's code takes
(its docstring says ceil). ``jax.lax.top_k`` breaks ties towards the lower
index; ``torch.topk`` promises no order among ties, so the selection here
is a stable descending sort of ``|g|``: the same set, in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def init_residual(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


# ---------------------------------------------------------------- int8
def quantize_int8(g: torch.Tensor) -> tuple:
    """(q, scale). The divisor is a tensor on g's device: CUDA divides by a
    Python number as a multiply by its reciprocal, which can round the
    other way from the reference's division."""
    levels = torch.full((), 127.0, device=g.device)
    scale = torch.clamp(g.abs().max(), min=1e-12) / levels
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_int8(grads: dict, residual: dict) -> tuple:
    """Returns (wire {path: (q, scale)}, decoded_grads, new_residual)."""
    wire, dec, res = {}, {}, {}
    for k, g in grads.items():
        gf = g.to(torch.float32) + residual[k]
        q, scale = quantize_int8(gf)
        d = dequantize_int8(q, scale)
        wire[k], dec[k], res[k] = (q, scale), d, gf - d
    return wire, dec, res


# ---------------------------------------------------------------- top-k
def topk_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest |flat|, ties to the lower index, largest first:
    ``jax.lax.top_k(abs(flat), k)``'s indices."""
    return torch.sort(flat.abs(), descending=True, stable=True).indices[:k]


def compress_topk(grads: dict, residual: dict, frac: float = 0.01) -> tuple:
    """Keep the max(floor(frac * n), 1) largest-|g| entries per tensor, with
    error feedback. Returns (wire {path: (values, int32 indices)},
    decoded_grads, new_residual)."""
    wire, dec, res = {}, {}, {}
    for key, g in grads.items():
        gf = g.to(torch.float32) + residual[key]
        flat = gf.reshape(-1)
        k = max(int(flat.shape[0] * frac), 1)
        idx = topk_indices(flat, k)
        sel = flat[idx]
        d = torch.zeros_like(flat).index_put_((idx,), sel).reshape(gf.shape)
        wire[key], dec[key], res[key] = (sel, idx.to(torch.int32)), d, gf - d
    return wire, dec, res


def wire_bytes(wire_tree: dict) -> int:
    """Serialized size of the compressed representation."""
    return sum(t.numel() * t.element_size() for leaf in wire_tree.values()
               for t in (leaf if isinstance(leaf, tuple) else (leaf,)))


@dataclass(frozen=True)
class CompressionConfig:
    codec: str = "none"      # none | int8 | topk
    topk_frac: float = 0.01


def compress_gradients(grads: dict, residual: dict, cfg: CompressionConfig) -> tuple:
    """Dispatch; returns (decoded_grads, new_residual, wire_bytes_factor)."""
    if cfg.codec == "none":
        return grads, residual, 1.0
    if cfg.codec == "int8":
        _, dec, res = compress_int8(grads, residual)
        return dec, res, 0.25
    if cfg.codec == "topk":
        _, dec, res = compress_topk(grads, residual, cfg.topk_frac)
        return dec, res, cfg.topk_frac * 2  # values + indices
    raise ValueError(cfg.codec)
