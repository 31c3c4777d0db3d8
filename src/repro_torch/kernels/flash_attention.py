"""Wrapper of the CUDA kernel ``csrc/flash_attention.cu``: blocked
online-softmax attention with grouped-query heads.

It replaces the Pallas kernel ``flash_attention`` of the JAX package (a TPU
kernel) and is every attention of the LM serving path
(:mod:`repro_torch.models.transformer`): one launch per layer per forward,
prefill and decode. Its plain twin is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

Beyond the Pallas kernel it takes ``q_offset`` (query row i sits at
position i + q_offset; the Pallas kernel fixes Sk - Sq), any Sq and Sk (no
block multiple), and tensors addressed through their strides, so the
model's (B, S, H, D) activations and its (B, Smax, Hkv, D) cache go in as
(B, H, S, D) views without a copy. The output is (B, Hq, Sq, D) with
(B, Sq, Hq, D) memory, which the model reshapes to (B, Sq, Hq * D) for free.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None, sm_scale: float | None = None,
                         q_offset: int | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), one dtype (float32 or
    bfloat16) on one CUDA device, D contiguous and a multiple of 8 up to
    256, rows 16-byte aligned; Hq a multiple of Hkv. ``window`` >= 1 or
    None, ``softcap`` > 0 or None. Returns (B, Hq, Sq, D) in q's dtype; see
    :func:`repro_torch.kernels.ref.flash_attention_ref` for the function.
    Sq == 0 launches nothing."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda takes q, k, v of one dtype, float32 or "
                        f"bfloat16, not {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, not {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, not {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, not {softcap}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.numel() and (x.stride(3) != 1 or x.data_ptr() % 16
                          or any(s % vec for s in x.stride()[:3])):
            raise ValueError(f"flash_attention_cuda needs {name} with D contiguous and "
                             "16-byte aligned rows")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    if sm_scale is None:
        sm_scale = float(1.0 / (d ** 0.5))
    _build.launch("flash_attention", "flash_attention", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  int(causal), window or 0, sk - sq if q_offset is None else q_offset,
                  softcap or 0.0, sm_scale, _DTYPES[q.dtype])
    return out
