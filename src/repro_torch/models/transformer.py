"""Decoder-only transformer, dense GQA path: the serving side of
``repro.models.transformer`` on one GPU.

Pre-norm layers of grouped-query attention with rotary positions and an
optional QKV bias, then a SiLU-gated MLP; ``qwen2-1.5b`` is this model. Every
attention, prefill and decode, goes through the hand-written
``flash_attention`` kernel (:func:`repro_torch.kernels.ops.flash_attention`),
one launch per layer per forward.

Port decisions:

- (a) Weights keep the reference's layout: (in, out) matrices applied as
  ``x @ w``, layers stacked on a leading L axis, so ``init_params``'s
  pytree carries across without a transpose.
- (b) The KV cache keeps the reference's layout too, a pair of
  (L, B, Smax, Hkv, D) tensors. The kernel reads a layer's slice through
  its strides as (B, Hkv, Smax, D), and q, (B, S, Hq, D) after the
  projection, as (B, Hq, S, D): nothing is transposed or copied per layer.
- (c) The cache is written in place: ``prefill_step`` fills positions
  0..S-1 of a new cache and ``decode_step`` writes ``cur_index`` into the
  cache it is given and returns that same cache, where the reference
  returns a new one through ``dynamic_update_slice``.
- (d) Query positions reach the kernel as ``q_offset``: prefill attends
  positions 0..S-1 against the whole ``max_len`` cache (``q_offset`` 0),
  decode position ``cur_index`` against it (``q_offset = cur_index``). The
  kernel skips the cache tiles no query can see, so the zeros past the
  prompt cost nothing.
- (e) Attention has one numerics, the Pallas kernel's (p rounded to the
  cache dtype before the PV product). The reference has two, by prefill
  length: its einsum branch rounds the normalised probabilities, its
  ``_flash_jnp`` branch (S > 512, S % 512 == 0) keeps p in float32. In
  float32 all agree up to summation order.
- (f) Left padding is attended, as in the reference: positions are
  0..S-1 for every row and there is no padding mask.

MoE layers, Gemma-2's alternating local/global attention, post-norms and
logit soft-caps are not ported: a config that asks for one raises
``NotImplementedError``. Training (``forward_loss``) is not ported either.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm, rope_tables

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_INIT_CHUNK = 1 << 24  # elements drawn at a time: 64 MiB of float32 scratch


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE (n_experts == 0 -> dense FFN); not ported
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group: int = 2048
    # gemma-2 extras; not ported
    local_window: int | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # numerics: the dtype of weights, activations and cache
    dtype: str = "bfloat16"
    # the reference's lowering knobs, kept so configs compare field by
    # field; eager serving reads none of them
    remat: str = "full"
    ce_chunk: int = 256
    scan_layers: bool = True
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    context_parallel: bool = False
    seq_parallel_residual: bool = False

    def n_params(self) -> int:
        d, h, kv, dh, f, v = (self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                              self.d_ff, self.vocab)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        ffn = self.n_experts * 3 * d * f + d * self.n_experts if self.n_experts else 3 * d * f
        return self.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d


def _check_ported(cfg: TransformerConfig) -> None:
    missing = [what for what, asked in (
        ("MoE layers (n_experts > 0)", cfg.n_experts > 0),
        ("alternating local/global attention (local_window)", cfg.local_window is not None),
        ("post-norms", cfg.post_norms),
        ("attention logit soft-cap", cfg.attn_softcap is not None),
        ("final logit soft-cap", cfg.final_softcap is not None)) if asked]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md queue A, "
            "'The rest of the model zoo'); only the dense GQA path is")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, not {cfg.dtype!r}")


def param_shapes(cfg: TransformerConfig) -> dict:
    """``init_params``'s shapes: {name: (shape, init scale)}, scale None for
    zeros; layer entries carry the leading L axis."""
    d, h, kv, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.d_ff, cfg.vocab)
    L = (cfg.n_layers,)
    layers = {
        "ln_attn": ((d,), None),
        "wq": ((d, h * dh), d ** -0.5), "wk": ((d, kv * dh), d ** -0.5),
        "wv": ((d, kv * dh), d ** -0.5), "wo": ((h * dh, d), (h * dh) ** -0.5),
        "ln_mlp": ((d,), None),
    }
    if cfg.qkv_bias:
        layers.update(bq=((h * dh,), None), bk=((kv * dh,), None), bv=((kv * dh,), None))
    layers.update(w_gate=((d, f), d ** -0.5), w_up=((d, f), d ** -0.5),
                  w_down=((f, d), f ** -0.5))
    return {"embed": ((v, d), 0.02), **{k: (L + s, sc) for k, (s, sc) in layers.items()},
            "ln_final": ((d,), None), "w_vocab": ((d, v), d ** -0.5)}


def normal_chunked(shape, scale, dtype, gen: torch.Generator, device) -> torch.Tensor:
    """Normal * scale in ``dtype``, drawn in float32 a chunk at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for a in range(0, flat.numel(), _INIT_CHUNK):
        b = min(a + _INIT_CHUNK, flat.numel())
        flat[a:b] = (torch.randn(b - a, generator=gen, device=device) * scale).to(dtype)
    return out


class Transformer(nn.Module):
    """The dense decoder with the reference's parameters as frozen tensors:
    ``embed`` (V, d), the layer weights stacked (L, ...), ``ln_final`` (d,),
    ``w_vocab`` (d, V), all in ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig, params: dict):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        shapes = param_shapes(cfg)
        if set(params) != set(shapes):
            raise ValueError(f"params must hold {sorted(shapes)}, not {sorted(params)}")
        for name, (shape, _) in shapes.items():
            t = params[name]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{name} must be {shape} {dtype}, not "
                                 f"{tuple(t.shape)} {t.dtype}")
            setattr(self, name, nn.Parameter(t, requires_grad=False))

    @classmethod
    def from_config(cls, cfg: TransformerConfig, device=None, seed: int = 0) -> "Transformer":
        """``init_params`` on the device from a ``torch.Generator`` seeded with
        ``seed``: the reference's shapes and scales (normal / sqrt(fan_in)
        for the matrices, normal * 0.02 for the embedding, zeros for norms
        and biases), drawn in float32 a chunk at a time and stored in
        ``cfg.dtype``."""
        _check_ported(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dtype = DTYPES[cfg.dtype]
        params = {name: (torch.zeros(shape, dtype=dtype, device=dev) if scale is None
                         else normal_chunked(shape, scale, dtype, gen, dev))
                  for name, (shape, scale) in param_shapes(cfg).items()}
        return cls(cfg, params)

    @classmethod
    def from_numpy_params(cls, params: dict, cfg: TransformerConfig,
                          device=None) -> "Transformer":
        """Carry the JAX package's parameters across: ``params`` is the
        ``init_params`` pytree as numpy arrays, ``{"embed", "layers": {"wq",
        ...}, "ln_final", "w_vocab"}``, layer weights stacked on a leading L
        axis."""
        _check_ported(cfg)
        dev = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        flat = {k: v for k, v in params.items() if k != "layers"}
        flat.update(params["layers"])
        return cls(cfg, {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(dev, dtype)
                         for k, v in flat.items()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ layers
    def _attention(self, x, l: int, rope_cs, cache, index: int):
        cfg = self.cfg
        B, S, _ = x.shape
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = x @ self.wq[l], x @ self.wk[l], x @ self.wv[l]
        if cfg.qkv_bias:
            q, k, v = q + self.bq[l], k + self.bk[l], v + self.bv[l]
        # heads in the reference's (kv, group) order: head h reads kv head h // group
        q = apply_rope(q.view(B, S, h, dh), *rope_cs)
        k = apply_rope(k.view(B, S, kv, dh), *rope_cs)
        v = v.view(B, S, kv, dh)
        if cache is None:
            k_att, v_att = k, v
        else:
            k_att, v_att = cache[0][l], cache[1][l]  # (B, Smax, kv, dh) views
            k_att[:, index:index + S] = k
            v_att[:, index:index + S] = v
        out = ops.flash_attention(q.transpose(1, 2), k_att.transpose(1, 2),
                                  v_att.transpose(1, 2), causal=True,
                                  sm_scale=dh ** -0.5, q_offset=index)
        out = out.transpose(1, 2).reshape(B, S, h * dh).to(x.dtype)
        return out @ self.wo[l]

    def _layer(self, x, l: int, rope_cs, cache=None, index: int = 0):
        x = x + self._attention(rms_norm(x, self.ln_attn[l]), l, rope_cs, cache, index)
        m_in = rms_norm(x, self.ln_mlp[l])
        return x + (F.silu(m_in @ self.w_gate[l]) * (m_in @ self.w_up[l])) @ self.w_down[l]

    def _stack(self, tokens: torch.Tensor, cache=None, index: int = 0) -> torch.Tensor:
        x = self.embed[tokens.to(device=self.device, dtype=torch.int64)]
        positions = torch.arange(index, index + x.shape[1], device=self.device)
        rope_cs = rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for l in range(self.cfg.n_layers):
            x = self._layer(x, l, rope_cs, cache, index)
        return x

    # ------------------------------------------------------------ entry points
    @torch.no_grad()
    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: tokens (B, S) -> (B, S, V) float32."""
        x = rms_norm(self._stack(tokens), self.ln_final)
        return x.float() @ self.w_vocab.float()

    def init_cache(self, batch: int, max_len: int) -> tuple:
        """A zero (k, v) cache, each (L, batch, max_len, Hkv, D) in
        ``cfg.dtype``, on the model's device."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return tuple(torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=self.device)
                     for _ in range(2))

    @torch.no_grad()
    def prefill_step(self, tokens: torch.Tensor, max_len: int | None = None):
        """Run the prompt tokens (B, S), fill a new cache of ``max_len``
        (default S) positions, and return (last-position logits (B, V)
        float32, cache)."""
        B, S = tokens.shape
        max_len = max_len or S
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens does not fit a cache of {max_len}")
        cache = self.init_cache(B, max_len)
        x = self._stack(tokens, cache, 0)
        x_last = rms_norm(x[:, -1], self.ln_final)
        return (x_last @ self.w_vocab).float(), cache

    @torch.no_grad()
    def decode_step(self, cache: tuple, tokens: torch.Tensor, cur_index: int):
        """One token per sequence: tokens (B,) at position ``cur_index``,
        attending to cache positions 0..cur_index. Writes the token's k, v
        into ``cache`` in place; returns (logits (B, V) float32, cache)."""
        cur_index = int(cur_index)
        if not 0 <= cur_index < cache[0].shape[2]:
            raise ValueError(f"cur_index {cur_index} is outside the cache's "
                             f"{cache[0].shape[2]} positions")
        x = self._stack(tokens.reshape(-1, 1), cache, cur_index)
        x = rms_norm(x[:, 0], self.ln_final)
        return (x @ self.w_vocab).float(), cache
