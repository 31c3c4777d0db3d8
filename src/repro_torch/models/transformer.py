"""Decoder-only transformer: ``repro.models.transformer`` on one GPU, for
every config the reference defines: serving (prefill, decode, teacher-forced
logits) and training (:meth:`Transformer.forward_loss`).

Pre-norm layers of grouped-query attention with rotary positions and an
optional QKV bias, then a SiLU-gated MLP (``qwen2-1.5b``, ``yi-34b``) or
the grouped-dispatch mixture of experts :func:`moe_ffn` (``olmoe-1b-7b``,
``phi3.5-moe-42b-a6.6b``). Gemma-2 (``gemma2-9b``) alternates local
(windowed) and global attention layers, soft-caps the attention scores and
the final logits, and normalises each sub-layer's output before its
residual add (post-norms). Every attention, prefill and decode, goes
through the hand-written ``flash_attention`` kernel
(:func:`repro_torch.kernels.ops.flash_attention`), one launch per layer per
forward, which takes the window and the soft-cap itself.

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
- (g) An alternating model's layers stay on one flat (L, ...) axis, where
  the reference stacks them (L/2, 2, ...) (``layers_leading``): layer
  ``l = 2 i + sub``, so even layers are the local ones (the reference's
  sub-layer 0 has the window). :meth:`Transformer.from_numpy_params`
  reshapes (L/2, 2, ...) leaves to (L, ...) without reordering, and the
  cache is (L, B, Smax, Hkv, D) too, every layer the full length, local
  layers included, as the reference's ``init_cache``.
- (h) The MoE FFN dispatches and combines by index: each kept (token,
  slot) is copied into its (group, expert, position) row and gathered
  back, where the reference multiplies one-hot (G, E, C) tensors (84 MB a
  group a layer at OLMoE's sizes). The values are the same: a one-hot
  product summed in float32 copies a token exactly. Top-k ties go to the
  lower expert index, as ``jax.lax.top_k``'s; a token count that is above
  ``moe_group`` and not a multiple of it raises ``ValueError`` where the
  reference's reshape fails.
- (i) The MoE's float32-summing products (:func:`_bmm_f32`: the router
  logits and the three expert products) have a gradient of their own,
  :class:`BmmF32`: on the card the bfloat16 product with a float32 output
  has no derivative in PyTorch. Its backward forms dA = dC B^T and dB =
  A^T dC as float32 products (bfloat16 operands widened) and rounds each
  once to its operand's dtype, as JAX transposes an einsum with
  ``preferred_element_type=float32``.

Training: :meth:`Transformer.forward_loss` is the reference's
``forward_loss`` (cross-entropy by :func:`chunked_cross_entropy` plus 0.01
times the Switch loss summed over layers over ``n_layers``). ``remat="full"``
(the reference's ``nothing_saveable``) wraps each layer in
``torch.utils.checkpoint`` (non-reentrant): the forward keeps each layer's
input and the backward runs the layer again, the same values. The
parameters are built frozen; ``requires_grad_()`` makes them trainable
leaves (:meth:`Transformer.leaves` names them by the reference's pytree
paths). Serving runs under ``torch.no_grad()`` and launches the same
kernels as before. Each attention of a training step runs
the kernel's forward twice (forward and remat) and its backward once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, chunked_cross_entropy, rms_norm, rope_tables

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOP = ("embed", "ln_final", "w_vocab")  # the parameters outside ``layers``
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
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group: int = 2048
    # gemma-2 extras
    local_window: int | None = None    # if set, layers alternate local/global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # numerics: the dtype of weights, activations and cache
    dtype: str = "bfloat16"
    # the reference's lowering knobs, kept so configs compare field by
    # field; training reads remat ("full" or "none") and ce_chunk
    remat: str = "full"
    ce_chunk: int = 256
    scan_layers: bool = True
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    context_parallel: bool = False
    seq_parallel_residual: bool = False

    @property
    def alternating(self) -> bool:
        return self.local_window is not None

    @property
    def layers_leading(self) -> tuple:
        """The reference's leading layer axes: (L/2, 2) when alternating."""
        return (self.n_layers // 2, 2) if self.alternating else (self.n_layers,)

    def n_params(self) -> int:
        d, h, kv, dh, f, v = (self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                              self.d_ff, self.vocab)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        ffn = self.n_experts * 3 * d * f + d * self.n_experts if self.n_experts else 3 * d * f
        return self.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d

    def n_active_params(self) -> int:
        if not self.n_experts:
            return self.n_params()
        return self.n_params() - self.n_layers * (self.n_experts - self.top_k) * 3 \
            * self.d_model * self.d_ff


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, not {cfg.dtype!r}")
    if cfg.alternating and cfg.n_layers % 2:
        raise ValueError(f"{cfg.name}: alternating local/global layers come in pairs, "
                         f"not {cfg.n_layers} layers")


def param_shapes(cfg: TransformerConfig) -> dict:
    """``init_params``'s shapes: {name: (shape, init scale)}, scale None for
    zeros; layer entries carry one leading L axis (decision (g))."""
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
    if cfg.post_norms:
        layers.update(ln_attn_post=((d,), None), ln_mlp_post=((d,), None))
    if cfg.n_experts:
        e = cfg.n_experts
        layers.update(router=((d, e), d ** -0.5), w_gate_e=((e, d, f), d ** -0.5),
                      w_up_e=((e, d, f), d ** -0.5), w_down_e=((e, f, d), f ** -0.5))
    else:
        layers.update(w_gate=((d, f), d ** -0.5), w_up=((d, f), d ** -0.5),
                      w_down=((f, d), f ** -0.5))
    return {"embed": ((v, d), 0.02), **{k: (L + s, sc) for k, (s, sc) in layers.items()},
            "ln_final": ((d,), None), "w_vocab": ((d, v), d ** -0.5)}


def moe_group_size(cfg: TransformerConfig, n_tokens: int) -> int:
    """G, the tokens of one dispatch group: ``min(moe_group, n_tokens)``.
    Raises ValueError where the reference's reshape into groups fails (more
    tokens than ``moe_group`` and not a multiple of it): the port neither
    pads nor regroups."""
    g = min(cfg.moe_group, n_tokens)
    if g < 1 or n_tokens % g:
        raise ValueError(f"{cfg.name}: {n_tokens} tokens do not split into MoE groups of "
                         f"{g}; a batch's B * S must be at most moe_group or a multiple of it")
    return g


def moe_capacity(cfg: TransformerConfig, g: int) -> int:
    """C, the slots of an expert in a group of g tokens, as the reference
    reckons it in Python floats: max(int(k G / E * capacity_factor), k)."""
    return max(int(cfg.top_k * g / cfg.n_experts * cfg.capacity_factor), cfg.top_k)


def _bmm_f32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class BmmF32(torch.autograd.Function):
    """:func:`_bmm_f32` with its gradient (decision (i)): dA = dC B^T and
    dB = A^T dC summed in float32, each rounded once to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32_plain(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.float()
        da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype) if ctx.needs_input_grad[0] \
            else None
        db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return da, db


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, summed and returned in float32 (bfloat16 operands
    stay bfloat16 on the card; the CPU has no such product, so there they
    are cast to float32, which gives the same products). Differentiable
    through :class:`BmmF32` where autograd records."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return BmmF32.apply(a, b)
    return _bmm_f32_plain(a, b)


def moe_logits(tokens: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """The router logits of tokens (n, G, d): ``tokens @ router`` summed in
    float32 and rounded once to the tokens' dtype, as the reference's
    einsum in that dtype, then cast to float32: (n, G, E). (A bfloat16
    GEMM may reduce split partial sums in bfloat16, more than one rounding
    of a logit, which can flip near-tied experts.)"""
    n, g, d = tokens.shape
    logits = _bmm_f32(tokens.reshape(1, n * g, d), router.unsqueeze(0))
    return logits.reshape(n, g, -1).to(tokens.dtype).float()


def moe_route(logits: torch.Tensor, top_k: int) -> tuple:
    """The router's choice from float32 logits (..., E): (probs, softmax of
    the logits; idx (..., top_k) int64, the top k experts with ties to the
    lower index, a stable descending sort as ``jax.lax.top_k``)."""
    probs = torch.softmax(logits, dim=-1)
    return probs, torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]


def moe_positions(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, slot)'s position among the earlier slots of its group
    routed to the same expert, in flat (token, slot) order: idx (n, G, k)
    -> (n, G, k) int64."""
    n, g, k = idx.shape
    onehot = F.one_hot(idx.reshape(n, g * k), n_experts)
    return ((onehot.cumsum(1) - onehot) * onehot).sum(-1).reshape(n, g, k)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate_e: torch.Tensor,
            w_up_e: torch.Tensor, w_down_e: torch.Tensor, cfg: TransformerConfig) -> tuple:
    """The reference's ``_moe_ffn`` (GShard grouped dispatch) on x (B, S, d):
    tokens in (B, S) order cut into groups of :func:`moe_group_size`,
    routed by :func:`moe_route` on :func:`moe_logits`, gates renormalised
    over the k, slots whose :func:`moe_positions` is at or past the
    capacity :func:`moe_capacity` dropped. Kept tokens are copied into an
    (E, n, C, d) buffer by index (decision (h)); each expert's SiLU-gated
    MLP sums in float32, its hidden rounded to x's dtype before
    ``w_down_e`` and its output after; y sums the kept slots' outputs
    weighted by their gates rounded to x's dtype, in float32, and is cast
    to x's dtype. Returns (y (B, S, d), aux), aux the Switch load-balance
    loss E * sum(top-1 fraction * mean probability), a float32 scalar."""
    B, S, d = x.shape
    e = cfg.n_experts
    g = moe_group_size(cfg, B * S)
    c = moe_capacity(cfg, g)
    n = B * S // g
    tokens = x.reshape(n, g, d)
    probs, idx = moe_route(moe_logits(tokens, router), cfg.top_k)
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    pos = moe_positions(idx, e)
    keep = pos < c
    group = torch.arange(n, device=x.device)[:, None, None]
    rows = (idx * n + group) * c + pos  # row of (E, n, C) a kept slot goes to
    dropped = e * n * c                 # one spare row takes the dropped slots
    xe = x.new_zeros(dropped + 1, d)
    xe[torch.where(keep, rows, dropped)] = tokens[:, :, None, :]
    xe = xe[:dropped].view(e, n * c, d)
    hidden = F.silu(_bmm_f32(xe, w_gate_e)) * _bmm_f32(xe, w_up_e)
    ye = _bmm_f32(hidden.to(x.dtype), w_down_e).to(x.dtype).view(dropped, d)
    del xe, hidden
    gate_c = (gates * keep).to(x.dtype).float()  # 0 on a dropped slot
    rows = torch.where(keep, rows, 0)
    y = torch.zeros((n, g, d), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        y += gate_c[..., j, None] * ye[rows[..., j]].float()
    frac = F.one_hot(idx[..., 0], e).float().mean((0, 1))
    aux = e * (frac * probs.mean((0, 1))).sum()
    return y.reshape(B, S, d).to(x.dtype), aux


def normal_chunked(shape, scale, dtype, gen: torch.Generator, device) -> torch.Tensor:
    """Normal * scale in ``dtype``, drawn in float32 a chunk at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for a in range(0, flat.numel(), _INIT_CHUNK):
        b = min(a + _INIT_CHUNK, flat.numel())
        flat[a:b] = (torch.randn(b - a, generator=gen, device=device) * scale).to(dtype)
    return out


class Transformer(nn.Module):
    """The decoder with the reference's parameters: ``embed`` (V, d), the
    layer weights stacked (L, ...), ``ln_final`` (d,), ``w_vocab`` (d, V),
    all in ``cfg.dtype``. They are frozen as built (serving);
    ``requires_grad_()`` makes them trainable leaves, as the train cells do."""

    def __init__(self, cfg: TransformerConfig, params: dict):
        super().__init__()
        _check_config(cfg)
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
        _check_config(cfg)
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
        axis, (L/2, 2) for an alternating model, which becomes (L,) in layer
        order (decision (g))."""
        _check_config(cfg)
        dev = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        flat = {k: v for k, v in params.items() if k != "layers"}
        lead = len(cfg.layers_leading)
        flat.update({k: np.reshape(v, (cfg.n_layers,) + np.shape(v)[lead:])
                     for k, v in params["layers"].items()})
        # copied: a float32 CPU model would otherwise share the caller's arrays,
        # and a train step updates its parameters in place
        return cls(cfg, {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(
            dev, dtype, copy=True) for k, v in flat.items()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def leaves(self) -> dict[str, torch.Tensor]:
        """The parameters under the reference's pytree paths (``embed``,
        ``layers/wq``, ...), in JAX's flatten order (dict keys sorted at
        each level), each in the reference's shape: an alternating model's
        layer leaves are (L/2, 2, ...) views of the (L, ...) parameters
        (decision (g)), so an in-place update of a leaf updates the model."""
        lead = self.cfg.layers_leading
        out = {}
        for name in param_shapes(self.cfg):
            t = getattr(self, name)
            if name in _TOP:
                out[name] = t
            else:
                out[f"layers/{name}"] = t.view(lead + t.shape[1:])
        return dict(sorted(out.items()))

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
                                  v_att.transpose(1, 2), causal=True, window=self.window(l),
                                  softcap=cfg.attn_softcap, sm_scale=dh ** -0.5,
                                  q_offset=index)
        out = out.transpose(1, 2).reshape(B, S, h * dh).to(x.dtype)
        return out @ self.wo[l]

    def window(self, l: int) -> int | None:
        """Layer l's attention window: ``local_window`` on the even layers
        of an alternating model (decision (g)), else None."""
        return self.cfg.local_window if self.cfg.alternating and l % 2 == 0 else None

    def _mlp(self, x, l: int) -> tuple:
        """(the FFN's output, its Switch loss: 0 for a dense FFN)."""
        if self.cfg.n_experts:
            return moe_ffn(x, self.router[l], self.w_gate_e[l], self.w_up_e[l],
                           self.w_down_e[l], self.cfg)
        y = (F.silu(x @ self.w_gate[l]) * (x @ self.w_up[l])) @ self.w_down[l]
        return y, torch.zeros((), dtype=torch.float32, device=x.device)

    def _layer(self, x, l: int, rope_cs, cache=None, index: int = 0) -> tuple:
        """Layer l on x: (its output, the layer's Switch loss)."""
        post = self.cfg.post_norms
        a = self._attention(rms_norm(x, self.ln_attn[l]), l, rope_cs, cache, index)
        x = x + (rms_norm(a, self.ln_attn_post[l]) if post else a)
        m, aux = self._mlp(rms_norm(x, self.ln_mlp[l]), l)
        return x + (rms_norm(m, self.ln_mlp_post[l]) if post else m), aux

    def _logits(self, logits: torch.Tensor) -> torch.Tensor:
        """float32 logits, soft-capped by ``final_softcap`` where set."""
        cap = self.cfg.final_softcap
        return logits if cap is None else cap * torch.tanh(logits / cap)

    def _stack(self, tokens: torch.Tensor, cache=None, index: int = 0) -> torch.Tensor:
        x = self.embed[tokens.to(device=self.device, dtype=torch.int64)]
        positions = torch.arange(index, index + x.shape[1], device=self.device)
        rope_cs = rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for l in range(self.cfg.n_layers):
            x = self._layer(x, l, rope_cs, cache, index)[0]
        return x

    def forward_loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The training loss of tokens and targets (B, S), -100 targets
        ignored: :func:`chunked_cross_entropy` of the final norm's output
        against ``w_vocab`` (``ce_chunk`` positions at a time, soft-capped by
        ``final_softcap``) plus 0.01 * (the Switch losses summed over the
        layers) / n_layers, a float32 scalar. Each layer is rematerialised
        (``torch.utils.checkpoint``) when ``remat`` is "full"."""
        cfg = self.cfg
        if cfg.remat not in ("full", "none"):
            raise ValueError(f"remat must be 'full' or 'none', not {cfg.remat!r}")
        x = self.embed[tokens.to(device=self.device, dtype=torch.int64)]
        positions = torch.arange(x.shape[1], device=self.device)
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for l in range(cfg.n_layers):
            if cfg.remat == "full":
                x, a = checkpoint(self._layer, x, l, rope_cs, use_reentrant=False)
            else:
                x, a = self._layer(x, l, rope_cs)
            aux = aux + a
        x = rms_norm(x, self.ln_final)
        loss = chunked_cross_entropy(x, self.w_vocab, targets.to(self.device),
                                     chunk=cfg.ce_chunk, softcap=cfg.final_softcap)
        return loss + 0.01 * aux / max(cfg.n_layers, 1)

    # ------------------------------------------------------------ entry points
    @torch.no_grad()
    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: tokens (B, S) -> (B, S, V) float32."""
        x = rms_norm(self._stack(tokens), self.ln_final)
        return self._logits(x.float() @ self.w_vocab.float())

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
        return self._logits((x_last @ self.w_vocab).float()), cache

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
        return self._logits((x @ self.w_vocab).float()), cache
