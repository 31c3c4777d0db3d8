"""Batched LM serving engine: prefill + decode on one GPU.

The twin of ``repro.serve.engine``. Requests are left-padded into one batch
(the pad tokens are attended, as in the reference); one ``prefill_step``
fills the KV cache, then ``decode_step`` runs one token per iteration for
the whole batch, writing the cache in place, with per-sequence stop
handling. Greedy decoding takes the argmax (the first of equal maxima, as
``jnp.argmax``); temperature sampling draws from a ``torch.Generator``
seeded with ``seed``, which cannot reproduce ``jax.random``'s draws.

For a mixture-of-experts model the prefill's tokens are grouped as the
reference groups them: the padded batch's B * plen must be at most the
config's ``moe_group`` or a multiple of it (and B alone for decode), else
``generate`` raises the model's ValueError (``moe_group_size``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.transformer import Transformer


@dataclass
class GenerationResult:
    tokens: np.ndarray      # (B, <=max_new) generated ids (pad_id-padded)
    n_generated: np.ndarray
    prefill_ms: float
    decode_ms_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Serve ``model`` with a cache of ``max_len`` positions per sequence."""

    def __init__(self, model: Transformer, *, max_len: int = 512, pad_id: int = 0,
                 eos_id: int | None = None):
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len
        self.pad_id = pad_id
        self.eos_id = eos_id

    def _sample(self, logits: torch.Tensor, gen: torch.Generator | None,
                temperature: float) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, prompts: list[list[int]], *, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> GenerationResult:
        """Generate up to ``max_new_tokens`` per prompt. ``prefill_ms`` and
        ``decode_ms_per_token`` are host-clock times around work that ends
        in a device synchronisation."""
        dev = self.model.device
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        if plen + max_new_tokens > self.max_len:
            raise ValueError(f"{plen} prompt + {max_new_tokens} new tokens exceed "
                             f"max_len {self.max_len}")
        tokens = np.full((B, plen), self.pad_id, np.int64)
        for i, p in enumerate(prompts):
            tokens[i, plen - len(p):] = p  # left-pad so the last position is real
        tokens = torch.from_numpy(tokens).to(dev)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill_step(tokens, max_len=self.max_len)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3

        gen = None if temperature == 0.0 else torch.Generator(device=dev).manual_seed(seed)
        out = np.full((B, max_new_tokens), self.pad_id, np.int64)
        done = np.zeros(B, bool)
        n_gen = np.zeros(B, np.int64)
        t0 = time.perf_counter()
        cur = self._sample(logits, gen, temperature)
        for t in range(max_new_tokens):
            cur_np = cur.cpu().numpy()
            newly = ~done
            out[newly, t] = cur_np[newly]
            n_gen[newly] += 1
            if self.eos_id is not None:
                done |= cur_np == self.eos_id
                if done.all():
                    break
            logits, cache = self.model.decode_step(cache, cur, plen + t)
            cur = self._sample(logits, gen, temperature)
        _sync(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3 / max(int(n_gen.max()), 1)
        return GenerationResult(out, n_gen, prefill_ms, decode_ms)
