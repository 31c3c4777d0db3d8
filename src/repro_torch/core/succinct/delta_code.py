"""Elias gamma and delta universal codes over 32-bit word streams.

The encoder builds every code in one int64 lane and scatters it into the
word stream with at most three word touches, as the reference does. Codes
never share a bit, so the reference's scatter-OR is an exact scatter-add
here (torch has no scatter-OR). A code must fit in 63 bits (values below
2**53; the reference allows 64 bits); longer codes raise. The decoder walks the stream through one
Python integer, as in the reference: it runs once, off the query path.

Codes encode x >= 1; callers encoding values >= 0 shift by one.
"""
from __future__ import annotations

import torch

from repro_torch.core._arrays import I64, offsets_from_counts

_M32 = 0xFFFFFFFF


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) + 1 for x >= 1."""
    out = torch.zeros_like(x)
    cur = x.clone()
    for shift in (32, 16, 8, 4, 2, 1):
        ge = cur >= (1 << shift)
        out += ge.to(I64) * shift
        cur = torch.where(ge, cur >> shift, cur)
    return out + 1


def _pow2(n: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(n) << n


def _gamma_parts(x: torch.Tensor):
    """(code, length) of gamma(x), LSB-first: n zeros, a one, the n low bits."""
    n = _bit_length(x) - 1
    payload = x - _pow2(n)
    return _pow2(n) | (payload << (n + 1)), 2 * n + 1


def gamma_encode(values: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Elias gamma: bitlen(x) - 1 zeros, a one, then the low bits of x."""
    values = values.to(I64)
    if values.numel() == 0:
        return torch.zeros(0, dtype=I64, device=values.device), 0
    if bool((values < 1).any()):
        raise ValueError("gamma code requires values >= 1")
    code, length = _gamma_parts(values)
    if bool((length > 63).any()):
        raise ValueError("gamma codes over 63 bits unsupported (value too large)")
    return _pack_codes(code, length)


def delta_encode(values: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Elias delta: gamma(bitlen(x)) followed by the bitlen(x)-1 payload bits."""
    values = values.to(I64)
    if values.numel() == 0:
        return torch.zeros(0, dtype=I64, device=values.device), 0
    if bool((values < 1).any()):
        raise ValueError("delta code requires values >= 1")
    nbits = _bit_length(values)
    g_code, g_len = _gamma_parts(nbits)
    payload_len = nbits - 1
    total_len = g_len + payload_len
    if bool((total_len > 63).any()):
        raise ValueError("delta codes over 63 bits unsupported (value too large)")
    code = g_code | ((values - _pow2(payload_len)) << g_len)
    return _pack_codes(code, total_len)


def _pack_codes(codes: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Scatter LSB-first codes (< 2**63) into words holding 32 bits each."""
    offsets = offsets_from_counts(lengths)
    total_bits = int(offsets[-1])
    words = torch.zeros((total_bits + 31) // 32 + 2, dtype=I64, device=codes.device)
    starts = offsets[:-1]
    w0 = starts >> 5
    s = starts & 31
    c_lo, c_hi = codes & _M32, codes >> 32
    words.index_add_(0, w0, (c_lo << s) & _M32)
    words.index_add_(0, w0 + 1, ((c_lo >> (32 - s)) | (c_hi << s)) & _M32)
    words.index_add_(0, w0 + 2, c_hi >> (32 - s))
    return words[: (total_bits + 31) // 32], total_bits


class _BitReader:
    """Sequential bit reader over packed words using one big int."""

    def __init__(self, words: torch.Tensor, n_bits: int):
        raw = words.detach().cpu().numpy().astype("<u4").tobytes()
        self.big = int.from_bytes(raw, "little")
        self.n_bits = n_bits
        self.pos = 0

    def read_unary_zeros(self) -> int:
        z = 0
        big, pos = self.big, self.pos
        while not (big >> pos) & 1:
            z += 1
            pos += 1
            if pos > self.n_bits:
                raise ValueError("ran off bitstream in unary read")
        self.pos = pos + 1  # consume the terminating 1
        return z

    def read_bits(self, k: int) -> int:
        v = (self.big >> self.pos) & ((1 << k) - 1)
        self.pos += k
        return v


def gamma_decode(words: torch.Tensor, n_bits: int, count: int) -> torch.Tensor:
    r = _BitReader(words, n_bits)
    out = []
    for _ in range(count):
        n = r.read_unary_zeros()
        out.append((1 << n) | r.read_bits(n))
    return torch.tensor(out, dtype=I64, device=words.device)


def delta_decode(words: torch.Tensor, n_bits: int, count: int) -> torch.Tensor:
    r = _BitReader(words, n_bits)
    out = []
    for _ in range(count):
        n = r.read_unary_zeros()
        nbits = (1 << n) | r.read_bits(n)  # bit length of the value
        out.append((1 << (nbits - 1)) | r.read_bits(nbits - 1))
    return torch.tensor(out, dtype=I64, device=words.device)
