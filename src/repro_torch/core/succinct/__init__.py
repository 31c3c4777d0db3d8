"""Succinct structures of the port: bitvector, k²-tree, Elias–Fano, δ codes."""
from repro_torch.core.succinct.bitvector import BitVector, pack_bits, unpack_bits
from repro_torch.core.succinct.delta_code import (
    delta_decode,
    delta_encode,
    gamma_decode,
    gamma_encode,
)
from repro_torch.core.succinct.elias_fano import EliasFano
from repro_torch.core.succinct.k2tree import K2Tree

__all__ = [
    "BitVector",
    "pack_bits",
    "unpack_bits",
    "EliasFano",
    "delta_encode",
    "delta_decode",
    "gamma_encode",
    "gamma_decode",
    "K2Tree",
]
