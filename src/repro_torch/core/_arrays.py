"""Small tensor helpers that stand in for numpy idioms of the reference."""
from __future__ import annotations

import torch

I64 = torch.int64


def empty(device) -> torch.Tensor:
    return torch.zeros(0, dtype=I64, device=device)


def lexsort(keys) -> torch.Tensor:
    """``np.lexsort``: the permutation sorting by ``keys[-1]`` first, ties by
    ``keys[-2]``, ..., then by original position; a chain of stable sorts."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        idx = torch.sort(kk, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def offsets_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """``concatenate([[0], cumsum(counts)])`` as int64."""
    out = torch.zeros(counts.numel() + 1, dtype=I64, device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def group_starts(v: torch.Tensor) -> torch.Tensor:
    """Indices where a run of equal values starts in `v`."""
    if v.numel() == 0:
        return empty(v.device)
    head = torch.ones(v.numel(), dtype=torch.bool, device=v.device)
    head[1:] = v[1:] != v[:-1]
    return torch.nonzero(head).reshape(-1)
