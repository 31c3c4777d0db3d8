"""HDT Bitmap-Triples baseline [10] on the card: the twin of
``repro.baselines.hdt_bt``.

Triples sorted by (s, p, o). Layer 1: the distinct predicates of each
subject (sequence ``Sp`` + bitmap ``Bp`` whose 1s close each subject's
run); layer 2: the objects of each (s, p) pair (sequence ``So`` + bitmap
``Bo``). ``Sp``, ``So``, ``subjects`` and the two port
:class:`~repro_torch.core.succinct.BitVector` s live on the device. A query
returns the reference's list of ``(p, (s, o))`` tuples of Python ints, in
its order (run by run, objects ascending).

Port decisions. The reference's ``_subj_pos`` dict is a ``searchsorted``
over ``subjects``. The S-rooted walk reads the subject's predicate runs
through ``Bp.select1`` and their objects, which lie side by side in
``So``, through ``Bo.select1``; each object's run is one ``Bo.rank1`` (a
``bitvec_rank`` launch). It makes 3 host syncs a query whatever the
subject's number of runs: the subject's copy to the card, one read of
(found, run range, object range) and one read of the answer. The O-rooted and P-only scan is one pass
over all runs: ``run_subject`` is one ``Bp.rank1`` (a ``bitvec_rank``
launch), a mask over the runs selects them, their object ranges (from
``Bo.select1``) expand with ``repeat_interleave``, and the answer is one
host copy; 2 host syncs a query (the expansion's size, the read), and
one more with P bound (the mask over the runs).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core._arrays import I64
from repro_torch.core.succinct import BitVector
from repro_torch.device import as_i64, resolve_device


def _end_flags(change: torch.Tensor) -> torch.Tensor:
    """1 at the last element of each run, given the run-start flags."""
    ends = torch.zeros_like(change, dtype=I64)
    if change.numel():
        ends[:-1] = change[1:].to(I64)
        ends[-1] = 1
    return ends


class HDTBitmapTriples:
    def __init__(self, triples, n_nodes: int, n_preds: int, device=None):
        dev = resolve_device(device)
        t = torch.unique(as_i64(triples, dev).reshape(-1, 3), dim=0)  # sorted by (s, p, o)
        self.n_nodes, self.n_preds = int(n_nodes), int(n_preds)
        s, p, o = t[:, 0], t[:, 1], t[:, 2]
        self.n_triples = int(t.shape[0])

        # layer 2: objects per (s, p) run
        sp_change = torch.ones(self.n_triples, dtype=torch.bool, device=dev)
        sp_change[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1])
        self.So = o.contiguous()
        self.Bo = BitVector(_end_flags(sp_change))

        # layer 1: predicates per subject (one entry per (s, p) run)
        sp_idx = torch.nonzero(sp_change).reshape(-1)
        self.Sp = p[sp_idx].contiguous()
        s_of_run = s[sp_idx]
        s_change = torch.ones(s_of_run.numel(), dtype=torch.bool, device=dev)
        s_change[1:] = s_of_run[1:] != s_of_run[:-1]
        self.Bp = BitVector(_end_flags(s_change))
        # subjects present, in order (for select into runs)
        self.subjects = torch.unique(s)

    @property
    def device(self) -> torch.device:
        return self.So.device

    # -- run lookups -----------------------------------------------------
    def _ends(self, bv: BitVector, j: torch.Tensor) -> torch.Tensor:
        """Position of the j-th 1 of ``bv`` for j in [-1, n_ones): -1 at
        j = -1, so a run's first element is ``_ends(j - 1) + 1``."""
        if bv.n_ones == 0:
            return torch.full_like(j, -1)
        pos = bv._select1(j.clamp(0, bv.n_ones - 1))
        return torch.where(j >= 0, pos, -1)

    def query(self, s: int | None, p: int | None, o: int | None) -> list[tuple]:
        if s is not None:
            return self._subject_walk(int(s), p, o)
        return self._scan(p, o)

    def _subject_walk(self, s: int, p: int | None, o: int | None) -> list[tuple]:
        dev = self.device
        n_subj = self.subjects.numel()
        if n_subj == 0:
            return []
        i = torch.searchsorted(self.subjects, s)
        found = (i < n_subj) & (self.subjects[i.clamp(max=n_subj - 1)] == s)
        i = i.clamp(max=n_subj - 1)
        run_lo = self._ends(self.Bp, i - 1) + 1        # runs [run_lo, run_hi)
        run_hi = self._ends(self.Bp, i) + 1
        obj_lo = self._ends(self.Bo, run_lo - 1) + 1   # their objects, side by side
        obj_hi = self._ends(self.Bo, run_hi - 1) + 1
        hit, lo, hi = torch.stack([found.to(I64), obj_lo, obj_hi]).tolist()  # sync 1
        if not hit:
            return []
        pos = torch.arange(lo, hi, dtype=I64, device=dev)
        pp = self.Sp[self.Bo.rank1(pos)]  # each object's run, its predicate
        objs = self.So[pos]
        keep = torch.ones_like(pos, dtype=torch.bool)
        if p is not None:
            keep &= pp == p
        if o is not None:
            keep &= objs == o
        rows = torch.stack([pp, objs, keep.to(I64)]).tolist()  # sync 2
        return [(a, (s, b)) for a, b, k in zip(*rows) if k]

    def _scan(self, p: int | None, o: int | None) -> list[tuple]:
        """O-rooted / P-only patterns: scan the runs (no OPS index)."""
        dev = self.device
        n_runs = self.Sp.numel()
        if n_runs == 0:
            return []
        runs = torch.arange(n_runs, dtype=I64, device=dev)
        run_subject = self.subjects[self.Bp.rank1(runs)]
        sel = runs if p is None else torch.nonzero(self.Sp == p).reshape(-1)  # sync 1
        lo = self._ends(self.Bo, sel - 1) + 1
        lens = self._ends(self.Bo, sel) + 1 - lo
        offs = torch.cumsum(lens, 0)
        total = int(offs[-1]) if sel.numel() else 0  # sync 2
        run_of = torch.repeat_interleave(sel, lens, output_size=total)
        pos = torch.arange(total, dtype=I64, device=dev) + torch.repeat_interleave(
            lo - (offs - lens), lens, output_size=total)
        objs = self.So[pos]
        keep = objs == o if o is not None else torch.ones_like(objs, dtype=torch.bool)
        rows = torch.stack([self.Sp[run_of], run_subject[run_of], objs,
                            keep.to(I64)]).tolist()  # sync 3
        return [(a, (b, c)) for a, b, c, k in zip(*rows) if k]

    def size_in_bytes(self) -> int:
        # sequences log-packed like HDT: ceil(log2) bits per element
        bits_p = max(1, int(math.ceil(math.log2(max(self.n_preds, 2)))))
        bits_o = max(1, int(math.ceil(math.log2(max(self.n_nodes, 2)))))
        seq = (self.Sp.numel() * bits_p + self.So.numel() * bits_o + 7) // 8
        subj = (self.subjects.numel() * bits_o + 7) // 8
        return seq + subj + self.Bp.size_in_bytes() + self.Bo.size_in_bytes()
