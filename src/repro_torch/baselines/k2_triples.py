"""k²-Triples baseline [9]: a k²-tree per predicate over subject × object.

The twin of ``repro.baselines.k2_triples``, with each predicate's tree a
port :class:`~repro_torch.core.succinct.K2Tree` on the device. A query
returns the reference's list of ``(p, (s, o))`` tuples of Python ints, in
its order: predicate by predicate, then by row and column.

Where the reference loops ``row(r)`` over every node for ``???``, a
predicate here is one ``rows_many`` over all nodes (one ``k2_lines`` pair,
one host sync); ``s??`` / ``??o`` are one ``row`` / ``col`` a predicate
(one ``k2_lines`` pair each), ``sp?`` / ``?po`` one of them; ``s?o`` /
``spo`` walk :meth:`K2Tree.access`, one ``bitvec_rank`` launch a level
of each tree it reaches. CUDA's sync debug mode counted 80 host syncs
for an ``spo`` hit in a tree of 16 levels on an H100: five a level
(scalar positions copied to the card, the bit and the rank read back).
"""
from __future__ import annotations

import torch

from repro_torch.core.succinct import K2Tree
from repro_torch.device import as_i64, resolve_device


class K2Triples:
    def __init__(self, triples, n_nodes: int, n_preds: int, device=None):
        dev = resolve_device(device)
        t = as_i64(triples, dev).reshape(-1, 3)
        self.n_nodes, self.n_preds = int(n_nodes), int(n_preds)
        self.trees: list[K2Tree] = []
        for p in range(self.n_preds):
            sel = t[:, 1] == p
            self.trees.append(K2Tree(t[sel, 0], t[sel, 2], n_nodes, n_nodes))

    def query(self, s: int | None, p: int | None, o: int | None) -> list[tuple]:
        preds = [p] if p is not None else range(self.n_preds)
        out = []
        for pp in preds:
            t = self.trees[pp]
            if s is not None and o is not None:
                if t.access(s, o):
                    out.append((pp, (s, o)))
            elif s is not None:
                out.extend((pp, (s, c)) for c in t.row(s).tolist())
            elif o is not None:
                out.extend((pp, (r, o)) for r in t.col(o).tolist())
            else:
                idx, cols = t.rows_many(torch.arange(self.n_nodes, device=t.device))
                out.extend((pp, (r, c)) for r, c in zip(*torch.stack([idx, cols]).tolist()))
        return out

    def size_in_bytes(self) -> int:
        return sum(t.size_in_bytes() for t in self.trees) + 8 * self.n_preds
