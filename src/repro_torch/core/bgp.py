"""Basic graph pattern (BGP) join queries over the batched triple engine.

A BGP is a conjunction of triple patterns sharing named variables,
``?x worksFor ?y . ?y locatedIn Berlin``. This module is the join layer on
top of the single-pattern engine, the twin of the reference's
``core/bgp.py``:

* **Pattern model**: :func:`parse_bgp` takes the string form above (integer
  ids for constants, ``?name`` for variables, patterns separated by ``.``)
  or a list of ``(s, p, o)`` triples whose terms are ints or ``?name``
  strings. String constants go through the term dictionary
  (:mod:`repro_torch.core.term_dict`) before they reach this module.
* **Selectivity stats**: :class:`SelectivityStats`, computed once per
  engine build from the flattened grammar without decompressing it. Rule
  bodies only reference earlier rules, so per-rule terminal counts
  propagate bottom up; that part runs on the host over the rule bodies the
  engine already copied there. The distinct subject and object counts are
  ``torch.unique`` on the device.
* **Planner**: :func:`plan_bgp` greedily takes the next pattern with the
  lowest estimated cardinality given the variables already solved,
  preferring patterns connected to them. Costs are host floats.
* **Executor**: :func:`execute_bgp` keeps a binding table, an ``(n, k)``
  int64 tensor on the engine's device, and joins one pattern in a step
  through a ``batch_fn`` with the ``query_batch_view`` signature. A step
  binds (the distinct bound-variable combos substituted into one batch of
  concrete patterns, joined back through the unique inverse) or scans
  (the pattern once with its constants only, merged by a sort and
  ``searchsorted`` equi-join, :func:`_join_indices`).

Candidates come out of a result view in one pass over its flat buffer
(:class:`_Candidates`): the rank-2 mask, the repeated-variable
equalities and a running count of kept edges, from which each entry's
candidates are addressed by ``searchsorted``. No step loops over entries or
combos, and a step's host syncs outside ``batch_fn`` do not grow with them:
the number of distinct combos (read to choose bind or scan), the join's
``torch.unique`` on a scan, and the output size.

Results are a :class:`BGPResult`: variables in first-appearance order,
binding rows sorted lexicographically by stable sorts, duplicates kept, so
whole-BGP results compare byte for byte across executions.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core._arrays import I64, lexsort, offsets_from_counts
from repro_torch.core.flatten import _ragged_arange
from repro_torch.core.hypergraph import _ragged_take

# bind-join fan-out floor: below this many distinct bound-variable combos a
# step always binds; above it the combo count competes against the
# pattern's constants-only cardinality estimate and the step may scan
_BIND_FANOUT = 64


@dataclass(frozen=True)
class TriplePattern:
    """One (s, p, o) pattern: each term an int constant or a ``?var`` name."""

    s: int | str
    p: int | str
    o: int | str

    @property
    def terms(self) -> tuple:
        return (self.s, self.p, self.o)

    def variables(self) -> list[str]:
        """Variable names in slot order (repeats kept)."""
        return [t for t in self.terms if isinstance(t, str)]

    def __str__(self) -> str:
        return " ".join(str(t) for t in self.terms)


def _parse_term(tok):
    if isinstance(tok, TriplePattern):
        raise TypeError("pattern given where a term was expected")
    if isinstance(tok, str):
        tok = tok.strip()
        if tok.startswith("?"):
            if len(tok) < 2:
                raise ValueError("variable needs a name: bare '?'")
            return tok
        try:
            val = int(tok)
        except ValueError:
            raise ValueError(
                f"term {tok!r} is neither an integer id nor a ?variable "
                "(string terms go through the term dictionary first)") from None
        tok = val
    if isinstance(tok, (int, np.integer)):
        val = int(tok)
        if val < 0:
            raise ValueError(f"constant ids must be >= 0, got {val}")
        return val
    raise TypeError(f"unsupported pattern term: {tok!r}")


def parse_bgp(bgp) -> list[TriplePattern]:
    """Normalize a BGP into a list of :class:`TriplePattern`.

    Accepts the string form (``"?x 0 ?y . ?y 1 17"``: whitespace-split
    terms, ``.``-separated patterns) or an iterable of 3-term patterns
    (``TriplePattern`` instances pass through). Every term must be a
    non-negative int id or a ``?name`` variable; an empty BGP is an error.
    """
    if isinstance(bgp, TriplePattern):
        return [bgp]
    if isinstance(bgp, str):
        parts = [part.strip() for part in bgp.split(".")]
        patterns: list = [part.split() for part in parts if part]
    else:
        patterns = list(bgp)
    out: list[TriplePattern] = []
    for pat in patterns:
        if isinstance(pat, TriplePattern):
            out.append(pat)
            continue
        terms = tuple(pat)
        if len(terms) != 3:
            raise ValueError(f"triple pattern needs 3 terms, got {terms!r}")
        out.append(TriplePattern(*(_parse_term(t) for t in terms)))
    if not out:
        raise ValueError("empty BGP: at least one triple pattern required")
    return out


def bgp_variables(patterns: list[TriplePattern]) -> list[str]:
    """Variable names in first-appearance order: the result column order."""
    seen: dict[str, None] = {}
    for pat in patterns:
        for v in pat.variables():
            seen.setdefault(v, None)
    return list(seen)


def canonical_bgp(patterns: list[TriplePattern]) -> str:
    """Stable text form with variables renamed by first occurrence, so two
    BGPs identical up to variable names share one cache key. Pattern order
    is part of the key."""
    names: dict[str, int] = {}
    parts = []
    for pat in patterns:
        toks = []
        for t in pat.terms:
            if isinstance(t, str):
                toks.append(f"?{names.setdefault(t, len(names))}")
            else:
                toks.append(str(t))
        parts.append(" ".join(toks))
    return " . ".join(parts)


def bgp_cache_key(patterns: list[TriplePattern]) -> tuple[int, int, int]:
    """Digest a canonicalized BGP into the (S, P, O) int slots of the shared
    result cache. The three ints are always <= -2, so a key never collides
    with a real pattern key (those use values >= -1)."""
    digest = hashlib.blake2b(canonical_bgp(patterns).encode(), digest_size=24).digest()
    return tuple(-2 - (int.from_bytes(digest[8 * i:8 * i + 8], "big") >> 2)
                 for i in range(3))


class BGPResult:
    """Bindings of a BGP: ``vars`` (first-appearance order) x ``rows``.

    ``rows`` is an ``(n_bindings, n_vars)`` int64 tensor on the engine's
    device, in lexicographic row order, so results compare byte for byte
    across executions. Callers must not write it (the reference's array is
    read-only; a tensor has no such flag). :meth:`tuples` and
    :meth:`bindings` read it back to the host once.
    """

    __slots__ = ("vars", "rows")

    def __init__(self, variables, rows: torch.Tensor):
        self.vars = tuple(variables)
        self.rows = rows

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def tuples(self) -> list[tuple]:
        """Binding rows as plain int tuples (test/oracle comparison form)."""
        return [tuple(row) for row in self.rows.tolist()]

    def bindings(self) -> list[dict]:
        """Binding rows as var -> id dicts."""
        return [dict(zip(self.vars, row)) for row in self.tuples()]

    def __repr__(self) -> str:
        return f"BGPResult(vars={self.vars}, n={len(self)})"


def encode_result_entry(result: BGPResult):
    """A :class:`BGPResult` in the cache's ``(labels, nodes_flat, offsets)``
    entry shape: one edge a binding row (labels all zero, nodes the row's
    values, rank ``n_vars``), so whole-BGP results ride the result cache's
    budgets. Inverse: :func:`decode_result_entry`."""
    n, k = result.rows.shape
    dev = result.rows.device
    labels = torch.zeros(n, dtype=I64, device=dev)
    nodes = result.rows.to(I64).contiguous().reshape(-1)
    offsets = torch.arange(n + 1, dtype=I64, device=dev) * k
    return labels, nodes, offsets


def decode_result_entry(entry, variables) -> BGPResult:
    labels, nodes, _ = entry
    k = len(tuple(variables))
    n = int(labels.numel())
    rows = nodes.reshape(n, k) if k else torch.zeros((n, 0), dtype=I64, device=labels.device)
    return BGPResult(variables, rows)


# -- selectivity statistics ---------------------------------------------------
@dataclass
class SelectivityStats:
    """Join-ordering statistics of one engine's compressed base.

    ``pred_card[p]`` (a host int64 tensor) is the exact number of base edges
    labeled ``p``: per-rule terminal-label counts propagate bottom up
    through the rule bodies, then each start edge contributes its own label
    or its rule's counts. ``n_subjects`` / ``n_objects`` are distinct-value
    counts over the terminal start edges' first/second slots plus every
    nonterminal edge's attachment nodes (an upper bound). The mutation
    overlay is ignored: stats only order joins.
    """

    total: int
    pred_card: torch.Tensor
    n_subjects: int
    n_objects: int

    @classmethod
    def from_csr(cls, labels, ranks, nodes_flat, offsets, flat, n_terminals: int,
                 rules: dict) -> "SelectivityStats":
        """From the label-sorted start graph's tensors and the flat grammar.
        `rules` is the rule bodies on the host, ``{rule label: [(child
        label, params), ...]}`` in rule-slot order: the copy the engine
        made at build, so the per-rule counts need no device-to-host copy."""
        T = int(n_terminals)
        slot_of = {lbl: r for r, lbl in enumerate(rules)}
        counts: list[list[int]] = []
        for slot, body in enumerate(rules.values()):
            row = [0] * T
            for child, _ in body:
                if child < T:
                    row[child] += 1
                    continue
                c = slot_of[child]
                if c >= slot:
                    raise ValueError("rule bodies must reference earlier rules "
                                     "(RePair output is bottom-up ordered)")
                row = [a + b for a, b in zip(row, counts[c])]
            counts.append(row)

        dev = labels.device
        is_term = labels < T
        pred_card = torch.bincount(labels[is_term], minlength=T) if T \
            else torch.zeros(0, dtype=I64, device=dev)
        nt_idx = torch.nonzero(~is_term).reshape(-1)
        if nt_idx.numel() and counts and T:
            per_rule = torch.tensor(counts, dtype=I64).to(dev)
            pred_card = pred_card + per_rule[flat.rule_index[labels[nt_idx]]].sum(0)

        starts = offsets[:-1]
        t2 = torch.nonzero(is_term & (ranks >= 2)).reshape(-1)
        subs = nodes_flat[starts[t2]]
        objs = nodes_flat[starts[t2] + 1]
        att = nodes_flat[_ragged_take(offsets, nt_idx, ranks[nt_idx])]
        n_subjects = torch.unique(torch.cat([subs, att])).numel()
        n_objects = torch.unique(torch.cat([objs, att])).numel()
        pred_card = pred_card.cpu()
        return cls(total=int(pred_card.sum()), pred_card=pred_card,
                   n_subjects=max(1, n_subjects), n_objects=max(1, n_objects))

    @classmethod
    def merge(cls, parts) -> "SelectivityStats":
        """Tier-level stats: per-shard sums (distinct counts overestimate
        where one subject spans shards; acceptable for ordering joins)."""
        parts = list(parts)
        if not parts:
            return cls(0, torch.zeros(0, dtype=I64), 1, 1)
        T = max(len(p.pred_card) for p in parts)
        pred = torch.zeros(T, dtype=I64)
        for p in parts:
            pred[:len(p.pred_card)] += torch.as_tensor(p.pred_card, dtype=I64)
        return cls(total=int(sum(p.total for p in parts)), pred_card=pred,
                   n_subjects=sum(p.n_subjects for p in parts),
                   n_objects=sum(p.n_objects for p in parts))

    def estimate(self, s_bound: bool, p: int | None, o_bound: bool) -> float:
        """Expected matches of one pattern under independence: predicate
        cardinality (or the full edge count for a free/variable P), divided
        by the distinct subject/object counts per bound slot."""
        if p is not None:
            p = int(p)
            card = float(self.pred_card[p]) if 0 <= p < len(self.pred_card) else 0.0
        else:
            card = float(self.total)
        if s_bound:
            card /= max(1, self.n_subjects)
        if o_bound:
            card /= max(1, self.n_objects)
        return card


def pattern_cost(pattern: TriplePattern, bound, stats) -> float:
    """Estimated matches of `pattern` once the variables in `bound` carry
    concrete values. With no stats, falls back to counting free slots."""
    s, p, o = pattern.terms
    s_bound = not isinstance(s, str) or s in bound
    o_bound = not isinstance(o, str) or o in bound
    if stats is None:
        free = sum(1 for b in (s_bound, not isinstance(p, str) or p in bound, o_bound)
                   if not b)
        return float(1000 ** free)
    if not isinstance(p, str):
        return stats.estimate(s_bound, p, o_bound)
    if p in bound:  # concrete at run time, unknown now: average predicate
        card = stats.total / max(1, len(stats.pred_card))
        if s_bound:
            card /= max(1, stats.n_subjects)
        if o_bound:
            card /= max(1, stats.n_objects)
        return card
    return stats.estimate(s_bound, None, o_bound)


def plan_bgp(patterns: list[TriplePattern], stats=None) -> list[int]:
    """Greedy variable-elimination order (pattern indices).

    Start from the pattern with the lowest constants-only estimate; then
    repeatedly take the cheapest pattern given the solved variables,
    restricted to patterns sharing a solved variable whenever any exists.
    Ties break on pattern index, so plans are deterministic.
    """
    remaining = list(range(len(patterns)))
    bound: set[str] = set()
    order: list[int] = []
    while remaining:
        best = None
        best_key = None
        for i in remaining:
            pat = patterns[i]
            connected = not bound or any(v in bound for v in pat.variables()) \
                or not pat.variables()
            key = (not connected, pattern_cost(pat, bound, stats), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        order.append(best)
        remaining.remove(best)
        bound.update(patterns[best].variables())
    return order


# -- execution ----------------------------------------------------------------
def _join_indices(left: torch.Tensor, right: torch.Tensor, right_keep=None):
    """Equi-join of two key matrices on all columns.

    Returns aligned ``(li, ri)`` index tensors: every pair with
    ``left[li[k]] == right[ri[k]]`` row-wise, grouped by left row, right
    rows in position order. `right_keep` (bool per right row) leaves the
    rows where it is False out of the join. One shared ``torch.unique``
    assigns both sides integer key codes, then a stable sort and
    ``searchsorted`` emit the pairs; two host syncs (the unique's size and
    the pair count).
    """
    n = int(left.shape[0])
    dev = left.device
    if n == 0 or right.shape[0] == 0:
        return torch.zeros(0, dtype=I64, device=dev), torch.zeros(0, dtype=I64, device=dev)
    _, codes = torch.unique(torch.cat([left, right]), dim=0, return_inverse=True)
    codes = codes.reshape(-1)
    lcode, rcode = codes[:n], codes[n:]
    if right_keep is not None:
        rcode = torch.where(right_keep, rcode, -1)  # sorts first, matches nothing
    order = torch.sort(rcode, stable=True).indices
    rsorted = rcode[order]
    lo = torch.searchsorted(rsorted, lcode)
    cnt = torch.searchsorted(rsorted, lcode, right=True) - lo
    total = int(cnt.sum())
    li = torch.repeat_interleave(torch.arange(n, dtype=I64, device=dev), cnt, output_size=total)
    ri = order[torch.repeat_interleave(lo, cnt, output_size=total) + _ragged_arange(cnt, total)]
    return li, ri


def _var_positions(pattern: TriplePattern) -> dict[str, list[int]]:
    pos: dict[str, list[int]] = {}
    for slot, t in enumerate(pattern.terms):
        if isinstance(t, str):
            pos.setdefault(t, []).append(slot)
    return pos


class _Candidates:
    """Candidate rows of a whole result view, in one pass over its flat
    buffer: ``cols`` is ``(E, len(want))`` with one row an edge of the view
    (values of edges that are not kept are meaningless), ``keep`` says which
    edges are rank-2 and pass the repeated-variable equalities, ``kept``
    the running count of kept edges (``kept[e]`` kept edges before edge e,
    ``E + 1`` long). Entry i's kept candidates are the kept edges numbered
    ``first[i] .. first[i] + count[i] - 1``; :meth:`edges` turns kept
    numbers into edge positions."""

    __slots__ = ("cols", "keep", "kept", "first", "count")

    def __init__(self, view, want_slots: list[int], check_pos: list[list[int]]):
        labels, nodes, offsets = view.labels, view.nodes, view.offsets
        n_edges = labels.numel()
        starts = offsets[:-1]
        if nodes.numel():  # non-rank-2 edges read a clamped neighbour, masked below
            last = nodes.numel() - 1
            first_col = nodes[starts.clamp(max=last)]
            second_col = nodes[(starts + 1).clamp(max=last)]
        else:
            first_col = second_col = torch.zeros_like(labels)
        slot_cols = (first_col, labels, second_col)
        keep = (offsets[1:] - starts) == 2
        for slots in check_pos:
            for extra in slots[1:]:
                keep &= slot_cols[slots[0]] == slot_cols[extra]
        self.keep = keep
        self.cols = torch.stack([slot_cols[s] for s in want_slots], 1) if want_slots \
            else torch.zeros((n_edges, 0), dtype=I64, device=labels.device)
        self.kept = offsets_from_counts(keep.to(I64))
        at_bounds = self.kept[view.entry_bounds]
        self.first = at_bounds[:-1]
        self.count = at_bounds[1:] - at_bounds[:-1]

    def edges(self, numbers: torch.Tensor) -> torch.Tensor:
        """Edge positions of kept candidates by their running number: the
        first edge where the running count passes it."""
        return torch.searchsorted(self.kept[1:], numbers + 1)

    def total(self) -> int:
        return int(self.kept[-1])


def execute_bgp(patterns, batch_fn, stats=None, order=None) -> BGPResult:
    """Evaluate a BGP through a batched single-pattern executor.

    `batch_fn(s, p, o)` takes aligned int64 columns (-1 = unbound) and
    returns a :class:`~repro_torch.core.query.QueryResultView`: pass
    ``engine.query_batch_view``, so every sub-pattern batch takes that
    path's dedup, result cache, overlay merge and crossover. `stats` orders
    the join (:func:`plan_bgp`) and arbitrates bind against scan per step;
    `order` overrides the planner with an explicit pattern-index order.

    The binding table starts as the single empty binding and each step
    joins one pattern in; when it empties, the remaining patterns are never
    executed. The table lives on the views' device.
    """
    patterns = parse_bgp(patterns)
    out_vars = bgp_variables(patterns)
    if order is None:
        order = plan_bgp(patterns, stats)
    elif sorted(order) != list(range(len(patterns))):
        raise ValueError(f"order must permute range({len(patterns)}), got {order!r}")
    solved: list[str] = []
    rows = torch.zeros((1, 0), dtype=I64)
    for i in order:
        rows, solved = _join_step(rows, solved, patterns[i], batch_fn, stats)
        if rows.shape[0] == 0:
            break
    if rows.shape[0] == 0:
        final = torch.zeros((0, len(out_vars)), dtype=I64, device=rows.device)
    else:
        perm = [solved.index(v) for v in out_vars]
        final = _columns(rows, perm)
        if perm:
            # np.lexsort(final.T[::-1]): column 0 decides first, duplicates kept
            final = final[lexsort([final[:, j] for j in reversed(range(final.shape[1]))])]
    return BGPResult(out_vars, final)


def _columns(rows: torch.Tensor, cols: list[int]) -> torch.Tensor:
    """``rows[:, cols]`` (contiguous) from column views: a list index would
    copy it to the device first, a host sync."""
    if not cols:
        return rows[:, :0].contiguous()
    return torch.stack([rows[:, j] for j in cols], 1)


def _constants(pattern: TriplePattern, device) -> list[torch.Tensor]:
    """The pattern with its constants only, as three one-row int64 columns
    filled on `device` (no host-to-device copy)."""
    return [torch.full((1,), -1 if isinstance(t, str) else t, dtype=I64, device=device)
            for t in pattern.terms]


def _join_step(rows: torch.Tensor, solved: list[str], pattern: TriplePattern, batch_fn,
               stats):
    """Join one pattern into the binding table; returns (rows, solved)."""
    var_pos = _var_positions(pattern)
    bound_vars = [v for v in solved if v in var_pos]
    new_vars = [v for v in var_pos if v not in solved]
    new_slots = [var_pos[v][0] for v in new_vars]
    width = len(solved) + len(new_vars)
    n = int(rows.shape[0])

    if not bound_vars:
        # first step, or a disconnected pattern: one scan, then a cross
        # product against the table (n == 1 empty binding at the start)
        view = batch_fn(*_constants(pattern, rows.device))
        rows = rows.to(view.labels.device)
        cand = _Candidates(view, new_slots, list(var_pos.values()))
        m = cand.total()
        if n * m == 0:
            return torch.zeros((0, width), dtype=I64, device=rows.device), solved + new_vars
        picked = cand.cols[cand.edges(torch.arange(m, dtype=I64, device=rows.device))]
        out = torch.cat([rows.repeat_interleave(m, dim=0), picked.repeat(n, 1)], 1)
        return out, solved + new_vars

    key_cols = [solved.index(v) for v in bound_vars]
    table_keys = _columns(rows, key_cols)
    combos, inv = torch.unique(table_keys, dim=0, return_inverse=True)
    inv = inv.reshape(-1)
    u = int(combos.shape[0])
    # bind pays per distinct combo (a point pattern each); scan pays one
    # est_const-row fetch plus a join: bind only when the combo count is
    # small in absolute terms or tiny against the scan
    est_const = pattern_cost(pattern, frozenset(), stats) if stats is not None else None
    threshold = _BIND_FANOUT if est_const is None else max(_BIND_FANOUT, est_const / 8.0)

    if u > threshold:
        # scan + hash join: the pattern once with constants only, its
        # candidate columns merged against the table on the bound vars
        view = batch_fn(*_constants(pattern, rows.device))
        want = [var_pos[v][0] for v in bound_vars] + new_slots
        cand = _Candidates(view, want, list(var_pos.values()))
        b = len(bound_vars)
        li, ri = _join_indices(table_keys, cand.cols[:, :b], cand.keep)
        return torch.cat([rows[li], cand.cols[ri][:, b:]], 1), solved + new_vars

    # bind: one concrete pattern a distinct combo, shipped as one batch; the
    # unique inverse joins results back to table rows
    dev = rows.device
    sub = []
    for t in pattern.terms:
        if isinstance(t, str):
            sub.append(combos[:, bound_vars.index(t)] if t in bound_vars
                       else torch.full((u,), -1, dtype=I64, device=dev))
        else:
            sub.append(torch.full((u,), t, dtype=I64, device=dev))
    view = batch_fn(*sub)
    # repeated-variable checks cover free groups only: bound and constant
    # slots were substituted, so the executor enforced them
    check = [slots for v, slots in var_pos.items() if v in new_vars and len(slots) > 1]
    cand = _Candidates(view, new_slots, check)
    combo_entry = view.qid_entry
    cnt = cand.count[combo_entry][inv]  # candidates of each table row's combo
    total = int(cnt.sum())
    if total == 0:
        return torch.zeros((0, width), dtype=I64, device=dev), solved + new_vars
    numbers = torch.repeat_interleave(cand.first[combo_entry][inv], cnt, output_size=total) \
        + _ragged_arange(cnt, total)
    out = torch.cat([rows.repeat_interleave(cnt, dim=0, output_size=total),
                     cand.cols[cand.edges(numbers)]], 1)
    return out, solved + new_vars
