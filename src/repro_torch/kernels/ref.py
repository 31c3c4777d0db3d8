"""Plain PyTorch twins of the hand-written kernels.

Each twin computes exactly what its CUDA kernel computes. The wrappers in
:mod:`repro_torch.kernels.ops` run the twin for a tensor on the CPU, and
``chip_smoke.py`` holds each kernel against its twin on the card. The CSR
product has two: :func:`csr_spmm_ref`, a plain float32 sum, is the CPU
path; :func:`csr_spmm_split_ref` sums as the kernel does (split by its
plan, compensated), for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
SPLIT_KEYS = 64  # a split of the decode's keys covers whole chunks of this many keys


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 lanes holding values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def bitvec_rank_ref(words: torch.Tensor, word_ranks: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """rank1(pos) = word_ranks[pos >> 5] + popcount(words[pos >> 5] & mask).

    words: (W+1,) int32 or int64 holding the uint32 bit patterns (the last
    word is the zero pad that keeps ``pos == n`` in bounds); word_ranks:
    (W+1,) int64 exclusive prefix popcounts; positions: (Q,) int64.
    Returns (Q,) int64.
    """
    w = positions >> 5
    rem = positions & 31
    word = words[w].to(torch.int64) & _M32
    mask = (torch.ones_like(rem) << rem) - 1
    return word_ranks[w] + popcount32(word & mask)


def k2_stack_cap(k: int, h: int) -> int:
    """The most entries the k²-tree walk's stack holds: below the deepest
    level at most 32 (k - 1) nodes a level, at the deepest 32 k."""
    return 32 * (k - 1) * h + 32


def k2_lines_ref(lay, fixed: torch.Tensor, axis: int, rank=bitvec_rank_ref):
    """Rows (axis 0) or columns (axis 1) ``fixed`` of the k²-tree laid out
    in ``lay`` (a :class:`repro_torch.kernels.k2_lines.K2Layout`), level by
    level: each level tests every frontier node's k candidate bits, keeps
    the set ones and takes their ranks, one batched ``rank(words, ranks,
    positions)`` a level, as the reference does.

    fixed: (Q,) int64. Returns (idx, coords), int64: query ``idx[i]`` has a
    1 at free coordinate ``coords[i]``, sorted by (idx, coord). Fixed values
    out of range yield nothing, duplicates are expanded independently, and
    free coordinates past the matrix are dropped.
    """
    k, k2, h = lay.k, lay.k * lay.k, lay.h
    dev = fixed.device
    limit_fixed, limit_free = lay.limits(axis)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    qids = torch.nonzero((fixed >= 0) & (fixed < limit_fixed)).reshape(-1)
    fvals = fixed[qids]
    blocks = torch.zeros_like(qids)
    prefixes = torch.zeros_like(qids)  # free-axis coordinate prefix
    free = torch.arange(k, dtype=torch.int64, device=dev)
    for t in range(h):
        if blocks.numel() == 0:
            break
        fixed_digit = fvals // k ** (h - 1 - t) % k
        # candidate children: fixed-axis digit fixed, free-axis digit 0..k-1
        if axis == 0:
            child = fixed_digit[:, None] * k + free[None, :]
        else:
            child = free[None, :] * k + fixed_digit[:, None]
        bitpos = (blocks[:, None] * k2 + child).reshape(-1)
        words, ranks = lay.level(t)
        valid = bitpos < lay.bits[t]
        pos = torch.where(valid, bitpos, 0)
        setbit = valid & ((words[pos >> 5].to(torch.int64) >> (pos & 31)) & 1 == 1)
        sel = torch.nonzero(setbit).reshape(-1)
        parent = sel // k
        prefixes = prefixes[parent] * k + sel % k
        qids, fvals = qids[parent], fvals[parent]
        if t < h - 1:
            blocks = rank(words, ranks, bitpos[sel])
        else:
            keep = torch.nonzero(prefixes < limit_free).reshape(-1)
            qids, coords = qids[keep], prefixes[keep]
            order = torch.sort(coords, stable=True).indices
            order = order[torch.sort(qids[order], stable=True).indices]
            return qids[order], coords[order]
    return none, none.clone()


def k2_lines_walk_ref(lay, fixed: torch.Tensor, axis: int, peaks: list | None = None):
    """:func:`k2_lines_ref` computed as the fused kernel walks, one query at
    a time in plain Python: a stack of (level, block, coordinate prefix)
    nodes, smallest coordinate on top; each step pops the top run of the
    deepest level, up to 32 nodes (one a lane), tests their k candidate
    bits, and at the last level emits the coordinates in lane order, else
    pushes the children back in coordinate order. With ``peaks``, appends
    each walked query's largest stack size (never above
    :func:`k2_stack_cap`)."""
    k, h = lay.k, lay.h
    limit_fixed, limit_free = lay.limits(axis)
    words = [w & _M32 for w in lay.words.tolist()]
    ranks = lay.ranks.tolist()
    idx, coords = [], []
    for qi, f in enumerate(fixed.tolist()):
        if not 0 <= f < limit_fixed:
            continue
        digits = [f // k ** (h - 1 - t) % k for t in range(h)]
        stack = [(0, 0, 0)]
        peak = 1
        while stack:
            t = stack[-1][0]
            m = 1
            while m < min(32, len(stack)) and stack[-1 - m][0] == t:
                m += 1
            lanes = stack[:-m - 1:-1]  # lane 0 holds the smallest coordinate
            del stack[-m:]
            off, fd = lay.offsets[t], digits[t]
            pushed = []
            for _, b, p in lanes:
                for j in range(k):
                    pos = b * k * k + (fd * k + j if axis == 0 else j * k + fd)
                    if pos >= lay.bits[t] or not words[off + (pos >> 5)] >> (pos & 31) & 1:
                        continue
                    if t < h - 1:
                        word = words[off + (pos >> 5)] & ((1 << (pos & 31)) - 1)
                        pushed.append((t + 1, ranks[off + (pos >> 5)] + bin(word).count("1"),
                                       p * k + j))
                    elif p * k + j < limit_free:
                        idx.append(qi)
                        coords.append(p * k + j)
            stack.extend(reversed(pushed))
            peak = max(peak, len(stack))
        if peaks is not None:
            peaks.append(peak)
    return (torch.tensor(idx, dtype=torch.int64, device=fixed.device),
            torch.tensor(coords, dtype=torch.int64, device=fixed.device))


def digram_pair_counts_ref(its: torch.Tensor, cnts: torch.Tensor):
    """Per-node pairwise digram counts (the paper's count_v formula).

    its, cnts: (N, K) int32, -1 / 0 padded. Returns (lo, hi, count), each
    (N, K(K+1)/2) int32 in ``triu_indices(K)`` order; pairs with a padded
    side carry count 0.
    """
    K = its.shape[1]
    ii, jj = torch.triu_indices(K, K, device=its.device)
    it1, it2 = its[:, ii], its[:, jj]
    c1, c2 = cnts[:, ii], cnts[:, jj]
    cv = torch.where(ii == jj, torch.div(c1, 2, rounding_mode="floor"),
                     torch.minimum(c1, c2))
    cv = torch.where((it1 >= 0) & (it2 >= 0), cv, torch.zeros_like(cv))
    return torch.minimum(it1, it2), torch.maximum(it1, it2), cv


def digram_pairs_ref(row_ptr: torch.Tensor, its: torch.Tensor, cnts: torch.Tensor,
                     sign: torch.Tensor):
    """The signed pair values of a CSR of node histograms.

    For every row r (items ``row_ptr[r]:row_ptr[r+1]`` of its, cnts) and slot
    pair i <= j of it, in ``triu_indices`` order, the key ``min(it_i, it_j)
    << 32 | max(...)`` and the value ``sign[r] * (c_i // 2 if i == j else
    min(c_i, c_j))``, where that value is not 0. Returns (keys, values),
    int64.
    """
    dev = row_ptr.device
    lens = row_ptr[1:] - row_ptr[:-1]
    n_items = its.numel()
    ar = torch.arange(n_items, dtype=torch.int64, device=dev)
    item_row = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens,
                                       output_size=n_items)
    partners = row_ptr[1:][item_row] - ar  # slot i pairs with j = i .. K-1
    total = int(partners.sum())
    i = torch.repeat_interleave(ar, partners, output_size=total)
    j = i + torch.arange(total, dtype=torch.int64, device=dev) \
        - (torch.cumsum(partners, 0) - partners)[i]
    it1, it2 = its[i].to(torch.int64), its[j].to(torch.int64)
    c1, c2 = cnts[i].to(torch.int64), cnts[j].to(torch.int64)
    v = torch.where(i == j, torch.div(c1, 2, rounding_mode="floor"), torch.minimum(c1, c2))
    v = v * sign.to(torch.int64)[item_row[i]]
    keep = v != 0
    keys = (torch.minimum(it1, it2) << 32) | torch.maximum(it1, it2)
    return keys[keep], v[keep]


def digram_pair_accum_ref(table, row_ptr: torch.Tensor, its: torch.Tensor,
                          cnts: torch.Tensor, sign: torch.Tensor) -> None:
    """Add :func:`digram_pairs_ref` of the CSR to the sorted
    :class:`repro_torch.kernels.digram_count.DigramTable` `table`, in place:
    the twin of ``digram_pair_accum``. A key keeps its flag; a new key
    gets flag 0; a count that falls to 0 keeps its key."""
    if table.used is not None:
        raise ValueError("digram_pair_accum_ref takes a sorted DigramTable")
    keys, vals = digram_pairs_ref(row_ptr, its, cnts, sign)
    m = table.keys.numel()
    uk, inv = torch.unique(torch.cat([table.keys, keys]), return_inverse=True)
    table.counts = torch.zeros(uk.numel(), dtype=torch.int64, device=uk.device).index_add_(
        0, inv, torch.cat([table.counts, vals]))
    table.flags = torch.zeros(uk.numel(), dtype=torch.uint8, device=uk.device).index_copy_(
        0, inv[:m], table.flags)
    table.keys = uk


def digram_select_slot_ref(table) -> torch.Tensor:
    """(key, count, slot, used), int64, on the table's device: the twin of
    ``digram_select`` on a hashed or a sorted table (``used``: its
    entries). Among the slots with flag 0 and count > 0, the largest
    count, and among equal counts the smallest key; key and slot -1 and
    count 0 when there is none."""
    dev = table.keys.device
    used = table.used[0] if table.used is not None else \
        torch.full((), table.keys.numel(), dtype=torch.int64, device=dev)
    if table.keys.numel() == 0:
        return torch.stack([torch.full_like(used, -1), torch.zeros_like(used),
                            torch.full_like(used, -1), used])
    ok = (table.flags == 0) & (table.counts > 0)
    c = torch.where(ok, table.counts, 0)
    best = c.max()
    k = torch.where(ok & (c == best), table.keys, torch.iinfo(torch.int64).max)
    slot = torch.argmin(k)
    found = best > 0
    return torch.stack([torch.where(found, k[slot], -1), best,
                        torch.where(found, slot, -1), used])


def digram_select_ref(table) -> tuple[int, int] | None:
    """(key, count) that ``digram_select`` picks from `table`, or None."""
    key, count, _, _ = digram_select_slot_ref(table).tolist()
    return None if key < 0 else (key, count)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      combiner: str = "sum") -> torch.Tensor:
    """Sum or mean of the table rows of each bag.

    table: (V, D) float32 or bfloat16; indices: (B, L) int32 or int64, a
    negative index is padding. ``mean`` divides by max(#valid, 1). Rows are
    summed in float32 over l = 0..L-1 and the result is cast back to
    ``table.dtype``. Returns (B, D).
    """
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
    valid = indices >= 0
    rows = table[indices.clamp(min=0).to(torch.int64)].float()
    out = torch.zeros((indices.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for l in range(indices.shape[1]):  # the kernel's summation order
        out += torch.where(valid[:, l, None], rows[:, l], 0.0)
    if combiner == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp(min=1).float()
    return out.to(table.dtype)


def bag_runs(indices: torch.Tensor) -> tuple:
    """The sorted runs of a batch's ids, the preparation that the
    ``embedding_bag`` backward shares with its twin: (ids, perm, slot,
    n_unique), where ids are the flattened (B, L) indices sorted stably
    (padding first), perm their positions in the flattening, slot (int64)
    the running count of run heads less one (a valid run's head holds its
    slot among the distinct valid ids), and n_unique that count, a 0-dim
    int64 tensor. No host read."""
    ids, perm = torch.sort(indices.reshape(-1), stable=True)
    head = ids >= 0
    head[1:] &= ids[1:] != ids[:-1]
    slot = torch.cumsum(head, 0) - 1
    return ids, perm, slot, head.sum()


def embedding_bag_backward_ref(indices: torch.Tensor, grad_out: torch.Tensor,
                               combiner: str = "sum", n_rows: int | None = None) -> tuple:
    """The gradient of :func:`embedding_bag_ref` with respect to the table,
    by distinct row: (rows, grads, n_unique), rows (B * L,) int64 and grads
    (B * L, D) float32, whose first n_unique slots hold the distinct valid
    ids ascending and the float32 sums of ``grad_out[b]`` (divided by
    max(#valid_b, 1) for the mean, in float32) over their occurrences, added
    in the stable sorted order; the other slots hold -1 and zeros. An id >=
    ``n_rows`` raises ValueError."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
    n, d = indices.numel(), grad_out.shape[1]
    ids, perm, slot, n_unique = bag_runs(indices)
    valid = ids >= 0
    if n_rows is not None and bool((ids >= n_rows).any()):
        raise ValueError(f"an id lies outside [0, {n_rows})")
    bag = perm // max(indices.shape[1], 1)
    g = grad_out.float()[bag]
    if combiner == "mean":
        g = g / (indices >= 0).sum(dim=1).clamp(min=1).float()[bag, None]
    rows = torch.full((n,), -1, dtype=torch.int64, device=grad_out.device)
    rows[slot[valid]] = ids[valid].to(torch.int64)
    grads = torch.zeros((n, d), dtype=torch.float32, device=grad_out.device)
    grads.index_add_(0, slot[valid], g[valid])
    return rows, grads, n_unique


def bag_chunk_scan_ref(ids: torch.Tensor, chunk: int) -> tuple:
    """The one-pass ``embedding_bag`` backward's scan of run heads over
    chunks of ``chunk`` sorted positions, as the kernel computes it from the
    sorted ids alone: (heads, first_slot, run_chunk, n_unique), each (n_chunks,)
    int64 but the last, a 0-dim int64. heads: the run heads in each chunk (a
    valid id unlike the one before it); first_slot: the heads before the
    chunk, the slot of its first head (less one: the slot of a run that
    continues into it); run_chunk: the last chunk before it that holds a
    head (where a run that continues into it began), -1 for none; n_unique:
    the heads in all."""
    n = ids.numel()
    n_chunks = -(-n // chunk)
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]]) if n else ids
    head = (ids >= 0) & (ids != prev)
    heads = torch.zeros(n_chunks, dtype=torch.int64, device=ids.device)
    heads.index_add_(0, torch.arange(n, device=ids.device) // chunk, head.long())
    inc = torch.cumsum(heads, 0)
    has = torch.where(heads > 0, torch.arange(n_chunks, device=ids.device), -1)
    last = has.cummax(0).values if n_chunks else has
    run_chunk = torch.cat([last.new_full((1,), -1), last[:-1]]) if n_chunks else last
    return heads, inc - heads, run_chunk, inc[-1] if n_chunks else inc.new_zeros(())


def bag_chunk_slots_ref(ids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Each sorted position's slot from :func:`bag_chunk_scan_ref`, the way
    the one-pass kernel gives it: its chunk's first slot plus the heads of
    the chunk up to it, less one (``bag_runs``' slot)."""
    n = ids.numel()
    _, first_slot, _, _ = bag_chunk_scan_ref(ids, chunk)
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]]) if n else ids
    head = ((ids >= 0) & (ids != prev)).long()
    k = torch.arange(n, device=ids.device) // chunk
    within = torch.cumsum(head, 0) - (torch.cumsum(head, 0) - head)[k * chunk]
    return first_slot[k] + within - 1


def embedding_bag_backward_pieces_ref(indices: torch.Tensor, grad_out: torch.Tensor,
                                      combiner: str = "sum", chunk: int = 256) -> tuple:
    """The ``embedding_bag`` backward's sums in its kernels' order of
    additions, bit for bit: (rows, grads, n_unique, (part_first, part_last,
    last_slot, first_kind)). The sorted positions are cut into chunks of
    ``chunk``; each run's piece in a chunk is summed from zero in sorted
    order; a run inside one chunk goes to its slot, a run cut by chunk
    boundaries leaves its first piece in ``part_last`` of the chunk where it
    begins (``last_slot`` its slot) and each later piece in ``part_first``
    of its chunk (``first_kind`` 1 where the run ends in that chunk, 2 where
    it goes on). Slots of cut runs are left zero. All chunks at once, one
    step a position of a chunk."""
    n, d = indices.numel(), grad_out.shape[1]
    ids, perm, slot, n_unique = bag_runs(indices)
    bag = perm // max(indices.shape[1], 1)
    g = grad_out.float()[bag]
    if combiner == "mean":
        g = g / (indices >= 0).sum(dim=1).clamp(min=1).float()[bag, None]
    dev = grad_out.device
    valid = ids >= 0
    rows = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rows[slot[valid]] = ids[valid].to(torch.int64)
    grads = torch.zeros((n, d), dtype=torch.float32, device=dev)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    idp = torch.cat([ids.long(), ids.new_full((pad,), -1).long()]).view(n_chunks, chunk)
    gp = torch.cat([g, g.new_zeros((pad, d))]).view(n_chunks, chunk, d)
    sp = torch.cat([slot, slot.new_full((pad,), -1)]).view(n_chunks, chunk)
    c0 = torch.arange(n_chunks, device=dev) * chunk
    c1 = (c0 + chunk).clamp(max=n)
    first, last = ids[c0].long() if n else c0, ids[c1 - 1].long() if n else c0
    before = torch.where(c0 > 0, ids[(c0 - 1).clamp(min=0)].long() if n else c0, -1)
    after = torch.where(c1 < n, ids[c1.clamp(max=max(n - 1, 0))].long() if n else c0, -1)
    cont_in = (first >= 0) & (before == first)
    cont_out = (last >= 0) & (after == last)
    first_kind = torch.where(cont_in, torch.where(cont_out & (first == last), 2, 1), 0)
    part_first = torch.zeros((n_chunks, d), dtype=torch.float32, device=dev)
    part_last = torch.zeros((n_chunks, d), dtype=torch.float32, device=dev)
    last_slot = torch.full((n_chunks,), -1, dtype=torch.int64, device=dev)
    acc = torch.zeros((n_chunks, d), dtype=torch.float32, device=dev)
    in_first = torch.zeros(n_chunks, dtype=torch.bool, device=dev)  # the piece continues a run
    for t in range(chunk):
        v = idp[:, t] >= 0
        start = v & ((idp[:, t - 1] != idp[:, t]) if t else torch.ones_like(v))
        in_first = torch.where(start, cont_in & (t == 0), in_first)
        acc = torch.where(v[:, None], torch.where(start[:, None], 0.0, acc) + gp[:, t], acc)
        end = v & ((idp[:, t + 1] != idp[:, t]) if t + 1 < chunk else torch.ones_like(v))
        to_first = end & in_first
        to_last = end & ~in_first & (c0 + t == c1 - 1) & cont_out
        to_slot = end & ~in_first & ~to_last
        part_first[to_first] = acc[to_first]
        part_last[to_last] = acc[to_last]
        last_slot[to_last] = sp[to_last, t]
        grads[sp[to_slot, t]] = acc[to_slot]
    return rows, grads, n_unique, (part_first, part_last, last_slot, first_kind)


def embedding_bag_backward_combine_ref(part_first: torch.Tensor, part_last: torch.Tensor,
                                       last_slot: torch.Tensor, first_kind: torch.Tensor,
                                       grads: torch.Tensor) -> None:
    """The cut runs' sums of the ``embedding_bag`` backward, in place on
    ``grads``: a run cut by chunk boundaries, begun in chunk k, gets
    ``part_last[k]`` plus ``part_first[j]`` of each later chunk j it reaches,
    added in chunk order, one step a chunk for all runs at once (the same
    sums on any device). The two-pass route's combine kernel and the
    one-pass kernel add them in this order."""
    begun = torch.nonzero(last_slot >= 0).flatten()
    sums = part_last[begun].clone()
    j, going = begun + 1, torch.ones_like(begun, dtype=torch.bool)
    while bool(going.any()):
        at = torch.nonzero(going).flatten()
        sums[at] += part_first[j[at]]
        going[at] = first_kind[j[at]] == 2
        j += 1
    grads[last_slot[begun]] = sums


def embedding_bag_backward_split_ref(indices: torch.Tensor, grad_out: torch.Tensor,
                                     combiner: str = "sum", chunk: int = 256) -> tuple:
    """:func:`embedding_bag_backward_ref` in the kernels' order of additions,
    bit for bit on the CPU: the pieces, then their combine."""
    rows, grads, n_unique, pieces = embedding_bag_backward_pieces_ref(indices, grad_out,
                                                                      combiner, chunk)
    embedding_bag_backward_combine_ref(*pieces, grads)
    return rows, grads, n_unique


def sgd_rows_ref(master: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                 grads: torch.Tensor, n_unique: torch.Tensor, lr: torch.Tensor,
                 clip: torch.Tensor) -> None:
    """The table's SGD on the rows a batch touched, in place: for the first
    n_unique slots, ``master[rows] -= lr * (clip * grads)`` in float32 (the
    reference's SGD leaf, in its order of operations), then ``table[rows] =
    master[rows]`` in the table's type. Computed on the gradients' device;
    the master may lie on another."""
    n = int(n_unique)
    r = rows[:n]
    upd = lr * (grads[:n] * clip)
    m = master[r.to(master.device)].to(grads.device) - upd
    master[r.to(master.device)] = m.to(master.device)
    table[r.to(table.device)] = m.to(table.device, table.dtype)


def dot_interaction_ref(x: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction: x (B, F, D) float32 or bfloat16 -> the strictly
    lower triangle of x @ x^T per sample, (B, F(F-1)/2) float32 in
    ``tril_indices(F, -1)`` order. Inputs are upcast to float32 first."""
    f = x.shape[1]
    xf = x.float()
    z = torch.bmm(xf, xf.transpose(1, 2))
    ii, jj = torch.tril_indices(f, f, -1, device=x.device)
    return z[:, ii, jj]


def dot_interaction_backward_ref(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`dot_interaction_ref` with respect to x: dz (B,
    F(F-1)/2) float32 in ``tril_indices(F, -1)`` order -> (G + Gᵀ) x per
    sample, G (F, F) holding dz at those indices, in float32, rounded to
    x's dtype."""
    b, f, _ = x.shape
    ii, jj = torch.tril_indices(f, f, -1, device=x.device)
    g = torch.zeros((b, f, f), dtype=torch.float32, device=x.device)
    g[:, ii, jj] = dz.float()
    return torch.bmm(g + g.transpose(1, 2), x.float()).to(x.dtype)


def bf16_split(v: torch.Tensor) -> tuple:
    """float32 v as three bfloat16 terms, the tensor-core backward's split
    of S: hi = bf16_rn(v), mid = bf16_rn(v - hi), lo = bf16_rn(v - hi - mid),
    with hi + mid + lo == v exactly for every finite v whose lo is normal;
    where hi is not finite, mid = lo = 0."""
    v = v.float()
    hi = v.to(torch.bfloat16)
    h = hi.float()
    r = torch.where(torch.isfinite(h), v - h, torch.zeros_like(v))
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def dot_interaction_backward_tc_ref(x: torch.Tensor, dz: torch.Tensor,
                                    terms: int = 3) -> torch.Tensor:
    """The tensor-core backward's arithmetic, like
    :func:`dot_interaction_backward_ref`: S = G + Gᵀ padded with zeros to
    16-row tiles and split by :func:`bf16_split`; dX summed in float32 one
    16-wide k-step (16 fields) at a time, each term's product in turn (hi,
    mid, lo), and rounded once to x's dtype. `terms` = 2 drops lo (a
    control that a case where lo decides must catch)."""
    b, f, d = x.shape
    fp = -(-f // 16) * 16
    ii, jj = torch.tril_indices(f, f, -1, device=x.device)
    s = torch.zeros((b, fp, fp), dtype=torch.float32, device=x.device)
    s[:, ii, jj] = dz.float()
    s[:, jj, ii] = dz.float()
    parts = [t.float() for t in bf16_split(s)[:terms]]
    xp = torch.zeros((b, fp, d), dtype=torch.float32, device=x.device)
    xp[:, :f] = x.float()
    acc = torch.zeros((b, fp, d), dtype=torch.float32, device=x.device)
    for k0 in range(0, fp, 16):
        for t in parts:
            acc += torch.bmm(t[:, :, k0:k0 + 16], xp[:, k0:k0 + 16])
    return acc[:, :f].to(x.dtype)


def split_decisive_case(b: int, f: int, d: int, gen: torch.Generator) -> tuple:
    """Inputs (x bfloat16, dz float32) on which dX depends on the split's lo
    term alone: per sample, fields j1 and j2 share a row v of signed powers
    of two, field i is zero, and dz is zero but for a at (i, j1) and -(a +
    δ) at (i, j2), where a = hi + mid has lo = 0 and a + δ splits into the
    same hi and mid with lo = δ (|mid| under half of hi's last bit, |δ| of
    1-63 float32 steps of a, under half of mid's). So dX is zero but row i,
    -δ v, exact in float32, and a split that drops lo gives 0 there. Needs
    f >= 3."""
    rnd = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    ints = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=gen)  # noqa: E731
    x = torch.randn((b, f, d), generator=gen).to(torch.bfloat16)
    ijk = rnd(b, f).argsort(dim=1)[:, :3]
    i, j1, j2 = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    v = torch.where(rnd(b, d) < 0.5, -1.0, 1.0) * torch.exp2(ints(-2, 3, b, d).float())
    rows = torch.arange(b)
    x[rows, i] = 0
    x[rows, j1] = v.to(torch.bfloat16)
    x[rows, j2] = v.to(torch.bfloat16)
    e = ints(-6, 7, b).float()
    sign = torch.where(rnd(b) < 0.5, -1.0, 1.0)
    hi = sign * (1 + ints(0, 128, b).float() / 128) * torch.exp2(e)
    mid = sign * (1.25 + ints(0, 32, b).float() / 64) * torch.exp2(e - 9)
    a = hi + mid
    k = ints(1, 64, b).float() * torch.where(rnd(b) < 0.5, -1.0, 1.0)
    a_delta = a + k * torch.exp2(e - 23)
    pair = lambda p, q: torch.maximum(p, q) * (torch.maximum(p, q) - 1) // 2 \
        + torch.minimum(p, q)  # noqa: E731
    dz = torch.zeros((b, f * (f - 1) // 2), dtype=torch.float32)
    dz[rows, pair(i, j1)] = a
    dz[rows, pair(i, j2)] = -a_delta
    return x, dz


def _tc_fragment_rows_cols(f: int):
    """Row i and column j of Z = X Xᵀ that each accumulator entry of the
    tensor-core kernel holds, indexed (m-tile, n-tile, lane, register) over
    ceil(F / 16) m-tiles of 16 rows and twice as many n-tiles of 8 columns:
    the m16n8 accumulator layout, row 16 mt + lane // 4 + 8 (r // 2), column
    8 nt + 2 (lane % 4) + r % 2."""
    mts = -(-f // 16)
    mt, nt, lane, r = torch.meshgrid(torch.arange(mts), torch.arange(2 * mts),
                                     torch.arange(32), torch.arange(4), indexing="ij")
    i = 16 * mt + lane // 4 + 8 * (r // 2)
    j = 8 * nt + 2 * (lane % 4) + r % 2
    return i, j


def tc_store_map(f: int) -> torch.Tensor:
    """The tensor-core kernel's store map: for each (m-tile, n-tile, lane,
    register) of F's tiles, (ceil(F/16), 2 ceil(F/16), 32, 4) int64, the
    output column i(i-1)/2 + j its entry goes to, or -1 where it is thrown
    away (a pad row i >= F, or j >= i). Only tiles with 8 nt < min(16 mt +
    15, F - 1) are computed; every kept entry lies in one of them."""
    i, j = _tc_fragment_rows_cols(f)
    mt, nt = i // 16, j // 8
    computed = 8 * nt < torch.clamp(16 * mt + 15, max=f - 1)
    kept = computed & (j < i) & (i < f)
    return torch.where(kept, i * (i - 1) // 2 + j, -1)


def dot_interaction_tc_ref(x: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's arithmetic: x (B, F, D) float32 or bfloat16
    -> (B, F(F-1)/2) float32, like :func:`dot_interaction_ref`. F is padded
    with zero rows to 16-row tiles (the kernel's pad rows hold the next
    sample's rows; they reach only entries the map throws away) and D with
    zeros to 16-wide k-steps; Z is summed in float32 one k-step at a time,
    and each entry reaches its output column through :func:`tc_store_map`."""
    b, f, d = x.shape
    fp, dp = -(-f // 16) * 16, -(-d // 16) * 16
    xp = torch.zeros((b, fp, dp), dtype=torch.float32, device=x.device)
    xp[:, :f, :d] = x.float()
    z = torch.zeros((b, fp, fp), dtype=torch.float32, device=x.device)
    for k0 in range(0, dp, 16):
        xk = xp[:, :, k0:k0 + 16]
        z += torch.bmm(xk, xk.transpose(1, 2))
    cols = tc_store_map(f)
    i, j = _tc_fragment_rows_cols(f)
    kept = cols >= 0
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32, device=x.device)
    out[:, cols[kept].to(x.device)] = z[:, i[kept].to(x.device), j[kept].to(x.device)]
    return out


def csr_spmm_ref(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """CSR sparse-dense product: out[r] = sum over k in [row_ptr[r],
    row_ptr[r + 1]) of x[col[k]].

    x: (n_x, D) float32 or bfloat16; row_ptr: (n_out + 1,) int64; col:
    (nnz,) int32 or int64 in [0, n_x). The rows x[col] are gathered as
    float32 and summed into their output rows by ``index_add_``, then cast
    to x's dtype; a row with no entries is 0. Returns (n_out, D).
    """
    rows = torch.repeat_interleave(torch.arange(n_out, device=x.device),
                                   row_ptr[1:] - row_ptr[:-1], output_size=col.numel())
    out = torch.zeros((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, x[col.to(torch.int64)].float())
    return out.to(x.dtype)


def csr_spmm_segments_ref(row_ptr: torch.Tensor, chunk: int):
    """The split of the CSR kernel's plan, as segments in CSR order: a row of
    more than ``chunk`` edges is cut into segments of ``chunk`` edges (its
    last one shorter), any other row is one segment, empty or not. Returns
    (row, start, end), int64: segment s sums the edges [start[s], end[s])
    of row ``row[s]``."""
    lengths = row_ptr[1:] - row_ptr[:-1]
    per_row = torch.where(lengths > chunk, (lengths + chunk - 1) // chunk, 1)
    n = int(per_row.sum())
    row = torch.repeat_interleave(torch.arange(lengths.numel(), device=row_ptr.device), per_row,
                                  output_size=n)
    first = torch.cumsum(per_row, 0) - per_row  # each row's first segment
    start = row_ptr[row] + (torch.arange(n, device=row_ptr.device) - first[row]) * chunk
    return row, start, torch.minimum(start + chunk, row_ptr[row + 1])


def add2(s: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """One compensated float32 addition (Knuth's TwoSum): the new (s, c)
    of a sum s with error c, plus x; s + c is the sum rounded once, but for
    an error of about n * 2**-48 of the sum of |terms| after n additions."""
    t = s + x
    z = t - s
    return t, c + ((s - (t - z)) + (x - z))


def csr_spmm_partials_ref(x: torch.Tensor, col: torch.Tensor, start: torch.Tensor,
                          end: torch.Tensor) -> torch.Tensor:
    """The float32 sum of x[col[k]] over k in [start[s], end[s]) for each
    segment s, added in CSR order (one position of every segment at a time)
    from 0 by :func:`add2`, and rounded once (s + c). Returns (n_segments, D)
    float32."""
    acc = torch.zeros((start.numel(), x.shape[1]), dtype=torch.float32, device=x.device)
    err = torch.zeros_like(acc)
    lengths = end - start
    for p in range(int(lengths.max()) if lengths.numel() else 0):
        live = torch.nonzero(lengths > p).squeeze(1)
        acc[live], err[live] = add2(acc[live], err[live], x[col[start[live] + p].long()].float())
    return acc + err


def csr_spmm_combine_ref(partials: torch.Tensor, row: torch.Tensor, n_rows: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """Each row's segment partials (n_segments, D) float32 added in the
    order the segments come, from 0, by :func:`add2`, and rounded once to
    float32 (s + c), then to ``dtype``; a row with no segment is 0. Returns
    (n_rows, D)."""
    acc = torch.zeros((n_rows, partials.shape[1]), dtype=torch.float32, device=partials.device)
    err = torch.zeros_like(acc)
    order = torch.argsort(row, stable=True)
    by_row = row[order]
    rank = torch.arange(row.numel(), device=row.device) - torch.searchsorted(by_row, by_row)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = order[rank == r]  # at most one segment of each row
        acc[row[sel]], err[row[sel]] = add2(acc[row[sel]], err[row[sel]], partials[sel])
    return (acc + err).to(dtype)


def csr_spmm_split_ref(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor, n_out: int,
                       chunk: int) -> torch.Tensor:
    """:func:`csr_spmm_ref` summed as the CUDA kernel sums it, compensated
    (:func:`add2`): the segments of :func:`csr_spmm_segments_ref`, each
    summed by :func:`csr_spmm_partials_ref`, added row by row in segment
    order by :func:`csr_spmm_combine_ref`. Returns (n_out, D) in x's
    dtype."""
    row, start, end = csr_spmm_segments_ref(row_ptr, chunk)
    return csr_spmm_combine_ref(csr_spmm_partials_ref(x, col, start, end), row, n_out, x.dtype)


NEG_INF = -1e30  # the masked-score constant of the Pallas attention kernel


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None, sm_scale: float | None = None,
                        q_offset: int | None = None) -> torch.Tensor:
    """Attention with the flash kernel's numerics, scores materialised.

    q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), float32 or bfloat16; q head
    h reads kv head h // (Hq / Hkv). Query row i sits at position
    i + q_offset (default Sk - Sq, the Pallas kernel's right alignment);
    key j is visible when ``i + q_offset >= j`` (causal) and
    ``j > i + q_offset - window`` (window). Scores ``q.k * sm_scale``
    (default 1/sqrt(D)) are float32, soft-capped as ``softcap *
    tanh(s / softcap)``, masked to -1e30; p = exp(s - max) with masked p
    set to 0 is rounded to v's dtype before the PV product, which sums in
    float32. A row with no visible key is 0. Returns (B, Hq, Sq, D) in q's
    dtype.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(1.0 / (d ** 0.5))
    if q_offset is None:
        q_offset = sk - sq
    if sq == 0 or sk == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    qf = q.float().reshape(b, hkv, group, sq, d)
    s = torch.matmul(qf, k.float().unsqueeze(2).transpose(-1, -2)) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float().unsqueeze(2))
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.reshape(b, hq, sq, d).to(q.dtype)


def visible_range(sq: int, sk: int, q_offset: int, causal: bool,
                  window: int | None) -> tuple[int, int]:
    """Keys [lo, hi) that some of the Sq query rows at positions q_offset..
    can see, as the kernel computes them for a tile that holds every row;
    empty when hi <= lo."""
    lo, hi = 0, sk
    if causal:
        hi = min(hi, sq - 1 + q_offset + 1)
    if window:
        lo = max(lo, q_offset - window + 1)
    return lo, hi


def split_bounds(lo: int, hi: int, n_splits: int) -> list[tuple[int, int]]:
    """The kernel's splits of the keys [lo, hi): whole SPLIT_KEYS chunks,
    split s taking chunks [s * per, (s + 1) * per) with per =
    ceil(chunks / n_splits), the last cut at hi; a split past the last
    chunk is empty (its two bounds equal)."""
    chunks = -(-(hi - lo) // SPLIT_KEYS) if hi > lo else 0
    per = -(-chunks // n_splits)
    out = []
    for s in range(n_splits):
        a = lo + s * per * SPLIT_KEYS
        out.append((a, max(a, min(a + per * SPLIT_KEYS, hi))))
    return out


def flash_attention_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 n_splits: int, causal: bool = True, window: int | None = None,
                                 softcap: float | None = None, sm_scale: float | None = None,
                                 q_offset: int | None = None):
    """The split decode's first pass: float32 partials (m, l, acc) of each
    split, over the splits that :func:`split_bounds` cuts from the
    :func:`visible_range` (the kernel's arithmetic).

    Rows are the kernel's: r = i * group + g for query position i and head
    g of a kv head's group. m (S, B, Hkv, R) is a split's max scaled score
    (-1e30 where it sees no key), l (S, B, Hkv, R) the sum of p = exp(s -
    m), acc (S, B, Hkv, R, D) p rounded to v's dtype times v.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(1.0 / (d ** 0.5))
    if q_offset is None:
        q_offset = sk - sq
    qf = q.float().reshape(b, hkv, group, sq, d).transpose(2, 3).reshape(b, hkv, sq * group, d)
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = (torch.arange(sq, device=q.device) + q_offset).repeat_interleave(group)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq * group, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    vf = v.float()
    ms, ls, accs = [], [], []
    for lo, hi in split_bounds(*visible_range(sq, sk, q_offset, causal, window), n_splits):
        lo, hi = min(lo, sk), min(max(lo, hi), sk)  # the split's keys: [lo, hi)
        m_in = mask[:, lo:hi]
        s_in = torch.where(m_in, s[..., lo:hi], NEG_INF)
        m_s = s_in.amax(dim=-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF,
                                                             device=q.device)
        p = torch.where(m_in, torch.exp(s_in - m_s[..., None]), 0.0)
        ms.append(m_s)
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p.to(v.dtype).float(), vf[:, :, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def _merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> tuple:
    """(m*, l*, acc*) of partials stacked on dim 0: m* = max m_s, l* = sum
    l_s e^(m_s - m*), acc* = sum acc_s e^(m_s - m*); -1e30, 0, 0 for none."""
    if m.shape[0] == 0:
        return (torch.full(m.shape[1:], NEG_INF, device=m.device),
                torch.zeros(l.shape[1:], device=l.device),
                torch.zeros(acc.shape[1:], device=acc.device))
    m_all = m.amax(dim=0)
    w = torch.exp(m - m_all)
    return m_all, (l * w).sum(dim=0), (acc * w[..., None]).sum(dim=0)


def _merged_output(l_all: torch.Tensor, acc_all: torch.Tensor, group: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """o = acc* / l*, 0 where l* = 0, from (B, Hkv, rows) sums to (B, Hkv *
    group, Sq, D) in `dtype`."""
    b, hkv, rows, d = acc_all.shape
    o = acc_all / torch.where(l_all == 0.0, 1.0, l_all)[..., None]
    o = o.reshape(b, hkv, rows // group, group, d).transpose(2, 3)
    return o.reshape(b, hkv * group, rows // group, d).to(dtype)


def flash_attention_combine_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                                group: int, dtype: torch.dtype) -> torch.Tensor:
    """The merge of the split partials of
    :func:`flash_attention_partials_ref`: m* = max m_s, o = sum acc_s
    e^(m_s - m*) / sum l_s e^(m_s - m*), 0 where that sum is 0. Returns
    (B, Hkv * group, Sq, D) in `dtype`."""
    _, l_all, acc_all = _merge_partials(m, l, acc)
    return _merged_output(l_all, acc_all, group, dtype)


def merge_chunks(n_splits: int, chunks: int) -> list[tuple[int, int]]:
    """The merge kernel's chunks of a row's n_splits partials: chunk c takes
    splits [c * per, (c + 1) * per) with per = ceil(n_splits / chunks), the
    last cut at n_splits; a chunk past the last split is empty."""
    per = -(-n_splits // chunks)
    return [(min(c * per, n_splits), min((c + 1) * per, n_splits)) for c in range(chunks)]


def flash_attention_combine_chunked_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                                        group: int, dtype: torch.dtype,
                                        chunks: int) -> torch.Tensor:
    """:func:`flash_attention_combine_ref` in the merge kernel's two levels:
    each of :func:`merge_chunks`' chunks merged alone into (m_c, l_c,
    acc_c) (an empty chunk gives -1e30, 0, 0), then the chunks merged. Returns
    (B, Hkv * group, Sq, D) in `dtype`."""
    parts = [_merge_partials(m[a:e], l[a:e], acc[a:e])
             for a, e in merge_chunks(m.shape[0], chunks)]
    _, l_all, acc_all = _merge_partials(*(torch.stack(x) for x in zip(*parts)))
    return _merged_output(l_all, acc_all, group, dtype)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              n_splits: int, causal: bool = True, window: int | None = None,
                              softcap: float | None = None, sm_scale: float | None = None,
                              q_offset: int | None = None) -> torch.Tensor:
    """:func:`flash_attention_ref` computed as the split decode computes it:
    the partials of :func:`flash_attention_partials_ref` merged by
    :func:`flash_attention_combine_ref`. Returns (B, Hq, Sq, D) in q's
    dtype."""
    kw = dict(causal=causal, window=window, softcap=softcap, sm_scale=sm_scale,
              q_offset=q_offset)
    m, l, acc = flash_attention_partials_ref(q, k, v, n_splits=n_splits, **kw)
    return flash_attention_combine_ref(m, l, acc, q.shape[1] // k.shape[1], q.dtype)


def _attention_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int | None,
                      softcap: float | None, sm_scale: float, q_offset: int) -> tuple:
    """(s, mask): the float32 scores (B, Hkv, group, Sq, Sk) after scale and
    soft-cap, and the (Sq, Sk) visibility, as :func:`flash_attention_ref`
    forms them."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.matmul(qf, k.float().unsqueeze(2).transpose(-1, -2)) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return s, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            softcap: float | None = None, sm_scale: float | None = None,
                            q_offset: int | None = None) -> tuple:
    """:func:`flash_attention_ref` and its log-sum-exp rows: (out (B, Hq,
    Sq, D) in q's dtype, lse (B, Hq, Sq) float32). lse = m + log(l) over the
    visible scores in the kernel's units (after sm_scale and the soft-cap),
    +inf for a row that sees no key, so that exp(s - lse) is that row's
    normalised probability (0 for the empty row)."""
    b, hq, sq, d = q.shape
    sm_scale = float(1.0 / (d ** 0.5)) if sm_scale is None else sm_scale
    q_offset = k.shape[2] - sq if q_offset is None else q_offset
    out = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                              sm_scale=sm_scale, q_offset=q_offset)
    if sq == 0 or k.shape[2] == 0:
        return out, torch.full((b, hq, sq), float("inf"), device=q.device)
    s, mask = _attention_scores(q, k, causal=causal, window=window, softcap=softcap,
                                sm_scale=sm_scale, q_offset=q_offset)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    l = torch.where(mask, torch.exp(s - m[..., None]), 0.0).sum(dim=-1)
    lse = torch.where(l > 0, m + torch.log(l), float("inf"))
    return out, lse.reshape(b, hq, sq)


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                                 causal: bool = True, window: int | None = None,
                                 softcap: float | None = None, sm_scale: float | None = None,
                                 q_offset: int | None = None, round_p: bool = True,
                                 round_ds: bool = True) -> tuple:
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at ``dout``,
    as the backward kernels compute them, scores materialised.

    ``out`` and ``lse`` are the forward's (:func:`flash_attention_lse_ref`).
    Every product sums in float32 over inputs read exactly as float32:

    - s = q.k * sm_scale, soft-capped (s_c = softcap * tanh(s / softcap));
    - p = exp(s_c - lse) where visible, else 0;
    - dv = sum over the query heads of a kv head of p^T dout, p rounded to
      v's dtype first (the forward's rounding point; ``round_p=False``
      keeps it float32, the witness of that rounding);
    - dp = dout v^T; delta = rowsum(dout * out), out as stored;
    - ds = p (dp - delta), times 1 - (s_c / softcap)^2 under a soft-cap,
      then rounded to q's dtype (the bf16 kernels' A operand of both its
      products; nothing for float32; ``round_ds=False`` keeps it float32,
      the witness of that rounding);
    - dk = sm_scale * sum over the group of ds^T q; dq = sm_scale * ds k.

    Each is rounded once to its input's dtype. Returns (dq (B, Hq, Sq, D),
    dk, dv (B, Hkv, Sk, D))."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sq == 0 or sk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    p, do, ds, _, sm_scale = _backward_ds(q, k, v, out, lse, dout, causal=causal, window=window,
                                          softcap=softcap, sm_scale=sm_scale,
                                          q_offset=q_offset, round_ds=round_ds)
    pr = p.to(v.dtype).float() if round_p else p
    dv = torch.matmul(pr.transpose(-1, -2), do).sum(dim=2)
    dk = torch.matmul(ds.transpose(-1, -2), q.float().reshape(b, hkv, hq // hkv, sq, d)).sum(dim=2)
    return _dq_of(ds, k, q, sm_scale), (dk * sm_scale).to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                               causal: bool = True, window: int | None = None,
                               softcap: float | None = None, sm_scale: float | None = None,
                               q_offset: int | None = None) -> tuple:
    """What the launch ``flash_attention_bwd_dq`` computes when it forms delta
    itself: (dq, delta), dq as :func:`flash_attention_backward_ref` gives it
    (the same arithmetic) and delta = rowsum(dout * out), float32 (B, Hq,
    Sq), out as stored (0 for a row that sees no key)."""
    b, hq, sq, d = q.shape
    if sq == 0 or k.shape[2] == 0:
        return torch.zeros_like(q), (dout.float() * out.float()).sum(dim=-1)
    _, _, ds, delta, sm_scale = _backward_ds(q, k, v, out, lse, dout, causal=causal,
                                             window=window, softcap=softcap, sm_scale=sm_scale,
                                             q_offset=q_offset, round_ds=True)
    return _dq_of(ds, k, q, sm_scale), delta.reshape(b, hq, sq)


def _backward_ds(q, k, v, out, lse, dout, *, causal, window, softcap, sm_scale, q_offset,
                 round_ds) -> tuple:
    """(p, dout, ds, delta, sm_scale) of :func:`flash_attention_backward_ref`,
    float32, by (B, Hkv, group, Sq, ...)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    sm_scale = float(1.0 / (d ** 0.5)) if sm_scale is None else sm_scale
    q_offset = sk - sq if q_offset is None else q_offset
    s, mask = _attention_scores(q, k, causal=causal, window=window, softcap=softcap,
                                sm_scale=sm_scale, q_offset=q_offset)
    lse5 = lse.float().reshape(b, hkv, group, sq, 1)
    p = torch.where(mask, torch.exp(torch.where(mask, s, 0.0) - lse5), 0.0)
    do = dout.float().reshape(b, hkv, group, sq, d)
    dp = torch.matmul(do, v.float().unsqueeze(2).transpose(-1, -2))
    delta = (do * out.float().reshape(b, hkv, group, sq, d)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap).square())
    if round_ds:
        ds = ds.to(q.dtype).float()
    return p, do, ds, delta, sm_scale


def _dq_of(ds: torch.Tensor, k: torch.Tensor, q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """dq = sm_scale * ds k, rounded once to q's dtype, (B, Hq, Sq, D)."""
    dq = torch.matmul(ds, k.float().unsqueeze(2))
    return (dq * sm_scale).reshape(q.shape).to(q.dtype)
