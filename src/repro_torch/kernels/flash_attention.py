"""Wrapper of the CUDA kernels ``csrc/flash_attention.cu``: blocked
online-softmax attention with grouped-query heads.

It replaces the Pallas kernel ``flash_attention`` of the JAX package (a TPU
kernel) and is every attention of the LM serving path
(:mod:`repro_torch.models.transformer`): one call per layer per forward,
prefill and decode. Its plain twin is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

Beyond the Pallas kernel it takes ``q_offset`` (query row i sits at
position i + q_offset; the Pallas kernel fixes Sk - Sq), any Sq and Sk (no
block multiple), and tensors addressed through their strides, so the
model's (B, S, H, D) activations and its (B, Smax, Hkv, D) cache go in as
(B, H, S, D) views without a copy. The output is (B, Hq, Sq, D) with
(B, Sq, Hq, D) memory, which the model reshapes to (B, Sq, Hq * D) for free.

A call is one launch of the attention kernel: bfloat16 runs on the tensor
cores, float32 on float32 FMAs. At decode (at most ``SPLIT_MAX_ROWS`` rows
of a (batch, kv head): Sq times the GQA group) the visible keys are split
over ``n_splits`` blocks a (batch, kv head), planned by
:func:`plan_splits`; each block writes float32 partials, and a second
launch, ``flash_attention_combine`` (:func:`flash_attention_combine_cuda`),
merges them: a block a chunk of a row's splits, the chunks planned by
:func:`plan_merge` and merged by the row's last block (known by tickets kept
for the device and stream) through a scratch. The first merge, a block a row, stays off the
path (:func:`flash_attention_combine_rowwise_cuda`). The split arithmetic,
:func:`visible_range`, :func:`split_bounds` and :func:`merge_chunks`, lives
beside the twin in :mod:`repro_torch.kernels.ref`.

Training: ``flash_attention_cuda(..., lse=True)`` also returns each row's
log-sum-exp (one split), and :func:`flash_attention_backward_cuda` is the
backward, which the Pallas kernel lacks: two launches,
``flash_attention_bwd_dq`` (which also forms delta = rowsum(dO * O) and
writes it) and then ``flash_attention_bwd_dkdv`` (which reads it);
bfloat16 runs both on the tensor cores (dS rounded to bfloat16 for its two
products, as p is for dV), float32 on float32 FMAs. Its twin is
:func:`repro_torch.kernels.ref.flash_attention_backward_ref`; the dq
launch's alone (dq and delta) is
:func:`repro_torch.kernels.ref.flash_attention_bwd_dq_ref`. The standalone
delta launch ``flash_attention_bwd_delta`` stays in the source, off the
path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SPLIT_KEYS, visible_range

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
SPLIT_MAX_ROWS = 8       # rows of a (batch, kv head) up to which decode splits
SPLIT_BLOCKS_PER_SM = 8  # the planner's aim: about this many decode blocks per SM
# the merge kernel's (csrc/flash_attention.cu): threads a block at most, float4
# loads in flight a thread, splits or chunks one block weighs
MERGE_THREADS, MERGE_LOADS, MERGE_MAX_SPLITS = 256, 4, 1024
# the merge plan's: rounds of loads up to which a row stays one block (the
# second level costs about as much; chip_smoke.py times the plan against
# others at long_500k), and the blocks an SM it aims at when it splits
MERGE_ONE_LEVEL_ROUNDS, MERGE_BLOCKS_PER_SM = 8, 2
_sm_counts: dict[int, int] = {}
_merge_tickets: dict[tuple, torch.Tensor] = {}  # (device index, stream) -> the merge's tickets


def plan_splits(pairs: int, rows: int, lo: int, hi: int, n_sm: int = 132) -> int:
    """Splits of the visible keys [lo, hi) for `pairs` (batch, kv head)
    pairs of `rows` rows each: 1 above SPLIT_MAX_ROWS rows (prefill) or for
    fewer than two chunks of keys, else enough for about
    SPLIT_BLOCKS_PER_SM blocks on each of `n_sm` SMs, at most one a chunk,
    and never an empty split."""
    chunks = -(-(hi - lo) // SPLIT_KEYS) if hi > lo else 0
    if rows > SPLIT_MAX_ROWS or chunks < 2:
        return 1
    want = min(chunks, -(-SPLIT_BLOCKS_PER_SM * n_sm // max(pairs, 1)))
    if want < 2:
        return 1
    per = -(-chunks // want)
    return -(-chunks // per)


def planned_splits(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                   window: int | None = None, q_offset: int | None = None,
                   n_splits: int | None = None, n_sm: int | None = None, **_) -> int:
    """The split count :func:`flash_attention_cuda` uses for a call with
    these arguments: ``n_splits`` where given, else :func:`plan_splits` over
    the call's visible keys for ``n_sm`` SMs (None: q's device's). Its
    other keywords (``softcap``, ``sm_scale``) do not change the plan."""
    if n_splits is not None:
        return n_splits
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    off = sk - sq if q_offset is None else q_offset
    return plan_splits(b * hkv, sq * (hq // hkv), *visible_range(sq, sk, off, causal, window),
                       n_sm=_sm_count(q.device) if n_sm is None else n_sm)


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None, sm_scale: float | None = None,
                         q_offset: int | None = None,
                         n_splits: int | None = None, lse: bool = False):
    """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), one dtype (float32 or
    bfloat16) on one CUDA device, D contiguous and a multiple of 8 up to
    256, rows 16-byte aligned; Hq a multiple of Hkv. ``window`` >= 1 or
    None, ``softcap`` > 0 or None. ``n_splits``: the decode's split count,
    None to plan it (:func:`plan_splits`), above 1 only at decode. Returns
    (B, Hq, Sq, D) in q's dtype; see
    :func:`repro_torch.kernels.ref.flash_attention_ref` for the function.
    With ``lse`` it returns (out, lse), lse (B, Hq, Sq) float32 as
    :func:`repro_torch.kernels.ref.flash_attention_lse_ref` defines it, from
    one launch of one split (``n_splits`` must then be None or 1). Sq == 0
    launches nothing."""
    if n_splits is not None and (not isinstance(n_splits, int) or isinstance(n_splits, bool)
                                 or n_splits < 1):
        raise ValueError(f"n_splits must be an int >= 1 or None, not {n_splits!r}")
    if lse and n_splits not in (None, 1):
        raise ValueError(f"lse comes from one split, not {n_splits}")
    _check_shapes(q, k, v, window, softcap)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    rows = sq * (hq // hkv)
    if n_splits is not None and n_splits > 1 and rows > SPLIT_MAX_ROWS:
        raise ValueError(f"n_splits > 1 needs at most {SPLIT_MAX_ROWS} rows of a (batch, kv "
                         f"head) (decode), not {rows}")
    _check_memory(q, k, v)
    dev = q.device
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    lse_t = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if lse else None
    if out.numel() == 0:
        return (out, lse_t) if lse else out
    if sm_scale is None:
        sm_scale = float(1.0 / (d ** 0.5))
    off = sk - sq if q_offset is None else q_offset
    n_splits = 1 if lse else planned_splits(q, k, causal=causal, window=window, q_offset=off,
                                            n_splits=n_splits)
    part = None
    if n_splits > 1:
        part = torch.empty(partials_size(n_splits, b, hkv, rows, d), dtype=torch.float32,
                           device=dev)
    _build.launch("flash_attention", "flash_attention", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), 0 if part is None else part.data_ptr(),
                  0 if lse_t is None else lse_t.data_ptr(), b, hq, hkv, sq, sk, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  int(causal), window or 0, off, n_splits, softcap or 0.0, sm_scale,
                  _DTYPES[q.dtype])
    if part is not None:  # partials made here to fit: merge without checking them again
        _launch_combine(part, out, hkv, n_splits)
    return (out, lse_t) if lse else out


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window,
                  softcap) -> None:
    """Raise on shapes and types the kernels do not take: q (B, Hq, Sq,
    D), k and v (B, Hkv, Sk, D) of one dtype, float32 or bfloat16, D a
    multiple of 8 up to 256, Hq a multiple of Hkv."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda takes q, k, v of one dtype, float32 or "
                        f"bfloat16, not {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, not {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, not {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, not {softcap}")


def _check_memory(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, more: tuple = ()) -> None:
    """Raise unless q, k, v and ``more`` (name, tensor) pairs, each shaped
    like q or k in q's dtype, lie on one CUDA device with D contiguous and
    16-byte aligned rows."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v), *more):
        if x.device != dev or x.dtype != q.dtype or x.shape not in (q.shape, k.shape):
            raise ValueError(f"{name} must be shaped like q or k, {q.dtype} on {dev}")
        if x.numel() and (x.stride(3) != 1 or x.data_ptr() % 16
                          or any(s % vec for s in x.stride()[:3])):
            raise ValueError(f"flash_attention_cuda needs {name} with D contiguous and "
                             "16-byte aligned rows")


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                                  causal: bool = True, window: int | None = None,
                                  softcap: float | None = None, sm_scale: float | None = None,
                                  q_offset: int | None = None) -> tuple:
    """The gradients (dq, dk, dv) of :func:`flash_attention_cuda` at
    ``dout``, from its ``out`` and ``lse`` (``lse=True``): two launches on
    the current stream, dq with delta = rowsum(dout * out) (written to a
    float32 buffer), then dk and dv from that delta, on the tensor cores
    for bfloat16 and on float32 FMAs for float32 (a refused launch raises;
    neither route stands in for the other); see
    :func:`repro_torch.kernels.ref.flash_attention_backward_ref` for the
    function. q, k, v as the forward took them; out and dout shaped like q,
    D contiguous, 16-byte aligned rows; lse (B, Hq, Sq) float32
    contiguous. dq has q's layout ((B, Sq, Hq, D) memory), dk and dv k's
    ((B, Sk, Hkv, D) memory). Sq == 0 or Sk == 0 launches nothing and
    returns zeros."""
    _check_shapes(q, k, v, window, softcap)
    _check_memory(q, k, v, (("out", out), ("dout", dout)))
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be shaped like q {tuple(q.shape)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 ({b}, {hq}, {sq}) contiguous on q's device")
    dev = q.device
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((b, sk, hkv, d), dtype=v.dtype, device=dev).transpose(1, 2)
    if sq == 0 or sk == 0 or b == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if sm_scale is None:
        sm_scale = float(1.0 / (d ** 0.5))
    off = sk - sq if q_offset is None else q_offset
    dt = _DTYPES[q.dtype]
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *out.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
            *dv.stride()[:3], int(causal), window or 0, off, softcap or 0.0, sm_scale, dt)
    _build.launch("flash_attention", "flash_attention_bwd_dq", dev, *args)  # writes delta
    _build.launch("flash_attention", "flash_attention_bwd_dkdv", dev, *args)
    return dq, dk, dv


def partials_size(n_splits: int, b: int, hkv: int, rows: int, d: int) -> int:
    """Float32 values of the split partials, one flat buffer: acc (S, B,
    Hkv, rows, D), then m and l, (S, B, Hkv, rows) each."""
    return n_splits * b * hkv * rows * (d + 2)


def pack_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Split partials m, l (S, B, Hkv, rows) and acc (S, B, Hkv, rows, D)
    packed flat as the first pass writes them for the merge (the layout of
    :func:`partials_size`), float32."""
    return torch.cat([acc.flatten(), m.flatten(), l.flatten()]).float()


def plan_merge(rows: int, n_splits: int, d: int, n_sm: int = 132) -> int:
    """Chunks C of each of `rows` rows' n_splits partials (width d) for the
    merge kernel, a block a (row, chunk). C = 1 where one block reads a row
    in at most MERGE_ONE_LEVEL_ROUNDS rounds of MERGE_LOADS loads a thread
    (the second level costs about that much); else as many chunks as let a
    block read its share in one round, but no more than give
    MERGE_BLOCKS_PER_SM blocks on each of `n_sm` SMs, so C = 1 where the
    rows alone fill the card. At least enough that no block weighs more
    than MERGE_MAX_SPLITS; never an empty chunk."""
    rounds = -(-n_splits // (MERGE_THREADS // (d // 4) * MERGE_LOADS))
    c = 1
    if rounds > MERGE_ONE_LEVEL_ROUNDS:
        c = min(rounds, -(-MERGE_BLOCKS_PER_SM * n_sm // max(rows, 1)))
    c = max(c, -(-n_splits // MERGE_MAX_SPLITS))
    per = -(-n_splits // c)
    return -(-n_splits // per)


def merge_scratch_size(rows: int, chunks: int, d: int) -> int:
    """Float32 values of the merge's scratch for `rows` rows in `chunks`
    chunks: acc_c (rows, chunks, d), then m_c and l_c; none for one chunk."""
    return rows * chunks * (d + 2) if chunks > 1 else 0


def _check_combine(part: torch.Tensor, out: torch.Tensor, hkv: int, n_splits: int) -> None:
    b, hq, sq, d = out.shape
    if out.dtype not in _DTYPES or part.dtype != torch.float32:
        raise TypeError(f"combine takes float32 partials and a float32 or bfloat16 output, "
                        f"not {part.dtype}, {out.dtype}")
    if hkv < 1 or hq % hkv or n_splits < 2 or out.stride(3) != 1 or d % 8 \
            or not 0 < d <= MAX_HEAD_DIM \
            or part.numel() != partials_size(n_splits, b, hkv, sq * (hq // hkv), d):
        raise ValueError(f"partials of {part.numel()} values do not fit out {tuple(out.shape)}, "
                         f"{hkv} kv heads, {n_splits} splits")
    if n_splits > MERGE_MAX_SPLITS ** 2:
        raise ValueError(f"the merge takes at most {MERGE_MAX_SPLITS ** 2} splits, not {n_splits}")
    if out.device.type != "cuda" or part.device != out.device or not part.is_contiguous() \
            or part.data_ptr() % 16:
        raise ValueError("combine needs contiguous 16-byte aligned partials and out on one "
                         "CUDA device")


def flash_attention_combine_cuda(part: torch.Tensor, out: torch.Tensor, hkv: int,
                                 n_splits: int, *, chunks: int | None = None) -> torch.Tensor:
    """Merge the float32 split partials ``part`` (the flat layout of
    :func:`partials_size`) of out's (batch, kv head) pairs into ``out``
    (B, Hq, Sq, D), float32 or bfloat16, D contiguous, in place; see
    :func:`repro_torch.kernels.ref.flash_attention_combine_ref`. One launch
    of the merge kernel over ``chunks`` chunks of each row's splits (None:
    :func:`plan_merge`'s); its two levels are
    :func:`repro_torch.kernels.ref.flash_attention_combine_chunked_ref`."""
    if chunks is not None and (not isinstance(chunks, int) or isinstance(chunks, bool)
                               or not 1 <= chunks <= min(n_splits, MERGE_MAX_SPLITS)
                               or -(-n_splits // chunks) > MERGE_MAX_SPLITS):
        raise ValueError(f"chunks must be an int in 1..{n_splits} of at most "
                         f"{MERGE_MAX_SPLITS} splits each, or None, not {chunks!r}")
    _check_combine(part, out, hkv, n_splits)
    if out.numel():
        _launch_combine(part, out, hkv, n_splits, chunks)
    return out


def flash_attention_combine_rowwise_cuda(part: torch.Tensor, out: torch.Tensor, hkv: int,
                                         n_splits: int) -> torch.Tensor:
    """:func:`flash_attention_combine_cuda` by the first merge kernel (a
    block a row, each thread walking every split for its columns), off the
    path: kept to be timed beside the merge that took its place."""
    _check_combine(part, out, hkv, n_splits)
    if out.numel():
        b, hq, sq, d = out.shape
        _build.launch("flash_attention", "flash_attention_combine_rowwise", out.device,
                      part.data_ptr(), out.data_ptr(), b, hq, hkv, sq, d, n_splits,
                      *out.stride()[:3], _DTYPES[out.dtype])
    return out


def _tickets(dev: torch.device, rows: int) -> torch.Tensor:
    """The merge's tickets, one a row, on dev's current stream: kept for the
    device and stream (launches on one stream are ordered, so they can
    share them; another stream gets its own), zeroed when made, as each
    launch leaves them. The scratch is not kept: a call takes it from the
    stream-ordered allocator, so no cached segment stays pinned by it."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    got = _merge_tickets.get(key)
    if got is None or got.numel() < rows:
        got = _merge_tickets[key] = torch.zeros(rows, dtype=torch.int32, device=dev)
    return got


def _launch_combine(part: torch.Tensor, out: torch.Tensor, hkv: int, n_splits: int,
                    chunks: int | None = None) -> None:
    b, hq, sq, d = out.shape
    rows = b * hq * sq
    dev = out.device
    if chunks is None:
        chunks = plan_merge(rows, n_splits, d, _sm_count(dev))
    scratch = tickets = None
    if chunks > 1:
        scratch = torch.empty(merge_scratch_size(rows, chunks, d), dtype=torch.float32,
                              device=dev)
        tickets = _tickets(dev, rows)
    _build.launch("flash_attention", "flash_attention_combine", dev, part.data_ptr(),
                  out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                  0 if tickets is None else tickets.data_ptr(), b, hq, hkv, sq, d, n_splits,
                  chunks, *out.stride()[:3], _DTYPES[out.dtype])
