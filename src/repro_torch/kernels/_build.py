"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into ``build/repro_torch/<name>.<hash>.so`` at the root of the checkout
(the hash is the source's, so an edited kernel never loads a stale
library), and is loaded with ``ctypes``. The sources have a plain C
interface and include no PyTorch header, so a build takes seconds.
:func:`build_all` starts one ``nvcc`` per source, all at once;
:func:`launch` calls an entry point on the current stream and counts the
launch in :data:`launch_counts` (under a lock: kernels launch from
several threads at once, as the sharded tier's scatter pool does).

A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

CUDA_ROOTS = ("/usr/local/cuda",)  # where nvcc is looked for off the PATH

_P, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# source name -> {kernel name: (C entry point, its argument types; the last
# is the stream)}; each kernel name is a key of launch_counts
SOURCES = {
    "bitvec_rank": {
        "bitvec_rank": ("bitvec_rank_launch", [_P, _P, _P, _P, _I64, _P]),
        # words, ranks, word_off, nbits, fixed, counts; q, k, h, axis,
        # limit_fixed, limit_free, stack entries a warp
        "k2_lines_count": ("k2_lines_count_launch", [_P] * 6 + [_I64] * 7 + [_P]),
        # words, ranks, word_off, nbits, fixed, starts, out_idx, out_coord; the same
        "k2_lines_write": ("k2_lines_write_launch", [_P] * 8 + [_I64] * 7 + [_P]),
    },
    "digram_count": {
        "digram_pair_counts": ("digram_pair_counts_launch", [_P] * 5 + [_I64] * 2 + [_P]),
        # keys, counts, used; capacity; row_ptr, its, cnts, sign; n_rows
        "digram_pair_accum": ("digram_pair_accum_launch", [_P] * 3 + [_I64] + [_P] * 4
                              + [_I64, _P]),
        # keys, counts, flags, used, scratch, out; capacity
        "digram_select": ("digram_select_launch", [_P] * 6 + [_I64, _P]),
    },
    "embedding_bag": {
        "embedding_bag": ("embedding_bag_launch",
                          [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P]),
        # ids, perm, grad, denom, rows, grads, part, work; n, n_rows, L, D,
        # dtype, idx64, chunk, rows a stage
        "embedding_bag_backward": ("embedding_bag_backward_launch",
                                   [_P] * 8 + [_I64] * 8 + [_P]),
        # the two-pass kernel, kept to be timed beside it: ids, perm, slot,
        # grad, denom, rows, grads, part_first, part_last, last_slot,
        # first_kind; n, n_rows, L, D, dtype, idx64
        "embedding_bag_backward_two_pass": ("embedding_bag_backward_two_pass_launch",
                                            [_P] * 11 + [_I64] * 6 + [_P]),
        # part_first, part_last, last_slot, first_kind, grads; n_chunks, D
        "embedding_bag_backward_combine": ("embedding_bag_backward_combine_launch",
                                           [_P] * 5 + [_I64] * 2 + [_P]),
        # master, table, rows, grads, n_unique, lr, clip; cap, n_rows, D, dtype,
        # rows a warp, blocks, mode
        "sgd_rows": ("sgd_rows_launch", [_P] * 7 + [_I64] * 7 + [_P]),
    },
    # x, out; B, F, D, dtype, spg, stages, grid: one entry point, counted
    # under the path the wrapper asked for (spg > 0: tensor cores)
    "dot_interaction": {
        "dot_interaction": ("dot_interaction_launch", [_P, _P] + [_I64] * 7 + [_P]),
        "dot_interaction_simt": ("dot_interaction_launch", [_P, _P] + [_I64] * 7 + [_P]),
        # x, dz, dx; B, F, D, dtype, spg, stages, grid: the same, spg > 0 for
        # the tensor cores
        "dot_interaction_backward": ("dot_interaction_backward_launch",
                                     [_P] * 3 + [_I64] * 7 + [_P]),
        "dot_interaction_backward_simt": ("dot_interaction_backward_launch",
                                          [_P] * 3 + [_I64] * 7 + [_P]),
    },
    "flash_attention": {
        # q, k, v, o, part, lse; B, Hq, Hkv, Sq, Sk, D; 12 strides; causal,
        # window, q_offset, n_splits; softcap, sm_scale; dtype
        "flash_attention": ("flash_attention_launch",
                            [_P] * 6 + [_I64] * 6 + [_I64] * 12 + [_I64] * 4 + [_F32] * 2
                            + [_I64, _P]),
        # o, dout, delta; B, Hq, Sq, D; 6 strides; dtype (off the path)
        "flash_attention_bwd_delta": ("flash_attention_bwd_delta_launch",
                                      [_P] * 3 + [_I64] * 4 + [_I64] * 6 + [_I64, _P]),
        # q, k, v, dout, o, lse, delta, dq, dk, dv; B, Hq, Hkv, Sq, Sk, D; 24
        # strides; causal, window, q_offset; softcap, sm_scale; dtype
        "flash_attention_bwd_dkdv": ("flash_attention_bwd_dkdv_launch",
                                     [_P] * 10 + [_I64] * 6 + [_I64] * 24 + [_I64] * 3
                                     + [_F32] * 2 + [_I64, _P]),
        "flash_attention_bwd_dq": ("flash_attention_bwd_dq_launch",
                                   [_P] * 10 + [_I64] * 6 + [_I64] * 24 + [_I64] * 3
                                   + [_F32] * 2 + [_I64, _P]),
        # part, o, scratch, tickets; B, Hq, Hkv, Sq, D, n_splits, chunks; 3
        # strides of o; dtype
        "flash_attention_combine": ("flash_attention_combine_launch",
                                    [_P] * 4 + [_I64] * 7 + [_I64] * 3 + [_I64, _P]),
        # part, o; B, Hq, Hkv, Sq, D, n_splits; 3 strides of o; dtype (the
        # first merge, a block a row, off the path)
        "flash_attention_combine_rowwise": ("flash_attention_combine_rowwise_launch",
                                            [_P] * 2 + [_I64] * 6 + [_I64] * 3 + [_I64, _P]),
    },
    "segment_matmul": {
        # x, row_ptr, col, out, part, chunk_start, chunk_end, short_rows;
        # n_chunks, n_items, n_x, D, dtype
        "csr_spmm": ("csr_spmm_launch", [_P] * 8 + [_I64] * 5 + [_P]),
        # part, long_rows, chunk_ptr, out; n_long, D, dtype
        "csr_spmm_combine": ("csr_spmm_combine_launch", [_P] * 4 + [_I64] * 3 + [_P]),
    },
}

# kernel name -> launches so far; each wrapper adds one where it launches,
# through count_launch
launch_counts: dict[str, int] = {k: 0 for entries in SOURCES.values() for k in entries}
_count_lock = threading.Lock()  # `+= 1` on a dict entry is not atomic across threads

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict = {}  # kernel name -> its ctypes entry point, typed


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def count_launch(kernel: str) -> None:
    """Add one launch of `kernel` to :data:`launch_counts`."""
    with _count_lock:
        launch_counts[kernel] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}.{digest}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every source that is not built yet, in parallel, and load
    them all; returns the seconds it took."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    for name, s in started.items():
        _finish(name, s)
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(_target(name)))
    for kernel, (symbol, argtypes) in SOURCES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[kernel] = fn
    _libs[name] = lib
    return lib


def launch(source: str, kernel: str, device: torch.device, *args) -> None:
    """Call the C entry point of `kernel` in ``csrc/<source>.cu`` with `args`
    and the current stream of `device`; raise if the launch failed, else
    count it."""
    fn = _entries.get(kernel)
    if fn is None:
        load(source)
        fn = _entries[kernel]
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed with error {err}")
    count_launch(kernel)
