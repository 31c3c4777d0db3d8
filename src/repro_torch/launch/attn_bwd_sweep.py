"""What the tile shapes of the bf16 attention backward cost on one GPU: the
kernels ``flash_attention_bwd_dkdv`` and ``flash_attention_bwd_dq`` of
``csrc/flash_attention.cu`` built again with other template arguments in
their dispatch (warps a block, rows or keys a tile, passes, blocks an SM),
each held against the twin and timed at the LM layers' shapes.

    PYTHONPATH=src python3 src/repro_torch/launch/attn_bwd_sweep.py
        [--variants shipped,dkdv_bm32,...] [--repeats 5]

Each variant is the source with a few textual replacements (``VARIANTS``;
``shipped`` has none), built with ``nvcc -Xptxas -v`` into
``build/repro_torch/attn_bwd_sweep/`` (all at once, one process each) and
loaded with ``ctypes`` beside the shipped library. Each is first held
against ``ref.flash_attention_backward_ref`` on two small cases (bf16, the
case's largest |want| times 2**-6), then timed at ``SHAPES``: the mean of
``--repeats`` launches between CUDA events, after one warm-up, variants in
turn and again in reverse order. The bound of a kernel is its operations
(4 products of 2 D FLOPs a visible pair in dK/dV, 3 in dQ) at 989 TFLOP/s.
It prints a line a reading and, last, one JSON line: the card, each
variant's registers and spills as ptxas reports them, its errors, and its
ms and share of the bound by shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda

BF16_FLOPS = 989e12
# (what, B, Hq, Hkv, S, D, keywords): qwen2-1.5b's train_4k layer at its
# micro-batch of 2, Gemma-2's global layer, yi-34b's layer (group 7)
SHAPES = (
    ("qwen2-1.5b", 2, 12, 2, 4096, 128, {}),
    ("gemma2-9b global", 1, 16, 8, 4096, 256, dict(softcap=50.0)),
    ("yi-34b", 1, 56, 8, 4096, 128, {}),
)
CHECKS = ((1, 7, 1, 77, 130, 128, dict(q_offset=40), 1.0),
          (1, 4, 2, 65, 65, 256, dict(softcap=50.0), 16.0))
DKDV_128 = "launch_dkdv_mma<DMAX, 4, 16, false, 3>"
DKDV_256 = "launch_dkdv_mma<DMAX, 8, 32, true, 1>"
DQ_128 = "launch_dq_mma<DMAX, 4, 32, 3>"
DQ_256 = "launch_dq_mma<DMAX, 8, 32, 1>"
# name -> (old, new) replacements in the source; the template arguments
# are <D, warps, query rows (dK/dV) or keys (dQ) a tile, [two passes,]
# blocks an SM>
VARIANTS = {
    "shipped": (),
    "dkdv_bm32": ((DKDV_128, "launch_dkdv_mma<DMAX, 4, 32, false, 2>"),),
    "dkdv_8warps": ((DKDV_128, "launch_dkdv_mma<DMAX, 8, 32, false, 1>"),),
    "dkdv_two_pass": ((DKDV_128, "launch_dkdv_mma<DMAX, 4, 32, true, 2>"),),
    "dq_bn64": ((DQ_128, "launch_dq_mma<DMAX, 4, 64, 2>"),),
    "dq_8warps": ((DQ_128, "launch_dq_mma<DMAX, 8, 64, 1>"),),
    "d256_4warps": ((DKDV_256, "launch_dkdv_mma<DMAX, 4, 32, true, 1>"),
                    (DQ_256, "launch_dq_mma<DMAX, 4, 32, 1>")),
    "tanhf": (("tanh_fast(u * inv_cap)", "tanhf(u * inv_cap)"),),
    "no_cluster": (("int c = 8;  // the largest divisor", "int c = 1;  // the largest divisor"),),
}


def _build_variant(name: str, src: str) -> dict:
    s = src
    for old, new in VARIANTS[name]:
        if old not in s:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        s = s.replace(old, new)
    out = _build.BUILD_DIR / "attn_bwd_sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(s)
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{r.stderr[-3000:]}")
    ptxas, kernel = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else None
        elif kernel and "_mma_kernel" in kernel and ("registers" in line or "spill" in line):
            key = kernel.split("_mma_kernel")[0][-4:] + kernel.split("_mma_kernel")[1][:24]
            ptxas.setdefault(key, []).append(line.split(":", 1)[-1].strip())
    lib = ctypes.CDLL(str(so))
    for symbol, argtypes in _build.SOURCES["flash_attention"].values():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {"lib": lib, "build_s": time.perf_counter() - t0, "ptxas": ptxas}


def _inputs(gen, b, hq, hkv, sq, sk, d, kw, q_scale=1.0):
    def draw(s, h, scale=1.0):
        x = torch.randn((b, s, h, d), generator=gen, device="cuda") * scale
        return x.to(torch.bfloat16).transpose(1, 2)

    q, k, v, do = draw(sq, hq, q_scale), draw(sk, hkv), draw(sk, hkv), draw(sq, hq)
    out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    grads = [torch.empty_like(t) for t in (q, k, v)]
    return q, k, v, do, out, lse, delta, grads


def _launch(lib, which: str, q, k, v, do, lse, delta, grads, kw) -> None:
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = grads
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk,
            d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], 1, kw.get("window") or 0,
            kw.get("q_offset", sk - sq), kw.get("softcap") or 0.0, d ** -0.5, 1,
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, f"flash_attention_bwd_{which}_launch")
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_{which} returned {rc}")


def _ms(fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(repeats):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / repeats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd_sweep needs a CUDA device")
    names = args.variants.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card {card}", flush=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(lambda n: _build_variant(n, src), names)))
    _build.load("flash_attention")  # the shipped library, for the forward
    res = {n: {"ptxas": b["ptxas"], "build_s": b["build_s"], "errs": [], "ms": {}}
           for n, b in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, hq, hkv, sq, sk, d, kw, q_scale in CHECKS:
        q, k, v, do, out, lse, delta, grads = _inputs(gen, b, hq, hkv, sq, sk, d, kw, q_scale)
        want = ref.flash_attention_backward_ref(q, k, v, out, lse, do, **kw)
        scale = max(float(w.float().abs().max()) for w in want)
        for n, bt in built.items():
            for which in ("dkdv", "dq"):
                _launch(bt["lib"], which, q, k, v, do, lse, delta, grads, kw)
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(grads, want))
            res[n]["errs"].append(err / scale)
            if err > 2.0 ** -6 * scale:
                raise SystemExit(f"variant {n} differs from the twin ({err / scale:.3e})")
    for what, b, hq, hkv, s, d, kw in SHAPES:
        q, k, v, do, out, lse, delta, grads = _inputs(gen, b, hq, hkv, s, s, d, kw)
        w = kw.get("window") or s
        pairs = b * hq * sum(min(i + 1, w) for i in range(s))
        bound = {"dkdv": 8 * d * pairs / BF16_FLOPS * 1e3, "dq": 6 * d * pairs / BF16_FLOPS * 1e3}
        for order in (names, names[::-1]):
            for n in order:
                for which in ("dkdv", "dq"):
                    ms = _ms(lambda: _launch(built[n]["lib"], which, q, k, v, do, lse, delta,
                                             grads, kw), args.repeats)
                    res[n]["ms"].setdefault(what, {}).setdefault(which, []).append(ms)
                    print(f"{what} {n} {which} ms={ms:.4f} share of bound "
                          f"{bound[which] / ms:.1%}", flush=True)
        for n in names:
            res[n]["ms"][what]["bound_ms"] = bound
        del q, k, v, do, out, lse, delta, grads
        torch.cuda.empty_cache()
    out = {"card": card, "variants": {n: {k: v for k, v in r.items()} for n, r in res.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
