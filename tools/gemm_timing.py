#!/usr/bin/env python3
"""Time the port's kernels of one source tree on the card, row by row.

    python3 tools/gemm_timing.py [--root DIR] [--rows 1,1f,...] [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels, and times each row below through the public wrappers, the
same calls on every tree since they were ported: the RedMulE GEMMs
(``ops.redmule_matmul`` / ``ops.redmule_matmul_batched``, rows 1* and 2*,
since PR 11), flash attention (``flash_attention.flash_attention``, row 3,
since PR 11) and the chunked linear-attention sweep
(``chunked_linear_attention.chunked_linear_attention``, rows 4*, since PR
12; 4h / 4t / 4x at the recurrent slice's shapes).  A row's time is the device time of one call from torch.profiler
(the row's kernels alone — for row 4 every kernel the call launches — not
the host's enqueue), averaged over a window of calls.  A decode or prefill
row reads, call after call, the next of enough weight copies to exceed the
card's 50 MB L2, as the serving step finds its weights cold; the other
rows run as their paths run them, hot.
Bounds are the larger of the bytes (each input read once, the output
written once) over 3.35 TB/s and the operations over the peak of their
type (989 TFLOP/s bf16 / fp16, 1979 fp8, 67 fp32), H100 SXM data sheet.

To compare two trees on one card, run it on each in one chip call, in
turns (parent, change, change, parent), with ``--root`` pointing at an
unpacked ``git archive`` of the parent.  Prints one JSON line per row and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

HBM = 3.35e12
PEAK = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "fp32": 67e12}
L2_BYTES = 50 * 2 ** 20
D, V, FF, HQ, HKV, HD, B, T = 2048, 151936, 6144, 16, 8, 128, 4, 144


def _rows(torch, prec, dev):
    """(name, what, make) for every row; ``make()`` returns the call and the
    bound's (bytes, flops, peak key); operands come from one seed."""
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = prec.FP32
    bf = prec.TPU_BF16

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def copies(t):
        n = max(1, math.ceil(2 * L2_BYTES / (t.numel() * t.element_size())))
        return [t] + [t.clone() for _ in range(n - 1)]

    def e4(*shape):
        return prec.quantize_fp8(torch.randn(shape, generator=g, device=dev),
                                 torch.float8_e4m3fn)[0]

    def gemm(x, ws, **kw):
        cyc = itertools.cycle(ws)
        from repro_torch.kernels import ops
        return lambda: ops.redmule_matmul(x, next(cyc), **kw)

    def batched(x, ws, **kw):
        cyc = itertools.cycle(ws)
        from repro_torch.kernels import ops
        return lambda: ops.redmule_matmul_batched(x, next(cyc), **kw)

    def mk_1():
        x, e = rnd(B, D), rnd(V, D, scale=0.02)
        return gemm(x, [e], policy=bf, layout="nt"), (
            (B * D + V * D + B * V) * 2, 2 * B * D * V, "bf16")

    def mk_1a():
        x, w = rnd(16, 640, dtype=torch.float16), rnd(640, 128, dtype=torch.float16)
        b = rnd(128, dtype=torch.float16)
        return gemm(x, [w], policy=prec.PAPER_FP16, bias=b), (
            (16 * 640 + 640 * 128 + 16 * 128 + 128) * 2, 2 * 16 * 640 * 128, "fp16")

    def mk_1f():
        x, w = rnd(1024, 4096, dtype=torch.float32), rnd(4096, 8, dtype=torch.float32)
        return gemm(x, [w], policy=f32), (
            (1024 * 4096 + 4096 * 8 + 1024 * 8) * 4, 2 * 1024 * 4096 * 8, "fp32")

    def mk_1g():
        from repro_torch.core import tiling
        x, e = e4(B, D), e4(V, D)
        blk = tiling.accum_block(B, D, V, compute_dtype=torch.float16,
                                 accum_dtype=torch.float16,
                                 x_dtype=torch.float8_e4m3fn,
                                 w_dtype=torch.float8_e4m3fn)
        return gemm(x, [e], policy=prec.MIXED_FP8_E4M3, layout="nt",
                    accum_block=blk), (B * D + V * D + B * V * 2, 2 * B * D * V, "fp8")

    def mk_2():
        p = rnd(B, HKV, HQ // HKV, 1, T)
        v = rnd(B, HKV, 1, T, HD)
        return batched(p, [v], policy=bf), (
            (p.numel() + v.numel() + B * HQ * HD) * 2, 2 * B * HQ * T * HD, "bf16")

    def mk_2f():
        q, s = rnd(16, 64, 1024, dtype=torch.float32), rnd(16, 1024, 1024, dtype=torch.float32)
        return batched(q, [s], policy=f32), (
            (2 * q.numel() + s.numel()) * 4, 2 * 16 * 64 * 1024 * 1024, "fp32")

    def mk_nn(M, N, K):
        def make():
            x, w = rnd(M, N), rnd(N, K, scale=N ** -0.5)
            return gemm(x, copies(w), policy=bf), (
                (M * N + N * K + M * K) * 2, 2 * M * N * K, "bf16")
        return make

    def mk_1l():
        x, dz = rnd(1024, 4096, dtype=torch.float32), rnd(1024, 8, dtype=torch.float32)
        return gemm(x, [dz], policy=f32, layout="tn"), (
            (1024 * 4096 + 1024 * 8 + 4096 * 8) * 4, 2 * 4096 * 1024 * 8, "fp32")

    def mk_2h():
        h, r = rnd(4, 4, 512, dtype=torch.float32), rnd(4, 512, 2048, dtype=torch.float32)
        return batched(h, [r], policy=f32), (
            (h.numel() + r.numel() + 4 * 4 * 2048) * 4, 2 * 4 * 4 * 512 * 2048, "fp32")

    def mk_2i():
        dz, r = rnd(4, 4, 2048, dtype=torch.float32), rnd(4, 512, 2048, dtype=torch.float32)
        return batched(dz, [r], policy=f32, layout="nt"), (
            (dz.numel() + r.numel() + 4 * 4 * 512) * 4, 2 * 4 * 4 * 2048 * 512, "fp32")

    def mk_3():
        from repro_torch.kernels import flash_attention as fa
        q, k, v = rnd(HQ, 128, HD), rnd(HKV, T, HD), rnd(HKV, T, HD)
        pairs = 128 * 129 // 2
        return (lambda: fa.flash_attention(q, k, v, group=HQ // HKV, t_valid=128)), (
            (2 * HQ * 128 * HD + 2 * HKV * 128 * HD) * 2, 4 * HQ * pairs * HD, "bf16")

    def mk_4():
        from repro_torch.kernels import chunked_linear_attention as cla
        BH, S, DK, C = 16, 256, 1024, 64
        q = rnd(BH, S, DK, scale=DK ** -0.5)
        k, v = rnd(BH, S, DK, scale=0.5), rnd(BH, S, DK)
        lg = -torch.rand(BH, S, generator=g, device=dev) * 0.1
        pairs = C * (C + 1) // 2
        return (lambda: cla.chunked_linear_attention(q, k, v, lg, chunk=C)), (
            4 * BH * S * DK * 2 + BH * S * 4 + BH * DK * DK * 4,
            BH * (S // C) * (4 * pairs * DK + 4 * C * DK * DK), "fp32")

    def mk_sweep(BH, S, dk, dv, qk_dtype, v_dtype, C=64):
        # the recurrent slice's sweeps: hymba's fp32 C / B with a bf16
        # dt·x at dk 16, and the xLSTM prefill
        def make():
            from repro_torch.kernels import chunked_linear_attention as cla
            q = rnd(BH, S, dk, scale=dk ** -0.5, dtype=qk_dtype)
            k, v = rnd(BH, S, dk, scale=0.5, dtype=qk_dtype), rnd(BH, S, dv, dtype=v_dtype)
            lg = -torch.rand(BH, S, generator=g, device=dev) * 0.7
            pairs = C * (C + 1) // 2
            size = lambda dt: torch.tensor([], dtype=dt).element_size()
            n_bytes = (2 * BH * S * dk * size(qk_dtype) + BH * S * dv * size(v_dtype)
                       + BH * S * 4 + BH * S * dv * size(qk_dtype) + BH * dk * dv * 4)
            return (lambda: cla.chunked_linear_attention(q, k, v, lg, chunk=C)), (
                n_bytes, BH * (S // C) * (2 * pairs * (dk + dv) + 4 * C * dk * dv), "fp32")
        return make

    return [
        ("1", "tied head nt 4 x 2048 x 151936 bf16", mk_1),
        ("1a", "AE fc0 nn 16 x 640 x 128 +bias paper_fp16", mk_1a),
        ("1f", "mLSTM gates nn 1024 x 4096 x 8 fp32", mk_1f),
        ("1g", "tied head nt 4 x 2048 x 151936 e4m3, faithful", mk_1g),
        ("2", "decode PV 4x8x2 x (1 x 144 x 128) bf16, V broadcast", mk_2),
        ("2f", "sweep inter read 16 x (64 x 1024 x 1024) fp32", mk_2f),
        ("1i", "decode w_out nn 4 x 6144 x 2048 bf16, L2 cold", mk_nn(B, FF, D)),
        ("1j", "decode wqkv nn 4 x 2048 x 4096 bf16, L2 cold",
         mk_nn(B, D, (HQ + 2 * HKV) * HD)),
        ("1k", "prefill w_in nn 128 x 2048 x 12288 bf16, L2 cold",
         mk_nn(128, D, 2 * FF)),
        ("1l", "mLSTM gates dW tn 4096 x 1024 x 8 fp32", mk_1l),
        ("2h", "sLSTM recurrence nn 4 x (4 x 512 x 2048) fp32", mk_2h),
        ("2i", "sLSTM recurrence dX nt 4 x (4 x 2048 x 512) fp32", mk_2i),
        ("3", "flash prefill 16/8 heads D 128 S 128 T 144 t_valid 128 bf16", mk_3),
        ("4", "sweep BH 16 S 256 dk = dv = 1024 chunk 64 bf16", mk_4),
        ("4h", "sweep hymba prefill BH 100 S 1152 dk 16 dv 64, fp32 q / k, bf16 v",
         mk_sweep(100, 1152, 16, 64, torch.float32, torch.bfloat16)),
        ("4t", "sweep hymba train BH 100 S 256 dk 16 dv 64, fp32 q / k, bf16 v",
         mk_sweep(100, 256, 16, 64, torch.float32, torch.bfloat16)),
        ("4x", "sweep xlstm prefill BH 16 S 128 dk = dv = 1024 bf16",
         mk_sweep(16, 128, 1024, 1024, torch.bfloat16, torch.bfloat16)),
    ]


# the kernels a row's device time sums, by a substring of their names
KERNEL_KEY = {"3": "flash_fwd", "4": "chunked_linear_attention",
              "4h": "chunked_linear_attention", "4t": "chunked_linear_attention",
              "4x": "chunked_linear_attention"}


def device_ms(torch, fn, key: str = "redmule_gemm", iters: int = 30,
              warmup: int = 5) -> float:
    """Device time of one call of ``fn``: the time of the kernels whose
    names contain ``key`` in a profiled window of ``iters`` calls, over
    ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if key in ev.key and ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
    if us <= 0:
        raise RuntimeError(f"torch.profiler recorded no kernel named *{key}*")
    return us / 1e3 / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rows", default="", help="comma-separated row names (all)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("gemm_timing: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.core import precision as prec
    from repro_torch.kernels import _build

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    want = set(filter(None, args.rows.split(",")))
    out = []
    for name, what, make in _rows(torch, prec, torch.device("cuda")):
        if want and name not in want:
            continue
        fn, (n_bytes, flops, peak) = make()
        ms = device_ms(torch, fn, KERNEL_KEY.get(name, "redmule_gemm"))
        bound = max(n_bytes / HBM, flops / PEAK[peak]) * 1e3
        row = {"row": name, "what": what, "tree": str(root), "card": card,
               "device_ms": ms, "bound_ms": bound,
               "bound_by": "bytes" if n_bytes / HBM >= flops / PEAK[peak]
               else "operations"}
        print(json.dumps(row), flush=True)
        out.append(row)
        del fn
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
