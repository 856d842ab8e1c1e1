#!/usr/bin/env python3
"""Time kernel 1 / 2's fp32 route built with and without nvcc's
``--split-compile=0``, in one process on one card.

    PYTHONPATH=src python3 tools/split_compile_ab.py [--iters 20]

Builds ``src/repro_torch/csrc/redmule_matmul.cu`` twice (the kernel
build's flags, and the same less ``--split-compile=0``) into
``build/split_ab/``, both ``nvcc`` at once, then runs ``chip_smoke.py``'s
nine fp32-route GEMM rows through the wrappers on each library in the order
base, split, split, base: each row's output must be bitwise equal across
the two builds, and each row's device time (the ``redmule_gemm_f32_kernel``
launches, from the profiler, averaged over ``--iters`` calls) is printed
for every pass.  One JSON line at the end holds every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FLAG = "--split-compile=0"


def build(out_dir: Path) -> dict:
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "redmule_matmul.cu"
    flags = {"split": list(_build.NVCC_FLAGS),
             "base": [f for f in _build.NVCC_FLAGS if f != FLAG]}
    assert FLAG in flags["split"] and FLAG not in flags["base"]
    t0 = time.perf_counter()
    procs = {v: subprocess.Popen([_build._nvcc(), *f, "-o", str(out_dir / f"{v}.so"),
                                  str(src)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for v, f in flags.items()}
    libs = {}
    for v, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc ({v}) failed:\n{log}")
        print(f"[build] {v}: {time.perf_counter() - t0:.1f} s", flush=True)
        libs[v] = out_dir / f"{v}.so"
    return libs


def rows(torch, ops, f32, device="cuda"):
    """chip_smoke.py's fp32-route GEMM rows: (name, call)."""
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device, dtype=torch.float32)

    x_gate, w_gate = rnd(1024, 4096), rnd(4096, 8)
    qe, st = rnd(16, 64, 1024), rnd(16, 1024, 1024)
    x16f, dz16f = rnd(16, 640), rnd(16, 128)
    xg, dg = rnd(1024, 4096), rnd(1024, 8)
    h, r, dzr = rnd(4, 4, 512), rnd(4, 512, 2048), rnd(4, 4, 2048)
    x_b, w_b = rnd(4608, 1600), rnd(1600, 57)
    qx, sx = rnd(16, 1, 1024), rnd(16, 1024, 1024)
    qh, sh = rnd(100, 1, 16), rnd(100, 16, 64)
    mm, bmm = ops.redmule_matmul, ops.redmule_matmul_batched
    return [
        ("redmule_matmul (fp32 route)", lambda: mm(x_gate, w_gate, policy=f32)),
        ("redmule_matmul_batched (fp32 route)", lambda: bmm(qe, st, policy=f32)),
        ("redmule_matmul (fp32 route, fused backward dW + db)",
         lambda: mm(x16f, dz16f, policy=f32, layout="tn", bias_grad=True)),
        ("redmule_matmul (fp32 route, split, gates dW)",
         lambda: mm(xg, dg, policy=f32, layout="tn")),
        ("redmule_matmul_batched (fp32 route, split, sLSTM recurrence)",
         lambda: bmm(h, r, policy=f32)),
        ("redmule_matmul_batched (fp32 route, split, sLSTM dX)",
         lambda: bmm(dzr, r, policy=f32, layout="nt")),
        ("redmule_matmul (fp32 route, hymba w_bcdt N=57)",
         lambda: mm(x_b, w_b, policy=f32)),
        ("redmule_matmul_batched (fp32 route, xlstm decode readout)",
         lambda: bmm(qx, sx, policy=f32)),
        ("redmule_matmul_batched (fp32 route, hymba decode readout)",
         lambda: bmm(qh, sh, policy=f32)),
    ]


def device_ms(torch, fn, iters: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if "redmule_gemm_f32_kernel" in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
    if us <= 0:
        raise RuntimeError("the profiler recorded no fp32-route kernel time")
    return us / 1e3 / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "split_ab"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("split_compile_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import precision as prec
    from repro_torch.kernels import _build, ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    libs = {v: ctypes.CDLL(str(p)) for v, p in build(Path(args.out)).items()}
    f32 = prec.FP32
    table = rows(torch, ops, f32)
    times = {name: {"base": [], "split": []} for name, _ in table}
    outs = {}
    for v in ("base", "split", "split", "base"):
        _build._libs["redmule_matmul"] = libs[v]
        for name, fn in table:
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            if name in outs and not all(map(torch.equal, outs[name], out)):
                raise AssertionError(f"{name}: the two builds' outputs differ")
            outs.setdefault(name, out)
            times[name][v].append(device_ms(torch, fn, args.iters))
    print("[ab] every row bitwise equal across the builds", flush=True)
    for name, t in times.items():
        b, s = sum(t["base"]) / 2, sum(t["split"]) / 2
        print(f"[ab] {name}: base {t['base'][0]:.4f} / {t['base'][1]:.4f} ms, split "
              f"{t['split'][0]:.4f} / {t['split'][1]:.4f} ms (split / base "
              f"{s / b:.3f})", flush=True)
    print(json.dumps({"card": card, "iters": args.iters, "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
