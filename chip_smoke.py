#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. **build** — compile every CUDA source in ``src/repro_torch/csrc`` with
   nvcc for sm_90a (all at once) and print the build seconds and the
   compiler's register / shared-memory report;
2. **kernels** — each kernel's wrapper against its plain PyTorch version on
   the same inputs, at the serving path's shapes (qwen3-1.7b at full
   width) and the training paths' (xlstm-1.3b at full width, the
   AutoEncoder at batch 16 and 4096), with the tolerance printed beside
   the error: the bf16 / fp16 GEMM (kernels 1 and 2), its fp32 route in nn
   / nt / tn, kernel 1's faithful fp16 accumulator and fused backward
   (deriv, dW + db) on every route, FP8 storage upcast on load in kernels
   1 and 2 (each FP8 launch also bitwise against the same launch on
   pre-widened fp16 operands), flash attention (kernel 3) and the chunked
   linear-attention sweep (kernel 4: the training shape, a ragged dk != dv
   shape, fp32 input); then the split of the reduction inside one GEMM
   launch (a ragged last slice, the faithful accumulator over 3 rounding
   blocks, an FP8 pair bitwise against its pre-widened launch, a broadcast
   batched operand, the fp32 route), every split launch repeated and
   bitwise equal run to run, and rows at qwen3-1.7b's decode / prefill and
   the xLSTM's fp32 gate and sLSTM shapes.  Each kernel, its plain version
   and — where one exists — one PyTorch library call for the same function
   are timed with CUDA events (decode / prefill rows over weight copies
   that exceed the L2), the kernel alone with torch.profiler, and each
   GEMM row prints the slices S its launch split into;
3. **serve** — every kernel's launch count is set to 0, then
   ``repro_torch.launch.serve`` serves qwen3-1.7b at full width (random
   weights from a seed): 4 requests, prompt 128, 16 new tokens; the counts
   are read right after and every kernel of the path must have run; tokens
   must be in range.  Then one prefill and one decode step are timed with
   CUDA events (logits must be finite) and profiled, and a two-layer cut
   of the same model is held against the plain path on the CPU;
4. **train** — the counts are set to 0 again, then
   ``repro_torch.launch.train`` trains xlstm-1.3b at full width (48
   blocks, d 2048, random weights from a seed) for 3 steps at batch 4 x
   seq 256; loss and gradient norm must be finite on every step and the
   sweep kernel's launch count must equal the structural one (42 mLSTM
   blocks per forward, once more in the remat recompute).  The warm-up
   step's fp32-route launches are tallied by shape, each shape then timed
   alone; then one step is profiled (device busy / idle share) with its
   peak memory, and one
   full-width super-block (7 mLSTM + 1 sLSTM, batch 1, seq 128) is held
   against the plain path on the CPU: loss and the gradients of w_up,
   w_qkv and r_gates;
5. **ae** — the counts are set to 0 again, then ``repro_torch.launch.train
   --arch ae`` trains the paper's TinyMLPerf AutoEncoder (640 -> [128 x4]
   -> 8 -> [128 x4] -> 640, random weights from a seed) for 200 steps at
   batch 16 under ``paper_fp16``, then 3 steps under ``fp32``: the mse must
   be finite and falling, and kernel 1 must launch exactly 30 times a step
   (every one faithful, 10 of them the fused dW + db).  Then one step is
   profiled, the loss-scaled example runs 200 steps, and one step is held
   against the CPU plain path at batch 16 and at batch 4096 (where the dW
   reductions span 2 to 4 rounding blocks);
6. **ae8** — the same entry point under FP8 storage: 200
   ``mixed_fp8_e4m3`` steps at batch 16 (the mse must fall to the
   reference's level), 3 at batch 4096 and 3 ``mixed_fp8_e5m2`` steps,
   each with its own counts (30 kernel-1 launches a step, all FP8, none
   fused-backward); one profiled step; one step at batch 16 and 4096 held
   against the CPU plain path, with BatchNorm in float64 on both sides and
   as the path runs it, each bound beside two controls that must fail it;
7. **serve8** — qwen3-1.7b at full width under ``mixed_fp8_e4m3``:
   ``launch.serve.generate`` of 4 x (128 + 16) with the counts set to 0
   (the structural 2260 / 896 / 112 launches, every GEMM launch FP8);
   one prefill and one decode step timed and profiled; a two-layer cut
   (prefill, and a decode step from one cache) against the CPU plain path;
8. **report** — the GEMM wrappers' split launches (``.launches_split``)
   per path, the card (``nvidia-smi``), a ``{"kernels": [...]}`` line, and
   last ``{"ok": true, "device": {...}}``.

Everything is also written to ``chiprun_out/chip_smoke.json``.  It needs
one card and exits non-zero without one, or without the rest of the repo.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
FP8_FLOPS = 1979e12         # H100 SXM dense fp8 tensor-core peak
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
ARCH, BATCH, PROMPT, GEN, SEED = "qwen3-1.7b", 4, 128, 16, 0
# the training path: xlstm-1.3b at full width
T_ARCH, T_BATCH, T_SEQ, T_STEPS = "xlstm-1.3b", 4, 256, 3
# the AutoEncoder path: the paper's use case at its published width
AE_BATCH, AE_STEPS, AE_BIG = 16, 200, 4096
# the FP8 AE step with BatchNorm in float64 on both sides, card vs CPU:
# two fp16 ulps of the largest gradient
AE8_STATS_TOL = 2.0 ** -9
# the serve8 two-layer cut, card vs CPU plain: four fp16 ulps of max
SERVE8_TOL = 2.0 ** -8


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_profile(fn, iters: int = 5) -> dict:
    """Device time of ``iters`` calls of ``fn`` from torch.profiler, by
    kernel group, beside the host wall time of the same calls; an empty
    profile (no CUDA activity recorded) raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        name = ("redmule_gemm" if "redmule_gemm_kernel" in ev.key else
                "redmule_gemm_f32" if "redmule_gemm_f32_kernel" in ev.key else
                "flash_fwd" if "flash_fwd_kernel" in ev.key else
                "chunked_linear_attention"
                if "chunked_linear_attention_kernel" in ev.key else "other")
        g = groups.setdefault(name, {"ms": 0.0, "count": 0})
        g["ms"] += us / 1e3 / iters
        g["count"] += ev.count / iters
    busy = sum(g["ms"] for g in groups.values())
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    wall_ms = wall * 1e3 / iters
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "by_kernel": groups}


def _bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check(name, got, want, tol_rel, log):
    """max |got - want| against tol_rel * max |want|; raises on failure."""
    err = (got.float() - want.float()).abs().max().item()
    tol = tol_rel * max(want.float().abs().max().item(), 1e-30)
    ok = math.isfinite(err) and err <= tol
    log.append({"check": name, "max_abs_err": err, "tol": tol, "ok": ok})
    print(f"[check] {name}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def kernel1_mode_checks(log, g):
    """Kernel 1's faithful fp16 accumulator and fused backward epilogue
    (the AutoEncoder path) on the card against the plain version on the
    card: faithful GEMMs at the AE shapes and at multi-block shapes, the dW
    "tn" with db (faithful, fp16 -> fp32 and the fp32 route), deriv on
    "nt" / "tn" (relu, gelu).  Returns the runs to time.

    Tolerances: the faithful accumulator one fp16 ulp (2^-10 relative) per
    rounding step (each reduction block, and the bias add) — both sides
    sum each block in fp32 in another order, so a rounding may flip; a
    transcendental derivative under fp16 2e-2 (the reference's); fp32
    accumulation 1e-5 of max."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core.engine import _grad_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    paper, f32 = prec.PAPER_FP16, prec.FP32
    g16, g32 = _grad_policy(prec.TPU_FP16), _grad_policy(prec.TPU_BF16)
    ulp = 2.0 ** -10

    def rnd(*shape, dtype=torch.float16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def both(name, x, w, policy, tol, **kw):
        got = ops.redmule_matmul(x, w, policy=policy, **kw)
        want = rm.redmule_matmul_plain(x, w, policy=policy, **kw)
        if kw.get("bias_grad"):
            err = _check(name, got[0], want[0], tol, log)
            _check(name + " db", got[1], want[1], tol, log)
            return err
        return _check(name, got, want, tol, log)

    # forward: the AE's layers at batch 16 (one block: the reduction fits
    # the reference's bn) and multi-block shapes
    B, d_in, d_h = 16, 640, 128
    x16, w0 = rnd(B, d_in), rnd(d_in, d_h, scale=(2 / d_in) ** 0.5)
    b0 = torch.randn(d_h, generator=g, device=dev).half()
    err_fwd = both("faithful nn AE fc0 M=16 N=640 K=128 +bias (1 block of 640)",
                   x16, w0, paper, 2 * ulp, bias=b0)
    both("faithful nn AE fc9 M=16 N=128 K=640 +bias", rnd(B, d_h),
         rnd(d_h, d_in, scale=(2 / d_h) ** 0.5), paper, 2 * ulp,
         bias=torch.randn(d_in, generator=g, device=dev).half())
    xm, wm = rnd(256, 640), rnd(640, 128, scale=640 ** -0.5)
    both("faithful nn M=256 N=640 K=128 block 128 (5 blocks)", xm, wm, paper,
         6 * ulp, bias=b0, accum_block=128)
    both("faithful nn M=64 N=4096 K=256 block 2048 (2 blocks)", rnd(64, 4096),
         rnd(4096, 256, scale=4096 ** -0.5), paper, 2 * ulp, accum_block=2048)
    both("faithful nt dX M=16 N=128 K=640", rnd(B, d_h), w0, paper, ulp,
         layout="nt")
    # the 8-wide bottleneck: fc4 (128 -> 8) and fc5 (8 -> 128) forward, dX
    # and dW + db; fc5's forward and fc4's dX reduce over 8 rows, fewer
    # than the kernel's 32-deep step (the rest is masked)
    w4, w5 = rnd(d_h, 8, scale=(2 / d_h) ** 0.5), rnd(8, d_h, scale=0.5)
    both("faithful nn AE fc4 M=16 N=128 K=8 +bias", rnd(B, d_h), w4, paper,
         2 * ulp, bias=rnd(8))
    both("faithful nn AE fc5 M=16 N=8 K=128 +bias", rnd(B, 8), w5, paper,
         2 * ulp, bias=rnd(d_h))
    both("faithful nt dX AE fc4 M=16 N=8 K=128", rnd(B, 8, scale=1e-2), w4,
         paper, ulp, layout="nt")
    both("faithful nt dX AE fc5 M=16 N=128 K=8", rnd(B, d_h, scale=1e-2), w5,
         paper, ulp, layout="nt")
    both("faithful tn dW+db AE fc4 M=128 N=16 K=8", rnd(B, d_h),
         rnd(B, 8, scale=1e-2), paper, ulp, layout="tn", bias_grad=True)
    both("faithful tn dW+db AE fc5 M=8 N=16 K=128", rnd(B, 8),
         rnd(B, d_h, scale=1e-2), paper, ulp, layout="tn", bias_grad=True)
    # db over an empty M or N: the kernel still launches (one M-tile row of
    # blocks sums db, no z is stored)
    for what, xe, dze in (("M=0 N=16 K=128", rnd(B, 0), rnd(B, d_h, scale=1e-2)),
                          ("M=640 N=0 K=128", rnd(0, d_in), rnd(0, d_h))):
        before = ops.redmule_matmul.launches
        z_e, db_e = ops.redmule_matmul(xe, dze, policy=paper, layout="tn",
                                       bias_grad=True)
        z_w, db_w = rm.redmule_matmul_plain(xe, dze, policy=paper, layout="tn",
                                            bias_grad=True)
        if ops.redmule_matmul.launches != before + 1 or z_e.shape != z_w.shape:
            raise AssertionError(f"empty-{what} dW + db did not launch the kernel")
        _check(f"faithful tn dW+db {what}: db", db_e, db_w, ulp, log)
    # the dW "tn" with db: AE fc0 at batch 16 (1 block) and 4096 (4 x 1024)
    xb, dzb = rnd(4096, d_in), rnd(4096, d_h, scale=1e-2)
    err_dw16 = both("faithful tn dW+db AE fc0 M=640 N=16 K=128", x16,
                    rnd(B, d_h, scale=1e-2), paper, ulp, layout="tn",
                    bias_grad=True)
    err_dw4k = both("faithful tn dW+db AE fc0 M=640 N=4096 K=128 (4 blocks)",
                    xb, dzb, paper, 4 * ulp, layout="tn", bias_grad=True)
    err_mb = both("faithful tn dW AE fc0 M=640 N=4096 K=128, no db",
                  xb, dzb, paper, 4 * ulp, layout="tn")
    both("tn dW+db fp16 -> fp32 M=640 N=4096 K=128", xb, dzb, g16, 1e-5,
         layout="tn", bias_grad=True)
    xb32, dzb32 = xb.float(), dzb.float()
    both("fp32 route tn dW+db M=640 N=4096 K=128", xb32, dzb32, f32, 1e-5,
         layout="tn", bias_grad=True)
    x16f, dz16f = x16.float(), dzb[:B].float()
    err_dw32 = both("fp32 route tn dW+db AE fc0 M=640 N=16 K=128", x16f, dz16f,
                    f32, 1e-5, layout="tn", bias_grad=True)
    # deriv on load: relu (output form) and gelu (pre-activation), nt / tn
    for act, from_out in (("relu", True), ("gelu", False)):
        dx_d = rnd(B, d_h)
        dw_d = rnd(4096, d_h)
        tol = 2e-2 if act == "gelu" else ulp
        both(f"faithful nt dX deriv {act} M=16 N=128 K=640", rnd(B, d_h), w0,
             paper, tol, layout="nt", deriv=dx_d, grad_epilogue=act,
             grad_from_output=from_out)
        both(f"faithful tn dW+db deriv {act} M=640 N=4096 K=128", xb, dzb,
             paper, max(tol, 4 * ulp), layout="tn", deriv=dw_d,
             grad_epilogue=act, grad_from_output=from_out, bias_grad=True)
        both(f"bf16 -> fp32 tn dW+db deriv {act} M=640 N=4096 K=128",
             xb.bfloat16(), dzb.bfloat16(), g32, 2e-2 if act == "gelu" else 1e-5,
             layout="tn", deriv=dw_d.bfloat16(), grad_epilogue=act,
             grad_from_output=from_out, bias_grad=True)
        both(f"fp32 route nt dX deriv {act} M=16 N=128 K=640", rnd(B, d_h).float(),
             w0.float(), f32, 1e-5, layout="nt", deriv=dx_d.float(),
             grad_epilogue=act, grad_from_output=from_out)
        both(f"fp32 route tn dW+db deriv {act} M=640 N=4096 K=128", xb32, dzb32,
             f32, 1e-5, layout="tn", deriv=dw_d.float(), grad_epilogue=act,
             grad_from_output=from_out, bias_grad=True)
    # kernel 2 (batched) under the faithful accumulator
    xq, wq = rnd(3, 64, 640), rnd(3, 640, 96, scale=640 ** -0.5)
    got = ops.redmule_matmul_batched(xq, wq, policy=paper, accum_block=128)
    _check("faithful batched B=3 M=64 N=640 K=96 block 128", got,
           rm.redmule_matmul_plain(xq, wq, policy=paper, accum_block=128),
           5 * ulp, log)
    torch.cuda.synchronize()
    # the faithful accumulator's cost: the same dW with fp32 accumulation
    t_faithful = _time_ms(lambda: ops.redmule_matmul(xb, dzb, policy=paper,
                                                     layout="tn"))
    t_fp32acc = _time_ms(lambda: ops.redmule_matmul(xb, dzb, policy=g16,
                                                    layout="tn"))
    print(f"[time] AE fc0 dW tn M=640 N=4096 K=128 fp16: faithful (4 blocks) "
          f"{t_faithful:.4f} ms, fp32 accumulation {t_fp32acc:.4f} ms", flush=True)

    fp16_b = lambda M, N, K, extra=0: _bound_ms(
        (M * N + N * K + M * K) * 2 + extra, 2 * M * N * K)
    src = "src/repro_torch/csrc/redmule_matmul.cu"
    rep = "src/repro/kernels/redmule_matmul.py:289"
    lib_tn = lambda a, b_: (lambda: torch.matmul(a.t(), b_))
    # ``paths``: the main-path runs whose launches a row reports (default:
    # every run); the batch-16 and batch-4096 dW + db rows share a counter
    # and each reads only the run at its batch
    return [
        dict(name="redmule_matmul (faithful fp16)", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_faithful"), source=src,
             replaces=rep, err=err_fwd, bound=fp16_b(B, d_in, d_h, d_h * 2),
             shape="AE fc0 forward nn M=16 N=640 K=128 +bias, 1 block",
             kernel=lambda: ops.redmule_matmul(x16, w0, policy=paper, bias=b0),
             plain=lambda: rm.redmule_matmul_plain(x16, w0, policy=paper, bias=b0),
             library=lambda: torch.matmul(x16, w0)),
        dict(name="redmule_matmul (faithful fp16, multi-block)",
             group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_multiblock"), source=src,
             replaces=rep, err=err_mb, bound=fp16_b(d_in, 4096, d_h),
             shape="AE fc0 dW tn M=640 N=4096 K=128, 4 blocks of 1024, no db "
                   "(the path's multi-block launches are its dW + db at batch 4096)",
             kernel=lambda: ops.redmule_matmul(xb, dzb, policy=paper, layout="tn",
                                               accum_block=1024),
             plain=lambda: rm.redmule_matmul_plain(xb, dzb, policy=paper,
                                                   layout="tn", accum_block=1024),
             library=lib_tn(xb, dzb)),
        dict(name="redmule_matmul (fused backward dW + db)", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_fused_bwd"), paths=("ae",),
             source=src,
             replaces=rep, err=err_dw16, bound=fp16_b(d_in, B, d_h, d_h * 2),
             shape="AE fc0 dW tn M=640 N=16 K=128 +db, faithful, 1 block",
             kernel=lambda: ops.redmule_matmul(x16, dzb[:B], policy=paper,
                                               layout="tn", bias_grad=True),
             plain=lambda: rm.redmule_matmul_plain(x16, dzb[:B], policy=paper,
                                                   layout="tn", bias_grad=True),
             library=lib_tn(x16, dzb[:B])),
        dict(name="redmule_matmul (fused backward dW + db, batch 4096)",
             group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_fused_bwd"),
             paths=("ae_b4096",), source=src, replaces=rep, err=err_dw4k, bound=fp16_b(d_in, 4096, d_h, d_h * 2),
             shape="AE fc0 dW tn M=640 N=4096 K=128 +db, faithful, 4 blocks",
             kernel=lambda: ops.redmule_matmul(xb, dzb, policy=paper, layout="tn",
                                               bias_grad=True),
             plain=lambda: rm.redmule_matmul_plain(xb, dzb, policy=paper,
                                                   layout="tn", bias_grad=True),
             library=lib_tn(xb, dzb)),
        dict(name="redmule_matmul (fp32 route, fused backward dW + db)",
             group="redmule_gemm_f32",
             counter=(ops.redmule_matmul, "launches_fused_bwd_fp32"), source=src,
             replaces=rep, err=err_dw32,
             bound=_bound_ms((d_in * B + B * d_h + d_in * d_h + d_h) * 4,
                             2 * d_in * B * d_h, FP32_FLOPS),
             shape="AE fc0 dW tn M=640 N=16 K=128 +db, fp32",
             kernel=lambda: ops.redmule_matmul(x16f, dz16f, policy=f32,
                                               layout="tn", bias_grad=True),
             plain=lambda: rm.redmule_matmul_plain(x16f, dz16f, policy=f32,
                                                   layout="tn", bias_grad=True),
             library=lib_tn(x16f, dz16f)),
    ]


def fp8_kernel_checks(log, g):
    """FP8 storage, upcast on load, in kernels 1 and 2 (the mixed_fp8_*
    policies) at the ae8 and serve8 paths' shapes.  Each launch is held
    two ways: **bitwise** against the same kernel on the operands widened
    to fp16 first (the reference's ``operand_dtypes`` contract: the bytes
    change, the values do not; both launches get the same rounding block),
    and against the plain version on the card.  Returns the runs to time.

    Tolerances against the plain version: the faithful fp16 accumulator
    one fp16 ulp (2^-10 of max) per rounding step — each reduction block,
    plus the fused derivative's rounding — as in the paper_fp16 checks; an
    fp16 store after fp32 accumulation two ulps (2^-9); fp32 stores after
    fp32 accumulation 1e-5 (summation order only); a transcendental
    derivative 2e-2 (the reference's)."""
    import dataclasses

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.core.engine import _grad_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    E4, E5 = torch.float8_e4m3fn, torch.float8_e5m2
    e4, e5 = prec.MIXED_FP8_E4M3, prec.MIXED_FP8_E5M2
    g4, g5 = _grad_policy(e4), _grad_policy(e5)
    s4 = dataclasses.replace(e4, name=e4.name + "_scores",
                             output_dtype=torch.float32, faithful_accum=False)
    ulp = 2.0 ** -10

    def q(*shape, dtype=E4):
        """A random operand quantized per tensor, as the engine does."""
        return prec.quantize_fp8(torch.randn(shape, generator=g, device=dev),
                                 dtype)[0]

    launched = set()

    def both(name, x, w, policy, tol, *, batched=False, **kw):
        fn = ops.redmule_matmul_batched if batched else ops.redmule_matmul
        if policy.blockwise_accum and "accum_block" not in kw:
            M, N, K = rm.logical_dims(x.shape, w.shape, kw.get("layout", "nn"))
            kw["accum_block"] = tiling.accum_block(
                M, N, K, compute_dtype=torch.float16, accum_dtype=torch.float16,
                fused_bwd=bool(kw.get("grad_epilogue") or kw.get("bias_grad")),
                x_dtype=x.dtype, w_dtype=w.dtype)
        got = fn(x, w, policy=policy, **kw)
        launched.add((x.dtype, w.dtype, policy.out_dtype, bool(
            kw.get("accum_block") or kw.get("grad_epilogue") or kw.get("bias_grad"))))
        wide = fn(x.half(), w.half(), policy=policy, **kw)
        want = rm.redmule_matmul_plain(x, w, policy=policy, **kw)
        pairs = zip(got, wide) if kw.get("bias_grad") else ((got, wide),)
        same = all(torch.equal(a, b) for a, b in pairs)
        log.append({"check": name + ": FP8 == pre-widened fp16 launch",
                    "bitwise": same, "ok": same})
        print(f"[check] {name}: FP8 vs pre-widened fp16 launch "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{name}: the FP8 launch differs from the "
                                 "pre-widened fp16 launch")
        if kw.get("bias_grad"):
            _check(name + " db", got[1], want[1], tol, log)
            return _check(name, got[0], want[0], tol, log)
        return _check(name, got, want, tol, log)

    # the AutoEncoder under mixed_fp8_e4m3 (faithful): forward E4M3 x E4M3,
    # dX E5M2 dZ x E4M3 W ("nt"), dW E4M3 X x E5M2 dZ ("tn"), batch 16 and
    # 4096 (the dW reduction over 4096 rows spans 2 blocks of 2048)
    B, d_in, d_h = 16, 640, 128
    x16, w0 = q(B, d_in), q(d_in, d_h)
    both("fp8 e4m3 nn AE fc0 M=16 N=640 K=128", x16, w0, e4, 2 * ulp)
    both("fp8 e5m2 x e4m3 nt dX AE fc0 M=16 N=128 K=640", q(B, d_h, dtype=E5),
         w0, g4, 2 * ulp, layout="nt")
    both("fp8 e4m3 x e5m2 tn dW AE fc0 M=640 N=16 K=128", x16,
         q(B, d_h, dtype=E5), g4, 2 * ulp, layout="tn")
    xb, dzb = q(4096, d_in), q(4096, d_h, dtype=E5)
    both("fp8 e4m3 x e5m2 tn dW AE fc0 M=640 N=4096 K=128 (2 blocks)", xb, dzb,
         g4, 3 * ulp, layout="tn")
    # the 8-wide bottleneck: extents of 8 take the scalar (unvectorised) load
    w4, w5 = q(d_h, 8), q(8, d_h)
    both("fp8 e4m3 nn AE fc4 M=16 N=128 K=8 (scalar w)", q(B, d_h), w4, e4,
         2 * ulp)
    both("fp8 e4m3 nn AE fc5 M=16 N=8 K=128 (scalar x)", q(B, 8), w5, e4,
         2 * ulp)
    both("fp8 e5m2 x e4m3 nt dX AE fc4 M=16 N=8 K=128", q(B, 8, dtype=E5), w4,
         g4, 2 * ulp, layout="nt")
    both("fp8 e4m3 x e5m2 tn dW AE fc5 M=8 N=16 K=128", q(B, 8),
         q(B, d_h, dtype=E5), g4, 2 * ulp, layout="tn")
    # unaligned: a view one byte into its storage, odd strides
    xu = q(B + 1, d_in + 3)[1:, 3:]
    both("fp8 e4m3 nn unaligned view M=16 N=640 K=128", xu, w0, e4, 2 * ulp)
    # the fused backward on FP8 dZ: act' on load (nt, tn) and db
    dzx, dzw = q(B, d_h, dtype=E5), q(4096, d_h, dtype=E5)
    dder = (torch.randn(B, d_h, generator=g, device=dev)).half()
    wder = (torch.randn(4096, d_h, generator=g, device=dev)).half()
    both("fp8 e5m2 x e4m3 nt dX deriv relu M=16 N=128 K=640", dzx, w0, g4,
         2 * ulp, layout="nt", deriv=dder.relu(), grad_epilogue="relu",
         grad_from_output=True)
    both("fp8 e4m3 x e5m2 tn dW+db deriv gelu M=640 N=4096 K=128", xb, dzw, g4,
         2e-2, layout="tn", deriv=wder, grad_epilogue="gelu", bias_grad=True)
    # mixed_fp8_e5m2 (fp32 accumulator): E5M2 x E5M2, fp16 forward, fp32 grads
    x5, w5b = q(B, d_in, dtype=E5), q(d_in, d_h, dtype=E5)
    err_e5 = both("fp8 e5m2 nn AE fc0 M=16 N=640 K=128 (fp32 acc)", x5, w5b, e5,
                  2 * ulp)
    both("fp8 e5m2 nt dX AE fc0 M=16 N=128 K=640 (fp32 out)",
         q(B, d_h, dtype=E5), w5b, g5, 1e-5, layout="nt")
    both("fp8 e5m2 tn dW AE fc0 M=640 N=4096 K=128 (fp32 out)",
         q(4096, d_in, dtype=E5), q(4096, d_h, dtype=E5), g5, 1e-5, layout="tn")

    # qwen3-1.7b serving under mixed_fp8_e4m3: the tied head ("nt"), the
    # prefill projections, and kernel 2's decode scores (fp32 out) and PV
    d, V, ff, hq, hkv, hd = 2048, 151936, 6144, 16, 8, 128
    T = PROMPT + GEN
    x_dec, emb = q(BATCH, d), q(V, d)
    err_head = both("fp8 e4m3 nt tied head M=4 N=2048 K=151936", x_dec, emb, e4,
                    2 * ulp, layout="nt")
    both("fp8 e4m3 nn wqkv prefill M=128 N=2048 K=4096", q(PROMPT, d),
         q(d, (hq + 2 * hkv) * hd), e4, 2 * ulp)
    both("fp8 e4m3 nn w_out prefill M=128 N=6144 K=2048 (3 blocks)",
         q(PROMPT, ff), q(ff, d), e4, 4 * ulp)
    kc, qt = q(BATCH * hkv, T, hd), q(BATCH * hkv, hd, hq // hkv)
    err_sc = both("fp8 e4m3 batched decode scores B=32 M=144 N=128 K=2 "
                  "(fp32 out)", kc, qt, s4, 2 * ulp, batched=True)
    p8, v8 = q(BATCH, hkv, hq // hkv, 1, T), q(BATCH, hkv, 1, T, hd)
    both("fp8 e4m3 batched decode PV B=4x8x2 M=1 N=144 K=128 (V broadcast)",
         p8, v8, e4, 2 * ulp, batched=True)
    # the kernel's compiled pairs are what the Python side declares: each
    # declared pair launched above, and an undeclared one fails in the
    # kernel's own dispatch (it is never widened)
    same = launched == rm.FP8_KERNELS
    log.append({"check": "FP8 pairs launched == FP8_KERNELS", "ok": same})
    if not same:
        raise AssertionError(f"FP8 pairs launched {sorted(map(str, launched))} "
                             f"differ from FP8_KERNELS")
    try:
        ops.redmule_matmul(x5, w5b, policy=e4)
    except RuntimeError as e:
        log.append({"check": "undeclared FP8 pair fails", "ok": True})
        print(f"[check] undeclared FP8 pair fails: {e}"[:200], flush=True)
    else:
        raise AssertionError("an undeclared FP8 pair (e5m2 x e5m2 -> fp16 "
                             "faithful forward) did not fail")
    torch.cuda.synchronize()

    src = "src/repro_torch/csrc/redmule_matmul.cu"

    def bound(M, N, K, out_bytes, batch=1, w_batch=None):
        # FP8 operands at one byte per element; FP8 tensor-core peak
        wb = batch if w_batch is None else w_batch
        return _bound_ms(batch * M * N + wb * N * K + batch * M * K * out_bytes,
                         2 * batch * M * N * K, FP8_FLOPS)

    head_blk = tiling.accum_block(BATCH, d, V, compute_dtype=torch.float16,
                                  accum_dtype=torch.float16, x_dtype=E4,
                                  w_dtype=E4)
    return [
        dict(name="redmule_matmul (FP8 e4m3, faithful)", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_fp8"),
             paths=("serve8", "ae8", "ae8_b4096"), source=src,
             replaces="src/repro/kernels/redmule_matmul.py:289", err=err_head,
             bound=bound(BATCH, d, V, 2),
             shape="nt tied head M=4 N=2048 K=151936, e4m3 x e4m3 -> fp16, "
                   "faithful (1 block)",
             kernel=lambda: ops.redmule_matmul(x_dec, emb, policy=e4, layout="nt",
                                               accum_block=head_blk),
             plain=lambda: rm.redmule_matmul_plain(x_dec, emb, policy=e4,
                                                   layout="nt",
                                                   accum_block=head_blk),
             library=lambda: torch.matmul(x_dec.half(), emb.half().t())),
        dict(name="redmule_matmul (FP8 e5m2, fp32 accumulator)",
             group="redmule_gemm", counter=(ops.redmule_matmul, "launches_fp8"),
             paths=("ae8_e5m2",), source=src,
             replaces="src/repro/kernels/redmule_matmul.py:289", err=err_e5,
             bound=bound(B, d_in, d_h, 2),
             shape="AE fc0 forward nn M=16 N=640 K=128, e5m2 x e5m2 -> fp16",
             kernel=lambda: ops.redmule_matmul(x5, w5b, policy=e5),
             plain=lambda: rm.redmule_matmul_plain(x5, w5b, policy=e5),
             library=lambda: torch.matmul(x5.half(), w5b.half())),
        dict(name="redmule_matmul_batched (FP8 e4m3, decode scores)",
             group="redmule_gemm",
             counter=(ops.redmule_matmul_batched, "launches_fp8"),
             paths=("serve8",), source=src,
             replaces="src/repro/kernels/redmule_matmul.py:478", err=err_sc,
             bound=bound(T, hd, hq // hkv, 4, batch=BATCH * hkv),
             shape="decode scores B=32 M=144 N=128 K=2, e4m3 x e4m3 -> fp32, "
                   "fp16 accumulator",
             kernel=lambda: ops.redmule_matmul_batched(kc, qt, policy=s4),
             plain=lambda: rm.redmule_matmul_plain(kc, qt, policy=s4),
             library=lambda: torch.matmul(kc.half(), qt.half()).float()),
    ]


def _with_splits(fn):
    """``(fn(), S)``: what one call returns, and the number of slices its
    GEMM launch split the reduction into (``core/tiling.split_plan``, read
    as the launch asks for it); S is None where ``fn`` launches no GEMM."""
    from repro_torch.core import tiling

    seen = []
    plan_of = tiling.split_plan

    def record(*a, **k):
        plan = plan_of(*a, **k)
        seen.append(plan.splits)
        return plan

    tiling.split_plan = record
    try:
        out = fn()
    finally:
        tiling.split_plan = plan_of
    return out, (max(seen) if seen else None)


def split_checks(log, g):
    """The split of the reduction (kernels 1 and 2, both routes) on the
    card: the serving and training shapes it exists for, each against its
    plain version, and cases of the split itself — a last slice shorter
    than the others (N not a multiple of S x 32), the faithful accumulator
    over 3 rounding blocks of 4 slices each, an FP8 pair (still bitwise
    equal to the launch on pre-widened fp16 operands), a batched launch
    with a broadcast (stride-0) operand, the fp32 route with a ragged last
    slice.  Every launch is repeated and must be bitwise equal run to run:
    the last block of a tile sums the slices in split order, whichever
    block arrives last.  Returns the rows to time; the decode and prefill
    rows read, call after call, the next of several weight copies (more
    than the 50 MB L2 holds), as the serving step finds its weights cold.

    Tolerances: a bf16 output two ulps (2^-7 of max); fp32 1e-5 of max
    (summation order); the faithful accumulator one fp16 ulp (2^-10) per
    rounding block plus one, since each block's slices are summed in fp32
    in another order than the plain version's one dot, then rounded."""
    import itertools

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    bf, f32, paper = prec.TPU_BF16, prec.FP32, prec.PAPER_FP16
    E4 = torch.float8_e4m3fn
    ulp, tol_bf16, tol_fp32 = 2.0 ** -10, 2.0 ** -7, 1e-5

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def both(name, x, w, policy, tol, *, batched=False, split=True, **kw):
        """The launch against its plain version, and against itself run to
        run; ``split``: S must be above 1.  Returns (max_abs_err, S)."""
        fn = ops.redmule_matmul_batched if batched else ops.redmule_matmul
        got, S = _with_splits(lambda: fn(x, w, policy=policy, **kw))
        if split and S <= 1:
            raise AssertionError(f"{name}: the launch did not split (S = {S})")
        same = torch.equal(got, fn(x, w, policy=policy, **kw))
        log.append({"check": name + ": run to run", "splits": S, "bitwise": same,
                    "ok": same})
        print(f"[check] {name}: S={S}, run to run "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{name}: two launches differ")
        want = rm.redmule_matmul_plain(x, w, policy=policy, **kw)
        return _check(f"{name} (S={S})", got, want, tol, log), S

    # the last slice shorter than the others (N = 2000 in slices of 128),
    # and ragged K
    both("split gemm nn M=4 N=2000 K=1000 bf16 (ragged last slice)", rnd(4, 2000),
         rnd(2000, 1000, scale=2000 ** -0.5), bf, tol_bf16)
    # the faithful accumulator: 3 rounding blocks of 512, 4 slices each
    both("split faithful nn M=16 N=1536 K=256 +bias, 3 blocks of 512",
         rnd(16, 1536, dtype=torch.float16),
         rnd(1536, 256, dtype=torch.float16, scale=1536 ** -0.5), paper, 4 * ulp,
         bias=rnd(256, dtype=torch.float16), accum_block=512)
    # an FP8 pair on the decode wqkv: bitwise equal to the pre-widened launch
    x8 = prec.quantize_fp8(torch.randn(BATCH, 2048, generator=g, device=dev), E4)[0]
    w8 = prec.quantize_fp8(torch.randn(2048, 4096, generator=g, device=dev), E4)[0]
    blk8 = tiling.accum_block(BATCH, 2048, 4096, compute_dtype=torch.float16,
                              accum_dtype=torch.float16, x_dtype=E4, w_dtype=E4)
    e4 = prec.MIXED_FP8_E4M3
    both("split fp8 e4m3 nn decode wqkv M=4 N=2048 K=4096, faithful", x8, w8, e4,
         2 * ulp, accum_block=blk8)
    same = torch.equal(ops.redmule_matmul(x8, w8, policy=e4, accum_block=blk8),
                       ops.redmule_matmul(x8.half(), w8.half(), policy=e4,
                                          accum_block=blk8))
    log.append({"check": "split fp8 decode wqkv: FP8 == pre-widened fp16 launch",
                "bitwise": same, "ok": same})
    print(f"[check] split fp8 decode wqkv: FP8 vs pre-widened fp16 launch "
          f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
    if not same:
        raise AssertionError("split FP8 launch differs from the pre-widened one")
    # batched, w broadcast over both batch levels (stride 0)
    both("split batched nn B=2x4 M=4 N=2048 K=256 bf16, w broadcast",
         rnd(2, 4, BATCH, 2048), rnd(2048, 256, scale=2048 ** -0.5), bf, tol_bf16,
         batched=True)
    # the fp32 route: "nt", 16 slices of 64, the last holding 40 rows
    both("split fp32 nt M=30 N=1000 K=50 (ragged last slice)", rnd(30, 1000,
         dtype=torch.float32), rnd(50, 1000, dtype=torch.float32), f32, tol_fp32,
         layout="nt")

    # the rows: qwen3-1.7b's decode and prefill GEMMs (bf16), the xLSTM's
    # fp32 gates dW and sLSTM recurrence (4 heads of 512)
    d, ff, qkv = 2048, 6144, (16 + 2 * 8) * 128

    def copies(t):
        n = max(1, math.ceil(100 * 2 ** 20 / (t.numel() * t.element_size())))
        return [t] + [t.clone() for _ in range(n - 1)]

    def cycling(f, ws):
        it = itertools.cycle(ws)
        return lambda: f(next(it))

    def bf_bound(M, N, K):
        return _bound_ms((M * N + N * K + M * K) * 2, 2 * M * N * K)

    def f32_bound(M, N, K, batch=1):
        return _bound_ms(batch * (M * N + N * K + M * K) * 4, 2 * batch * M * N * K,
                         FP32_FLOPS)

    src = "src/repro_torch/csrc/redmule_matmul.cu"
    rep1 = "src/repro/kernels/redmule_matmul.py:289"
    rep2 = "src/repro/kernels/redmule_matmul.py:478"
    rows = []

    def cold_row(name, shape, M, N, K, counter, paths, split):
        x = rnd(M, N)
        ws = copies(rnd(N, K, scale=N ** -0.5))
        err, _ = both(f"gemm nn {shape}", x, ws[0], bf, tol_bf16, split=split)
        rows.append(dict(
            name=name, group="redmule_gemm", counter=counter, paths=paths,
            source=src, replaces=rep1, err=err, bound=bf_bound(M, N, K),
            shape=f"{shape} bf16, L2 cold ({len(ws)} weight copies)",
            kernel=cycling(lambda w: ops.redmule_matmul(x, w, policy=bf), ws),
            plain=cycling(lambda w: rm.redmule_matmul_plain(x, w, policy=bf), ws),
            library=cycling(lambda w: torch.matmul(x, w), ws)))

    split1 = (ops.redmule_matmul, "launches_split")
    split2 = (ops.redmule_matmul_batched, "launches_split")
    cold_row("redmule_matmul (split, decode w_out)", "decode w_out M=4 N=6144 K=2048",
             BATCH, ff, d, split1, ("serve", "serve8"), True)
    cold_row("redmule_matmul (split, decode wqkv)", "decode wqkv M=4 N=2048 K=4096",
             BATCH, d, qkv, split1, ("serve", "serve8"), True)
    cold_row("redmule_matmul (ring, prefill w_in)", "prefill w_in M=128 N=2048 K=12288",
             PROMPT, d, 2 * ff, (ops.redmule_matmul, "launches"), ("serve",), False)
    xg, dzg = rnd(T_BATCH * T_SEQ, 4096, dtype=torch.float32), rnd(
        T_BATCH * T_SEQ, 8, dtype=torch.float32)
    err, _ = both("split fp32 tn gates dW M=4096 N=1024 K=8", xg, dzg, f32, tol_fp32,
                  layout="tn")
    rows.append(dict(
        name="redmule_matmul (fp32 route, split, gates dW)", group="redmule_gemm_f32",
        counter=split1, paths=("train",), source=src, replaces=rep1, err=err,
        bound=f32_bound(4096, T_BATCH * T_SEQ, 8),
        shape="mLSTM gates dW tn M=4096 N=1024 K=8 fp32",
        kernel=lambda: ops.redmule_matmul(xg, dzg, policy=f32, layout="tn"),
        plain=lambda: rm.redmule_matmul_plain(xg, dzg, policy=f32, layout="tn"),
        library=lambda: torch.matmul(xg.t(), dzg)))
    h, r = rnd(4, T_BATCH, 512, dtype=torch.float32), rnd(4, 512, 2048,
                                                          dtype=torch.float32,
                                                          scale=512 ** -0.5)
    dzr = rnd(4, T_BATCH, 2048, dtype=torch.float32)
    err_h, _ = both("split batched fp32 nn sLSTM recurrence B=4 M=4 N=512 K=2048",
                    h, r, f32, tol_fp32, batched=True)
    err_i, _ = both("split batched fp32 nt sLSTM dX B=4 M=4 N=2048 K=512",
                    dzr, r, f32, tol_fp32, batched=True, layout="nt")
    rows += [
        dict(name="redmule_matmul_batched (fp32 route, split, sLSTM recurrence)",
             group="redmule_gemm_f32", counter=split2, paths=("train",), source=src,
             replaces=rep2, err=err_h, bound=f32_bound(T_BATCH, 512, 2048, 4),
             shape="sLSTM recurrence nn B=4 M=4 N=512 K=2048 fp32",
             kernel=lambda: ops.redmule_matmul_batched(h, r, policy=f32),
             plain=lambda: rm.redmule_matmul_plain(h, r, policy=f32),
             library=lambda: torch.matmul(h, r)),
        dict(name="redmule_matmul_batched (fp32 route, split, sLSTM dX)",
             group="redmule_gemm_f32", counter=split2, paths=("train",), source=src,
             replaces=rep2, err=err_i, bound=f32_bound(T_BATCH, 2048, 512, 4),
             shape="sLSTM recurrence dX nt B=4 M=4 N=2048 K=512 fp32",
             kernel=lambda: ops.redmule_matmul_batched(dzr, r, policy=f32, layout="nt"),
             plain=lambda: rm.redmule_matmul_plain(dzr, r, policy=f32, layout="nt"),
             library=lambda: torch.matmul(dzr, r.transpose(-1, -2)))]
    torch.cuda.synchronize()
    return rows


def kernel_phase(log):
    """Each kernel vs its plain version at the main path's shapes; times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import precision as prec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, pol = torch.bfloat16, prec.TPU_BF16
    torch.backends.cuda.matmul.allow_tf32 = False    # the fp32 plain versions
    scores = prec.Policy("tpu_bf16_scores", bf16, torch.float32, torch.float32)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    # bf16 outputs: both sides sum the same bf16 products in fp32 and differ
    # only in order, but the final bf16 rounding may then differ by one ulp
    # (2^-8 relative): allow two ulps at the top of the range.  fp32 outputs
    # (decode scores): summation order only, N = 128 terms.
    tol_bf16, tol_f32 = 2.0 ** -7, 1e-4

    def gemm(name, x, w, layout, policy=pol, bias=None, epilogue=None,
             tol=tol_bf16):
        got = ops.redmule_matmul(x, w, policy=policy, layout=layout,
                                 bias=bias, epilogue=epilogue)
        want = rm.redmule_matmul_plain(x, w, policy=policy, layout=layout,
                                       bias=bias, epilogue=epilogue)
        return _check(name, got, want, tol, log)

    d, V, ff, hq, hkv, hd = 2048, 151936, 6144, 16, 8, 128
    T = PROMPT + GEN
    # kernel 1: the tied head ("nt"), the decode and prefill projections
    x_dec, emb = rnd(BATCH, d), rnd(V, d, scale=0.02)
    err_head = gemm("gemm nt tied head M=4 N=2048 K=151936", x_dec, emb, "nt")
    gemm("gemm nn wqkv decode M=4 N=2048 K=4096", x_dec,
         rnd(d, (hq + 2 * hkv) * hd, scale=d ** -0.5), "nn")
    gemm("gemm nn w_in prefill M=128 N=2048 K=12288", rnd(PROMPT, d),
         rnd(d, 2 * ff, scale=d ** -0.5), "nn")
    gemm("gemm nn w_out prefill M=128 N=6144 K=2048", rnd(PROMPT, ff),
         rnd(ff, d, scale=ff ** -0.5), "nn")
    gemm("gemm tn M=100 N=300 K=72", rnd(300, 100), rnd(300, 72), "tn")
    gemm("gemm nn bias+gelu M=77 N=200 K=130", rnd(77, 200), rnd(200, 130),
         "nn", bias=torch.randn(130, generator=g, device=dev),
         epilogue="gelu")
    # fp16 operands and output (tpu_fp16): one fp16 ulp is 2^-10 relative
    gemm("gemm nt fp16 bias+silu M=33 N=96 K=40", rnd(33, 96).half(),
         rnd(40, 96).half(), "nt", policy=prec.TPU_FP16,
         bias=torch.randn(40, generator=g, device=dev), epilogue="silu",
         tol=2.0 ** -9)

    # kernel 2: the ragged decode scores (fp32 out) and the decode PV with V
    # broadcast over the two q heads of each KV head (batch stride 0)
    kc = rnd(BATCH * hkv, T, hd)
    qt = rnd(BATCH * hkv, hd, hq // hkv)
    got = ops.redmule_matmul_batched(kc, qt, policy=scores)
    _check("batched scores B=32 M=144 N=128 K=2 (fp32 out)", got,
           rm.redmule_matmul_plain(kc, qt, policy=scores), tol_f32, log)
    p = torch.softmax(torch.randn(BATCH, hkv, hq // hkv, 1, T, generator=g,
                                  device=dev), -1).to(bf16)
    v = rnd(BATCH, hkv, 1, T, hd)
    err_pv = _check("batched PV B=4x8x2 M=1 N=144 K=128 (V broadcast)",
                    ops.redmule_matmul_batched(p, v, policy=pol),
                    rm.redmule_matmul_plain(p, v, policy=pol), tol_bf16, log)

    # kernel 3: prefill flash (16 / 8 heads, D = 128, S = 128 in a T = 144
    # cache), and a continuation at q_offset > 0
    q, k, vv = rnd(hq, PROMPT, hd), rnd(hkv, T, hd), rnd(hkv, T, hd)
    fl = dict(group=hq // hkv, t_valid=PROMPT, q_offset=0)
    err_fl = _check("flash Hq=16 Hkv=8 D=128 S=128 T=144 q_offset=0",
                    fa.flash_attention(q, k, vv, **fl),
                    fa.flash_attention_plain(q, k, vv, **fl), tol_bf16, log)
    q2 = rnd(hq, GEN, hd)
    fl2 = dict(group=hq // hkv, t_valid=T, q_offset=PROMPT)
    _check("flash Hq=16 Hkv=8 D=128 S=16 T=144 q_offset=128",
           fa.flash_attention(q2, k, vv, **fl2),
           fa.flash_attention_plain(q2, k, vv, **fl2), tol_bf16, log)
    # the other compiled variants: fp16, D = 64, non-causal, ragged S / T
    q3, k3, v3 = (rnd(8, 100, 64).half(), rnd(4, 130, 64).half(),
                  rnd(4, 130, 64).half())
    for causal in (True, False):
        fl3 = dict(group=2, causal=causal, t_valid=120, q_offset=10)
        _check(f"flash fp16 Hq=8 Hkv=4 D=64 S=100 T=130 causal={causal}",
               fa.flash_attention(q3, k3, v3, **fl3),
               fa.flash_attention_plain(q3, k3, v3, **fl3), 2.0 ** -9, log)

    # the fp32 route of kernels 1 and 2 (SIMT fp32 FMAs, no TF32): fp32 sums
    # in another order, N <= 1024 terms
    from repro_torch.kernels import chunked_linear_attention as cla

    f32, tol_fp32 = prec.FP32, 1e-5

    def rnd32(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x_gate, w_gate = rnd32(T_BATCH * T_SEQ, 4096), rnd32(4096, 8, scale=4096 ** -0.5)
    err_g32 = _check("gemm fp32 nn mLSTM gates M=1024 N=4096 K=8",
                     ops.redmule_matmul(x_gate, w_gate, policy=f32),
                     rm.redmule_matmul_plain(x_gate, w_gate, policy=f32),
                     tol_fp32, log)
    dz_gate = rnd32(T_BATCH * T_SEQ, 8)
    _check("gemm fp32 nt gates dX M=1024 N=8 K=4096",
           ops.redmule_matmul(dz_gate, w_gate, policy=f32, layout="nt"),
           rm.redmule_matmul_plain(dz_gate, w_gate, policy=f32, layout="nt"),
           tol_fp32, log)
    _check("gemm fp32 tn gates dW M=4096 N=1024 K=8",
           ops.redmule_matmul(x_gate, dz_gate, policy=f32, layout="tn"),
           rm.redmule_matmul_plain(x_gate, dz_gate, policy=f32, layout="tn"),
           tol_fp32, log)
    xr, wr = rnd32(77, 200), rnd32(200, 130)
    _check("gemm fp32 nn ragged M=77 N=200 K=130",
           ops.redmule_matmul(xr, wr, policy=f32),
           rm.redmule_matmul_plain(xr, wr, policy=f32), tol_fp32, log)
    # batched: the sweep backward's inter-chunk read (16 heads, 64 x 1024 x
    # 1024), its dX / dW layouts, and the sLSTM recurrence (4 heads)
    BH, C, DK = T_BATCH * 4, 64, 1024
    qe, st = rnd32(BH, C, DK), rnd32(BH, DK, DK, scale=DK ** -0.5)
    err_b32 = _check("batched fp32 nn inter B=16 M=64 N=1024 K=1024",
                     ops.redmule_matmul_batched(qe, st, policy=f32),
                     rm.redmule_matmul_plain(qe, st, policy=f32), tol_fp32, log)
    do = rnd32(BH, C, DK)
    _check("batched fp32 nt inter dX B=16 M=64 N=1024 K=1024",
           ops.redmule_matmul_batched(do, st, policy=f32, layout="nt"),
           rm.redmule_matmul_plain(do, st, policy=f32, layout="nt"), tol_fp32, log)
    _check("batched fp32 tn inter dW B=16 M=1024 N=64 K=1024",
           ops.redmule_matmul_batched(qe, do, policy=f32, layout="tn"),
           rm.redmule_matmul_plain(qe, do, policy=f32, layout="tn"), tol_fp32, log)
    h_s, r_s = rnd32(4, T_BATCH, 512), rnd32(4, 512, 2048, scale=512 ** -0.5)
    _check("batched fp32 nn sLSTM recurrence B=4 M=4 N=512 K=2048",
           ops.redmule_matmul_batched(h_s, r_s, policy=f32),
           rm.redmule_matmul_plain(h_s, r_s, policy=f32), tol_fp32, log)

    # kernel 4: the training shape (16 (batch, head) pairs, S 256, dk = dv =
    # 1024, chunk 64, bf16), a ragged dk != dv shape at chunk 16, fp32 input.
    # fp32 inside; the state (fp32) differs in summation order over up to
    # 4 x 64 x 1024 terms (1e-4); the output is stored in the input dtype
    # (bf16: one-ulp flips, 2^-7).
    def sweep(BH_, S_, dk_, dv_, dtype):
        q = (torch.randn(BH_, S_, dk_, generator=g, device=dev) * dk_ ** -0.5).to(dtype)
        k = (torch.randn(BH_, S_, dk_, generator=g, device=dev) * 0.5).to(dtype)
        v = torch.randn(BH_, S_, dv_, generator=g, device=dev).to(dtype)
        lg = -torch.rand(BH_, S_, generator=g, device=dev) * 0.1
        return q, k, v, lg

    cla_cases = [("train BH=16 S=256 dk=dv=1024 chunk=64 bf16",
                  (BH, T_SEQ, DK, DK, torch.bfloat16), 64),
                 ("ragged BH=6 S=48 dk=16 dv=64 chunk=16 bf16",
                  (6, 48, 16, 64, torch.bfloat16), 16),
                 ("fp32 BH=4 S=256 dk=96 dv=40 chunk=128",
                  (4, 256, 96, 40, torch.float32), 128),
                 ("fp16 BH=3 S=64 dk=64 dv=64 chunk=32",
                  (3, 64, 64, 64, torch.float16), 32)]
    cla_in = None
    for name, shape, chunk in cla_cases:
        ins = sweep(*shape)
        out, state = cla.chunked_linear_attention(*ins, chunk=chunk)
        want_o, want_s = cla.chunked_linear_attention_plain(*ins, chunk=chunk)
        tol_o = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9,
                 torch.float32: 1e-4}[shape[-1]]
        err = _check(f"sweep {name} out", out, want_o, tol_o, log)
        _check(f"sweep {name} state", state, want_s, 1e-4, log)
        if cla_in is None:
            cla_in, err_cla = ins, err
    torch.cuda.synchronize()

    # times at one main-path shape per kernel
    head_b, head_f = _bound_ms((BATCH * d + V * d + BATCH * V) * 2, 2 * BATCH * d * V)
    pv_b, pv_f = _bound_ms(p.numel() * 2 + BATCH * hkv * T * hd * 2
                           + BATCH * hq * hd * 2, 2 * BATCH * hq * T * hd)
    rows = torch.arange(PROMPT)
    pairs = int(torch.clamp(rows + 1, max=PROMPT).sum())
    fl_b, fl_f = _bound_ms((2 * hq * PROMPT * hd + 2 * hkv * PROMPT * hd) * 2,
                           4 * hq * pairs * hd)
    q4, k4, v4 = q[None], k[None, :, :PROMPT], vv[None, :, :PROMPT]
    # kernel 4's bound at the training shape: q, k, v, g read once, out and
    # the fp32 state written once; the causal score / PV pairs plus the
    # inter-chunk read and state update, all fp32 FMAs
    BHc, Sc, dkc, dvc = cla_in[0].shape[0], T_SEQ, DK, DK
    n_ch, pairs_c = Sc // 64, 64 * 65 // 2
    cla_b, cla_f = _bound_ms(
        2 * BHc * Sc * dkc * 2 + 2 * BHc * Sc * dvc * 2 + BHc * Sc * 4
        + BHc * dkc * dvc * 4,
        BHc * n_ch * (2 * pairs_c * (dkc + dvc) + 4 * 64 * dkc * dvc), FP32_FLOPS)
    g32_b, g32_f = _bound_ms((x_gate.numel() + w_gate.numel()
                              + T_BATCH * T_SEQ * 8) * 4,
                             2 * T_BATCH * T_SEQ * 4096 * 8, FP32_FLOPS)
    b32_b, b32_f = _bound_ms((qe.numel() + st.numel() + qe.numel()) * 4,
                             2 * BH * C * DK * DK, FP32_FLOPS)
    torch.backends.cuda.matmul.allow_tf32 = False    # full-fp32 yardsticks
    # fp16 yardsticks accumulate in fp32 and round once (the faithful
    # accumulator's function where the reduction is one block)
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    runs = [
        dict(name="redmule_matmul", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:289",
             shape="nt tied head M=4 N=2048 K=151936 bf16", err=err_head,
             bound=(head_b, head_f),
             kernel=lambda: ops.redmule_matmul(x_dec, emb, policy=pol, layout="nt"),
             plain=lambda: rm.redmule_matmul_plain(x_dec, emb, policy=pol, layout="nt"),
             library=lambda: torch.matmul(x_dec, emb.t())),
        dict(name="redmule_matmul_batched", group="redmule_gemm",
             counter=(ops.redmule_matmul_batched, "launches"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:478",
             shape="decode PV B=4x8x2 M=1 N=144 K=128 bf16, V broadcast",
             err=err_pv, bound=(pv_b, pv_f),
             kernel=lambda: ops.redmule_matmul_batched(p, v, policy=pol),
             plain=lambda: rm.redmule_matmul_plain(p, v, policy=pol),
             library=lambda: torch.matmul(p, v)),
        dict(name="flash_attention", group="flash_fwd",
             counter=(fa.flash_attention, "launches"),
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:102",
             shape="prefill Hq=16 Hkv=8 D=128 S=128 T=144 t_valid=128 bf16",
             err=err_fl, bound=(fl_b, fl_f),
             kernel=lambda: fa.flash_attention(q, k, vv, **fl),
             plain=lambda: fa.flash_attention_plain(q, k, vv, **fl),
             library=lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, is_causal=True, enable_gqa=True)),
        dict(name="chunked_linear_attention", group="chunked_linear_attention",
             counter=(cla.chunked_linear_attention, "launches"),
             source="src/repro_torch/csrc/chunked_linear_attention.cu",
             replaces="src/repro/kernels/chunked_linear_attention.py:79",
             shape="train BH=16 S=256 dk=dv=1024 chunk=64 bf16", err=err_cla,
             bound=(cla_b, cla_f),
             kernel=lambda: cla.chunked_linear_attention(*cla_in, chunk=64),
             plain=lambda: cla.chunked_linear_attention_plain(*cla_in, chunk=64),
             library=None),            # no single PyTorch call computes it
        dict(name="redmule_matmul (fp32 route)", group="redmule_gemm_f32",
             counter=(ops.redmule_matmul, "launches_fp32"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:289",
             shape="nn mLSTM gates M=1024 N=4096 K=8 fp32", err=err_g32,
             bound=(g32_b, g32_f),
             kernel=lambda: ops.redmule_matmul(x_gate, w_gate, policy=f32),
             plain=lambda: rm.redmule_matmul_plain(x_gate, w_gate, policy=f32),
             library=lambda: torch.matmul(x_gate, w_gate)),
        dict(name="redmule_matmul_batched (fp32 route)", group="redmule_gemm_f32",
             counter=(ops.redmule_matmul_batched, "launches_fp32"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:478",
             shape="nn sweep inter read B=16 M=64 N=1024 K=1024 fp32",
             err=err_b32, bound=(b32_b, b32_f),
             kernel=lambda: ops.redmule_matmul_batched(qe, st, policy=f32),
             plain=lambda: rm.redmule_matmul_plain(qe, st, policy=f32),
             library=lambda: torch.matmul(qe, st)),
    ]
    runs += kernel1_mode_checks(log, g)
    runs += fp8_kernel_checks(log, g)
    runs += split_checks(log, g)
    kernels = []
    for r in runs:
        # ms: CUDA events around back-to-back calls (host launch cost
        # included where it exceeds the kernel); device_ms: the kernel
        # alone, from the profiler; splits: the slices S of the call
        _, splits = _with_splits(r["kernel"])
        prof = _device_profile(r["kernel"], 10)["by_kernel"]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "shape": r["shape"],
            "max_abs_err": r["err"], "ms": _time_ms(r["kernel"]),
            "plain_ms": _time_ms(r["plain"]), "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": None if r["library"] is None else _time_ms(r["library"]),
            "device_ms": prof[r["group"]]["ms"], "splits": splits})
        print(f"[time] {r['name']} ({r['shape']}): {kernels[-1]['ms']:.4f} ms, "
              f"device {kernels[-1]['device_ms']:.4f} ms, plain "
              f"{kernels[-1]['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), library {kernels[-1]['library_ms']}, "
              f"S={splits}", flush=True)
    counters = {r["name"]: r["counter"] for r in runs}
    counters.update(_split_counters(ops))
    return kernels, counters, \
        {r["name"]: r["paths"] for r in runs if "paths" in r}


def _split_counters(ops):
    """The GEMM wrappers' counts of launches that split their reduction,
    reported per path beside the kernels' rows."""
    return {"split launches: redmule_matmul": (ops.redmule_matmul, "launches_split"),
            "split launches: redmule_matmul_batched":
                (ops.redmule_matmul_batched, "launches_split")}


def _zero(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def _require(launches: dict, names, path: str) -> None:
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def serve_phase(log, counters):
    """The serving path through its entry point, with launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    _zero(counters)
    t0 = time.perf_counter()
    seqs = serve.main(["--arch", ARCH, "--full", "--batch", str(BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN),
                       "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _read(counters)
    print(f"[serve] launches on the main path: {launches}", flush=True)
    cfg = configs.get(ARCH)
    if seqs.shape != (BATCH, PROMPT + GEN):
        raise AssertionError(f"generate returned shape {seqs.shape}")
    if not ((seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    _require(launches, ("redmule_matmul", "redmule_matmul_batched",
                        "flash_attention"), "serve")

    # one prefill and one decode step at the same shapes, CUDA-event timed
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device="cuda")
    logits, _ = transformer.prefill(params, cfg, {"inputs": prompt}, PROMPT + GEN)
    prefill_ms = _time_ms(lambda: transformer.prefill(
        params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=10, warmup=2)
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen, device="cuda")
    pos = torch.full((BATCH,), PROMPT, device="cuda")
    sizes = np.full((BATCH,), PROMPT + 1, np.int32)

    def decode():
        return transformer.serve_step(params, cfg, toks, cache, pos,
                                      kv_group_sizes=sizes)

    dec_logits, _ = decode()
    decode_ms = _time_ms(decode, iters=20, warmup=2)
    for name, t in (("prefill", logits), ("decode", dec_logits)):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name} logits are not finite")
    print(f"[serve] generate {BATCH}x({PROMPT}+{GEN}) {serve_s:.3f}s wall; "
          f"prefill(1x{PROMPT}) {prefill_ms:.3f} ms; decode step (B={BATCH}) "
          f"{decode_ms:.3f} ms", flush=True)
    profiles = {
        "prefill": _device_profile(lambda: transformer.prefill(
            params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=3),
        "decode_step": _device_profile(decode, iters=5)}
    for name, prof in profiles.items():
        parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                          for k, g in sorted(prof["by_kernel"].items()))
        print(f"[profile] {name}: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}): "
              f"{parts}", flush=True)
    del params

    # small input: a two-layer cut at full width, card vs the CPU plain path
    small = dataclasses.replace(cfg, n_layers=2)
    pc = transformer.init_params(small, seed=SEED + 1, device="cuda")
    pcpu = _to_cpu(pc)
    sp = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device="cuda")
    got, _ = transformer.prefill(pc, small, {"inputs": sp}, 24)
    want, _ = transformer.prefill(pcpu, small, {"inputs": sp.cpu()}, 24)
    # two bf16 layers: per-GEMM one-ulp rounding flips (2^-8) compound over
    # ~10 rounded stages; a broken kernel is off by O(1)
    _check("two-layer prefill logits, card vs CPU plain", got.cpu(), want,
           2.0 ** -4, log)
    return {"serve_wall_s": serve_s, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms, "launches": launches,
            "profiles": profiles}


def train_phase(log, counters):
    """The training path through its entry point, with launch counts; one
    profiled step; one full-width super-block against the CPU plain path."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import layers, transformer
    from repro_torch.optim import AdamW, tree_map

    cfg = configs.get(T_ARCH)
    n_mlstm = cfg.n_layers // cfg.ssm.slstm_period * (cfg.ssm.slstm_period - 1)
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.main(["--arch", T_ARCH, "--full", "--batch", str(T_BATCH),
                      "--seq", str(T_SEQ), "--steps", str(T_STEPS),
                      "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _read(counters)
    peak_main = torch.cuda.max_memory_allocated()
    print(f"[train] launches on the main path: {launches}", flush=True)
    hist = out["history"]
    if len(hist) != T_STEPS or not all(math.isfinite(h["loss"])
                                       and math.isfinite(h["grad_norm"])
                                       for h in hist):
        raise AssertionError(f"non-finite or missing steps: {hist}")
    # one sweep per mLSTM block per forward, and again when the remat
    # region of each super-block recomputes in the backward
    structural = T_STEPS * n_mlstm * (2 if cfg.remat == "full" else 1)
    print(f"[train] sweep launches {launches['chunked_linear_attention']}, "
          f"structural {structural} ({T_STEPS} steps x {n_mlstm} mLSTM blocks "
          f"x 2 for remat)", flush=True)
    if launches["chunked_linear_attention"] != structural:
        raise AssertionError("sweep kernel launches differ from the structural count")
    _require(launches, ("redmule_matmul", "redmule_matmul_batched",
                        "chunked_linear_attention", "redmule_matmul (fp32 route)",
                        "redmule_matmul_batched (fp32 route)"), "train")
    for h in hist:
        print(f"[train] step {h['step']}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} step {h['step_ms']:.1f} ms", flush=True)

    # one profiled step after a warm-up step, with its peak memory
    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = train.build_train_step(cfg, opt)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=T_SEQ,
                     global_batch=T_BATCH, seed=SEED)
    holder = [train.init_state(cfg, opt, seed=SEED, device="cuda")]
    # the warm-up step also tallies the fp32 route's dispatches by shape,
    # each timed alone before the step's profile (after a profile of ~200k
    # kernels the profiler records no device time for a while)
    fp32_shapes = _fp32_shapes(lambda: step(holder[0], ds.batch(0)))
    holder[0], _ = fp32_shapes.pop("result")
    by_shape = _fp32_by_shape(fp32_shapes["tally"])

    def one_step():
        holder[0], m = step(holder[0], ds.batch(1))
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = _device_profile(one_step, iters=1)
    peak_step = torch.cuda.max_memory_allocated()
    del holder, step
    torch.cuda.empty_cache()
    parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    print(f"[profile] train step: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms (idle {prof['idle_share']:.3f}), peak "
          f"{peak_step / 2**30:.2f} GiB: {parts}", flush=True)

    # one full-width super-block, batch 1 x seq 128: card vs the CPU plain
    # path, under the fp32 policy (every GEMM on the fp32 route, the sweep on
    # fp32 inputs) and under the training policy (bf16).  The gradients are
    # ill-conditioned: the sLSTM stabilizer's max(log f + m, i) and
    # max(|n|, 1) switch branch under rounding noise, so two correct
    # summation orders disagree far above one rounding.  The run measures
    # that spread itself — the CPU plain path with one thread against all
    # threads (another BLAS blocking, another summation order) — and holds
    # the card to 8x it, above a floor of one rounding's worth (fp32 1e-5,
    # bf16 2^-8); a broken kernel is off by O(1).
    n_threads = torch.get_num_threads()
    for policy, floor in (("fp32", 1e-5), (cfg.policy_name, 2.0 ** -8)):
        small = dataclasses.replace(cfg, n_layers=cfg.ssm.slstm_period,
                                    policy_name=policy)
        p_cpu = layers.init_tree(transformer._xlstm_super_schema(small),
                                 seed=SEED + 2, device=torch.device("cpu"),
                                 dtype=torch.float32)
        p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
        gen = torch.Generator().manual_seed(SEED + 3)
        h0 = torch.randn(1, 128, cfg.d_model, generator=gen).to(
            small.policy.compute_dtype)
        proj = torch.randn(1, 128, cfg.d_model, generator=gen)

        def block_grads(p, h, r):
            wrt = [p["mlstm"]["cell"]["w_up"], p["mlstm"]["cell"]["w_qkv"],
                   p["slstm"]["cell"]["r_gates"]]
            wrt = [t.detach().requires_grad_(True) for t in wrt]
            q = {"mlstm": {**p["mlstm"], "cell": {**p["mlstm"]["cell"],
                                                  "w_up": wrt[0], "w_qkv": wrt[1]}},
                 "slstm": {**p["slstm"], "cell": {**p["slstm"]["cell"],
                                                  "r_gates": wrt[2]}}}
            y = transformer._xlstm_super_block(q, h, small, policy=small.policy)
            loss = (y.float() * r).mean()
            return [loss.detach()] + [g.detach() for g in
                                      torch.autograd.grad(loss, wrt)]

        got = block_grads(p_gpu, h0.cuda(), proj.cuda())
        want = block_grads(p_cpu, h0, proj)
        torch.set_num_threads(1)
        try:
            want_1t = block_grads(p_cpu, h0, proj)
        finally:
            torch.set_num_threads(n_threads)
        failed = []
        for name, a_, b_, c_ in zip(
                ("loss", "grad w_up", "grad w_qkv", "grad r_gates"), got, want,
                want_1t):
            scale = max(b_.abs().max().item(), 1e-30)
            spread = (c_ - b_).abs().max().item() / scale
            print(f"[train] super-block {policy} {name}: CPU spread (1 vs "
                  f"{n_threads} threads) {spread:.3e} of max", flush=True)
            try:
                _check(f"super-block (7 mLSTM + 1 sLSTM, 1x128, {policy}) {name}, "
                       "card vs CPU plain", a_.cpu(), b_, max(8 * spread, floor), log)
            except AssertionError as e:
                failed.append(str(e))
        if failed:
            raise AssertionError("; ".join(failed))
        del p_gpu, p_cpu
    step_ms = [h["step_ms"] for h in hist]
    return {"train_wall_s": train_s, "history": hist, "step_ms": step_ms,
            "launches": launches, "structural_sweeps": structural,
            "fp32_route_by_shape": by_shape,
            "peak_mem_main_gib": peak_main / 2**30,
            "peak_mem_step_gib": peak_step / 2**30, "profile": prof,
            "params": out["params"]}


def _fp32_shapes(run):
    """``{"result": run(), "tally": {...}}``: the fp32 GEMM launches that one
    ``run()`` makes, counted by (wrapper, layout, batch, M, N, K, fused
    backward) where the wrappers hand them to the kernel
    (``kernels/redmule_matmul.py::launch``)."""
    import torch

    from repro_torch.kernels import redmule_matmul as rm

    tally: dict = {}
    launch = rm.launch

    def counted(x, w, **kw):
        if x.dtype == torch.float32:
            layout = kw["layout"]
            M, N, K = rm.logical_dims(x.shape, w.shape, layout)
            batch = math.prod(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
            name = ("redmule_matmul" if x.ndim == w.ndim == 2
                    else "redmule_matmul_batched")
            key = (name, layout, batch, M, N, K,
                   bool(kw.get("bias_grad") or kw.get("grad_epilogue")))
            tally[key] = tally.get(key, 0) + 1
        return launch(x, w, **kw)

    rm.launch = counted
    try:
        result = run()
    finally:
        rm.launch = launch
    return {"result": result, "tally": tally}


def _fp32_by_shape(tally):
    """Each tallied fp32 GEMM shape timed alone on the card (device time of
    the kernel on contiguous random operands of that shape; a fused
    backward as db on "tn", act' on "nt"), times its count: where the fp32
    route's time in a training step goes.  Printed largest first; returns
    the rows."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.kernels import ops

    rows = []
    for (name, layout, batch, M, N, K, fused), n in tally.items():
        x_shape = (N, M) if layout == "tn" else (M, N)
        w_shape = (K, N) if layout == "nt" else (N, K)
        lead = (batch,) if name == "redmule_matmul_batched" else ()
        x = torch.randn(*lead, *x_shape, device="cuda")
        w = torch.randn(*lead, *w_shape, device="cuda")
        fn = getattr(ops, name)
        kw = {}
        if fused:  # "tn": dW + db; "nt": dX with act' on dZ
            kw = ({"bias_grad": True} if layout == "tn" else
                  {"deriv": torch.randn_like(x), "grad_epilogue": "relu"})
        ms = _device_profile(lambda: fn(x, w, policy=prec.FP32, layout=layout, **kw),
                             10)["by_kernel"]["redmule_gemm_f32"]["ms"]
        tile = tiling.choose_tiles(M, N, K)
        S = tiling.split_plan(M, N, K, tile=tile, batch=batch, route="simt",
                              fused_bwd=fused).splits
        rows.append({"wrapper": name, "layout": layout, "batch": batch, "M": M,
                     "N": N, "K": K, "fused_bwd": fused, "splits": S,
                     "launches": n, "ms": ms, "total_ms": n * ms})
    rows.sort(key=lambda r: -r["total_ms"])
    total = sum(r["total_ms"] for r in rows)
    print(f"[train] fp32 route by shape (each shape timed alone x its launches "
          f"in one step): {total:.1f} ms in {sum(r['launches'] for r in rows)} "
          f"launches", flush=True)
    for r in rows[:12]:
        print(f"[train]   {r['wrapper']} {r['layout']} {r['batch']} x ({r['M']} x "
              f"{r['N']} x {r['K']}){' +db' if r['fused_bwd'] else ''} S={r['splits']}: "
              f"{r['launches']} x {r['ms']:.4f} ms = {r['total_ms']:.1f} ms", flush=True)
    return rows


def _ae_relabeled(params, seed: int):
    """The same AutoEncoder with its hidden units renumbered: the same
    function, another summation order in every GEMM after the first.
    Returns the tree and a map of its gradients back to the original
    labels."""
    import torch

    from repro_torch.models import autoencoder

    dims = autoencoder.AE_DIMS
    gen = torch.Generator().manual_seed(seed)
    perms = ([torch.arange(dims[0])]
             + [torch.randperm(d, generator=gen) for d in dims[1:-1]]
             + [torch.arange(dims[-1])])

    def relabel(tree, inverse=False):
        out = {}
        for i in range(len(dims) - 1):
            pi, po = perms[i], perms[i + 1]
            if inverse:
                pi, po = torch.argsort(pi), torch.argsort(po)
            out[f"fc{i}"] = {k: (v[pi][:, po] if k == "w" else v[po])
                             for k, v in tree[f"fc{i}"].items()}
        return out

    return relabel(params), lambda g: relabel(g, inverse=True)


def _ae_step_parity(log, batch: int):
    """One paper_fp16 step (loss and gradients) at ``batch``, the card
    against the CPU plain path, from the same parameters and data.

    The held bounds are the CPU parity's (loss 1e-3 relative, gradients
    2e-2 of the largest |g|) or 8x the spread that two correct summation
    orders show on this step, measured here: the CPU plain path on the same
    network with its hidden units renumbered.  BatchNorm over columns of
    nearly equal values makes the gradients ill-conditioned in fp16 (a
    one-ulp flip in an activation moves them by percents)."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.launch import train
    from repro_torch.models import autoencoder
    from repro_torch.optim import tree_leaves, tree_map

    params = autoencoder.init_ae(seed=SEED + 4, device="cpu")
    x = torch.from_numpy(SyntheticAE(batch=batch, seed=SEED).sample(1))

    def run(tree, dev):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), tree)
        loss, g = train.ae_grads(p, x.to(dev), prec.PAPER_FP16)
        return loss.cpu(), tree_map(lambda t: t.detach().cpu(), g)

    flat = lambda g: torch.cat([t.float().flatten() for t in tree_leaves(g)])
    loss_gpu, g_gpu = run(params, "cuda")
    loss_cpu, g_cpu = run(params, "cpu")
    alt, back = _ae_relabeled(params, SEED + 5)
    loss_alt, g_alt = run(alt, "cpu")
    g_alt = back(g_alt)
    spread_loss = abs(float(loss_alt - loss_cpu)) / abs(float(loss_cpu))
    spread_g = float((flat(g_alt) - flat(g_cpu)).abs().max()
                     / flat(g_cpu).abs().max())
    print(f"[ae] step parity B={batch}: CPU spread (hidden units renumbered) "
          f"loss {spread_loss:.3e}, grads {spread_g:.3e} of max", flush=True)
    err_l = _check(f"AE step B={batch} loss, card vs CPU plain", loss_gpu,
                   loss_cpu, max(1e-3, 8 * spread_loss), log)
    err_g = _check(f"AE step B={batch} grads, card vs CPU plain", flat(g_gpu),
                   flat(g_cpu), max(2e-2, 8 * spread_g), log)
    return {"batch": batch, "loss_err": err_l, "grad_err": err_g,
            "spread_loss": spread_loss, "spread_grad": spread_g}


def _ae8_step_parity(log, batch: int):
    """One mixed_fp8_e4m3 step (loss and gradients) at ``batch``, the card
    against the CPU plain path, from the same parameters and data.

    Renumbering hidden units (the paper_fp16 spread) moves nothing here:
    the FP8 products sum exactly.  What moves the step is BatchNorm's fp32
    reductions over the batch (its statistics, and their sums in the
    backward): another summation order there moves an activation or a
    cotangent across an E4M3 / E5M2 rounding boundary, and at large batch
    that moves the gradients by percents of their max.  So the step is held
    twice, each time beside two controls that must fail the same bound
    (on the CPU: the batch with its last row dropped, and E5M2 operands in
    place of E4M3):

    * with BatchNorm in float64 on both sides (``stats_dtype``), which
      makes those reductions order-independent: the gradients within
      ``AE8_STATS_TOL`` of max;
    * as the path runs it (fp32 statistics): within max(2e-2, 1.25x) the
      spread that the same batch with its rows shuffled inside each dW
      rounding block shows, measured here on the card and on the CPU (the
      same function: BatchNorm, the loss and each rounding block see the
      same rows).

    The loss is held to 1e-3 relative throughout."""
    import dataclasses

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.data import SyntheticAE
    from repro_torch.models import autoencoder
    from repro_torch.optim import tree_leaves, tree_map

    pol = prec.MIXED_FP8_E4M3
    wrong = dataclasses.replace(pol, x_dtype=torch.float8_e5m2,
                                w_dtype=torch.float8_e5m2)
    params = autoencoder.init_ae(seed=SEED + 4, device="cpu")
    names = [f"{layer}.{k}" for layer, leaves in params.items() for k in leaves]
    x = torch.from_numpy(SyntheticAE(batch=batch, seed=SEED).sample(1))
    dims = autoencoder.AE_DIMS
    blk = min(tiling.accum_block(dims[i], batch, dims[i + 1],
                                 compute_dtype=torch.float16,
                                 accum_dtype=torch.float16, x_dtype=pol.x_dtype,
                                 w_dtype=pol.grad_dtype)
              for i in range(len(dims) - 1))
    gen = torch.Generator().manual_seed(SEED + 6)
    shuffled = torch.cat([s + torch.randperm(min(blk, batch - s), generator=gen)
                          for s in range(0, batch, blk)])

    def run(dev, xx=x, stats=torch.float32, policy=pol):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), params)
        loss, _ = autoencoder.ae_loss(p, xx.to(dev), policy=policy,
                                      stats_dtype=stats)
        g = torch.autograd.grad(loss, tree_leaves(p))
        return loss.detach().cpu(), [t.detach().cpu().float() for t in g]

    flat = lambda g: torch.cat([t.flatten() for t in g])
    rel = lambda a, b: float((flat(a) - flat(b)).abs().max() / flat(b).abs().max())

    def worst_leaf(a, b):
        scale = flat(b).abs().max()
        errs = [float((u - v).abs().max() / scale) for u, v in zip(a, b)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return names[i], errs[i]

    out = {"policy": pol.name, "batch": batch, "shuffle_block": blk}
    for stats, label in ((torch.float64, "float64 BatchNorm"),
                         (torch.float32, "fp32 BatchNorm, as the path runs")):
        loss_gpu, g_gpu = run("cuda", stats=stats)
        loss_cpu, g_cpu = run("cpu", stats=stats)
        controls = {"last row dropped": run("cpu", x[:-1], stats)[1],
                    "e5m2 operands": run("cpu", stats=stats, policy=wrong)[1]}
        controls = {k: rel(v, g_cpu) for k, v in controls.items()}
        if stats == torch.float64:
            spread, tol_g = None, AE8_STATS_TOL
        else:
            spread = {"card": rel(run("cuda", x[shuffled], stats)[1], g_gpu),
                      "cpu": rel(run("cpu", x[shuffled], stats)[1], g_cpu)}
            tol_g = max(2e-2, 1.25 * max(spread.values()))
        leaf = worst_leaf(g_gpu, g_cpu)
        print(f"[ae8] step parity B={batch}, {label}: card vs CPU grads "
              f"{rel(g_gpu, g_cpu):.3e} of max (largest in {leaf[0]}); rows "
              f"shuffled in blocks of {blk}: {spread}; controls {controls}; "
              f"bound {tol_g:.3e}", flush=True)
        if not min(controls.values()) > tol_g:
            raise AssertionError(f"ae8 B={batch} {label}: a control passes the "
                                 f"bound {tol_g:.3e}: {controls}")
        tag = "float64" if stats == torch.float64 else "fp32"
        err_l = _check(f"AE step mixed_fp8_e4m3 B={batch} ({tag} BatchNorm) loss, "
                       "card vs CPU plain", loss_gpu, loss_cpu, 1e-3, log)
        err_g = _check(f"AE step mixed_fp8_e4m3 B={batch} ({tag} BatchNorm) grads, "
                       "card vs CPU plain", flat(g_gpu), flat(g_cpu), tol_g, log)
        out[tag] = {"loss_err": err_l, "grad_err": err_g,
                    "grad_err_of_max": rel(g_gpu, g_cpu), "worst_leaf": leaf,
                    "shuffle_spread": spread, "controls": controls,
                    "grad_tol_of_max": tol_g}
    return out


def _ae_run(counters, args, steps: int, want_per_step: dict, path: str):
    """``train.main`` for the AutoEncoder, with the counts set to 0 just
    before and read just after; checks finite losses and the kernel-1
    launches a step.  Returns (result, launches, wall seconds)."""
    import torch

    from repro_torch.launch import train

    _zero(counters)
    t0 = time.perf_counter()
    out = train.main(["--arch", "ae", "--steps", str(steps), "--seed", str(SEED),
                      "--device", "cuda", *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    print(f"[{path}] launches on the main path: {launches}", flush=True)
    if len(out["history"]) != steps or not all(
            math.isfinite(h["loss"]) for h in out["history"]):
        raise AssertionError(f"{path}: non-finite or missing AE steps")
    per_step = {k: launches[k] / steps for k in want_per_step}
    if per_step != want_per_step:
        raise AssertionError(f"{path}: kernel-1 launches a step {per_step}, "
                             f"expected {want_per_step}")
    return out, launches, wall


def ae_phase(log, counters):
    """The AutoEncoder path through its entry point: 200 paper_fp16 steps
    at batch 16 (the main path), 3 steps under fp32 (the fp32 route) and 3
    paper_fp16 steps at batch 4096 (the dW reductions span 2-4 rounding
    blocks), each with its own launch counts; one profiled step; the
    loss-scaled example; one step held against the CPU plain path at batch
    16 and 4096."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.examples import train_autoencoder as example
    from repro_torch.launch import train
    from repro_torch.models import autoencoder
    from repro_torch.optim import AdamW, tree_leaves

    k1, faithful, multi = ("redmule_matmul", "redmule_matmul (faithful fp16)",
                           "redmule_matmul (faithful fp16, multi-block)")
    fused, fused32 = ("redmule_matmul (fused backward dW + db)",
                      "redmule_matmul (fp32 route, fused backward dW + db)")
    # every AE layer is one kernel-1 launch forward, one dX, one dW + db
    torch.cuda.reset_peak_memory_stats()
    out, launches, ae_s = _ae_run(
        counters, ["--batch", str(AE_BATCH)], AE_STEPS,
        {k1: 30, faithful: 30, fused: 10, multi: 0}, "ae")
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not sum(losses[-10:]) < sum(losses[:10]):
        raise AssertionError(f"AE mse is not falling: {losses[:10]} ... {losses[-10:]}")
    _require(launches, (k1, faithful, fused), "ae")
    per_step = {k: launches[k] / AE_STEPS for k in (k1, faithful, fused)}
    # the fp32 policy: the fp32 route's fused backward
    _, launches_fp32, _ = _ae_run(
        counters, ["--batch", str(AE_BATCH), "--policy", "fp32"], 3,
        {k1: 30, "redmule_matmul (fp32 route)": 30, fused32: 10, faithful: 0},
        "ae_fp32")
    # batch 4096: ten multi-block faithful dW + db launches a step
    _, launches_b4096, _ = _ae_run(
        counters, ["--batch", str(AE_BIG)], 3,
        {k1: 30, faithful: 30, multi: 10, fused: 10}, "ae_b4096")
    step_ms = sorted(h["step_ms"] for h in hist[10:])
    print(f"[ae] {AE_STEPS} steps in {ae_s:.2f}s wall; step (CUDA events, steps "
          f"10..{AE_STEPS - 1}) median {step_ms[len(step_ms) // 2]:.3f} ms, mean "
          f"{sum(step_ms) / len(step_ms):.3f} ms; mse {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak {peak / 2**20:.1f} MiB", flush=True)

    # one profiled step (device busy / idle share)
    params = autoencoder.init_ae(seed=SEED, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=3e-3, warmup_steps=0)
    state = [opt.init(params)]
    step = train.build_ae_step(opt, prec.PAPER_FP16)
    xb = torch.from_numpy(SyntheticAE(batch=AE_BATCH, seed=SEED).sample(0)).cuda()

    def one_step():
        state[0], loss, _ = step(params, state[0], xb)
        return float(loss)

    one_step()
    prof = _device_profile(one_step, iters=5)
    parts = ", ".join(f"{k} {g['ms']:.4f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    print(f"[profile] AE step B={AE_BATCH}: wall {prof['wall_ms']:.3f} ms, device "
          f"busy {prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}): "
          f"{parts}", flush=True)

    # the loss-scaled example (paper_fp16, dynamic loss scaling)
    ex = example.main(["--steps", str(AE_STEPS), "--batch", str(AE_BATCH),
                       "--seed", str(SEED), "--device", "cuda"])
    if not all(math.isfinite(v) for v in ex["losses"]):
        raise AssertionError("the loss-scaled example lost finiteness")
    print(f"[ae] loss-scaled example: {AE_STEPS} steps, overflows "
          f"{ex['overflows']}, final scale {ex['loss_scale']}, mse "
          f"{ex['losses'][0]:.4f} -> {ex['losses'][-1]:.4f}", flush=True)

    parity = [_ae_step_parity(log, b) for b in (AE_BATCH, AE_BIG)]
    return {"ae_wall_s": ae_s, "history": hist, "launches": launches,
            "launches_fp32": launches_fp32, "launches_b4096": launches_b4096,
            "launches_per_step": per_step,
            "step_ms_median": step_ms[len(step_ms) // 2],
            "step_ms_mean": sum(step_ms) / len(step_ms), "peak_mem_mib": peak / 2**20,
            "profile": prof, "example": {k: ex[k] for k in ("overflows", "loss_scale")}
            | {"mse_first": ex["losses"][0], "mse_last": ex["losses"][-1]},
            "parity": parity}


def ae8_phase(log, counters):
    """The AutoEncoder under FP8 storage through its entry point: 200
    mixed_fp8_e4m3 steps at batch 16, 3 at batch 4096 (the dW reductions
    over 4096 rows span two rounding blocks) and 3 mixed_fp8_e5m2 steps at
    batch 16, each with its own launch counts — 30 kernel-1 launches a
    step, all FP8 (10 forward, 10 dX, 10 dW), none fused-backward; one
    profiled step; one step at batch 16 and one at 4096 held against the
    CPU plain path."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.launch import train
    from repro_torch.models import autoencoder
    from repro_torch.optim import AdamW, tree_leaves

    k1, fp8, fp8_e5 = ("redmule_matmul", "redmule_matmul (FP8 e4m3, faithful)",
                       "redmule_matmul (FP8 e5m2, fp32 accumulator)")
    faithful, multi = ("redmule_matmul (faithful fp16)",
                       "redmule_matmul (faithful fp16, multi-block)")
    fused = "redmule_matmul (fused backward dW + db)"
    torch.cuda.reset_peak_memory_stats()
    out, launches, wall = _ae_run(
        counters, ["--batch", str(AE_BATCH), "--policy", "mixed_fp8_e4m3"],
        AE_STEPS, {k1: 30, fp8: 30, faithful: 30, fused: 0, multi: 0}, "ae8")
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in out["history"]]
    # the reference reaches 0.1197 by step 40 on the CPU (xla backend)
    if not (sum(losses[-10:]) / 10 <= 0.1197 < losses[0]):
        raise AssertionError(f"ae8 mse did not fall to the reference's level: "
                             f"{losses[:3]} ... {losses[-10:]}")
    _, launches_4k, _ = _ae_run(
        counters, ["--batch", str(AE_BIG), "--policy", "mixed_fp8_e4m3"], 3,
        {k1: 30, fp8: 30, faithful: 30, fused: 0, multi: 10}, "ae8_b4096")
    out5, launches_e5, _ = _ae_run(
        counters, ["--batch", str(AE_BATCH), "--policy", "mixed_fp8_e5m2"], 3,
        {k1: 30, fp8_e5: 30, faithful: 0, fused: 0}, "ae8_e5m2")
    step_ms = sorted(h["step_ms"] for h in out["history"][10:])
    print(f"[ae8] {AE_STEPS} steps in {wall:.2f}s wall; step (CUDA events, "
          f"steps 10..{AE_STEPS - 1}) median {step_ms[len(step_ms) // 2]:.3f} "
          f"ms, mean {sum(step_ms) / len(step_ms):.3f} ms; mse {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (mean of the last 10: "
          f"{sum(losses[-10:]) / 10:.4f}); peak {peak / 2**20:.1f} MiB; "
          f"mixed_fp8_e5m2 mse {[round(h['loss'], 4) for h in out5['history']]}",
          flush=True)

    params = autoencoder.init_ae(seed=SEED, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=3e-3, warmup_steps=0)
    state = [opt.init(params)]
    step = train.build_ae_step(opt, prec.MIXED_FP8_E4M3)
    xb = torch.from_numpy(SyntheticAE(batch=AE_BATCH, seed=SEED).sample(0)).cuda()

    def one_step():
        state[0], loss, _ = step(params, state[0], xb)
        return float(loss)

    one_step()
    torch.cuda.reset_peak_memory_stats()
    prof = _device_profile(one_step, iters=5)
    peak_step = torch.cuda.max_memory_allocated()
    parts = ", ".join(f"{k} {g['ms']:.4f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    print(f"[profile] AE step mixed_fp8_e4m3 B={AE_BATCH}: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['device_ms']:.3f} ms "
          f"(idle {prof['idle_share']:.3f}), peak {peak_step / 2**20:.1f} MiB: "
          f"{parts}", flush=True)
    parity = [_ae8_step_parity(log, b) for b in (AE_BATCH, AE_BIG)]
    return {"ae8_wall_s": wall, "history": out["history"],
            "history_e5m2": out5["history"], "launches": launches,
            "launches_b4096": launches_4k, "launches_e5m2": launches_e5,
            "step_ms_median": step_ms[len(step_ms) // 2],
            "step_ms_mean": sum(step_ms) / len(step_ms),
            "peak_mem_mib": peak / 2**20, "peak_mem_step_mib": peak_step / 2**20,
            "profile": prof, "parity": parity}


def serve8_phase(log, counters):
    """qwen3-1.7b at full width under mixed_fp8_e4m3 (random fp16 weights
    from the seed, the dense fp16 KV cache): ``generate`` for 4 requests
    x (prompt 128 + 16 new tokens) with the counts set to 0 just before;
    every kernel-1 and kernel-2 launch must be FP8 and the counts
    structural; tokens in range, logits finite.  Then one prefill and one
    decode step timed and profiled, and a two-layer cut held against the
    CPU plain path: prefill logits, and one decode step from the same
    cache."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get(ARCH), policy_name="mixed_fp8_e4m3")
    L = cfg.n_layers
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    _zero(counters)
    t0 = time.perf_counter()
    seqs, _, final = serve.generate(params, cfg, prompts, GEN, return_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    print(f"[serve8] launches on the main path: {launches}", flush=True)
    if seqs.shape != (BATCH, PROMPT + GEN) or not (
            (seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError(f"serve8: generate returned {seqs.shape} / tokens "
                             "out of range")
    if not np.isfinite(final).all():
        raise AssertionError("serve8: final logits are not finite")
    # B prefills and GEN decode steps: 4 projections a layer and the head
    # each (kernel 1), scores and PV a layer per decode step (kernel 2),
    # flash a layer per prefill
    want = {"redmule_matmul": (BATCH + GEN) * (4 * L + 1),
            "redmule_matmul (FP8 e4m3, faithful)": (BATCH + GEN) * (4 * L + 1),
            "redmule_matmul_batched": GEN * 2 * L,
            "redmule_matmul_batched (FP8 e4m3, decode scores)": GEN * 2 * L,
            "flash_attention": BATCH * L}
    got = {k: launches[k] for k in want}
    print(f"[serve8] launches {got}, structural {want}", flush=True)
    if got != want:
        raise AssertionError("serve8: launches differ from the structural "
                             "count, or not every GEMM launch is FP8")

    gen_c = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen_c,
                           device="cuda")
    logits, _ = transformer.prefill(params, cfg, {"inputs": prompt}, PROMPT + GEN)
    prefill_ms = _time_ms(lambda: transformer.prefill(
        params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=10, warmup=2)
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen_c,
                         device="cuda")
    pos = torch.full((BATCH,), PROMPT, device="cuda")
    sizes = np.full((BATCH,), PROMPT + 1, np.int32)

    def decode():
        return transformer.serve_step(params, cfg, toks, cache, pos,
                                      kv_group_sizes=sizes)

    dec_logits, _ = decode()
    decode_ms = _time_ms(decode, iters=20, warmup=2)
    for name, t in (("prefill", logits), ("decode", dec_logits)):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"serve8: {name} logits are not finite")
    # the tied head's per-tensor quantization of the (V, d) embedding, alone
    from repro_torch.core import precision as prec
    quant_ms = _time_ms(lambda: prec.quantize_fp8(params["embed"],
                                                  torch.float8_e4m3fn), iters=10)
    print(f"[serve8] generate {BATCH}x({PROMPT}+{GEN}) {wall:.3f}s wall; "
          f"prefill(1x{PROMPT}) {prefill_ms:.3f} ms; decode step (B={BATCH}) "
          f"{decode_ms:.3f} ms; quantizing the embedding {quant_ms:.3f} ms",
          flush=True)
    profiles = {
        "prefill": _device_profile(lambda: transformer.prefill(
            params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=3),
        "decode_step": _device_profile(decode, iters=5)}
    for name, prof in profiles.items():
        parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                          for k, g in sorted(prof["by_kernel"].items()))
        print(f"[profile] serve8 {name}: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}): "
              f"{parts}", flush=True)
    del params, cache

    # a two-layer cut at full width, card vs the CPU plain path: the same
    # kernels' math on the same inputs, held to a few fp16 ulps of max
    small = dataclasses.replace(cfg, n_layers=2)
    pc = transformer.init_params(small, seed=SEED + 1, device="cuda")
    pcpu = _to_cpu(pc)
    sp = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen_c, device="cuda")
    got_l, got_c = transformer.prefill(pc, small, {"inputs": sp}, 24)
    want_l, want_c = transformer.prefill(pcpu, small, {"inputs": sp.cpu()}, 24)
    err_pre = _check("serve8 two-layer prefill logits, card vs CPU plain",
                     got_l.cpu(), want_l, SERVE8_TOL, log)
    # one decode step from the same cache (the CPU's, copied to the card)
    shared = _to_cpu(want_c)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen)
    p16 = torch.tensor([16])
    s16 = np.array([17], np.int32)
    got_d, _ = transformer.serve_step(pc, small, tok.cuda(),
                                      {"layers": {k: v.cuda() for k, v in
                                                  shared["layers"].items()}},
                                      p16.cuda(), kv_group_sizes=s16)
    want_d, _ = transformer.serve_step(pcpu, small, tok, shared, p16,
                                       kv_group_sizes=s16)
    err_dec = _check("serve8 two-layer decode step from one cache, card vs "
                     "CPU plain", got_d.cpu(), want_d, SERVE8_TOL, log)
    del got_c
    return {"serve_wall_s": wall, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms, "quantize_embed_ms": quant_ms,
            "launches": launches, "structural": want, "profiles": profiles,
            "two_layer_err": {"prefill": err_pre, "decode": err_dec}}


def _to_cpu(tree):
    if hasattr(tree, "cpu"):
        return tree.cpu()
    return {k: _to_cpu(v) for k, v in tree.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = _card()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    report = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f}s", flush=True)
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"[ptxas] {name}: {line.strip()}")
    log: list = []
    kernels, counters, row_paths = kernel_phase(log)
    serve = serve_phase(log, counters)
    train = train_phase(log, counters)
    ae = ae_phase(log, counters)
    ae8 = ae8_phase(log, counters)
    serve8 = serve8_phase(log, counters)
    runs = {"serve": serve["launches"], "train": train["launches"],
            "ae": ae["launches"], "ae_fp32": ae["launches_fp32"],
            "ae_b4096": ae["launches_b4096"], "ae8": ae8["launches"],
            "ae8_b4096": ae8["launches_b4096"], "ae8_e5m2": ae8["launches_e5m2"],
            "serve8": serve8["launches"]}
    for kern in kernels:
        # a path outside the row's ``paths`` does not run its shape: null
        paths = row_paths.get(kern["name"], tuple(runs))
        by_path = {p: (runs[p][kern["name"]] if p in paths else None)
                   for p in runs}
        kern["launches"] = sum(v for v in by_path.values() if v is not None)
        kern["launches_by_path"] = by_path
    split_by_path = {p: {k.split(": ")[1]: v for k, v in runs[p].items()
                         if k.startswith("split launches: ")} for p in runs}
    print(f"[report] split launches per path: {json.dumps(split_by_path)}", flush=True)
    out = {"card": card, "build_s": build_s, "checks": log, "serve": serve,
           "train": train, "ae": ae, "ae8": ae8, "serve8": serve8,
           "kernels": kernels, "split_launches_by_path": split_by_path}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
