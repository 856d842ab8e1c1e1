#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. **build** — compile every CUDA source in ``src/repro_torch/csrc`` with
   nvcc for sm_90a (all at once) and print the build seconds and the
   compiler's register / shared-memory report;
2. **kernels** — each kernel's wrapper against its plain PyTorch version on
   the same inputs, at the serving path's shapes (qwen3-1.7b at full
   width), with the tolerance printed beside the error; each kernel, its
   plain version and one PyTorch library call for the same function are
   timed with CUDA events, and the kernel alone with torch.profiler;
3. **serve** — every kernel's launch count is set to 0, then
   ``repro_torch.launch.serve`` serves qwen3-1.7b at full width (random
   weights from a seed): 4 requests, prompt 128, 16 new tokens; the counts
   are read right after and every kernel must have run; tokens must be in
   range.  Then one prefill and one decode step are timed with CUDA events
   (logits must be finite) and profiled (device time by kernel, idle
   share), and a two-layer cut of the same model is held against the plain
   path on the CPU;
4. **report** — the card (``nvidia-smi``), a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

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
ARCH, BATCH, PROMPT, GEN, SEED = "qwen3-1.7b", 4, 128, 16, 0


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
                "flash_fwd" if "flash_fwd_kernel" in ev.key else "other")
        g = groups.setdefault(name, {"ms": 0.0, "count": 0})
        g["ms"] += us / 1e3 / iters
        g["count"] += ev.count // iters
    busy = sum(g["ms"] for g in groups.values())
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    wall_ms = wall * 1e3 / iters
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "by_kernel": groups}


def _bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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
    runs = [
        ("redmule_matmul", "redmule_gemm", "src/repro_torch/csrc/redmule_matmul.cu",
         "src/repro/kernels/redmule_matmul.py:289",
         "nt tied head M=4 N=2048 K=151936 bf16", err_head, head_b, head_f,
         lambda: ops.redmule_matmul(x_dec, emb, policy=pol, layout="nt"),
         lambda: rm.redmule_matmul_plain(x_dec, emb, policy=pol, layout="nt"),
         lambda: torch.matmul(x_dec, emb.t())),
        ("redmule_matmul_batched", "redmule_gemm",
         "src/repro_torch/csrc/redmule_matmul.cu",
         "src/repro/kernels/redmule_matmul.py:478",
         "decode PV B=4x8x2 M=1 N=144 K=128 bf16, V broadcast", err_pv, pv_b, pv_f,
         lambda: ops.redmule_matmul_batched(p, v, policy=pol),
         lambda: rm.redmule_matmul_plain(p, v, policy=pol),
         lambda: torch.matmul(p, v)),
        ("flash_attention", "flash_fwd", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:102",
         "prefill Hq=16 Hkv=8 D=128 S=128 T=144 t_valid=128 bf16", err_fl, fl_b, fl_f,
         lambda: fa.flash_attention(q, k, vv, **fl),
         lambda: fa.flash_attention_plain(q, k, vv, **fl),
         lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                enable_gqa=True)),
    ]
    kernels = []
    for (name, group, source, replaces, shape, err, bound, bound_by, kernel,
         plain, library) in runs:
        # ms: CUDA events around back-to-back calls (host launch cost
        # included where it exceeds the kernel); device_ms: the kernel
        # alone, from the profiler
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "max_abs_err": err,
            "ms": _time_ms(kernel), "plain_ms": _time_ms(plain),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": _time_ms(library),
            "device_ms": _device_profile(kernel, 10)["by_kernel"][group]["ms"]})
    return kernels


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    return {"redmule_matmul": ops.redmule_matmul,
            "redmule_matmul_batched": ops.redmule_matmul_batched,
            "flash_attention": fa.flash_attention}


def serve_phase(log):
    """The main path through the serving entry point, with launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    seqs = serve.main(["--arch", ARCH, "--full", "--batch", str(BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN),
                       "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[serve] launches on the main path: {launches}", flush=True)
    cfg = configs.get(ARCH)
    if seqs.shape != (BATCH, PROMPT + GEN):
        raise AssertionError(f"generate returned shape {seqs.shape}")
    if not ((seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

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
    kernels = kernel_phase(log)
    serve = serve_phase(log)
    for kern in kernels:
        kern["launches"] = serve["launches"][kern["name"]]
    out = {"card": card, "build_s": build_s, "checks": log, "serve": serve,
           "kernels": kernels}
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
