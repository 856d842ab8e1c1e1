"""Quickstart: the port's RedMulE engine in five minutes (counterpart of the
repository's ``examples/quickstart.py``)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card each GEMM launches the hand-written CUDA kernel and is held
against its plain PyTorch version; on the CPU the wrapper takes the plain
version itself, so only that runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine, tiling
from repro_torch.core.perf_model import DEFAULT_MODEL, GEMM
from repro_torch.core.precision import PAPER_FP16, TPU_BF16
from repro_torch.kernels import redmule_matmul as rm

__all__ = ["main"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    dev = resolve_device(p.parse_args(argv).device)

    # 1. Z = X @ W on the engine: the backends are registry entries
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 640))).half().to(dev)
    w = torch.from_numpy(rng.normal(size=(640, 128))).half().to(dev)
    print("backends:", engine.registered_backends())
    z = engine.matmul(x, w, policy=PAPER_FP16)
    plain = rm.redmule_matmul_plain(x, w, policy=PAPER_FP16)
    what = "kernel" if dev.type == "cuda" else "plain version (CPU)"
    print(f"{what} vs plain max|diff|: "
          f"{(z.float() - plain.float()).abs().max().item():.3e}")

    # 2. instrumentation: every dispatch emits a GemmEvent with its tile
    with engine.instrument() as events:
        engine.linear(x, w, torch.zeros(128, dtype=torch.float16, device=dev),
                      activation="relu", policy=PAPER_FP16)
        engine.grouped_matmul(                      # 4 experts in one dispatch
            torch.zeros((4, 32, 640), dtype=torch.float16, device=dev),
            torch.zeros((4, 640, 128), dtype=torch.float16, device=dev),
            policy=PAPER_FP16)
    for ev in events:
        t = ev.spec.tile
        print(f"event: {ev.spec.op:16s} {ev.spec.tag:14s} "
              f"M/N/K={ev.spec.m}/{ev.spec.n}/{ev.spec.k} "
              f"groups={ev.spec.groups} backend={ev.backend} "
              f"tile={t.bm}x{t.bn}x{t.bk} flops={ev.total_flops}")

    # 3. tiling: the kernel's compiled tiles and the split of the reduction
    for M, N, K in ((4096, 4096, 4096), (4, 2048, 4096)):
        t = tiling.choose_tiles(M, N, K)
        plan = tiling.split_plan(M, N, K, tile=t)
        print(f"{M}x{N}x{K} GEMM: bm={t.bm} bn={t.bn} bk={t.bk}, "
              f"{plan.splits} slice(s) of {plan.depth} reduction rows")

    # 4. the paper's calibrated machine model (its 22 nm cluster)
    m = DEFAULT_MODEL
    g = GEMM(512, 512, 512)
    print(f"RedMulE 32-FMA @ 512^3: {m.hw_macs_per_cycle(g):.2f} MAC/cycle "
          f"({m.utilization(g) * 100:.1f}% of ideal), "
          f"{m.speedup(g):.1f}x over 8-core SW, "
          f"{m.gflops_per_watt(g):.0f} GFLOPS/W @ 0.65 V")

    # 5. precision policies
    for policy in (PAPER_FP16, TPU_BF16):
        z = engine.matmul(x, w, policy=policy)
        print(f"policy={policy.name:12s} out_dtype={z.dtype} "
              f"accum={policy.accum_dtype}")


if __name__ == "__main__":
    main()
