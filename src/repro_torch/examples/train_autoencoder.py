"""The paper's use case, end to end: the TinyMLPerf AutoEncoder trained in
pure FP16 (``paper_fp16``: the RedMulE fp16 accumulator in every GEMM) with
dynamic loss scaling (§III-B, Fig 4c/4d).  Counterpart of the repository's
``examples/train_autoencoder.py``::

    PYTHONPATH=src python -m repro_torch.examples.train_autoencoder [--steps 400]

A step whose unscaled gradients are not all finite leaves the parameters
and the AdamW moments (and its step count) untouched and halves the loss
scale, as ``repro.launch.train``'s loss-scaled step does.  (The
reference example keeps the moments it updated on such a step; see
ROADMAP.md, Queue C.)  It closes with the paper's Fig 4c/4d numbers for
this workload from the analytic RedMulE model (``core/perf_model.py``: the
paper's 22 nm cluster, not the card).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import precision as prec
from repro_torch.core.perf_model import DEFAULT_MODEL, autoencoder_report
from repro_torch.data import SyntheticAE
from repro_torch.launch.train import ae_grads
from repro_torch.models import autoencoder
from repro_torch.optim import (AdamW, LossScaleState, OptState, adjust,
                               init_scale, tree_leaves, unscale_and_check)

__all__ = ["loss_scaled_step", "main"]


def loss_scaled_step(params, opt_state: OptState, scale: LossScaleState,
                     x: torch.Tensor, opt: AdamW):
    """One loss-scaled ``paper_fp16`` step; returns ``(opt_state, scale,
    mse, finite)``.  The parameters are updated in place, and only when
    ``finite``."""
    loss, grads = ae_grads(params, x, prec.PAPER_FP16, loss_scale=scale.scale)
    grads, finite = unscale_and_check(grads, scale)
    scale = adjust(scale, finite)
    if bool(finite):
        updates, opt_state = opt.update(grads, opt_state, params)
        opt.apply(params, updates)
    return opt_state, scale, loss, finite


def main(argv=None) -> Dict[str, Any]:
    """Train; returns ``{"losses": [...], "overflows": n, "loss_scale": s}``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    params = autoencoder.init_ae(seed=args.seed, device=device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=args.lr)
    opt_state = opt.init(params)
    scale = init_scale(initial=2.0 ** 12, growth_interval=200, device=device)
    ds = SyntheticAE(batch=args.batch, seed=args.seed)

    losses = []
    for i in range(args.steps):
        x = torch.from_numpy(ds.sample(i % 8)).to(device)
        opt_state, scale, loss, finite = loss_scaled_step(
            params, opt_state, scale, x, opt)
        losses.append(float(loss))
        if i % 50 == 0:
            print(f"[{i:4d}] mse={losses[-1]:.4f} "
                  f"loss_scale={float(scale.scale):.0f} finite={bool(finite)}",
                  flush=True)
    overflows = int(scale.overflow_count)
    if losses:
        print(f"\nfinal mse: {np.mean(losses[-10:]):.4f} "
              f"(from {np.mean(losses[:10]):.4f}); overflows seen: {overflows}")

    # the paper's Fig 4c/4d numbers for this exact workload
    print("\npaper reproduction (calibrated machine model):")
    for B in (1, 16):
        r = autoencoder_report(DEFAULT_MODEL, B)
        print(f"  B={B:2d}: RedMulE speedup {r['speedup']:.1f}x over 8-core SW "
              f"(paper: {'2.6x' if B == 1 else '24.4x'}), "
              f"fwd {r['speedup_fwd']:.1f}x / bwd {r['speedup_bwd']:.1f}x, "
              f"{r['hw_macs_per_cycle']:.1f} MAC/cycle")
    return {"losses": losses, "overflows": overflows,
            "loss_scale": float(scale.scale)}


if __name__ == "__main__":
    main()
