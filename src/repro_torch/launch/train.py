"""Training entry point: the LM train step, the AutoEncoder use case and a
plain training loop.

Counterpart of ``repro.launch.train`` (``TrainState``, ``init_state``,
``build_train_step``, the LM branch of ``main`` without a checkpoint
directory, and ``_ae_main``).  It runs on one device, the card by default::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --full \\
        --batch 4 --seq 256 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --full \\
        --batch 4 --seq 256 --steps 3 --fp16-scale   # tpu_fp16, loss scaling
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --full \\
        --batch 4 --seq 256 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b --full \\
        --batch 4 --seq 256 --steps 3   # attention + Mamba2 / SSD heads
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --full --layers 3 --batch 4 --seq 256 \\
        --steps 3              # MoE + MLA at full width, depth cut to 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch ae --batch 16 \\
        --steps 200            # the paper's AutoEncoder, paper_fp16
    PYTHONPATH=src python -m repro_torch.launch.train --arch ae --batch 16 \\
        --steps 200 --policy mixed_fp8_e4m3   # FP8 storage, per-tensor scales

Weights are random, drawn from ``--seed``; batches are the reference's
``SyntheticLM`` / ``SyntheticAE`` streams (precomputed embeddings for the
embedding-input archs, musicgen-medium and pixtral-12b).  ``--device cpu``
runs the plain PyTorch versions of the kernels.  The default arch is the
reference's, qwen3-1.7b.  ``--fp16-scale`` trains an LM under ``tpu_fp16``
with dynamic loss scaling: a step whose gradients overflow skips the
parameters and the AdamW moments together and halves the scale.
``--layers N`` cuts an LM's depth to N layers at its width (a MoE arch
keeps its dense layer 0 and N - 1 MoE layers); a MoE arch prints its
router metrics (``moe_aux_loss``, ``moe_z_loss``, ``moe_drop_frac``,
summed over the MoE layers) every step and its history carries them.
``--arch ae`` trains the TinyMLPerf AutoEncoder under
``--policy`` (default ``paper_fp16``: the RedMulE fp16 accumulator in every
GEMM; ``mixed_fp8_e4m3`` / ``mixed_fp8_e5m2`` store every GEMM operand in
FP8 with a per-tensor scale).  Checkpointing, gradient compression / data
parallelism, failure injection and resume digests are not ported yet
(ROADMAP.md): their flags are kept so a command line carries over, and
each raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.data import Prefetcher, SyntheticAE, SyntheticLM
from repro_torch.models import autoencoder, moe, transformer
from repro_torch.optim import (AdamW, OptState, adjust, clip_by_global_norm,
                               init_scale, scale_loss, tree_leaves, tree_map,
                               unscale_and_check)
from repro_torch.roofline import analysis

__all__ = ["TrainState", "init_state", "build_train_step", "ae_grads",
           "build_ae_step", "main"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    scale: Any          # LossScaleState, or () when loss scaling is off


def init_state(cfg, opt, *, seed: int = 0, device="cuda",
               use_scale: bool = False) -> TrainState:
    """fp32 master parameters (``cfg.param_dtype``) drawn from ``seed`` on
    ``device``, marked as leaves that take gradients, ``opt``'s state, and
    with ``use_scale`` the dynamic loss scale (``optim.init_scale``)."""
    params = transformer.init_params(cfg, seed=seed, device=device,
                                     dtype=getattr(torch, cfg.param_dtype))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt=opt.init(params),
                      scale=init_scale(device=dev) if use_scale else ())


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Token ids and labels as int64, embeddings as fp32, on ``device``."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=torch.float32 if t.is_floating_point()
                      else torch.long)
    return out


def build_train_step(cfg, opt, rules=None, *, use_scale: bool = False,
                     clip_norm: float = 1.0, cast_params: bool = False,
                     grad_accum: int = 1):
    """``step(state, batch) -> (state, metrics)`` (``train.py:79-167`` of
    the reference): loss and gradients of ``transformer.loss_fn``, global-
    norm clipping, then ``opt``.  ``cast_params`` casts the fp32 master
    parameters to the compute dtype at step entry (differentiably: the
    gradients arrive in fp32); ``grad_accum`` splits the batch into
    microbatches and averages their fp32 gradients.  ``use_scale``
    differentiates the loss times ``state.scale``, unscales the gradients
    in fp32 and, if any is not finite, leaves the parameters and the
    optimizer state untouched (the reference's ``lax.cond`` over both);
    the scale adjusts either way and the metrics carry ``loss_scale`` and
    ``finite``.  The state's tensors are updated in place and returned
    (the reference donates them)."""
    if rules is not None:
        raise NotImplementedError(f"sharding rules are {_ROADMAP}")

    # the token table of an embedding-input arch with an untied head is
    # reached by no batch: it gets a zero gradient, as jax.grad gives it;
    # any other leaf the loss does not reach is an error
    unused = cfg.input_mode == "embeddings" and not cfg.tie_embeddings

    def value_and_grad(params, batch, scale):
        leaves = [t for t in tree_leaves(params)
                  if not (unused and t is params["embed"])]
        p = params
        if cast_params:
            p = tree_map(lambda x: x.to(cfg.policy.compute_dtype)
                         if x.is_floating_point() else x, params)
        loss, metrics = transformer.loss_fn(p, cfg, batch)
        if use_scale:
            loss = scale_loss(loss, scale)
        it = iter(torch.autograd.grad(loss, leaves))

        def grad_of(t):
            return (torch.zeros_like(t) if unused and t is params["embed"]
                    else next(it))

        return metrics, tree_map(grad_of, params)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = tree_leaves(state.params)[0].device
        batch = _to_device(batch, device)
        if grad_accum > 1:
            B = next(iter(batch.values())).shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} does not split into {grad_accum} "
                                 "microbatches")
            grads = metrics = None
            for mb in range(grad_accum):
                part = {k: v.reshape(grad_accum, B // grad_accum, *v.shape[1:])[mb]
                        for k, v in batch.items()}
                m, g = value_and_grad(state.params, part, state.scale)
                g = tree_map(lambda x: x.float(), g)
                m = {k: v.detach() for k, v in m.items()}
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = tree_map(torch.add, grads, g)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / grad_accum
            grads = tree_map(lambda g: g * inv, grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            metrics, grads = value_and_grad(state.params, batch, state.scale)
            metrics = {k: v.detach() for k, v in metrics.items()}
        finite, new_scale = None, state.scale
        if use_scale:
            grads, finite = unscale_and_check(grads, state.scale)
            new_scale = adjust(state.scale, finite)
            metrics["loss_scale"] = new_scale.scale
            metrics["finite"] = finite.to(torch.float32)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        metrics["grad_norm"] = gnorm
        if finite is not None and not bool(finite):
            # the moments update in place: skip opt.update itself
            return TrainState(state.params, state.opt, new_scale), metrics
        updates, new_opt = opt.update(grads, state.opt, state.params)
        new_params = opt.apply(state.params, updates)
        return TrainState(new_params, new_opt, new_scale), metrics

    return step


def ae_grads(params, x: torch.Tensor, policy: prec.Policy, *,
             loss_scale: Optional[torch.Tensor] = None):
    """``(mse, grads)`` of one AutoEncoder batch; with ``loss_scale`` the
    gradients are those of ``mse * loss_scale`` (still scaled)."""
    loss, _ = autoencoder.ae_loss(params, x, policy=policy)
    target = loss if loss_scale is None else loss * loss_scale.to(loss.dtype)
    grads = torch.autograd.grad(target, tree_leaves(params))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def build_ae_step(opt, policy: prec.Policy, *, clip_norm: float = 1.0):
    """``step(params, opt_state, x) -> (opt_state, mse, grad_norm)``: the
    reference's ``_ae_main`` step (loss and gradients, global-norm
    clipping, ``opt``); the parameters are updated in place."""

    def step(params, opt_state: OptState, x: torch.Tensor):
        loss, grads = ae_grads(params, x, policy)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, opt_state, params)
        opt.apply(params, updates)
        return opt_state, loss, gnorm

    return step


def _ae_main(args, device: torch.device) -> Dict[str, Any]:
    """The paper's §III-B use case: the AutoEncoder trained under
    ``--policy`` (``paper_fp16`` by default; the FP8 policies quantize
    every GEMM operand per tensor), AdamW without warmup, clip 1.0, one
    CUDA-event time per step."""
    policy = prec.resolve(args.policy or "paper_fp16")
    params = autoencoder.init_ae(seed=args.seed, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = AdamW(lr=args.lr, warmup_steps=0)
    opt_state = opt.init(params)
    ds = SyntheticAE(batch=args.batch, seed=args.seed)
    if args.instrument:
        with engine.instrument() as events:
            ae_grads(params, torch.from_numpy(ds.sample(0)).to(device), policy)
        _print_instrument_summary(events)
    step = build_ae_step(opt, policy)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch=ae params={n_params} device={device} policy={policy.name} "
          f"batch={args.batch}", flush=True)
    history: List[Dict[str, float]] = []
    for i in range(args.steps):
        x = torch.from_numpy(ds.sample(i)).to(device)
        with _StepTimer(device) as timer:
            opt_state, loss, gnorm = step(params, opt_state, x)
            loss, gnorm = float(loss), float(gnorm)
        history.append({"step": i, "loss": loss, "grad_norm": gnorm,
                        "step_ms": timer.ms})
        if i % 10 == 0 or i == args.steps - 1:
            print(f"[{i}] mse={loss:.4f} grad_norm={gnorm:.4f} "
                  f"step={timer.ms:.2f} ms", flush=True)
    if history:
        print(f"final mse: {history[-1]['loss']:.4f}")
    return {"arch": "ae", "device": str(device), "policy": policy.name,
            "params": n_params, "history": history}


def _print_instrument_summary(events) -> None:
    """Per-op engine summary and the fwd / bwd flop and byte split, a remat
    recompute counted as backward (``roofline.analysis``)."""
    for op, d in engine.summarize(events).items():
        print(f"[engine] {op}: calls={d['calls']} "
              f"gflops={d['flops'] / 1e9:.3f} gbytes={d['bytes'] / 1e9:.3f}")
    split = analysis.flops_by_direction(events)
    bsplit = analysis.bytes_by_direction(events)
    fwd, bwd = split["fwd"], split["bwd"]
    ratio = (fwd + bwd) / fwd if fwd else 0.0
    print(f"[engine] fwd_gflops={fwd / 1e9:.3f} bwd_gflops={bwd / 1e9:.3f} "
          f"train/inference={ratio:.2f}x")
    print(f"[engine] fwd_gbytes={bsplit['fwd'] / 1e9:.4f} "
          f"bwd_gbytes={bsplit['bwd'] / 1e9:.4f}")


def _instrumented_events(cfg, params, batch, device) -> List[engine.GemmEvent]:
    """The engine events of one step's loss and gradients (no update)."""
    batch = _to_device(batch, device)
    with engine.instrument() as events:
        loss, _ = transformer.loss_fn(params, cfg, batch)
        torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    return events


class _StepTimer:
    """Wall time of one step: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def main(argv=None) -> Dict[str, Any]:
    """Train on synthetic data; returns ``{"arch", "device", "policy",
    "params", "history": [{"step", "loss", "grad_norm", "step_ms"}, ...]}``
    (with ``--fp16-scale`` each step also carries ``loss_scale`` and
    ``finite``, a MoE arch's the three router metrics)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-1.7b",
                   help="an LM arch id, or 'ae' (the paper's AutoEncoder)")
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--layers", type=int, default=None,
                   help="LM archs: cut the depth to this many layers")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    p.add_argument("--instrument", action="store_true",
                   help="run one step's loss and gradients under "
                        "engine.instrument() and print the per-op GEMM "
                        "summary with the fwd/bwd split before training")
    p.add_argument("--fp16-scale", action="store_true",
                   help="LM archs: tpu_fp16 compute with dynamic loss scaling")
    p.add_argument("--policy", default=None,
                   help="precision policy for --arch ae (default paper_fp16; "
                        "tpu_fp16, tpu_bf16, fp32, mixed_fp8_e4m3 and "
                        "mixed_fp8_e5m2 are also accepted)")
    unported = p.add_argument_group("not yet ported (ROADMAP.md); each raises")
    unported.add_argument("--ckpt-dir", default="")
    unported.add_argument("--save-every", type=int, default=50)
    unported.add_argument("--compress", default="none",
                          choices=("none", "fp16", "int8", "fp8", "fp8_e4m3",
                                   "fp8_e5m2"))
    unported.add_argument("--dp-procs", type=int, default=0)
    unported.add_argument("--fail-step", type=int, default=None)
    unported.add_argument("--fail-mode", default="die",
                          choices=("raise", "die", "sigterm", "ckpt_crash"))
    unported.add_argument("--result", default="")
    args = p.parse_args(argv)

    for flag, what in ((bool(args.ckpt_dir), "--ckpt-dir (checkpointing, goodput)"),
                       (args.compress != "none" or args.dp_procs > 0,
                        "--compress / --dp-procs (compressed data parallelism)"),
                       (args.fail_step is not None, "--fail-step (failure injection)"),
                       (bool(args.result), "--result (resume digests)")):
        if flag:
            raise NotImplementedError(f"{what} is {_ROADMAP}")

    device = resolve_device(args.device)
    if args.arch == "ae":
        return _ae_main(args, device)
    if args.policy is not None:
        raise ValueError("--policy applies to --arch ae only")
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.fp16_scale:
        cfg = dataclasses.replace(cfg, policy_name="tpu_fp16")
    opt = AdamW(lr=args.lr, warmup_steps=10)
    step = build_train_step(cfg, opt, use_scale=args.fp16_scale)
    state = init_state(cfg, opt, seed=args.seed, device=device,
                       use_scale=args.fp16_scale)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed,
                     embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0)
    if args.instrument:
        _print_instrument_summary(
            _instrumented_events(cfg, state.params, ds.batch(0), device))

    n_params = transformer.count_params(cfg)
    print(f"arch={cfg.name} params={n_params} device={device} "
          f"policy={cfg.policy_name} batch={args.batch} seq={args.seq}", flush=True)
    history: List[Dict[str, float]] = []
    batches = Prefetcher(iter(ds), depth=2)
    try:
        for i in range(args.steps):
            batch = next(batches)
            with _StepTimer(device) as timer:
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
            row = {"step": i, "loss": loss, "grad_norm": gnorm,
                   "step_ms": timer.ms}
            if args.fp16_scale:
                row["loss_scale"] = float(metrics["loss_scale"])
                row["finite"] = bool(metrics["finite"])
            row.update({k: float(metrics[k]) for k in moe.METRICS if k in metrics})
            history.append(row)
            if cfg.moe or i % 10 == 0 or i == args.steps - 1:
                scale = (f" loss_scale={row['loss_scale']:g} finite={row['finite']}"
                         if args.fp16_scale else "")
                router = "".join(f" {k}={row[k]:.4f}" for k in moe.METRICS
                                 if k in row)
                print(f"[{i}] loss={loss:.4f} grad_norm={gnorm:.4f}{scale}"
                      f"{router} step={timer.ms:.1f} ms", flush=True)
    finally:
        batches.close()
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return {"arch": cfg.name, "device": str(device), "policy": cfg.policy_name,
            "params": n_params, "history": history}


if __name__ == "__main__":
    main()
