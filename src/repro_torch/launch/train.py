"""Training entry point: the LM train step, the AutoEncoder use case and a
plain training loop.

Counterpart of ``repro.launch.train`` (``TrainState``, ``init_state``,
``build_train_step``, the LM branch of ``main`` without a checkpoint
directory, and ``_ae_main``).  It runs on one device, the card by default::

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --full \\
        --batch 4 --seq 256 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch ae --batch 16 \\
        --steps 200            # the paper's AutoEncoder, paper_fp16
    PYTHONPATH=src python -m repro_torch.launch.train --arch ae --batch 16 \\
        --steps 200 --policy mixed_fp8_e4m3   # FP8 storage, per-tensor scales

Weights are random, drawn from ``--seed``; batches are the reference's
``SyntheticLM`` / ``SyntheticAE`` streams.  ``--device cpu`` runs the plain
PyTorch versions of the kernels.  The default arch is xlstm-1.3b (the
reference's default, qwen3-1.7b, needs the attention backward, which is not
ported yet).  ``--arch ae`` trains the TinyMLPerf AutoEncoder under
``--policy`` (default ``paper_fp16``: the RedMulE fp16 accumulator in every
GEMM; ``mixed_fp8_e4m3`` / ``mixed_fp8_e5m2`` store every GEMM operand in
FP8 with a per-tensor scale).  LM loss scaling, checkpointing, gradient
compression / data parallelism and failure injection are not ported yet
(ROADMAP.md): their flags are kept so a command line carries over, and
each raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.data import Prefetcher, SyntheticAE, SyntheticLM
from repro_torch.models import autoencoder, transformer
from repro_torch.optim import AdamW, OptState, clip_by_global_norm, tree_leaves, tree_map

__all__ = ["TrainState", "init_state", "build_train_step", "ae_grads",
           "build_ae_step", "main"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    scale: Any          # loss-scale state; () when disabled (always, here)


def init_state(cfg, opt, *, seed: int = 0, device="cuda",
               use_scale: bool = False) -> TrainState:
    """fp32 master parameters (``cfg.param_dtype``) drawn from ``seed`` on
    ``device``, marked as leaves that take gradients, and ``opt``'s state."""
    if use_scale:
        raise NotImplementedError(f"dynamic loss scaling is {_ROADMAP}")
    params = transformer.init_params(cfg, seed=seed, device=device,
                                     dtype=getattr(torch, cfg.param_dtype))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=opt.init(params), scale=())


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                               else v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def build_train_step(cfg, opt, rules=None, *, use_scale: bool = False,
                     clip_norm: float = 1.0, cast_params: bool = False,
                     grad_accum: int = 1):
    """``step(state, batch) -> (state, metrics)`` (``train.py:79-167`` of
    the reference): loss and gradients of ``transformer.loss_fn``, global-
    norm clipping, then ``opt``.  ``cast_params`` casts the fp32 master
    parameters to the compute dtype at step entry (differentiably: the
    gradients arrive in fp32); ``grad_accum`` splits the batch into
    microbatches and averages their fp32 gradients.  The state's tensors
    are updated in place and returned (the reference donates them)."""
    if rules is not None:
        raise NotImplementedError(f"sharding rules are {_ROADMAP}")
    if use_scale:
        raise NotImplementedError(f"dynamic loss scaling is {_ROADMAP}")

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        p = params
        if cast_params:
            p = tree_map(lambda x: x.to(cfg.policy.compute_dtype)
                         if x.is_floating_point() else x, params)
        loss, metrics = transformer.loss_fn(p, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return metrics, tree_map(lambda _: next(it), params)

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
                m, g = value_and_grad(state.params, part)
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
            metrics, grads = value_and_grad(state.params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, new_opt = opt.update(grads, state.opt, state.params)
        new_params = opt.apply(state.params, updates)
        metrics["grad_norm"] = gnorm
        return TrainState(new_params, new_opt, state.scale), metrics

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
    """Per-op engine summary and the fwd / bwd flop and byte split."""
    for op, d in engine.summarize(events).items():
        print(f"[engine] {op}: calls={d['calls']} "
              f"gflops={d['flops'] / 1e9:.3f} gbytes={d['bytes'] / 1e9:.3f}")
    split = {"fwd": 0, "bwd": 0}
    bsplit = {"fwd": 0, "bwd": 0}
    for ev in events:
        side = "bwd" if engine.is_backward_op(ev.spec.op) else "fwd"
        split[side] += ev.total_flops
        bsplit[side] += ev.total_bytes
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
        torch.autograd.grad(loss, tree_leaves(params))
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
    """Train on synthetic data; returns ``{"arch", "device", "params",
    "history": [{"step", "loss", "grad_norm", "step_ms"}, ...]}``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="xlstm-1.3b",
                   help="an LM arch id, or 'ae' (the paper's AutoEncoder)")
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    p.add_argument("--instrument", action="store_true",
                   help="run one step's loss and gradients under "
                        "engine.instrument() and print the per-op GEMM "
                        "summary with the fwd/bwd split before training")
    p.add_argument("--policy", default=None,
                   help="precision policy for --arch ae (default paper_fp16; "
                        "tpu_fp16, tpu_bf16, fp32, mixed_fp8_e4m3 and "
                        "mixed_fp8_e5m2 are also accepted)")
    unported = p.add_argument_group("not yet ported (ROADMAP.md); each raises")
    unported.add_argument("--ckpt-dir", default="")
    unported.add_argument("--save-every", type=int, default=50)
    unported.add_argument("--fp16-scale", action="store_true")
    unported.add_argument("--compress", default="none",
                          choices=("none", "fp16", "int8", "fp8", "fp8_e4m3",
                                   "fp8_e5m2"))
    unported.add_argument("--dp-procs", type=int, default=0)
    unported.add_argument("--fail-step", type=int, default=None)
    unported.add_argument("--fail-mode", default="die",
                          choices=("raise", "die", "sigterm", "ckpt_crash"))
    unported.add_argument("--result", default="")
    args = p.parse_args(argv)

    for flag, what in ((args.fp16_scale, "--fp16-scale (dynamic loss scaling "
                                         "of the LM step)"),
                       (bool(args.ckpt_dir), "--ckpt-dir (checkpointing, goodput)"),
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
    opt = AdamW(lr=args.lr, warmup_steps=10)
    step = build_train_step(cfg, opt)
    state = init_state(cfg, opt, seed=args.seed, device=device)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed)
    if args.instrument:
        _print_instrument_summary(
            _instrumented_events(cfg, state.params, ds.batch(0), device))

    n_params = transformer.count_params(cfg)
    print(f"arch={cfg.name} params={n_params} device={device} "
          f"batch={args.batch} seq={args.seq}", flush=True)
    history: List[Dict[str, float]] = []
    batches = Prefetcher(iter(ds), depth=2)
    try:
        for i in range(args.steps):
            batch = next(batches)
            with _StepTimer(device) as timer:
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
            history.append({"step": i, "loss": loss, "grad_norm": gnorm,
                            "step_ms": timer.ms})
            if i % 10 == 0 or i == args.steps - 1:
                print(f"[{i}] loss={loss:.4f} grad_norm={gnorm:.4f} "
                      f"step={timer.ms:.1f} ms", flush=True)
    finally:
        batches.close()
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return {"arch": cfg.name, "device": str(device), "params": n_params,
            "history": history}


if __name__ == "__main__":
    main()
