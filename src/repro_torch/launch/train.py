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
FP8 with a per-tensor scale).

``--ckpt-dir`` runs the fault-tolerant loop (``runtime/fault_tolerance.py``:
checkpoints every ``--save-every`` steps, auto-resume from the newest
valid one, the goodput heartbeat; ``--fail-step`` / ``--fail-mode`` inject
a fault).  ``--compress {none,fp16,int8,fp8,fp8_e4m3,fp8_e5m2}`` and / or
``--dp-procs N`` switch to the data-parallel step with a compressed
gradient wire (``build_compressed_dp_train_step``): N rank processes (gloo;
on one card every rank runs on ``cuda:0``), each on its contiguous
``batch / N`` rows, its fp32 error feedback kept on the rank; ``--result``
writes the params / error-feedback / optimizer digests and the loss, which
a killed and resumed run reproduces bit for bit::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --full --layers 2 --batch 4 --seq 256 --compress fp8_e4m3 \
        --dp-procs 2 --ckpt-dir D --save-every 2 --steps 4 \
        --fail-step 3 --fail-mode die          # exits 13; run again to resume

``--instrument`` then prints the wire bytes a step against the fp32 wire's
and, after a ``--ckpt-dir`` run, the goodput line.

``build_train_step(rules=...)`` runs on a mesh of ranks when one is active
(``make_sharded_train_step``; ``state_specs`` / ``batch_specs`` give the
layouts): each rank holds its blocks of the state and its data rows of the
batch, and the gradients are reduced as the layout asks (see
``build_train_step``).  ``launch/mesh.py`` runs such a step as a rank.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager, tree_flatten, tree_map_leaves
from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.data import Prefetcher, SyntheticAE, SyntheticLM
from repro_torch.models import autoencoder, moe, transformer
from repro_torch.optim import (AdamW, Compressor, OptState, adjust,
                               clip_by_global_norm, init_scale, scale_loss,
                               tree_leaves, tree_map, unscale_and_check)
from repro_torch.optim.compression import all_reduce_sum
from repro_torch.roofline import analysis
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import procs, sharding
from repro_torch.checkpoint.host_axis import HostAxisCheckpoint, digest
from repro_torch.runtime.fault_tolerance import (FailureInjector, GoodputMeter,
                                                 TrainLoop)

__all__ = ["TrainState", "init_state", "build_train_step",
           "build_compressed_dp_train_step", "state_specs", "batch_specs",
           "make_sharded_train_step", "ae_grads", "build_ae_step", "main"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    scale: Any          # LossScaleState, or () when loss scaling is off


def init_state(cfg, opt, *, seed: int = 0, device="cuda",
               use_scale: bool = False, mesh=None, specs=None) -> TrainState:
    """fp32 master parameters (``cfg.param_dtype``) drawn from ``seed`` on
    ``device``, marked as leaves that take gradients, ``opt``'s state, and
    with ``use_scale`` the dynamic loss scale (``optim.init_scale``).
    With ``mesh`` and ``specs`` (``state_specs(...).params``) the state is
    this rank's blocks, each leaf drawn whole and cut at once."""
    params = transformer.init_params(cfg, seed=seed, device=device,
                                     dtype=getattr(torch, cfg.param_dtype),
                                     mesh=mesh, specs=specs)
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


def _value_and_grad(cfg, params, batch, scale=None, *, cast_params: bool = False,
                    seed: float = 1.0):
    """``(metrics, grads)`` of ``transformer.loss_fn`` (times ``scale``
    when given, and the backward seeded with ``seed``) with respect to
    every parameter.  The token table of an embedding-input arch with an
    untied head is reached by no batch: it gets a zero gradient, as
    ``jax.grad`` gives it; any other leaf the loss does not reach is an
    error."""
    unused = cfg.input_mode == "embeddings" and not cfg.tie_embeddings
    leaves = [t for t in tree_leaves(params)
              if not (unused and t is params["embed"])]
    p = params
    if cast_params:
        p = tree_map(lambda x: x.to(cfg.policy.compute_dtype)
                     if x.is_floating_point() else x, params)
    loss, metrics = transformer.loss_fn(p, cfg, batch)
    if scale is not None:
        loss = scale_loss(loss, scale)
    if seed != 1.0:
        loss = loss * seed
    it = iter(torch.autograd.grad(loss, leaves))

    def grad_of(t):
        return (torch.zeros_like(t) if unused and t is params["embed"]
                else next(it))

    return metrics, tree_map(grad_of, params)


def build_train_step(cfg, opt, rules=None, *, use_scale: bool = False,
                     clip_norm: float = 1.0, cast_params: bool = False,
                     grad_accum: int = 1, return_grads: bool = False):
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
    (the reference donates them).

    Under ``rules`` with an active mesh of ranks (``sharding.use_mesh``,
    as ``make_sharded_train_step`` sets it) the state is this rank's
    blocks and the step takes the global batch and keeps the rows of its
    data coordinates.  The backward is seeded with ``1 / model``: a value
    replicated over the model axis carries a share of its gradient on each
    rank (``runtime/collectives.py``), so a leaf replicated over the model
    axis sums its gradient over it; every gradient is then averaged over
    the data axes (each rank's loss is the mean over its rows; a leaf FSDP
    cuts over a data axis arrives summed over it and is divided by its
    size).  With ``grad_accum`` the rank takes its data rows of each
    microbatch and accumulates their gradients locally: one reduction a
    step.  Clipping takes the global norm: the squares of each leaf summed
    over the axes it is cut over, replicated ones counted once.  Without a mesh the
    rules change nothing (the reference's no-op).  ``return_grads`` puts a
    copy of the (reduced, unclipped) gradients in ``metrics["grads"]``."""

    def microbatches(batch):
        """The batch's ``grad_accum`` microbatches: rows [i B / n, (i + 1)
        B / n), each as a leading index of the reshaped batch."""
        B = next(iter(batch.values())).shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} does not split into {grad_accum} "
                             "microbatches")
        return {k: v.reshape(grad_accum, B // grad_accum, *v.shape[1:])
                for k, v in batch.items()}

    def accumulate(params, parts, scale, seed=1.0):
        """``(metrics, grads)`` of ``transformer.loss_fn`` averaged over the
        microbatches ``parts``, their gradients accumulated in fp32."""
        grads = metrics = None
        for part in parts:
            m, g = _value_and_grad(cfg, params, part, scale if use_scale else None,
                                   cast_params=cast_params, seed=seed)
            m = {k: v.detach() for k, v in m.items()}
            if grad_accum > 1:
                g = tree_map(lambda x: x.float(), g)
            if grads is None:
                grads, metrics = g, m
            else:
                grads = tree_map(torch.add, grads, g)
                metrics = {k: metrics[k] + m[k] for k in metrics}
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            grads = tree_map(lambda g: g * inv, grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        return metrics, grads

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with sharding.use_rules(rules):
            sh = sharding.context()
            if sh is None:
                return _step(state, batch)
            return _sharded_step(state, batch, sh)

    def _sharded_step(state: TrainState, batch, sh):
        device = tree_leaves(state.params)[0].device
        # the unsharded path's microbatches; the rank keeps its data rows
        # of each and accumulates their gradients locally
        mbs = {k: sharding.shard_block(v, sharding.P(None, sh.data_axes), sh.mesh)
               for k, v in microbatches(_to_device(batch, device)).items()}
        pspec = sharding.sanitize_tree(transformer.param_specs(cfg, sh.rules),
                                       transformer.abstract_params(cfg), sh.mesh)
        metrics, grads = accumulate(
            state.params, [{k: v[i] for k, v in mbs.items()} for i in range(grad_accum)],
            state.scale, 1.0 / sh.model)
        for a in sh.data_axes:
            metrics = {k: coll.pmean(v, sh.mesh, a) for k, v in metrics.items()}
        grads = _reduce_grads(grads, pspec, sh)
        if return_grads:
            metrics["grads"] = tree_map(lambda g: g.detach().clone(), grads)
        finite, new_scale = None, state.scale
        if use_scale:
            grads, finite = unscale_and_check(grads, state.scale)
            finite = torch.tensor(not procs.agree_any(not bool(finite)),
                                  device=device)
            new_scale = adjust(state.scale, finite)
            metrics["loss_scale"] = new_scale.scale
            metrics["finite"] = finite.to(torch.float32)
        gnorm = _global_norm(grads, pspec, sh)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        for g in tree_leaves(grads):
            g.copy_((g.float() * scale).to(g.dtype))
        metrics["grad_norm"] = gnorm
        if finite is not None and not bool(finite):
            return TrainState(state.params, state.opt, new_scale), metrics
        updates, new_opt = opt.update(grads, state.opt, state.params)
        return TrainState(opt.apply(state.params, updates), new_opt, new_scale), metrics

    def _step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = tree_leaves(state.params)[0].device
        mbs = microbatches(_to_device(batch, device))
        metrics, grads = accumulate(
            state.params, [{k: v[i] for k, v in mbs.items()} for i in range(grad_accum)],
            state.scale)
        if return_grads:
            metrics["grads"] = tree_map(lambda g: g.detach().clone(), grads)
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


def _cut_axes(spec) -> frozenset:
    """The mesh axes a (sanitized) spec cuts its leaf over."""
    return frozenset(a for p in spec for a in sharding.axes_of(p))


def _reduce_grads(grads, pspec, sh):
    """Sum the gradients of model-replicated leaves over the model axis,
    then average every gradient over the data axes: a leaf cut over a
    data axis (FSDP) arrives summed over it (its gather's backward, a
    reduce-scatter) and is divided by the axis size; a whole one is
    averaged (``pmean``).  fp32 buckets, one collective per axis."""
    leaves, specs = tree_flatten(grads), sharding.spec_leaves(pspec)

    def bucket(sel, reduce):
        if not sel:
            return
        flat = torch.cat([leaves[i].float().reshape(-1) for i in sel])
        flat = reduce(flat)
        off = 0
        for i in sel:
            n = leaves[i].numel()
            leaves[i].copy_(flat[off:off + n].view_as(leaves[i]))
            off += n

    cut = [_cut_axes(sp) for sp in specs]
    with torch.no_grad():
        if sh.model > 1:
            bucket([i for i, c in enumerate(cut) if sharding.MODEL_AXIS not in c],
                   lambda f: coll.psum(f, sh.mesh, sharding.MODEL_AXIS))
        for a in (a for a in sh.data_axes if sh.mesh.shape[a] > 1):
            n = sh.mesh.shape[a]
            for i in (i for i, c in enumerate(cut) if a in c):
                leaves[i].div_(n)
            bucket([i for i, c in enumerate(cut) if a not in c],
                   lambda f: coll.pmean(f, sh.mesh, a))
    return grads


def _global_norm(grads, pspec, sh) -> torch.Tensor:
    """The norm of the whole (unsharded) gradient tree: each leaf's
    squares summed over the axes its spec cuts it over, once each; a
    replicated leaf counted once."""
    sums: Dict[frozenset, torch.Tensor] = {}
    for g, sp in zip(tree_flatten(grads), sharding.spec_leaves(pspec)):
        key = _cut_axes(sp)
        sq = g.float().square().sum()
        sums[key] = sq if key not in sums else sums[key] + sq
    total = 0.0
    for axes in sorted(sums, key=sorted):
        sq = sums[axes]
        for a in sorted(axes):
            sq = coll.psum(sq, sh.mesh, a)
        total = total + sq
    return torch.sqrt(total)


def state_specs(cfg, rules, mesh, opt, *, use_scale: bool = False) -> TrainState:
    """The sanitized spec of every leaf of the train state: the moments
    follow their parameters, the step and the loss scale are replicated."""
    pspec = sharding.sanitize_tree(transformer.param_specs(cfg, rules),
                                   transformer.abstract_params(cfg), mesh)
    scalar = sharding.P()
    opt_spec = OptState(step=scalar, mu=pspec, nu=pspec)
    scale_spec = (type(init_scale(device="meta"))(*(scalar,) * 4)
                  if use_scale else ())
    return TrainState(params=pspec, opt=opt_spec, scale=scale_spec)


def batch_specs(cfg, mesh) -> dict:
    """A batch's rows over the data axes."""
    dp = tuple(a for a in sharding.DATA_AXES if a in mesh.shape)
    dp = dp[0] if len(dp) == 1 else dp
    if cfg.input_mode == "embeddings":
        return {"embeddings": sharding.P(dp, None, None),
                "labels": sharding.P(dp, None)}
    return {"inputs": sharding.P(dp, None), "labels": sharding.P(dp, None)}


def make_sharded_train_step(cfg, mesh, rules, opt, *, use_scale: bool = False,
                            **kwargs):
    """``(step, state_specs)``: :func:`build_train_step` bound to ``mesh``
    (this rank's part of it: the state is its blocks, the batch global)."""
    inner = build_train_step(cfg, opt, rules, use_scale=use_scale, **kwargs)

    def step(state, batch):
        with sharding.use_mesh(mesh):
            return inner(state, batch)

    return step, state_specs(cfg, rules, mesh, opt, use_scale=use_scale)


def build_compressed_dp_train_step(cfg, opt, compressor: Compressor, *,
                                   clip_norm: float = 1.0):
    """The data-parallel train step on a compressed gradient wire
    (``train.py:170-240`` of the reference): each rank takes its
    contiguous ``batch / N`` rows of the global batch, computes
    ``transformer.loss_fn``'s gradients, compresses them with its own
    error feedback, and the wire is all-reduced over the process group
    (``Compressor.psum_wire``); then global-norm clipping and ``opt`` on
    the replicated state, identical on every rank.  ``loss`` is the mean
    over the ranks.  Without a group the world is one rank.

    Returns ``(step, init_fn)``; the state is ``(TrainState, ef)`` with
    ``ef`` this rank's compressor state (None on the fp32 wire; the
    checkpoint stacks every rank's on a leading host axis,
    ``checkpoint.host_axis.HostAxisCheckpoint``).  ``step.allreduce_s`` records
    each step's all-reduce seconds (the device synchronised first)."""

    def init_fn(seed: int = 0, device="cuda"):
        state = init_state(cfg, opt, seed=seed, device=device)
        return state, compressor.init(state.params)

    def step(state_and_ef, batch):
        state, ef = state_and_ef
        r, n = procs.rank(), procs.world()
        device = tree_leaves(state.params)[0].device
        batch = _to_device(batch, device)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch {rows} does not split over {n} ranks")
        b = rows // n
        metrics, grads = _value_and_grad(
            cfg, state.params, {k: v[r * b:(r + 1) * b] for k, v in batch.items()})
        wire, ef = compressor.compress(grads, ef)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        mean_g = compressor.psum_wire(wire)
        loss = all_reduce_sum([metrics["loss"].detach().float()])[0] / n
        step.allreduce_s.append(time.perf_counter() - t0)
        mean_g, gnorm = clip_by_global_norm(mean_g, clip_norm)
        updates, new_opt = opt.update(mean_g, state.opt, state.params)
        params = opt.apply(state.params, updates)
        return (TrainState(params, new_opt, state.scale), ef), {
            "loss": loss, "grad_norm": gnorm}

    step.allreduce_s = []
    return step, init_fn


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


def _print_goodput(out) -> None:
    g = out.get("goodput")
    if not g:
        return
    print(f"[ft] goodput={g['goodput']:.3f} "
          f"useful={g['useful_time']:.2f}s wall={g['wall_time']:.2f}s "
          f"lost_to_restart={g['time_lost_to_restart']:.2f}s "
          f"recomputed_steps={g['recomputed_steps']} "
          f"restarts={g['restarts']}")


def _kernel_launches() -> Dict[str, int]:
    """Every launch counter of the kernel wrappers in this process, keyed
    ``"<wrapper>.<counter>"`` (``redmule_matmul.launches``,
    ``redmule_matmul.launches_fp32``, ...)."""
    from repro_torch.kernels import chunked_linear_attention as cla
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    return {f"{fn.__name__}.{attr}": n
            for fn in (ops.redmule_matmul, ops.redmule_matmul_batched,
                       fa.flash_attention, cla.chunked_linear_attention)
            for attr, n in vars(fn).items() if attr.startswith("launches")}


def _ft_loop(args, step, ckpt, rank: int = 0, world: int = 1) -> TrainLoop:
    """The fault-tolerant loop of a ``--ckpt-dir`` run; rank 0 keeps the
    heartbeat in the checkpoint directory, another rank in its own."""
    injector = None
    if args.fail_step is not None:
        injector = FailureInjector(fail_at_step=args.fail_step, mode=args.fail_mode)
    root = args.ckpt_dir if rank == 0 else os.path.join(args.ckpt_dir, f".rank{rank}")
    # saves are synchronous: a full-width checkpoint written on a thread
    # would still be in flight when an injected death comes a step later
    return TrainLoop(step, ckpt, save_every=args.save_every, injector=injector,
                     async_save=False, handle_sigterm=True,
                     goodput=GoodputMeter(root),
                     sync_preempt=procs.agree_any if world > 1 else None)


def _write_result(path: str, res: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1)
    os.replace(tmp, path)
    print(f"[ft] result digests -> {path}")


def _compressed_dp_main(args, argv, cfg, device) -> Dict[str, Any]:
    """Data-parallel training on a compressed gradient wire, with the
    fault-tolerant loop when ``--ckpt-dir`` is set (``train.py:294-388``
    of the reference).  ``--dp-procs N > 1`` outside a rank starts the N
    ranks and returns ``{"returncode": ...}``."""
    n = max(args.dp_procs, 1)
    if args.batch % n:
        raise SystemExit(f"--batch {args.batch} must divide by --dp-procs {n}")
    if n > 1 and procs.rank_env() is None:
        rc = procs.spawn(n, ["-m", "repro_torch.launch.train", *argv],
                         run_dir=args.ckpt_dir or None)
        return {"returncode": rc}
    t0 = time.perf_counter()
    rank, world = procs.init_group()
    if world != n:
        raise SystemExit(f"--dp-procs {n} but this group has {world} ranks")
    setup_s = {"group": time.perf_counter() - t0}
    comp = Compressor(args.compress)
    opt = AdamW(lr=args.lr, warmup_steps=10)
    step, init_fn = build_compressed_dp_train_step(cfg, opt, comp)
    state = init_fn(seed=args.seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s["state"] = time.perf_counter() - t0 - setup_s["group"]
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed,
                     embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0)
    if args.instrument:
        wire = comp.wire_bytes(state[0].params)
        full = Compressor("none").wire_bytes(state[0].params)
        print(f"[ft] gradient wire: kind={comp.kind} bytes/step={wire} "
              f"fp32_bytes/step={full} ratio={full / max(wire, 1):.2f}x")
    print(f"arch={cfg.name} params={transformer.count_params(cfg)} device={device} "
          f"policy={cfg.policy_name} batch={args.batch} seq={args.seq} "
          f"dp={world} compress={comp.kind}", flush=True)
    launches0 = _kernel_launches()
    res: Dict[str, Any] = {}
    if args.ckpt_dir:
        ckpt = HostAxisCheckpoint(CheckpointManager(args.ckpt_dir, keep=2), 1)
        loop = _ft_loop(args, step, ckpt, rank, world)
        out = loop.run(state, ds.batch, args.steps)
        final_state = out["final_state"]
        final_loss = float(out["history"][-1]["loss"])
        print(f"final loss: {final_loss:.4f} "
              f"(stragglers: {out['straggler_steps']})")
        if args.instrument:
            _print_goodput(out)
        res.update(step_s=loop.step_times, save_s=ckpt.save_s,
                   restore_s=ckpt.restore_s, goodput=out["goodput"],
                   last_step=out["last_step"], preempted=out["preempted"])
    else:
        step_s, final_loss = [], float("nan")
        for i in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, ds.batch(i))
            final_loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - t0)
            if i % 10 == 0:
                print(f"[{i}] loss={final_loss:.4f}", flush=True)
        final_state = state
        print(f"final loss: {final_loss:.4f}")
        res.update(step_s=step_s)
    launches = {k: v - launches0.get(k, 0) for k, v in _kernel_launches().items()}
    res.update(setup_s=setup_s)
    if args.result:
        t1 = time.perf_counter()
        ef = final_state[1]
        ef_hosts = None if ef is None else tree_map_leaves(procs.gather_to_rank0, ef)
        if rank == 0:
            # sha256 releases the GIL on large buffers: one thread a digest
            with concurrent.futures.ThreadPoolExecutor(3) as pool:
                digests = dict(zip(("digest", "ef_digest", "opt_digest"), pool.map(
                    digest, (final_state[0].params, ef_hosts, final_state[0].opt))))
            _write_result(args.result, {
                **digests, "loss": final_loss, "dp": world, "compress": comp.kind,
                "launches": launches, "allreduce_s": step.allreduce_s,
                "digest_s": time.perf_counter() - t1, **res})
    procs.finish()
    return {"arch": cfg.name, "device": str(device), "dp": world,
            "compress": comp.kind, "loss": final_loss, "launches": launches, **res}


def main(argv=None) -> Dict[str, Any]:
    """Train on synthetic data; returns ``{"arch", "device", "policy",
    "params", "history": [{"step", "loss", "grad_norm", "step_ms"}, ...]}``
    (with ``--fp16-scale`` each step also carries ``loss_scale`` and
    ``finite``, a MoE arch's the three router metrics; a ``--ckpt-dir`` run
    also ``goodput``).  The data-parallel path returns its own summary
    (:func:`_compressed_dp_main`); its launcher ``{"returncode": rc}``."""
    argv = list(sys.argv[1:] if argv is None else argv)
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
                        "summary with the fwd/bwd split before training "
                        "(the DP path: the wire bytes, and the goodput line "
                        "after a --ckpt-dir run)")
    p.add_argument("--fp16-scale", action="store_true",
                   help="LM archs: tpu_fp16 compute with dynamic loss scaling")
    p.add_argument("--policy", default=None,
                   help="precision policy for --arch ae (default paper_fp16; "
                        "tpu_fp16, tpu_bf16, fp32, mixed_fp8_e4m3 and "
                        "mixed_fp8_e5m2 are also accepted)")
    p.add_argument("--ckpt-dir", default="",
                   help="run the fault-tolerant loop, checkpointing here and "
                        "resuming from the newest valid checkpoint")
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--compress", default="none",
                   choices=("none", "fp16", "int8", "fp8", "fp8_e4m3", "fp8_e5m2"),
                   help="gradient all-reduce wire of the data-parallel step "
                        "(fp8* = E4M3 / E5M2 with delayed scaling and error "
                        "feedback)")
    p.add_argument("--dp-procs", type=int, default=0,
                   help="data-parallel ranks (processes; on one card every "
                        "rank runs on cuda:0); 0 = one")
    p.add_argument("--fail-step", type=int, default=None,
                   help="inject a failure at this step (needs --ckpt-dir)")
    p.add_argument("--fail-mode", default="die",
                   choices=("raise", "die", "sigterm", "ckpt_crash"),
                   help="failure kind for --fail-step")
    p.add_argument("--result", default="",
                   help="write the final params / error-feedback / optimizer "
                        "sha256 digests and the loss as JSON")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.arch == "ae":
        return _ae_main(args, device)
    if args.policy is not None:
        raise ValueError("--policy applies to --arch ae only")
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.compress != "none" or args.dp_procs:
        return _compressed_dp_main(args, argv, cfg, device)
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
    summary = {"arch": cfg.name, "device": str(device), "policy": cfg.policy_name,
               "params": n_params}
    if args.ckpt_dir:
        loop = _ft_loop(args, step, CheckpointManager(args.ckpt_dir, keep=2))
        # step-indexed batches: the stream replays exactly after a restart
        out = loop.run(state, ds.batch, args.steps)
        first = out["last_step"] + 1 - len(out["history"])
        history = [{"step": first + i, **m, "step_ms": dt * 1e3}
                   for i, (m, dt) in enumerate(zip(out["history"], loop.step_times))]
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"(stragglers: {out['straggler_steps']})")
        if args.instrument:
            _print_goodput(out)
        if args.result:
            final = out["final_state"]
            _write_result(args.result, {
                "digest": digest(final.params), "ef_digest": digest(None),
                "opt_digest": digest(final.opt), "loss": history[-1]["loss"]})
        return {**summary, "history": history, "goodput": out["goodput"]}
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
    if args.result:
        _write_result(args.result, {
            "digest": digest(state.params), "ef_digest": digest(None),
            "opt_digest": digest(state.opt),
            "loss": history[-1]["loss"] if history else float("nan")})
    return {**summary, "history": history}


if __name__ == "__main__":
    sys.exit(main().get("returncode", 0))
