"""Meshes: the production layouts, and a mesh over a process group.

Counterpart of ``repro.launch.mesh``.  The production meshes are
descriptions here — ``(16, 16)`` ``("data", "model")`` for one pod,
``(2, 16, 16)`` ``("pod", "data", "model")`` for two, whose "pod" axis
carries only data parallelism — since the spec tables read nothing but
``mesh.shape`` (``runtime/sharding.py::sanitize_spec``).

:func:`make_mesh` lays a mesh over the ranks of the current process group
(``runtime/procs.py``), row-major as a device mesh is: rank ``r`` sits at
the coordinates of ``r`` in ``shape``.  Each axis longer than one gets
one gloo sub-group per line of ranks along it, so a collective "over
model" (``runtime/collectives.py``) runs among the ranks that share every
other coordinate.  Every rank builds every sub-group, in one order, as
``torch.distributed.new_group`` requires.

Run as a module, this file is one rank of a sharded cell::

    PYTHONPATH=src python -m repro_torch.launch.mesh --spawn 2 --device cpu \\
        --plan plan.json --out /tmp/shard

with ``plan.json`` a list of cells, e.g. ``[{"name": "s", "kind": "serve",
"arch": "qwen3-1.7b", "mesh": [1, 2], "batch": 2, "prompt": 8, "gen": 4}]``

(see :func:`main`): the CPU tests and ``chip_smoke.py`` start it through
``runtime.procs.spawn``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_production_mesh", "data_axes", "make_host_mesh",
           "make_mesh", "recurrent_states", "main"]


class Mesh:
    """Axis names, their sizes (``.shape``, a name -> size dict), this
    rank's coordinates (``.coords``), the device its shards live on and,
    when bound to a process group, one gloo sub-group per axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None, rank: int = 0, groups: Optional[Dict] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.devices_shape = tuple(int(s) for s in shape)
        self.shape = dict(zip(self.axis_names, self.devices_shape))
        self.size = math.prod(self.devices_shape)
        self.rank = rank
        idx = np.unravel_index(rank, self.devices_shape)
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self.device = torch.device(device) if device is not None else None
        self._groups = groups or {}

    def group(self, axis: str):
        """The gloo group of this rank's line along ``axis``."""
        if self.shape.get(axis, 1) == 1:
            return None
        if axis not in self._groups:
            raise RuntimeError(f"mesh {self.shape} is a description, not "
                               "bound to a process group (launch.mesh.make_mesh)")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def make_host_mesh(device="cpu") -> Mesh:
    """A one-rank mesh with the single pod's axis names."""
    return Mesh((1, 1), ("data", "model"), device=device)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("data", "model"),
              *, device=None) -> Mesh:
    """A mesh over the current process group (world size = its size)."""
    from repro_torch.runtime import procs

    r, n = procs.rank(), procs.world()
    size = math.prod(shape)
    if size != n:
        raise ValueError(f"mesh {tuple(shape)} needs {size} ranks, the group "
                         f"has {n}")
    groups = {}
    if n > 1:
        import torch.distributed as dist
        grid = np.arange(n).reshape(tuple(shape))
        for ax, name in enumerate(axis_names):
            if shape[ax] == 1:
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                g = dist.new_group([int(x) for x in line], backend="gloo")
                if r in line:
                    groups[name] = g
    return Mesh(shape, axis_names, device=device, rank=r, groups=groups)


# --------------------------------------------------------------------- #
# The rank worker: one rank's part of the sharded cells of a plan
# --------------------------------------------------------------------- #
def _wrappers():
    from repro_torch.kernels import chunked_linear_attention, flash_attention, ops

    return (ops.redmule_matmul, ops.redmule_matmul_batched,
            flash_attention.flash_attention,
            chunked_linear_attention.chunked_linear_attention)


def _kernel_launches() -> Dict[str, int]:
    """Every launch counter of the kernel wrappers, ``"<wrapper>.<counter>"``."""
    return {f"{fn.__name__}.{a}": getattr(fn, a) for fn in _wrappers()
            for a in vars(fn) if a.startswith("launches")}


def _zero_launches() -> None:
    for fn in _wrappers():
        for a in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(fn, a, 0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the cell's peak before the last _reset_peak (a cell's peak_bytes is the
# larger of it and the peak since)
_CELL_PEAK = [0]


def _reset_peak(device) -> None:
    """Start a step's peak (the cell's so far is kept in ``_CELL_PEAK``)."""
    if device.type == "cuda":
        _CELL_PEAK[0] = max(_CELL_PEAK[0], torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> Optional[int]:
    """``max_memory_allocated`` since the last :func:`_reset_peak` (None
    off the card)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _cfg(cell):
    from repro_torch import configs

    cfg = (configs.get if cell.get("full") else configs.get_reduced)(cell["arch"])
    repl = {k: cell[k] for k in ("n_layers", "policy_name", "moe_impl", "remat")
            if k in cell}
    # model overrides, e.g. hymba's heads: {"n_heads": 5, "n_kv_heads": 1}
    return dataclasses.replace(cfg, **repl, **cell.get("overrides", {}))


def _params(cell, cfg, mesh, specs, dtype):
    """This rank's blocks: from a host tree file (``params``) or drawn from
    ``seed`` leaf by leaf and cut."""
    from repro_torch.models import transformer
    from repro_torch.runtime.fault_tolerance import reshard

    if cell.get("params"):
        host = torch.load(cell["params"], weights_only=True)
        cast = lambda t: t.to(dtype) if isinstance(t, torch.Tensor) else {
            k: cast(v) for k, v in t.items()}
        return reshard(cast(host), mesh, specs)
    return transformer.init_params(cfg, seed=cell.get("seed", 0), device=mesh.device,
                                   dtype=dtype, mesh=mesh, specs=specs)


def _rules(cell, serve: bool):
    """The cell's layout: ``Rules(fsdp=, sequence_parallel=)`` from its
    keys, wrapped in the serving rules (``launch.serve.serve_rules``) when
    ``serve_rules`` (by default: a serve cell)."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.runtime import sharding

    base = sharding.Rules(fsdp=cell.get("fsdp", False),
                          sequence_parallel=cell.get("sequence_parallel", False))
    return serve_lib.serve_rules(base) if cell.get("serve_rules", serve) else base


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return sum(_tree_bytes(v) for v in tree)


def recurrent_states(cache, path=()) -> Dict[str, torch.Tensor]:
    """The recurrent-state leaves of a decode cache (xLSTM's ``mlstm`` /
    ``slstm``, hymba's ``ssm``), by path."""
    if isinstance(cache, torch.Tensor):
        keep = any(k in ("mlstm", "slstm", "ssm") for k in path)
        return {"/".join(path): cache} if keep else {}
    out = {}
    for k, v in cache.items():
        out.update(recurrent_states(v, path + (k,)))
    return out


def _digest(tensors: Dict[str, torch.Tensor]) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _aten_library(fn, device) -> Dict[str, float]:
    """The aten contractions one call of ``fn`` runs (host profile), by the
    escape audit's list (:data:`repro_torch.analysis.aten_audit.CONTRACTIONS`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.aten_audit import CONTRACTIONS

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        _sync(device)
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.key in CONTRACTIONS}


def _bill(events) -> Dict[str, Dict[str, float]]:
    """The engine's flops and bytes of ``events`` by direction (what the
    dry run predicts for the same step, ``launch/dryrun.py``)."""
    from repro_torch.roofline import analysis

    return {"flops": analysis.flops_by_direction(events),
            "bytes": analysis.bytes_by_direction(events)}


@contextlib.contextmanager
def _local_amax():
    """A control cell: every FP8 amax from the rank's own block.  The one
    reduction every per-tensor scale on a mesh takes (``collectives.
    pmax_over``: the engine's operands, the KV cache's write-back and
    admission, the scale report) keeps the rank's value."""
    from repro_torch.runtime import collectives as coll

    real = coll.pmax_over
    coll.pmax_over = lambda x, mesh, axes: real(x, mesh, ())
    try:
        yield
    finally:
        coll.pmax_over = real


def _scale_leaves(cache, cspec, mesh):
    """The FP8 cache's scale leaves gathered whole (host fp32 / int32):
    ``{"<key>/<name>_scale/<field>": tensor}``; empty for a 16-bit cache."""
    from repro_torch.runtime.fault_tolerance import gather

    out = {}
    for key, sub in cache.items():
        for name, leaf in sub.items():
            if name.endswith("_scale"):
                whole = gather(leaf, mesh, cspec[key][name])
                out.update({f"{key}/{name}/{f}": t.cpu() for f, t in whole.items()})
    return out


def _serve_pass(cfg, mesh, rules, params, prompts, G: int, T: int,
                storage_dtype, info: Dict, tag: str = ""):
    """Prefill ``prompts`` and ``G`` greedy decode steps on a cache of ``T``
    positions (FP8 with ``storage_dtype``): ``(logits (G + 1, B, V), fed
    (B, G), cache, cache specs)``; times, collectives, launches and bills
    into ``info`` (keys suffixed ``tag``)."""
    from repro_torch.core import engine
    from repro_torch.launch import serve as serve_lib
    from repro_torch.runtime import collectives as coll

    dev = mesh.device
    B, S = prompts.shape
    step, _, cspec = serve_lib.make_sharded_serve_step(
        cfg, mesh, rules, batch=B, max_len=T, storage_dtype=storage_dtype)
    pre = serve_lib.build_prefill(cfg, rules, T, mesh=mesh, storage_dtype=storage_dtype)
    coll.reset_stats()
    _zero_launches()
    _sync(dev)
    t0 = time.perf_counter()
    with engine.instrument() as events:
        logits, cache = pre(params, {"inputs": prompts.to(dev)})
    _sync(dev)
    info[f"prefill_s{tag}"] = time.perf_counter() - t0
    info[f"collectives_prefill{tag}"] = {k: dict(v) for k, v in coll.STATS.items()}
    info[f"launches_prefill{tag}"] = _kernel_launches()
    info[f"bill_prefill{tag}"] = _bill(events)
    rows, fed = [logits.float().cpu()], []
    coll.reset_stats()
    _zero_launches()
    t0 = time.perf_counter()
    with engine.instrument() as events:
        for i in range(G):
            tok = rows[-1].argmax(-1, keepdim=True)
            fed.append(tok)
            lg, cache = step(params, cache, tok.to(dev), S + i)
            rows.append(lg.float().cpu())
    _sync(dev)
    info[f"decode_s{tag}"] = time.perf_counter() - t0
    info[f"bill_decode{tag}"] = _bill(events)
    info[f"collectives_decode{tag}"] = {k: dict(v) for k, v in coll.STATS.items()}
    info[f"launches_decode{tag}"] = _kernel_launches()
    return torch.stack(rows), (torch.cat(fed, 1) if fed else None), cache, cspec


def _serve_cell(cell, mesh, out: Dict) -> Dict:
    """Prefill and greedy decode (teacher-forcing references are the
    caller's); ``storage_dtype`` serves from the FP8 cache, ``fp8_pass``
    runs a second pass over the same weights on an E4M3 cache (outputs
    suffixed ``_fp8``), ``generate`` also runs ``launch.serve.generate``.
    The cache holds ``max_len`` positions (default: prompt + gen rounded up
    to a multiple of the model axis)."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import moe

    cfg = _cfg(cell)
    dev = mesh.device
    B, S, G = cell["batch"], cell["prompt"], cell["gen"]
    m = mesh.shape["model"]
    T = cell.get("max_len", -(-(S + G) // m) * m)
    rules = _rules(cell, True)
    storage = cell.get("storage_dtype")
    _, pspec, _ = serve_lib.make_sharded_serve_step(cfg, mesh, rules, batch=B, max_len=T)
    params = _params(cell, cfg, mesh, pspec, cfg.policy.compute_dtype)
    info: Dict = {"param_bytes": _tree_bytes(params)}
    prompts = torch.from_numpy(np.random.default_rng(cell.get("data_seed", 1))
                               .integers(0, cfg.vocab_size, (B, S))).long()
    moe.ROUTES.clear()
    _reset_peak(dev)
    logits, fed, cache, cspec = _serve_pass(cfg, mesh, rules, params, prompts, G, T,
                                            storage, info)
    info["peak_steps_bytes"] = _peak(dev)      # over the prefill and decode steps
    info["decode_steps"] = G
    info["kv_bytes"] = _tree_bytes(cache)
    info["route"] = dict(moe.ROUTES)
    states = recurrent_states(cache)
    if states:      # replicated on every rank: held bitwise across them
        info["state_digest"] = _digest(states)
        out["states"] = {k: v.float().cpu() for k, v in states.items()}
    if dev.type == "cuda" and cell.get("profile"):
        step = serve_lib.make_sharded_serve_step(cfg, mesh, rules, batch=B, max_len=T,
                                                 storage_dtype=storage)[0]
        tok = logits[-1].argmax(-1, keepdim=True).to(dev)
        info["aten_library_decode"] = _aten_library(
            lambda: step(params, cache, tok, T - 1), dev)
    out.update(prompts=prompts, fed=fed, logits=logits,
               scales=_scale_leaves(cache, cspec, mesh))
    del cache
    if cell.get("fp8_pass"):
        lg8, fed8, cache8, cspec8 = _serve_pass(cfg, mesh, rules, params, prompts, G, T,
                                                "float8_e4m3fn", info, "_fp8")
        info["kv_bytes_fp8"] = _tree_bytes(cache8)
        out.update(fed_fp8=fed8, logits_fp8=lg8,
                   scales_fp8=_scale_leaves(cache8, cspec8, mesh))
        del cache8
    if cell.get("generate"):
        seqs, gcache, final = serve_lib.generate(params, cfg, prompts, G, rules=rules,
                                                 mesh=mesh, storage_dtype=storage,
                                                 return_state=True)
        gspec = serve_lib.cache_spec_tree(cfg, rules, mesh, B, S + G, storage)
        out.update(gen_seqs=torch.from_numpy(seqs), gen_final=torch.from_numpy(final),
                   gen_scales=_scale_leaves(gcache, gspec, mesh))
    return info


def _train_cell(cell, mesh, out: Dict) -> Dict:
    from repro_torch.core import engine
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import AdamW, tree_leaves
    from repro_torch.runtime import collectives as coll, sharding
    from repro_torch.runtime.fault_tolerance import gather

    cfg = _cfg(cell)
    dev = mesh.device
    opt = AdamW(lr=cell.get("lr", 1e-3))
    rules = _rules(cell, False)
    step, sspec = train_lib.make_sharded_train_step(
        cfg, mesh, rules, opt, return_grads=True, grad_accum=cell.get("grad_accum", 1),
        cast_params=cell.get("cast_params", False))
    params = _params(cell, cfg, mesh, sspec.params, getattr(torch, cfg.param_dtype))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = train_lib.TrainState(params, opt.init(params), ())
    ds = SyntheticLM(cfg.vocab_size, cell["seq"], cell["batch"], seed=cell.get("data_seed", 0))
    info: Dict = {"losses": [], "grad_norms": [], "step_s": [], "collectives": [],
                  "param_bytes": _tree_bytes(state.params),
                  "moment_bytes": _tree_bytes(state.opt.mu) + _tree_bytes(state.opt.nu)}
    for i in range(cell["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
        coll.reset_stats()
        _zero_launches()
        _sync(dev)
        _reset_peak(dev)
        t0 = time.perf_counter()
        with engine.instrument() as events, engine.record_scales() as scales:
            state, m = step(state, batch)
        loss = float(m["loss"])
        if i == 0 and cell.get("record_scales"):
            info["scales0"] = [[label, float(sc)] for label, sc in scales]
        info["step_s"].append(time.perf_counter() - t0)
        info["losses"].append(loss)
        info["grad_norms"].append(float(m["grad_norm"]))
        info["collectives"].append({k: dict(v) for k, v in coll.STATS.items()})
        info.setdefault("launches", []).append(_kernel_launches())
        info.setdefault("bill", []).append(_bill(events))
        info.setdefault("peak_steps_bytes", []).append(_peak(dev))
        if i == 0:
            grads, specs = m["grads"], sspec.params
            if cell.get("grads"):       # only these leaves ("a/b/c" paths)
                grads, specs = (_select(t, cell["grads"]) for t in (grads, specs))
            out["grads0"] = _host(gather(grads, mesh, specs))
            out["batch0"] = batch
            info.update({k: float(v) for k, v in m.items()
                         if k.startswith("moe_")})
    if dev.type == "cuda" and cell.get("profile"):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(0).items()}
        info["aten_library_step"] = _aten_library(lambda: step(state, batch), dev)
    return info


def _sched_cell(cell, mesh, out: Dict) -> Dict:
    """The continuous-batching scheduler on the mesh (``serving.
    scheduler``): ``requests`` seeded Poisson requests (``serving.loadgen``:
    ``rate``, ``prompt``, ``gen``, ``seed``) into ``n_slots`` slots of
    ``max_len`` positions (default prompt + gen + 4), FP8 with
    ``storage_dtype``, the KV audit every ``audit_every`` decode steps and
    an injector ``inject`` ("mode@step"), under the cell's rules (default
    the serving rules).  Every rank writes its trace digest, collectives,
    launches and peak, and a digest of each pool leaf that its spec leaves
    whole (every rank holds the same bytes); rank 0 the trace, each
    request's tokens and final logits and the pool's scale leaves
    (gathered; with ``pool`` its KV data leaves too).  ``rebuild: false``
    is a control: a quarantined slot is left as it is, stale."""
    import hashlib

    from repro_torch.core import engine
    from repro_torch.launch import serve as serve_lib
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serving import kv_cache, loadgen, scheduler

    cfg = _cfg(cell)
    dev = mesh.device
    rules = _rules(cell, True)
    S, G = cell["prompt"], cell["gen"]
    scfg = scheduler.SchedulerConfig(
        n_slots=cell["n_slots"], max_len=cell.get("max_len", S + G + 4),
        storage_dtype=cell.get("storage_dtype"), audit_every=cell.get("audit_every", 0))
    lc = loadgen.LoadConfig(rate=cell.get("rate", 1.0), n_requests=cell["requests"],
                            prompt_len=S, gen_len=G, seed=cell.get("seed_requests", 0))
    injector = None
    if cell.get("inject"):
        mode, _, at = cell["inject"].partition("@")
        injector = FailureInjector(fail_at_step=int(at), mode=mode)
    _, pspec, _ = serve_lib.make_sharded_serve_step(cfg, mesh, rules, batch=scfg.n_slots,
                                                    max_len=scfg.max_len)
    params = _params(cell, cfg, mesh, pspec, cfg.policy.compute_dtype)
    coll.reset_stats()
    _zero_launches()
    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    with engine.instrument() as events:
        sched = scheduler.Scheduler(params, cfg, scfg, injector, rules=rules, mesh=mesh)
        if cell.get("rebuild", True) is False:
            sched._rebuild_slot = lambda slot, s, rerun_decode: None
        sched.submit(loadgen.poisson_requests(cfg, lc))
        results = sched.run()
    _sync(dev)
    trace = [list(e) for e in sched.trace]
    info: Dict = {
        "seconds_run": time.perf_counter() - t0, "peak_steps_bytes": _peak(dev),
        "decode_steps": sched.decode_steps, "prefills": sched.prefill_count,
        "recovery_decode_steps": sched.recovery_decode_steps,
        "collectives": {k: dict(v) for k, v in coll.STATS.items()},
        "launches": _kernel_launches(), "bill": _bill(events),
        "kv_bytes": _tree_bytes(sched.cache),
        "trace_digest": hashlib.sha256(json.dumps(trace).encode()).hexdigest(),
        "tokens_digest": hashlib.sha256(json.dumps(
            [r.tokens for r in results]).encode()).hexdigest(),
        "goodput": sched.goodput.goodput,
        "scale_health": kv_cache.scale_health(sched.cache, sched.layout),
        "whole_leaves_digest": _digest(_whole_leaves(sched.cache, sched.layout.specs)
                                       if sched.layout is not None else {})}
    out.update(trace=trace, tokens={r.rid: list(r.tokens) for r in results},
               status={r.rid: r.status for r in results},
               final_logits={r.rid: torch.from_numpy(r.final_logits) for r in results
                             if r.final_logits is not None},
               scales=_scale_leaves(sched.cache, sched.layout.specs, mesh)
               if sched.layout is not None else {})
    if cell.get("pool"):        # the pool's KV data leaves, gathered whole
        from repro_torch.runtime.fault_tolerance import gather

        out["pool"] = {f"{k}/{n}": gather(leaf, mesh, sched.layout.specs[k][n]).cpu()
                       for k, n, leaf, _ in kv_cache.iter_kv_leaves(sched.cache)}
    return info


def _select(tree, paths):
    """The subtree of ``tree`` holding the leaves at ``paths``."""
    out: Dict = {}
    for path in paths:
        *head, last = path.split("/")
        src, dst = tree, out
        for k in head:
            src, dst = src[k], dst.setdefault(k, {})
        dst[last] = src[last]
    return out


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu()
    return {k: _host(v) for k, v in tree.items()}


def _whole_leaves(cache, cspec) -> Dict[str, torch.Tensor]:
    """The cache's leaves (scale leaves' fields too) that their spec
    leaves whole: replicated, so every rank must hold the same bytes."""
    out = {}
    for key, sub in cache.items():
        for name, leaf in sub.items():
            fields = leaf.items() if isinstance(leaf, dict) else ((None, leaf),)
            for f, t in fields:
                spec = cspec[key][name] if f is None else cspec[key][name][f]
                if all(p is None for p in spec):
                    out[f"{key}/{name}" + (f"/{f}" if f else "")] = t
    return out


def _forward_cell(cell, mesh, out: Dict) -> Dict:
    """A cache-free forward under the cell's rules (default ``Rules()``):
    gathered logits, the MoE metrics and this rank's GEMM bill."""
    from repro_torch.core import engine
    from repro_torch.models import moe, transformer
    from repro_torch.runtime import sharding

    cfg = _cfg(cell)
    rules = _rules(cell, False)
    pspec = sharding.sanitize_tree(transformer.param_specs(cfg, rules),
                                transformer.abstract_params(cfg), mesh)
    params = _params(cell, cfg, mesh, pspec, cfg.policy.compute_dtype)
    toks = torch.from_numpy(np.random.default_rng(cell.get("data_seed", 2)).integers(
        0, cfg.vocab_size, (cell["batch"], cell["seq"]))).long().to(mesh.device)
    moe.ROUTES.clear()
    with sharding.use_rules(rules), sharding.use_mesh(mesh), torch.no_grad(), \
            engine.instrument() as events:
        logits, _, aux = transformer.forward(params, cfg, {"inputs": toks})
        logits = transformer._gather_vocab(logits, params, cfg, sharding.context())
    out.update(tokens=toks.cpu(), logits=logits.float().cpu(),
               **{k: v.float().cpu() for k, v in aux.items()})
    bill: Dict[str, Dict[str, int]] = {}
    for ev in events:
        b = bill.setdefault(f"{ev.spec.op}/{ev.spec.policy.name}",
                            {"flops": 0, "bytes": 0})
        b["flops"] += ev.total_flops
        b["bytes"] += ev.total_bytes
    return {"bill": bill, "route": dict(moe.ROUTES)}


def _collectives_cell(cell, mesh, out: Dict) -> Dict:
    """Each collective's gradient against central differences of the
    global function ``sum over ranks of <w_r, f(x_r)>`` (fp64)."""
    from repro_torch.runtime import collectives as coll

    ax, n, me = "model", mesh.shape["model"], mesh.coords["model"]
    g = torch.Generator().manual_seed(7)   # the same draws on every rank
    xs = [torch.randn(4, 6, generator=g, dtype=torch.float64) for _ in range(n)]
    ws = {}
    fns = {
        "psum": lambda x: coll.psum(x, mesh, ax),
        "all_gather": lambda x: coll.all_gather(x, mesh, ax, 1),
        "all_to_all": lambda x: coll.all_to_all(x.reshape(n, -1, 6), mesh, ax),
        "redistribute": lambda x: coll.redistribute_last(
            x, mesh, ax, coll.blocks(6 * n, n), coll.segment_blocks((2 * n, 4 * n), n)),
    }
    errs = {}
    for name, f in fns.items():
        ws[name] = [torch.randn(f(xs[me].clone()).shape, generator=g,
                                dtype=torch.float64) for _ in range(n)]

        def total(x):
            return coll.psum((ws[name][me] * f(x)).sum(), mesh, ax)

        x = xs[me].clone().requires_grad_(True)
        (grad,) = torch.autograd.grad((ws[name][me] * f(x)).sum(), x)
        worst, eps = 0.0, 1e-6
        for r in range(n):
            for idx in ((0, 0), (1, 3), (3, 5)):
                hi, lo = xs[me].clone(), xs[me].clone()
                if r == me:
                    hi[idx] += eps
                    lo[idx] -= eps
                fd = (total(hi) - total(lo)) / (2 * eps)
                if r == me:
                    worst = max(worst, abs(float(fd) - float(grad[idx])))
        errs[name] = worst
    return {"fd_err": errs}


def _reshard_cell(cell, mesh, out: Dict) -> Dict:
    """``reshard`` then ``gather`` of a host tree, under ``Rules()`` and
    :func:`launch.serve.serve_rules`'s cache specs."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.fault_tolerance import gather, reshard

    cfg = _cfg(cell)
    specs = sharding.sanitize_tree(transformer.param_specs(cfg, sharding.Rules()),
                                transformer.abstract_params(cfg), mesh)
    host = transformer.init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    back = gather(reshard(host, mesh, specs), mesh, specs)
    same = all(torch.equal(a, b.cpu()) for a, b in
               zip(tree_leaves(host), tree_leaves(back)))
    cspec = serve_lib.cache_spec_tree(cfg, serve_lib.serve_rules(), mesh, 2, 8)
    with sharding.use_mesh(None):
        cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    g = torch.Generator().manual_seed(4)          # the same draws on every rank
    cache = {k: {n: torch.randn(t.shape, generator=g) for n, t in v.items()}
             for k, v in cache.items()}
    cback = gather(reshard(cache, mesh, cspec), mesh, cspec)
    same_cache = all(torch.equal(cache[k][n], cback[k][n].cpu())
                     for k in cache for n in cache[k])
    return {"params_identity": same, "cache_identity": same_cache}


CELLS = {"serve": _serve_cell, "train": _train_cell, "forward": _forward_cell,
         "collectives": _collectives_cell, "reshard": _reshard_cell,
         "sched": _sched_cell}


def main(argv=None) -> int:
    """Run every cell of ``--plan`` (a JSON list) as this rank.  A cell
    names its ``kind`` (serve | train | sched | forward | collectives |
    reshard),
    its ``mesh`` shape over ("data", "model"), its model (``arch``,
    ``full``, ``n_layers``, ``policy_name``, ``moe_impl``, ``overrides``;
    weights from ``params``, a ``torch.save``'d host tree, else drawn from
    ``seed``) and its layout: ``fsdp``, ``sequence_parallel`` and
    ``serve_rules`` (default true for serve cells: ``launch.serve.
    serve_rules`` of those rules; false gives the training rules), and a
    train cell's ``grad_accum``, ``cast_params`` (the master weights cast
    to the compute dtype at step entry, before FSDP's gathers) and
    ``grads`` (the "a/b" paths of the step-0 gradient leaves to gather,
    default all); ``local_amax`` makes it a control whose FP8 amaxes are
    each rank's own (:func:`_local_amax`).  Rank 0 writes ``OUT/<name>.pt``
    (gathered tensors); every rank writes ``OUT/<name>.rank<r>.json`` (its
    times, peak memory — the cell's, and ``peak_steps_bytes``: each train
    step's, a serve cell's over its prefill and decode steps, what the dry
    run predicts — resident parameter / moment / KV bytes, kernel
    launches, collectives and each step's engine bill: ``bill`` per train
    step, ``bill_prefill`` / ``bill_decode`` over a serve cell's decode
    steps).  ``--spawn N`` starts N such ranks."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--plan", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spawn", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=None)
    args = ap.parse_args(argv)
    if args.spawn:
        from repro_torch.runtime import procs
        rest = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = rest.index("--spawn")
        del rest[i:i + 2]
        return procs.spawn(args.spawn, ["-m", "repro_torch.launch.mesh", *rest],
                           run_dir=args.out, timeout=args.timeout)
    from repro_torch import resolve_device
    from repro_torch.runtime import procs

    device = resolve_device(args.device)
    r, n = procs.init_group()
    os.makedirs(args.out, exist_ok=True)
    meshes: Dict[Tuple[int, ...], Mesh] = {}
    try:
        for cell in json.loads(open(args.plan).read()):
            shape = tuple(cell.get("mesh", (1, n)))
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"), device=device)
            mesh = meshes[shape]
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
                _CELL_PEAK[0] = 0
            out: Dict = {}
            t0 = time.perf_counter()
            with (_local_amax() if cell.get("local_amax")
                  else contextlib.nullcontext()):
                info = CELLS[cell["kind"]](cell, mesh, out)
            info["seconds"] = time.perf_counter() - t0
            info["mesh"] = mesh.shape
            if device.type == "cuda":
                info["peak_bytes"] = max(_CELL_PEAK[0],
                                         torch.cuda.max_memory_allocated(device))
            # each file appears whole (written aside, then renamed): a
            # reader may take a cell's results while later cells run
            path = os.path.join(args.out, cell["name"])
            with open(f"{path}.rank{r}.json.tmp", "w") as f:
                json.dump(info, f)
            os.replace(f"{path}.rank{r}.json.tmp", f"{path}.rank{r}.json")
            if r == 0:
                torch.save(out, f"{path}.pt.tmp")
                os.replace(f"{path}.pt.tmp", f"{path}.pt")
            procs.barrier()
    finally:
        procs.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
