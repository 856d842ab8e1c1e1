"""Serving driver: batched greedy generation through the scheduler, and
the ``--sched`` Poisson load sweep.

Counterpart of ``repro.launch.serve`` (``generate``, ``main`` and the
``--sched`` path).  It runs on one device, the card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full \\
        --batch 4 --prompt-len 128 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --sched --arch yi-9b --full \\
        --prompt-len 128 --gen 16

``--sched`` runs the continuous-batching scheduler under the seeded
Poisson load of ``serving.loadgen`` at each of ``--rates`` and prints the
``serve/*`` rows (TTFT p50 / p99 in ticks, tokens/s, batch fill), by
default with the FP8 KV cache (``--storage float8_e4m3fn``) under
``mixed_fp8_e4m3`` (``--policy``); ``--inject MODE@STEP``, ``--deadline``
or ``--max-queue`` add the SLO scenario's ``[slo]`` line and rows.  The
rows are merged into ``--json`` (``BENCH_engine.json``; ``''`` skips it).
Weights are random, drawn from ``--seed``.  ``--device cpu`` runs the
plain PyTorch versions of the kernels.

On a mesh of ranks (``launch/mesh.py``) serving runs under
:func:`serve_rules` (the reference's prefill and decode layouts): the KV
cache is cut over its sequence, every rank holding its ``max_len /
model`` positions of every KV head (:func:`cache_spec_tree`), or under
``sharding.Rules()``, which cuts it over the KV heads where they divide
the model axis; :func:`make_sharded_serve_step`, :func:`build_prefill`
and ``generate(..., rules=, mesh=)`` run this rank's part, on the FP8
cache too (``storage_dtype``), and the scheduler runs over the data axes
as well (its pool's slots cut over them).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import engine
from repro_torch.models import transformer
from repro_torch.runtime import sharding
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.serving import kv_cache as kv_lib
from repro_torch.serving import loadgen as loadgen_lib
from repro_torch.serving import scheduler as sched_lib
from repro_torch.serving import specs as specs_lib

__all__ = ["serve_rules", "cache_spec_tree", "build_serve_step", "build_prefill",
           "make_sharded_serve_step", "generate", "main"]


def serve_rules(base: Optional[sharding.Rules] = None) -> sharding.Rules:
    """Decode-time rules: the KV sequence over the model axis, KV heads
    replicated (declared up front, or they would claim the model axis and
    leave the sequence whole after sanitization)."""
    base = base or sharding.Rules()
    return dataclasses.replace(
        base, serve_attention=True,
        overrides=base.overrides + (("kv_heads", None), ("kv_seq", ("model",))))


def cache_spec_tree(cfg, rules, mesh, batch: int, max_len: int,
                    storage_dtype: Optional[str] = None):
    """Sanitized decode-cache specs (``serving.specs`` is the source)."""
    return specs_lib.decode_cache_specs(
        cfg, rules, mesh, batch, max_len, storage_dtype=storage_dtype)[1]


def build_serve_step(cfg, rules: Optional[sharding.Rules], *, mesh=None,
                     max_len: Optional[int] = None):
    """``step(params, cache, tokens, pos) -> (logits, cache)`` under the
    rules (and ``mesh``, else the active one); ``max_len`` is the cache's
    global length (``transformer.serve_step``)."""
    def step(params, cache, tokens, pos):
        with sharding.use_rules(rules), _mesh(mesh):
            return transformer.serve_step(params, cfg, tokens, cache, pos,
                                          max_len=max_len)
    return step


def build_prefill(cfg, rules: Optional[sharding.Rules], max_len: int, *, mesh=None,
                  storage_dtype: Optional[str] = None):
    """``pre(params, batch) -> (logits, cache)`` under the rules, the cache
    FP8 with ``storage_dtype``."""
    def pre(params, batch):
        with sharding.use_rules(rules), _mesh(mesh):
            return transformer.prefill(params, cfg, batch, max_len,
                                       storage_dtype=storage_dtype)
    return pre


def _mesh(mesh):
    return sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def make_sharded_serve_step(cfg, mesh, rules, *, batch: int, max_len: int,
                            storage_dtype: Optional[str] = None):
    """``(step, param specs, cache specs)`` for this rank of ``mesh`` under
    ``rules`` (None: :func:`serve_rules`, the cache cut over its positions,
    or whole where ``max_len`` does not divide the model axis;
    ``sharding.Rules()`` cuts it over the KV heads where they divide the
    model axis).  ``step(params, cache, tokens, pos)`` takes this rank's
    blocks of the parameters and cache (FP8 with ``storage_dtype``: the
    cache specs then hold its scale leaves) and the global tokens (it
    keeps the rows of its data coordinates when they divide), and returns
    its rows' whole logits and the cache."""
    rules = rules if rules is not None else serve_rules()
    pspec = transformer.param_specs(cfg, rules)
    pshape = transformer.abstract_params(cfg)
    pspec = sharding.sanitize_tree(pspec, pshape, mesh)
    cspec = cache_spec_tree(cfg, rules, mesh, batch, max_len, storage_dtype)
    dp = tuple(a for a in sharding.DATA_AXES if a in mesh.shape)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    rows = sharding.P(dp) if batch % n_dp == 0 else sharding.P()
    inner = build_serve_step(cfg, rules, mesh=mesh, max_len=max_len)

    def step(params, cache, tokens, pos):
        return inner(params, cache, sharding.shard_block(tokens, rows, mesh), pos)

    return step, pspec, cspec


@torch.inference_mode()
def generate(params, cfg, prompts, gen_len: int,
             rules: Optional[sharding.Rules] = None, *, mesh=None,
             storage_dtype: Optional[str] = None, return_state: bool = False):
    """prompts ``(B, S)`` ints -> ``(B, S + gen_len)`` greedy continuations
    (a numpy int32 array).

    A thin fixed-batch client of the scheduler: B slots and B requests
    arriving at once, so every slot moves in lockstep, with the drain
    invariant — with ``return_state=True`` it returns ``(seqs, cache,
    final_logits)`` and ``argmax(final_logits)`` is the token a
    ``gen_len + 1`` run would emit next.  ``storage_dtype`` serves from
    the FP8 KV cache.  With ``rules`` and ``mesh`` the scheduler runs this
    rank's part on its blocks of ``params`` (every rank returns the same
    sequences and logits; the cache is the rank's block)."""
    pnp = np.asarray(prompts.cpu() if isinstance(prompts, torch.Tensor)
                     else prompts, dtype=np.int32)
    B, S = pnp.shape
    if gen_len < 1:
        raise ValueError("gen_len must be >= 1")
    sched = sched_lib.Scheduler(params, cfg, sched_lib.SchedulerConfig(
        n_slots=B, max_len=S + gen_len, storage_dtype=storage_dtype),
        rules=rules, mesh=mesh)
    sched.submit([sched_lib.Request(rid=i, arrival=0.0, prompt=pnp[i],
                                    max_new_tokens=gen_len) for i in range(B)])
    results = sched.run()
    seqs = np.concatenate([pnp, np.array([r.tokens for r in results], np.int32)],
                          axis=1)
    if return_state:
        return seqs, sched.cache, np.stack([r.final_logits for r in results])
    return seqs


def _instrumented_phases(params, cfg, prompts: torch.Tensor, gen: int) -> None:
    """Print the engine events of one prefill and one decode step."""
    B, S = prompts.shape
    with engine.instrument() as ev_pre:
        _, cache = transformer.prefill(params, cfg, {"inputs": prompts}, S + gen)
    with engine.instrument() as ev_dec:
        transformer.serve_step(params, cfg, prompts[:, -1:], cache, S)
    for phase, events in (("prefill", ev_pre), ("decode", ev_dec)):
        for op, d in engine.summarize(events).items():
            print(f"[engine] {phase} {op}: calls={d['calls']} "
                  f"gflops={d['flops'] / 1e9:.3f} gbytes={d['bytes'] / 1e9:.3f}")


def _parse_inject(spec: str) -> FailureInjector:
    """``MODE@STEP`` -> a one-shot injector with a serving mode, e.g.
    ``nan_logits@2``, ``kv_corrupt@3``, ``prefill_crash@1``."""
    mode, _, at = spec.partition("@")
    if mode not in FailureInjector.SERVING_MODES or not at.isdigit():
        raise SystemExit(f"--inject wants MODE@STEP with MODE in "
                         f"{FailureInjector.SERVING_MODES}, got {spec!r}")
    return FailureInjector(fail_at_step=int(at), mode=mode)


def _sched_config(cfg, args):
    """The ``--sched`` run's model config (under ``--policy``), scheduler
    config and load config, as the reference's ``_run_sched`` sets them."""
    if args.policy:
        # FP8 end to end: the decode GEMMs under the policy's storage
        # dtypes, on top of the FP8 KV cache of --storage
        cfg = dataclasses.replace(cfg, policy_name=args.policy)
    audit = args.audit_every if args.audit_every is not None else \
        (1 if args.inject else 0)
    scfg = sched_lib.SchedulerConfig(
        n_slots=args.slots, max_len=args.prompt_len + args.gen + 4,
        storage_dtype=args.storage or None, max_queue=args.max_queue or None,
        audit_every=audit)
    rates = [float(r) for r in args.rates.split(",")]
    lc = loadgen_lib.LoadConfig(
        rate=rates[0], n_requests=args.requests, prompt_len=args.prompt_len,
        gen_len=args.gen, seed=args.seed, deadline_ticks=args.deadline or None,
        max_retries=args.retries)
    return cfg, scfg, rates, lc


def _run_sched(cfg, params, args) -> dict:
    """The load sweep (and, with a fault, deadline or bounded queue, the
    SLO scenario at the first rate); returns the rows, each point's
    metrics and drained scheduler, and the SLO metrics."""
    cfg, scfg, rates, lc = _sched_config(cfg, args)
    if args.instrument:
        # one sweep under instrumentation: every dispatch of the serving
        # path, tagged serve_prefill / serve_admit / serve_decode
        with engine.instrument() as events:
            sched = sched_lib.Scheduler(params, cfg, scfg)
            sched.submit(loadgen_lib.poisson_requests(cfg, lc))
            sched.run()
        for op, d in engine.summarize(events).items():
            print(f"[engine] {op}: calls={d['calls']} "
                  f"gflops={d['flops'] / 1e9:.3f} gbytes={d['bytes'] / 1e9:.3f}")
        print("[sched] tick queue pend active fill")
        for h in sched.health:
            print(f"[sched] {h['tick']:8.2f} {h['queue_depth']:5d} "
                  f"{h['pending']:4d} {h['active_slots']:6d} {h['batch_fill']:.2f}")
        for leaf, d in kv_lib.scale_health(sched.cache).items():
            print(f"[kv] {leaf}: max_scale={d['max_scale']:.3g} "
                  f"overflow={d['overflow_total']}")
        # one exactly billed ragged decode step at the drained lengths
        lengths = [args.prompt_len + args.gen if i == 0 else 0
                   for i in range(scfg.n_slots)]
        ev = sched_lib.instrumented_decode_events(params, cfg, scfg, lengths)
        kvb = kv_lib.decode_step_kv_bytes(cfg, [n for n in lengths if n],
                                          scfg.storage_dtype)
        print(f"[kv] ragged decode step flops={engine.total_flops(ev)} "
              f"kv_bytes={kvb}")

    points: list = []
    schedulers: list = []
    rows = loadgen_lib.bench_rows(params, cfg, scfg, cfg.name, rates, lc,
                                  metrics=points, schedulers=schedulers)
    slo = None
    if args.inject or args.deadline or args.max_queue:
        # the SLO scenario at the first offered rate, a fresh injector
        injector = _parse_inject(args.inject) if args.inject else None
        tag = f"slo_{injector.mode}" if injector else "slo"
        srows, slo = loadgen_lib.slo_rows(params, cfg, scfg, cfg.name, lc,
                                          injector=injector, tag=tag)
        rows += srows
        print(f"[slo] goodput={slo['slo_goodput']:.4f} "
              f"deadline_hit={slo['deadline_hit_rate']:.3f} "
              f"finished={slo['n_finished']}/{slo['n_requests']} "
              f"retries={slo['retries']} abandons={slo['abandons']} "
              f"recoveries={slo['slo_recoveries']:.0f} "
              f"shed={slo['slo_shed']:.0f} expired={slo['slo_expired']:.0f}")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    if args.json:
        loadgen_lib.merge_bench_json(args.json, rows)
        print(f"merged {len(rows)} serve/* rows into {args.json}")
    return {"rows": rows, "points": points, "schedulers": schedulers, "slo": slo}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="yi-9b", choices=configs.ARCH_IDS)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--instrument", action="store_true",
                   help="print the engine's GEMM summary of the serving path; "
                        "with --sched also the per-step scheduler health and "
                        "the KV scale state")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    p.add_argument("--sched", action="store_true",
                   help="run the continuous-batching scheduler under the Poisson "
                        "load sweep and merge serve/* rows into --json")
    p.add_argument("--slots", type=int, default=4, help="--sched: decode slots")
    p.add_argument("--requests", type=int, default=8,
                   help="--sched: requests per offered-load point")
    p.add_argument("--rates", default="0.25,1.0",
                   help="--sched: offered loads (requests/tick), comma-separated")
    p.add_argument("--storage", default="float8_e4m3fn",
                   help="--sched: KV cache storage dtype ('' for the compute dtype)")
    p.add_argument("--policy", default="mixed_fp8_e4m3",
                   help="--sched: precision policy of the serve GEMMs ('' keeps "
                        "the arch's)")
    p.add_argument("--json", default="BENCH_engine.json",
                   help="--sched: merge the rows into this file ('' to skip)")
    p.add_argument("--inject", default="",
                   help="--sched: serving fault MODE@STEP (nan_logits / "
                        "kv_corrupt at the Nth decode step, prefill_crash at "
                        "the Nth prefill); adds the serve/*/slo_* rows")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="--sched: per-request deadline in ticks (0 = none)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="--sched: bounded admission queue (0 = unbounded)")
    p.add_argument("--retries", type=int, default=2,
                   help="--sched: the load generator's retries per rejection")
    p.add_argument("--audit-every", type=int, default=None,
                   help="--sched: KV checksum audit every N decode steps "
                        "(default: 1 with --inject, else off)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    if args.sched:
        # the weights in the policy's compute dtype (fp16 under the FP8
        # policies), as the reference's serve GEMMs read them
        sched_cfg = _sched_config(cfg, args)[0]
        params = transformer.init_params(sched_cfg, seed=args.seed, device=device)
        return _run_sched(cfg, params, args)
    params = transformer.init_params(cfg, seed=args.seed, device=device)
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen)
    if args.instrument:
        _instrumented_phases(params, cfg, prompts.to(device), args.gen)
    t0 = time.perf_counter()
    seqs = generate(params, cfg, prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} batched-generate {seqs.shape} in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", seqs[0, args.prompt_len:])
    return seqs


if __name__ == "__main__":
    main()
