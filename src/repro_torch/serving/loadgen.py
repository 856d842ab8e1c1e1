"""Poisson load generator + latency/throughput/SLO metrics for the scheduler.

Counterpart of ``repro.serving.loadgen``: the same seeded numpy streams,
so the same arrivals, prompts and retry jitter.  The wall clock of a run
is read after ``torch.cuda.synchronize()`` when the parameters live on the
card, so seconds per tick cover the device work.

Offered load is requests per *tick* (one tick == one batched decode
step); the seeded ``numpy.random.default_rng`` stream makes every sweep
reproducible bit for bit.  Per-request metrics are time-to-first-token
(ticks, includes queueing) and end-to-end tokens/tick; aggregation is
p50/p99 over the **finished** request population — rejected, shed, and
expired requests are excluded explicitly (their latency properties are
``nan`` by contract) and reported through their own counters.
:func:`bench_rows` converts a sweep into ``serve/*`` rows for
``benchmarks/run.py`` / ``BENCH_engine.json``, using the measured wall
seconds-per-tick to express throughput in tokens/s.

The generator is also the well-behaved *client* of the admission-control
loop (docs/serving.md): a ``queue_full`` rejection is retried up to
``max_retries`` times with exponential backoff seeded-jittered on top of
the server's ``retry_after`` hint; invalid rejections and exhausted
retry budgets count as abandons.  :func:`slo_rows` runs one (optionally
fault-injected) scenario and emits the CI-gated ``serve/*/slo_*`` rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig

__all__ = [
    "LoadConfig", "poisson_requests", "run_load", "bench_rows",
    "slo_rows", "merge_bench_json",
]


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    rate: float              # offered load: requests per tick
    n_requests: int = 8
    prompt_len: int = 8
    gen_len: int = 8
    seed: int = 0
    deadline_ticks: Optional[float] = None  # per-request budget from arrival
    n_priorities: int = 1    # round-robin priority classes (shed ordering)
    max_retries: int = 0     # client retry budget per rejected request
    backoff_base: float = 2.0
    backoff_init_ticks: float = 1.0
    jitter_ticks: float = 0.5


def poisson_requests(cfg, lc: LoadConfig) -> List[Request]:
    """Seeded Poisson arrivals with uniform random prompts over the vocab."""
    rng = np.random.default_rng(lc.seed)
    t, reqs = 0.0, []
    for i in range(lc.n_requests):
        t += float(rng.exponential(1.0 / lc.rate))
        prompt = rng.integers(
            0, cfg.vocab_size, size=lc.prompt_len).astype(np.int32)
        reqs.append(Request(rid=i, arrival=round(t, 6), prompt=prompt,
                            max_new_tokens=lc.gen_len,
                            deadline_ticks=lc.deadline_ticks,
                            priority=i % max(lc.n_priorities, 1)))
    return reqs


def _pct(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if len(values) \
        else float("nan")


def _sync(params) -> None:
    if params["embed"].is_cuda:
        torch.cuda.synchronize(params["embed"].device)


def run_load(params, cfg, scfg: SchedulerConfig, lc: LoadConfig,
             injector=None, *, scheduler: Optional[list] = None) -> Dict[str, float]:
    """One offered-load point: drive to drain with client-side retries.

    The drive loop steps the scheduler and, after every step, replays any
    new ``queue_full`` rejections as resubmissions delayed by the server's
    ``retry_after`` plus exponential backoff (``backoff_init_ticks *
    backoff_base**attempt``) plus seeded uniform jitter — deterministic
    end to end.  Aggregation skips unfinished requests explicitly.  A
    ``scheduler`` list receives the drained scheduler (its trace, results
    and cache).
    """
    sched = Scheduler(params, cfg, scfg, injector=injector)
    if scheduler is not None:
        scheduler.append(sched)
    reqs = {r.rid: r for r in poisson_requests(cfg, lc)}
    sched.submit(list(reqs.values()))
    rng = np.random.default_rng(lc.seed + 0x5EED)
    attempts: Dict[int, int] = {}
    retries = abandons = seen = 0
    _sync(params)
    t0 = time.perf_counter()
    while True:
        progressed = sched.step()
        resubmit = []
        for rej in sched.rejections[seen:]:
            if rej.retry_after is None:  # invalid: retrying cannot help
                abandons += 1
                continue
            a = attempts.get(rej.rid, 0)
            if a >= lc.max_retries:
                abandons += 1
                continue
            attempts[rej.rid] = a + 1
            retries += 1
            delay = (rej.retry_after
                     + lc.backoff_init_ticks * lc.backoff_base ** a
                     + float(rng.uniform(0.0, lc.jitter_ticks)))
            resubmit.append(dataclasses.replace(
                reqs[rej.rid], arrival=round(rej.tick + delay, 6)))
        seen = len(sched.rejections)
        if resubmit:
            sched.submit(resubmit)
        if not progressed and not resubmit:
            break
    _sync(params)
    wall = time.perf_counter() - t0

    results = [sched.results[rid] for rid in sorted(sched.results)]
    finished = [r for r in results if r.status == "finished"]
    s_per_tick = wall / max(sched.clock, 1e-9)
    fill = np.array([h["batch_fill"] for h in sched.health])
    if lc.deadline_ticks is None:
        hits = len(finished)
    else:
        hits = sum(1 for r in finished
                   if r.finish_tick - r.arrival <= lc.deadline_ticks)
    ttft = [r.ttft for r in finished]
    tpt = [r.tokens_per_tick for r in finished]
    metrics = {
        "rate": lc.rate,
        "n_requests": lc.n_requests,
        "n_finished": len(finished),
        "n_unfinished": len(results) - len(finished),
        "total_tokens": int(sum(len(r.tokens) for r in results)),
        "ticks": float(sched.clock),
        "decode_steps": len(sched.health),
        "wall_s": wall,
        "s_per_tick": s_per_tick,
        "p50_ttft_ticks": _pct(ttft, 50),
        "p99_ttft_ticks": _pct(ttft, 99),
        "p50_tokens_per_s": _pct(tpt, 50) / s_per_tick,
        "p99_tokens_per_s": _pct(tpt, 99) / s_per_tick,
        "mean_batch_fill": float(fill.mean()) if len(fill) else 0.0,
        "retries": retries,
        "abandons": abandons,
        "retry_rate": retries / lc.n_requests,
        "abandon_rate": abandons / lc.n_requests,
        "deadline_hit_rate": hits / lc.n_requests,
    }
    for key, val in sched.goodput.report().items():
        metrics[f"slo_{key}"] = val
    return metrics


def bench_rows(params, cfg, scfg: SchedulerConfig, arch: str,
               rates: Sequence[float], lc: Optional[LoadConfig] = None,
               metrics: Optional[list] = None,
               schedulers: Optional[list] = None) -> List[tuple]:
    """Sweep offered loads into ``(name, us, derived)`` benchmark rows; a
    ``metrics`` list receives each point's raw metrics, a ``schedulers``
    list each point's drained scheduler."""
    rows = []
    for rate in rates:
        point = dataclasses.replace(lc or LoadConfig(rate=rate), rate=rate)
        m = run_load(params, cfg, scfg, point, scheduler=schedulers)
        if metrics is not None:
            metrics.append(m)
        tag = f"serve/{arch}/r{rate:g}"
        rows.append((
            f"{tag}/ttft",
            m["p50_ttft_ticks"] * m["s_per_tick"] * 1e6,
            f"p50={m['p50_ttft_ticks']:.2f}t p99={m['p99_ttft_ticks']:.2f}t",
        ))
        rows.append((
            f"{tag}/tps",
            1e6 / max(m["p50_tokens_per_s"], 1e-9),  # us per token, p50
            f"p50={m['p50_tokens_per_s']:.1f}tok/s "
            f"p99={m['p99_tokens_per_s']:.1f}tok/s "
            f"fill={m['mean_batch_fill']:.2f}",
        ))
    return rows


def slo_rows(params, cfg, scfg: SchedulerConfig, arch: str, lc: LoadConfig,
             injector=None, tag: str = "slo",
             scheduler: Optional[list] = None) -> Tuple[List[tuple], Dict[str, float]]:
    """One SLO scenario (deadlines / bounded queue / optional injected
    fault) as ``(name, us, derived)`` rows plus the raw metrics.

    The ``derived`` string carries the held quantities (``goodput=`` /
    ``hit=``, against the floors of ``benchmarks/baselines/serve_slo.json``).
    """
    m = run_load(params, cfg, scfg, lc, injector=injector, scheduler=scheduler)
    derived = (
        f"goodput={m['slo_goodput']:.4f} hit={m['deadline_hit_rate']:.3f} "
        f"retries={m['retries']} abandons={m['abandons']} "
        f"recoveries={m['slo_recoveries']:.0f} shed={m['slo_shed']:.0f} "
        f"expired={m['slo_expired']:.0f} rejected={m['slo_rejected']:.0f}")
    rows = [(f"serve/{arch}/{tag}_goodput", m["wall_s"] * 1e6, derived)]
    return rows, m


def merge_bench_json(path: str, rows: Sequence[tuple],
                     module: str = "serve_loadgen") -> None:
    """Merge rows into ``BENCH_engine.json`` (same-name rows replaced)."""
    doc = {"benchmarks": []}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    names = {name for name, _, _ in rows}
    doc["benchmarks"] = [r for r in doc.get("benchmarks", [])
                         if r.get("name") not in names]
    for name, us, derived in rows:
        doc["benchmarks"].append({
            "name": name, "us_per_call": round(float(us), 3),
            "derived": derived, "module": module,
        })
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
