"""Serving driver: batched greedy generation through the scheduler.

Counterpart of ``repro.launch.serve`` (``generate`` and ``main``).  It runs
on one device, the card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full \\
        --batch 4 --prompt-len 128 --gen 16

Weights are random, drawn from ``--seed``.  ``--device cpu`` runs the
plain PyTorch versions of the kernels.  The reference's ``--sched`` load
sweep and its resilience flags are not ported yet (ROADMAP.md); the flags
are kept so a command line carries over, and ``--sched`` raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import engine
from repro_torch.models import transformer
from repro_torch.serving import scheduler as sched_lib

__all__ = ["generate", "main"]


@torch.inference_mode()
def generate(params, cfg, prompts, gen_len: int, *, return_state: bool = False):
    """prompts ``(B, S)`` ints -> ``(B, S + gen_len)`` greedy continuations
    (a numpy int32 array).

    A thin fixed-batch client of the scheduler: B slots and B requests
    arriving at once, so every slot moves in lockstep, with the drain
    invariant — with ``return_state=True`` it returns ``(seqs, cache,
    final_logits)`` and ``argmax(final_logits)`` is the token a
    ``gen_len + 1`` run would emit next."""
    pnp = np.asarray(prompts.cpu() if isinstance(prompts, torch.Tensor)
                     else prompts, dtype=np.int32)
    B, S = pnp.shape
    if gen_len < 1:
        raise ValueError("gen_len must be >= 1")
    sched = sched_lib.Scheduler(
        params, cfg, sched_lib.SchedulerConfig(n_slots=B, max_len=S + gen_len))
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="yi-9b")
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--instrument", action="store_true",
                   help="run one prefill and one decode step under "
                        "engine.instrument() and print the GEMM summary")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    p.add_argument("--sched", action="store_true",
                   help="the load sweep: not yet ported (ROADMAP.md)")
    for flag, kind, default in (("--slots", int, 4), ("--requests", int, 8),
                                ("--rates", str, "0.25,1.0"),
                                ("--storage", str, "float8_e4m3fn"),
                                ("--policy", str, "mixed_fp8_e4m3"),
                                ("--json", str, "BENCH_engine.json"),
                                ("--inject", str, ""), ("--deadline", float, 0.0),
                                ("--max-queue", int, 0), ("--retries", int, 2),
                                ("--audit-every", int, None)):
        p.add_argument(flag, type=kind, default=default,
                       help="--sched only (not yet ported)")
    args = p.parse_args(argv)
    if args.sched:
        raise SystemExit("--sched (the load sweep and resilience layer) is not "
                         "yet ported; see ROADMAP.md, Queue A")

    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
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
