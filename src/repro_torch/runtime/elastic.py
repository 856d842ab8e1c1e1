"""Elastic data-parallel training worker.

Counterpart of ``repro.runtime.elastic`` (``elastic.py:56-340``).  The
worker is the unit that dies: ``--dp N`` starts N rank processes
(``runtime/procs.py``, gloo; on one card every rank runs on ``cuda:0``),
each training the reference's toy 2-layer MLP regression on its
contiguous ``batch / N`` rows of a step-indexed synthetic stream, with
the compressed gradient wire (``--compress``, ``optim/compression.py``),
checksum-verified checkpoints, the goodput heartbeat and deterministic
fault injection (``--fail-step`` / ``--fail-mode``).

The contracts (``tests/test_torch_ft_gates.py``):

* **kill and resume** — a rank's ``os._exit`` at step k (every rank's
  injector fires at the same step; the launcher exits with 13), then the
  same command again: the run restores the last checkpoint, replays the
  batch stream and reaches the uninterrupted run's final digest, on the
  fp32 and the FP8 wire (the error feedback and the scale windows are
  checkpointed);
* **torn write** (``ckpt_crash``) — dying inside a save leaves only a
  ``.tmp``; resume lands on the previous complete checkpoint;
* **elastic attach** — a different ``--dp``: parameters and optimizer
  state are replicated and pass through, while the per-rank compression
  state, stored with an explicit leading host axis, is regrouped
  (residuals summed within each merge group, scale statistics the group
  maximum) and the checkpoint rewritten before the resume;
* **preemption** — SIGTERM to the launcher (forwarded to every rank) or
  ``--fail-mode sigterm``: each rank's flag is all-reduced (max) every
  step, so every rank checkpoints at the same step and exits 0.

Rank 0 writes one logical checkpoint holding every rank's slot of the
per-host state (``checkpoint.host_axis.HostAxisCheckpoint``); each rank
restores its own slot.  The model may stay ``torch.matmul``: the reference
computes it outside any Pallas kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointCorruptError, CheckpointManager,
                                    tree_flatten, tree_map_leaves)
from repro_torch.checkpoint.host_axis import (HostAxisCheckpoint, digest,
                                              stacked_like, with_part)
from repro_torch.optim import AdamW, Compressor, Fp8LeafState, Fp8ScaleState
from repro_torch.optim.compression import all_reduce_sum, compressed_mean_allreduce
from repro_torch.runtime import procs
from repro_torch.runtime.fault_tolerance import (FailureInjector, GoodputMeter,
                                                 StragglerWatchdog, TrainLoop)

__all__ = ["run_worker", "main"]

_MODEL_DIMS = (8, 32, 8)  # in -> hidden -> out


def _regroup_axis0(x, dp_new: int, how: str):
    """Regroup a per-host-stacked array onto ``dp_new`` hosts.

    ``how="sum"`` (residuals) conserves the total along axis 0: merge
    groups are summed, split groups divide evenly.  ``how="max"`` (scale
    statistics, amax windows, counters) takes the group maximum."""
    x = np.asarray(x)
    dp_old = x.shape[0]
    if dp_old == dp_new:
        return x
    if dp_old % dp_new == 0:
        g = x.reshape((dp_new, dp_old // dp_new) + x.shape[1:])
        return g.sum(axis=1) if how == "sum" else g.max(axis=1)
    if dp_new % dp_old == 0:
        r = dp_new // dp_old
        rep = np.repeat(x, r, axis=0)
        return rep / np.asarray(r, x.dtype) if how == "sum" else rep
    # non-divisible resize: collapse to one logical host, pad the rest
    tot = x.sum(axis=0) if how == "sum" else x.max(axis=0)
    out = np.zeros((dp_new,) + x.shape[1:], x.dtype)
    out[0] = tot
    if how == "max":
        out[:] = tot
    return out


def _regroup_ef(ef, dp_new: int):
    """Regroup the per-host compression-state tree onto ``dp_new`` hosts
    (host tensors in, host tensors out)."""
    if ef is None:
        return None
    regroup = lambda t, how: torch.from_numpy(np.ascontiguousarray(
        _regroup_axis0(np.asarray(t), dp_new, how)))
    if isinstance(ef, dict):
        return {k: _regroup_ef(v, dp_new) for k, v in ef.items()}
    if isinstance(ef, Fp8LeafState):
        return Fp8LeafState(ef=regroup(ef.ef, "sum"), scale=Fp8ScaleState(
            *(regroup(s, "max") for s in ef.scale)))
    return regroup(ef, "sum")


_MARK = object()


def _maybe_migrate_elastic(ckpt: CheckpointManager, like, key, dp_new: int,
                           log: Callable[[str], None] = print) -> None:
    """Elastic attach: if the newest valid checkpoint was written by a
    group of another size, regroup its per-host part onto ``dp_new``
    hosts and rewrite the checkpoint in place (the atomic save makes the
    migration crash-safe).  ``like`` is this rank's state; call it on rank
    0 only, then synchronise the group."""
    part = like[key]
    if part is None:
        return  # no per-host state on the fp32 wire
    marked = with_part(like, key, tree_map_leaves(lambda _: _MARK, part))
    idx = next(i for i, x in enumerate(tree_flatten(marked)) if x is _MARK)
    for step in reversed(ckpt.all_steps()):
        try:
            _, manifest = ckpt._load_verified(step)
        except CheckpointCorruptError:
            continue  # restore_latest will warn about this one
        dp_old = int(manifest["shapes"][f"leaf_{idx}"][0])
        if dp_old == dp_new:
            return
        log(f"[ft] elastic attach: regrouping step-{step} checkpoint "
            f"from dp={dp_old} to dp={dp_new}")
        state, meta = ckpt.restore(step, with_part(like, key, stacked_like(part, dp_old)))
        state = with_part(state, key, _regroup_ef(state[key], dp_new))
        ckpt.save(step, state, {**meta, "elastic_migrated_from_dp": dp_old})
        return


def _build(args, device: torch.device):
    """``(step_fn, init_state, batch_fn)`` of the toy MLP regression."""
    comp = Compressor(args.compress)
    opt = AdamW(lr=1e-2, warmup_steps=0)
    din, dh, dout = _MODEL_DIMS
    rng = np.random.default_rng(args.seed)
    w1 = rng.standard_normal((din, dh), dtype=np.float32) * np.float32(0.3)
    w2 = rng.standard_normal((dh, dout), dtype=np.float32) * np.float32(0.3)
    target_a = rng.standard_normal((din, dout), dtype=np.float32)

    def init_state():
        params = {"w1": torch.from_numpy(w1.copy()),
                  "b1": torch.zeros(dh),
                  "w2": torch.from_numpy(w2.copy()),
                  "b2": torch.zeros(dout)}
        params = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        return {"params": params, "opt": opt.init(params), "ef": comp.init(params)}

    def batch_fn(step: int):
        r = np.random.default_rng([args.seed + 1, step])
        x = r.standard_normal((args.batch, din), dtype=np.float32)
        return {"x": x, "y": x @ target_a}

    def step_fn(state, batch):
        r, n = procs.rank(), procs.world()
        b = args.batch // n
        x, y = (torch.from_numpy(batch[k][r * b:(r + 1) * b]).to(device)
                for k in ("x", "y"))
        params = state["params"]
        h = torch.tanh(x @ params["w1"] + params["b1"])
        loss = torch.mean((h @ params["w2"] + params["b2"] - y) ** 2)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        mean_g, ef = compressed_mean_allreduce(grads, state["ef"], comp)
        loss = all_reduce_sum([loss.detach()])[0] / n
        updates, opt_state = opt.update(mean_g, state["opt"], params)
        opt.apply(params, updates)
        if args.step_ms > 0:
            time.sleep(args.step_ms / 1e3)  # the SIGTERM-mid-run test hook
        return {"params": params, "opt": opt_state, "ef": ef}, {"loss": loss}

    return step_fn, init_state, batch_fn


def run_worker(args) -> dict:
    """One rank of the worker (or the whole of it at ``--dp 1``)."""
    r, n = procs.init_group()
    if n != args.dp:
        raise SystemExit(f"--dp {args.dp} but this group has {n} ranks")
    device = resolve_device(args.device)
    step_fn, init_state, batch_fn = _build(args, device)
    ckpt = CheckpointManager(args.ckpt, keep=args.keep)
    if r == 0:
        _maybe_migrate_elastic(ckpt, init_state(), "ef", n)
    procs.barrier()
    injector = None
    if args.fail_step is not None:
        injector = FailureInjector(fail_at_step=args.fail_step, mode=args.fail_mode)
    # saves are synchronous: the state is tiny, and an injected death then
    # always finds the previous checkpoint complete
    loop = TrainLoop(
        step_fn, HostAxisCheckpoint(ckpt, "ef"),
        save_every=args.save_every, injector=injector, async_save=False,
        handle_sigterm=args.handle_sigterm,
        watchdog=StragglerWatchdog(threshold=100.0),  # no flakes in CI
        goodput=GoodputMeter(args.ckpt if r == 0
                             else os.path.join(args.ckpt, f".rank{r}")),
        sync_preempt=procs.agree_any if n > 1 else None)
    out = loop.run(init_state(), batch_fn, args.steps, log_every=args.log_every)
    result = {
        "last_step": int(out["last_step"]),
        "loss": float(out["history"][-1]["loss"]) if out["history"] else None,
        "digest": digest(out["final_state"]["params"]),
        "preempted": bool(out["preempted"]),
        "goodput": out["goodput"],
        "dp": args.dp,
        "compress": args.compress,
    }
    if args.result and r == 0:
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, args.result)
    procs.finish()
    return result


def main(argv: Optional[Any] = None) -> int:
    """Parse, then run the worker: ``--dp N > 1`` starts N ranks and
    returns the launcher's exit code (0, or the first failing rank's)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--save-every", type=int, default=2)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (processes; on one card every "
                        "rank runs on cuda:0)")
    p.add_argument("--compress", default="none",
                   help="gradient wire: none|fp16|int8|fp8|fp8_e4m3|fp8_e5m2")
    p.add_argument("--batch", type=int, default=8,
                   help="global batch (must divide by --dp)")
    p.add_argument("--fail-step", type=int, default=None)
    p.add_argument("--fail-mode", default="die",
                   choices=("raise", "die", "sigterm", "ckpt_crash"))
    p.add_argument("--handle-sigterm", action="store_true")
    p.add_argument("--step-ms", type=int, default=0,
                   help="artificial per-step delay (signal-delivery tests)")
    p.add_argument("--result", default="",
                   help="write the final {digest, loss, goodput} JSON here")
    p.add_argument("--log-every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (every rank on cuda:0) or cpu")
    args = p.parse_args(argv)
    if args.batch % args.dp:
        raise SystemExit(f"--batch {args.batch} must divide by --dp {args.dp}")
    if args.dp > 1 and procs.rank_env() is None:
        return procs.spawn(args.dp, ["-m", "repro_torch.runtime.elastic", *argv],
                           run_dir=args.ckpt)
    run_worker(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
