"""Fault-tolerant training loop: auto-resume, fault injection, goodput.

Counterpart of ``repro.runtime.fault_tolerance`` (``fault_tolerance.py:
51-388``):

* **checkpoint / restart** — :class:`TrainLoop` starts by probing its
  checkpoint manager and resumes from the newest *valid* checkpoint
  (corrupt ones are skipped with a warning); :class:`FailureInjector`
  kills the loop at an exact step — by exception, by hard process death
  (``os._exit``), by dying inside a checkpoint write (a torn ``.tmp``), or
  by a SIGTERM the loop drains into a checkpoint — so tests can assert a
  bit-identical continuation.  The injector's serving modes are consumed
  by ``serving/scheduler.py`` through :meth:`FailureInjector.fires`.
* **straggler watchdog** — step wall times feed an EMA; a step slower than
  ``threshold`` times the EMA is counted and logged, and does not move the
  EMA.
* **goodput** — :class:`GoodputMeter` rewrites ``heartbeat.json`` next to
  the checkpoints every step, so a resumed run books what the dead one
  lost: ``goodput = useful_time / wall`` across every incarnation.
* **placement** — a checkpoint restores to host tensors; :func:`reshard`
  places a host tree on a device, like another tree, or as this rank's
  blocks under a spec tree on a mesh of ranks; :func:`gather` puts a
  sharded tree back together.

The port's train steps update their tensors in place, so a checkpoint's
snapshot is a device-to-host copy taken before the next step runs
(``CheckpointManager.save_async``), and a step is timed up to the host
reading its metrics, which synchronises with the device as the
reference's ``block_until_ready`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, tree_flatten,
                                    tree_unflatten)

__all__ = ["FailureInjector", "InjectedFault", "StragglerWatchdog",
           "GoodputMeter", "TrainLoop", "reshard", "gather"]


class InjectedFault(RuntimeError):
    """The error an injector raises; the serving scheduler retries only
    this one, so a genuine failure of a prefill is never swallowed."""


class FailureInjector:
    """Deterministic fault injection, one-shot (``fired`` is the latch).

    Training modes, at ``fail_at_step``:

    * ``"raise"`` — raise :class:`InjectedFault` before the step runs;
    * ``"die"`` — ``os._exit(exit_code)`` before the step: host death, no
      cleanup, no checkpoint flush;
    * ``"sigterm"`` — send this process a SIGTERM before the step; with
      ``TrainLoop(handle_sigterm=True)`` the loop finishes the step,
      checkpoints and exits cleanly;
    * ``"ckpt_crash"`` — die inside the first checkpoint write at or after
      ``fail_at_step``, leaving a torn ``.tmp`` payload.

    Serving modes (:meth:`fires`; no-ops in the training loop):
    ``"nan_logits"`` poisons one slot's logits at the ``fail_at_step``-th
    batched decode step, ``"kv_corrupt"`` bit-flips a slot's stored KV rows
    after it, ``"prefill_crash"`` raises inside the ``fail_at_step``-th
    prefill.  ``target`` names the victim request id of a serving mode;
    None lets the scheduler pick the lowest-rid active slot."""

    SERVING_MODES = ("nan_logits", "kv_corrupt", "prefill_crash")
    MODES = ("raise", "die", "sigterm", "ckpt_crash") + SERVING_MODES

    def __init__(self, fail_at_step: Optional[int] = None, mode: str = "raise",
                 exit_code: int = 13, target: Optional[int] = None):
        if mode not in self.MODES:
            raise ValueError(f"unknown failure mode {mode!r}; known: {self.MODES}")
        self.fail_at_step = fail_at_step
        self.mode = mode
        self.exit_code = exit_code
        self.target = target
        self.fired = False

    def _armed(self, step: int) -> bool:
        return (self.fail_at_step is not None and not self.fired
                and step >= self.fail_at_step)

    def fires(self, step: int, mode: str) -> bool:
        """True exactly once: at the first call whose ``step`` counter has
        reached ``fail_at_step`` with a matching ``mode``.  The scheduler
        owns the counters (``prefill_crash`` counts prefill attempts,
        ``nan_logits`` and ``kv_corrupt`` batched decode steps, 1-based)."""
        if self.mode != mode or not self._armed(step):
            return False
        self.fired = True
        return True

    def maybe_fail(self, step: int) -> None:
        """The loop's hook at the top of each step."""
        if self.mode not in ("raise", "die", "sigterm"):
            return
        if self.fail_at_step is None or self.fired or step != self.fail_at_step:
            return
        self.fired = True
        if self.mode == "raise":
            raise InjectedFault(f"injected failure at step {step}")
        if self.mode == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return  # the handler only sets a flag; the loop drains cleanly
        os._exit(self.exit_code)  # "die": host death, no cleanup

    def maybe_fail_save(self, step: int, ckpt: CheckpointManager) -> None:
        """The loop's hook just before the checkpoint save for ``step``:
        ``ckpt_crash`` writes a torn ``.tmp`` payload (what a mid-write
        crash leaves on disk) and hard-exits."""
        if self.mode != "ckpt_crash" or not self._armed(step):
            return
        self.fired = True
        tmp = ckpt._dir(step) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(b"PK\x03\x04torn-mid-write")  # a truncated zip header
        os._exit(self.exit_code)


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 3.0
    ema_decay: float = 0.9
    ema: Optional[float] = None
    straggler_steps: int = 0

    def observe(self, step_time: float) -> bool:
        is_straggler = self.ema is not None and step_time > self.threshold * self.ema
        if is_straggler:
            self.straggler_steps += 1
        # stragglers don't poison the EMA
        if self.ema is None:
            self.ema = step_time
        elif not is_straggler:
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * step_time
        return is_straggler


class GoodputMeter:
    """Useful-work / wall-clock accounting that survives process death.

    ``heartbeat.json`` in ``root`` is rewritten atomically every step; the
    next incarnation reads it on start and books ``recomputed_steps`` (the
    steps the dead run executed past its last checkpoint) and
    ``time_lost_to_restart`` (their step time plus the gap until the
    restart).  ``useful_time`` counts step time that became durable."""

    HEARTBEAT = "heartbeat.json"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.useful_time = 0.0
        self.useful_at_ckpt = 0.0
        self.time_lost_to_restart = 0.0
        self.recomputed_steps = 0
        self.restarts = 0
        self.first_start = time.time()
        self.step = 0

    @property
    def _path(self) -> str:
        return os.path.join(self.root, self.HEARTBEAT)

    def _beat(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "step": self.step,
                "wall": time.time(),
                "first_start": self.first_start,
                "useful_time": self.useful_time,
                "useful_at_ckpt": self.useful_at_ckpt,
                "time_lost_to_restart": self.time_lost_to_restart,
                "recomputed_steps": self.recomputed_steps,
                "restarts": self.restarts,
            }, f)
        os.replace(tmp, self._path)

    def start_run(self, start_step: int) -> None:
        """Attach to a (possibly restarted) run resuming at
        ``start_step``, booking the previous incarnation's losses."""
        if not os.path.exists(self._path):
            self.step = start_step
            return
        try:
            with open(self._path) as f:
                hb = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.step = start_step
            return  # a torn heartbeat only costs telemetry, never the run
        now = time.time()
        self.restarts = int(hb.get("restarts", 0)) + 1
        self.first_start = float(hb.get("first_start", now))
        self.useful_at_ckpt = float(hb.get("useful_at_ckpt", 0.0))
        # work past the last checkpoint died with the process
        self.useful_time = self.useful_at_ckpt
        self.recomputed_steps = int(hb.get("recomputed_steps", 0)) + max(
            0, int(hb.get("step", start_step)) - start_step)
        self.time_lost_to_restart = (
            float(hb.get("time_lost_to_restart", 0.0))
            + (float(hb.get("useful_time", 0.0)) - self.useful_at_ckpt)
            + max(0.0, now - float(hb.get("wall", now))))
        self.step = start_step

    def observe_step(self, step: int, dt: float) -> None:
        self.useful_time += dt
        self.step = step + 1  # the next step to run if we die right now
        self._beat()

    def on_checkpoint(self, step: int) -> None:
        """All useful time so far is now durable."""
        self.useful_at_ckpt = self.useful_time
        self._beat()

    def report(self) -> Dict[str, float]:
        wall = max(time.time() - self.first_start, 1e-9)
        return {
            "goodput": self.useful_time / wall,
            "wall_time": wall,
            "useful_time": self.useful_time,
            "time_lost_to_restart": self.time_lost_to_restart,
            "recomputed_steps": self.recomputed_steps,
            "restarts": self.restarts,
        }


def reshard(tree: Any, place, specs=None) -> Any:
    """Place a host tree: ``place`` is a device (every tensor moves there)
    or a tree of the same structure (each tensor takes its counterpart's
    device and dtype, and ``requires_grad`` where that leaf has it; a
    Python scalar leaf stays one).

    With ``specs`` (a tree of sanitized specs, leaf for leaf) ``place`` is
    a mesh of ranks (``launch.mesh.Mesh``): each tensor becomes this
    rank's block, every dim a spec cuts over mesh axes split into their
    size's contiguous blocks, the rank taking the one at its coordinates
    (what ``jax.device_put(x, NamedSharding(mesh, spec))`` leaves on a
    device), on the mesh's device."""
    if specs is not None:
        from repro_torch.runtime import sharding
        dev = place.device or torch.device("cpu")
        out = [sharding.shard_block(torch.as_tensor(x), sp, place).to(dev, copy=True)
               if isinstance(x, torch.Tensor) else x
               for x, sp in zip(tree_flatten(tree), sharding.spec_leaves(specs),
                                strict=True)]
        return tree_unflatten(tree, out)
    leaves = tree_flatten(tree)
    if isinstance(place, (str, torch.device)):
        dev = torch.device(place)
        return tree_unflatten(tree, [x.to(dev) if isinstance(x, torch.Tensor) else x
                                     for x in leaves])
    out = []
    for x, like in zip(leaves, tree_flatten(place), strict=True):
        if isinstance(like, torch.Tensor):
            x = torch.as_tensor(x).to(device=like.device, dtype=like.dtype)
            if like.requires_grad:
                x.requires_grad_(True)
        out.append(x)
    return tree_unflatten(place, out)


def gather(tree: Any, mesh, specs) -> Any:
    """The whole tree from every rank's blocks (:func:`reshard`'s
    inverse): each dim a spec cuts is gathered over its mesh axes, on
    every rank, on the blocks' device."""
    from repro_torch.runtime import collectives as coll, sharding

    def whole(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        with torch.no_grad():
            for dim, part in enumerate(spec):
                # the innermost named axis varies fastest along the dim
                for ax in reversed(sharding.axes_of(part)):
                    x = coll.all_gather(x, mesh, ax, dim)
        return x

    out = [whole(x, sp) for x, sp in zip(tree_flatten(tree),
                                         sharding.spec_leaves(specs), strict=True)]
    return tree_unflatten(tree, out)


class TrainLoop:
    """Generic fault-tolerant step loop.

    ``step_fn(state, batch) -> (state, metrics)``; the state is any tree
    of dicts, NamedTuples and tensors.  A restored state is placed like
    ``init_state`` (:func:`reshard`).  ``sync_preempt`` (data-parallel
    ranks) maps this process's preemption flag to the group's after every
    step, so every rank checkpoints at the same step.  The SIGTERM handler
    only sets ``_sigterm``; each step reads it once, agrees on it, and
    decides on the agreed value alone: a signal landing between the
    agreement and the decision (or inside the agreement) is taken at the
    next step by every rank, never by one rank alone, which would leave
    its peers waiting in a collective it never joins."""

    def __init__(
        self,
        step_fn: Callable,
        ckpt: CheckpointManager,
        *,
        save_every: int = 50,
        async_save: bool = True,
        watchdog: Optional[StragglerWatchdog] = None,
        injector: Optional[FailureInjector] = None,
        handle_sigterm: bool = False,
        goodput: Optional[GoodputMeter] = None,
        sync_preempt: Optional[Callable[[bool], bool]] = None,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.save_every = save_every
        self.async_save = async_save
        self.watchdog = watchdog or StragglerWatchdog()
        self.injector = injector
        self.goodput = goodput
        self.sync_preempt = sync_preempt
        self.step_times = []
        self._preempted = False
        self._sigterm = False       # set by the handler, never cleared
        if handle_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):
        self._sigterm = True

    def run(
        self,
        init_state: Any,
        batches,
        num_steps: int,
        *,
        log_every: int = 10,
        log: Callable[[str], None] = print,
    ) -> Dict[str, Any]:
        """``batches``: an iterator (fresh runs only) or a callable ``step
        -> batch`` (replays the exact stream after a restart).  Resuming
        with a plain iterator is rejected: it would replay from batch 0
        against a state at ``start_step``."""
        state = init_state
        start_step = 0
        restored = self.ckpt.restore_latest(init_state, log=log)
        if restored is not None:
            start_step, tree, _meta = restored
            state = reshard(tree, init_state)
            log(f"[ft] resumed from checkpoint step {start_step}")
        if start_step > 0 and not callable(batches):
            raise TypeError(
                "TrainLoop.run is resuming from checkpoint step "
                f"{start_step} but `batches` is a plain iterator, which "
                "would replay the stream from batch 0 and misalign data "
                "with the restored state. Pass a callable `step -> batch` "
                "(e.g. the deterministic pipeline's `.batch`) so the "
                "stream replays from the resume step.")

        meter = self.goodput or GoodputMeter(self.ckpt.root)
        meter.start_run(start_step)
        if meter.restarts:
            log(f"[ft] restart #{meter.restarts}: "
                f"{meter.recomputed_steps} step(s) to recompute, "
                f"{meter.time_lost_to_restart:.2f}s lost so far")

        history = []
        step = start_step
        try:
            for step in range(start_step, num_steps):
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                batch = batches(step) if callable(batches) else next(batches)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                m = {k: float(v) for k, v in metrics.items()}  # synchronises
                dt = time.perf_counter() - t0
                self.step_times.append(dt)
                straggler = self.watchdog.observe(dt)
                meter.observe_step(step, dt)
                if step % log_every == 0:
                    log(f"[step {step}] {m} ({dt * 1e3:.1f} ms)"
                        + (" STRAGGLER" if straggler else ""))
                history.append(m)
                preempt = self._sigterm
                if self.sync_preempt is not None:
                    preempt = self.sync_preempt(preempt)
                self._preempted = preempt
                next_step = step + 1
                if next_step % self.save_every == 0 or preempt:
                    if self.injector is not None:
                        # a write starts once the one in flight is done: a
                        # crash inside it leaves the previous one complete
                        self.ckpt.wait()
                        self.injector.maybe_fail_save(next_step, self.ckpt)
                    saver = self.ckpt.save_async if self.async_save else self.ckpt.save
                    saver(next_step, state, {"wall_time": time.time()})
                    meter.on_checkpoint(next_step)
                    if preempt:
                        self.ckpt.wait()
                        log(f"[ft] preempted: checkpointed at step {next_step}, "
                            "exiting")
                        break
        finally:
            # a crash must never lose an in-flight async checkpoint
            self.ckpt.wait()
        return {
            "final_state": state,
            "history": history,
            "last_step": step,
            "straggler_steps": self.watchdog.straggler_steps,
            "preempted": self._preempted,
            "goodput": meter.report(),
        }
