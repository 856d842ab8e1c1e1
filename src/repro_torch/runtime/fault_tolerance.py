"""Deterministic fault injection for the serving path.

Counterpart of ``repro.runtime.fault_tolerance.FailureInjector``
(``fault_tolerance.py:51-128``), for its serving modes, which the
scheduler consumes through :meth:`FailureInjector.fires`:

* ``"nan_logits"`` — poison the decode output of one slot at the
  ``fail_at_step``-th batched decode step (the FP8 scale-overflow shape);
* ``"kv_corrupt"`` — bit-flip the stored KV rows of one slot after the
  ``fail_at_step``-th decode step (caught by the checksum audit);
* ``"prefill_crash"`` — raise :class:`InjectedFault` inside the
  ``fail_at_step``-th prefill (the scheduler retries; one-shot, so the
  retry runs clean).

``"raise"`` raises :class:`InjectedFault` from :meth:`maybe_fail`, as the
reference's training loop sees it.  The modes that need a checkpoint and
a training loop — ``"die"``, ``"sigterm"``, ``"ckpt_crash"`` and
:meth:`maybe_fail_save` — are not ported yet (ROADMAP.md, Queue A 6), nor
are the rest of the reference's module (``StragglerWatchdog``,
``GoodputMeter``, ``TrainLoop``, ``reshard``).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["FailureInjector", "InjectedFault"]

_QUEUE_A6 = "not yet ported (see ROADMAP.md, Queue A 6: checkpoints and the train loop)"


class InjectedFault(RuntimeError):
    """The error an injector raises; the serving scheduler retries only
    this one, so a genuine failure of a prefill is never swallowed."""


class FailureInjector:
    """One-shot fault injection: every mode fires at ``fail_at_step`` and
    only once (``fired`` is the latch).  ``target`` names the victim
    request id of a serving mode; None lets the scheduler pick the
    lowest-rid active slot."""

    SERVING_MODES = ("nan_logits", "kv_corrupt", "prefill_crash")
    CHECKPOINT_MODES = ("die", "sigterm", "ckpt_crash")
    MODES = ("raise",) + CHECKPOINT_MODES + SERVING_MODES

    def __init__(self, fail_at_step: Optional[int] = None, mode: str = "raise",
                 exit_code: int = 13, target: Optional[int] = None):
        if mode not in self.MODES:
            raise ValueError(f"unknown failure mode {mode!r}; known: {self.MODES}")
        if mode in self.CHECKPOINT_MODES:
            raise NotImplementedError(f"failure mode {mode!r} is {_QUEUE_A6}")
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
        """The training loop's hook at the top of each step: ``"raise"``
        raises at ``fail_at_step``; the serving modes do nothing here."""
        if self.mode != "raise":
            return
        if self.fail_at_step is None or self.fired or step != self.fail_at_step:
            return
        self.fired = True
        raise InjectedFault(f"injected failure at step {step}")

    def maybe_fail_save(self, step: int, ckpt=None) -> None:
        raise NotImplementedError(f"a crash inside a checkpoint write is {_QUEUE_A6}")
