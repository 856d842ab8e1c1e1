"""Serving resilience: admission control, load shedding, serve goodput.

Counterpart of ``repro.serving.resilience``, plain host-side Python like
the reference's (its own copy: the port imports nothing of the JAX
package).  The policy layer of the serving failure model
(``docs/serving.md``).  The
*mechanisms* — checksums, corruption, slot rebuild — live next to the
state they guard (``kv_cache.py``, ``scheduler.py``); this module owns
the host-side policy objects, all plain deterministic Python:

* :class:`Rejection` — the structured admission-control verdict.  A
  bounded queue never grows past ``SchedulerConfig.max_queue``; instead
  the scheduler records a rejection carrying ``retry_after``, the
  server-side hint a well-behaved client (``loadgen.run_load``) feeds
  into its exponential-backoff retry loop.

* :class:`ShedPolicy` — deterministic graceful degradation under
  sustained overload.  Two axes, both optional: drop queued work whose
  deadline is already infeasible (it would burn decode-slot ticks and
  then be evicted anyway), and trim the queue above a high-water mark
  by shedding the lowest-priority / youngest work first.

* :class:`ServeGoodputMeter` — the serving mirror of the training
  ``GoodputMeter``: **useful tokens ÷ total decode-slot-ticks**.  The
  denominator bills every slot of every batched decode step (an empty
  slot in a half-full batch is waste by construction) plus the
  slot-ticks spent on recovery re-prefills; the numerator counts only
  tokens of requests that *finished* — tokens emitted for a request
  that later expired or was evicted are sunk cost.  Emitted as
  ``serve/slo_*`` rows into ``BENCH_engine.json`` and held to the floors of
  ``benchmarks/baselines/serve_slo.json``.

* :class:`SlotGuard` — the armed checksum for one occupied decode slot
  (what :meth:`Scheduler._audit_slots` compares against).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

__all__ = [
    "Rejection", "ShedPolicy", "SlotGuard", "ServeGoodputMeter",
    "retry_after_hint",
]


@dataclasses.dataclass(frozen=True)
class Rejection:
    """One admission-control rejection, recorded in submission order.

    ``retry_after`` is the server's deterministic backpressure hint in
    ticks (``None`` means the request is invalid and retrying is
    pointless — oversized prompt+gen, non-positive token budget).
    """
    rid: int
    tick: float
    reason: str                        # "invalid" | "oversized" | "queue_full"
    retry_after: Optional[float] = None


def retry_after_hint(queue_depth: int, prefill_ticks: float) -> float:
    """Backpressure hint for a ``queue_full`` rejection: the ticks until
    the queue has plausibly drained one request per prefill, never less
    than one full prefill."""
    return max(1, queue_depth) * max(prefill_ticks, 1.0)


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Deterministic load shedding over the admitted queue.

    ``shed_infeasible`` drops queued requests whose deadline cannot be
    met even if a slot freed *right now* (one prefill plus one tick per
    remaining token still overruns the deadline).  ``queue_high_water``
    then trims the queue down to the mark, shedding lowest ``priority``
    first, then latest arrival, then highest rid — so under identical
    traffic two runs shed the identical set.
    """
    queue_high_water: Optional[int] = None
    shed_infeasible: bool = True

    def feasible(self, req, clock: float, prefill_ticks: float) -> bool:
        if req.deadline_ticks is None:
            return True
        finish_at_best = clock + prefill_ticks + req.max_new_tokens
        return finish_at_best <= req.arrival + req.deadline_ticks

    def select_shed(self, queue: Sequence, clock: float,
                    prefill_ticks: float) -> List:
        victims = []
        survivors = list(queue)
        if self.shed_infeasible:
            victims = [r for r in survivors
                       if not self.feasible(r, clock, prefill_ticks)]
            survivors = [r for r in survivors
                         if self.feasible(r, clock, prefill_ticks)]
        if (self.queue_high_water is not None
                and len(survivors) > self.queue_high_water):
            n_drop = len(survivors) - self.queue_high_water
            # lowest priority sheds first; ties broken against the
            # youngest (latest-arriving, highest-rid) request
            by_value = sorted(survivors,
                              key=lambda r: (r.priority, -r.arrival, -r.rid))
            victims.extend(by_value[:n_drop])
        return victims


@dataclasses.dataclass(frozen=True)
class SlotGuard:
    """Armed integrity state for one occupied slot: the CRC32 of its
    ``length`` valid KV rows as of the last healthy cache mutation."""
    rid: int
    length: int
    checksum: int


@dataclasses.dataclass
class ServeGoodputMeter:
    """Serve goodput: useful tokens ÷ total decode-slot-ticks.

    ``decode_steps × n_slots`` bills the whole pool for every batched
    decode step — idle slots in a ragged batch are structural waste —
    and ``recovery_slot_ticks`` adds the re-prefill / re-decode work a
    quarantined slot costs (recovery overlaps the pool's virtual clock,
    so it shows up here and nowhere else).  Tokens emitted by requests
    that later expired are counted as ``wasted_tokens``, not useful.
    """
    n_slots: int
    decode_steps: int = 0
    useful_tokens: int = 0
    wasted_tokens: int = 0
    recovery_slot_ticks: float = 0.0
    recoveries: int = 0
    expired: int = 0
    shed: int = 0
    rejected: int = 0

    def on_decode_step(self) -> None:
        self.decode_steps += 1

    def on_finish(self, n_tokens: int) -> None:
        self.useful_tokens += n_tokens

    def on_expire(self, n_tokens_emitted: int) -> None:
        self.expired += 1
        self.wasted_tokens += n_tokens_emitted

    def on_recovery(self, slot_ticks: float) -> None:
        self.recoveries += 1
        self.recovery_slot_ticks += slot_ticks

    def on_shed(self) -> None:
        self.shed += 1

    def on_reject(self) -> None:
        self.rejected += 1

    @property
    def slot_ticks(self) -> float:
        return self.decode_steps * self.n_slots + self.recovery_slot_ticks

    @property
    def goodput(self) -> float:
        return self.useful_tokens / max(self.slot_ticks, 1e-9)

    def report(self) -> Dict[str, float]:
        return {
            "goodput": self.goodput,
            "useful_tokens": float(self.useful_tokens),
            "wasted_tokens": float(self.wasted_tokens),
            "slot_ticks": float(self.slot_ticks),
            "recovery_slot_ticks": float(self.recovery_slot_ticks),
            "recoveries": float(self.recoveries),
            "expired": float(self.expired),
            "shed": float(self.shed),
            "rejected": float(self.rejected),
        }
