"""Continuous-batching request scheduler over the engine's decode path.

Counterpart of ``repro.serving.scheduler``: requests enter a FIFO
admission queue stamped with arrival ticks; a free decode slot triggers a
batch-1 prefill of the request's real prompt, whose cache is inserted into
the pooled decode cache at that slot; all occupied slots then advance
together through batched decode steps with per-slot positions and per-slot
KV lengths (the ragged ``grouped_matmul`` path bills only valid rows).  A
sequence that has emitted its budget drains: one more step absorbs its
last token's KV, so the cache is always consistent with the emitted
tokens, then the slot frees for the next queued request.

Time is a virtual clock: one tick per batched decode step,
``prefill_ticks`` per prefill.  FIFO by ``(arrival, rid)``, lowest free
slot first and greedy argmax make a seeded arrival set pin the whole
``trace``.

The resilience layer (``docs/serving.md``'s failure model), as the
reference's: a request may carry ``deadline_ticks`` (expired work is
evicted queued or mid-decode; the drain invariant keeps the pool
consistent); ``max_queue`` bounds the queue, rejecting overflow with a
:class:`~repro_torch.serving.resilience.Rejection` carrying a
``retry_after`` hint; a :class:`~repro_torch.serving.resilience.ShedPolicy`
drops infeasible or lowest-priority queued work; a
:class:`~repro_torch.runtime.fault_tolerance.FailureInjector` with a
serving mode exercises the detectors: a NaN / inf guard on every decode
step's logits and per-slot CRC32 guards of the stored KV rows, audited
every ``audit_every`` decode steps and re-armed after every cache
mutation.  Recovery quarantines the slot and rebuilds its cache from the
arithmetic that built it (and for ``nan_logits`` replays the poisoned
decode step, whose logits row replaces the poisoned one); it overlaps
the virtual clock and is billed as waste slot-ticks by the
:class:`~repro_torch.serving.resilience.ServeGoodputMeter`.  An injected
prefill crash is retried once; any other error propagates.

On the 16-bit cache the rebuild re-prefills the prompt alone at the
admission's shape (batch 1, the prompt's length) into the victim's slot,
then replays the absorbed tokens one decode step at a time at the decode
steps' own shape (``n_slots`` rows, the other slots parked as padding,
the same cache length) in the pool itself; the parked slots' last rows,
which the replay writes, are put back after it, so a recovery needs no
KV memory beyond the pool.  Kernel 1's split, the row reductions and
kernel 2's tiling depend on those shapes only, and every row of a step is
computed from its own inputs, so the rebuilt rows and the victim's later
logits equal the decode-built ones bitwise, on the card as on the CPU.
The price is one prefill plus ``fed`` decode steps at the pool's batch,
linear in the tokens the victim has absorbed; the virtual clock and the
goodput meter bill a rebuild as one prefill, as the reference does.
(A MoE layer routes over the whole batch with a capacity, so there a
replay is exact only where the padding does not move the routing.)  On
an FP8 cache a decode step reads rows quantized under the pool's
ratcheted scale, which a replay cannot reproduce, so the rebuild re-
prefills ``prompt + absorbed tokens`` batch 1 (and replays the poisoned
step batch 1), as the reference does: the rows lie within one E4M3 step
of the decode-built ones (``chip_smoke.py``'s sched phase holds both).

On a mesh of ranks (``rules`` and ``mesh``, the reference's ``Scheduler(
rules=...)`` on its ambient mesh) every rank runs this same host state
machine.  The pool is the rank's block of the sanitized cache specs
(``serving.specs``): its batch cut over the data axes where ``n_slots``
divides (else replicated), its positions or KV heads over the model axis
as the rules say.  A batch-1 prefill runs replicated across the data ranks
(its batch dim sanitizes to whole) and its cache is inserted on the rank
holding the slot (``kv_cache.insert_slot``).  A decode step runs the
rank's slots, and the logits are all-gathered over the data axes before
the NaN guard and the argmax, so every rank takes the same decisions and
writes the same ``trace``.  The audit gathers a slot's stored bytes to
every rank (``kv_cache.slot_checksum``), the corruptor flips the same
global rows, and a rebuild runs the same shapes as on one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.models import transformer
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding
from repro_torch.runtime.fault_tolerance import InjectedFault
from repro_torch.serving import kv_cache, resilience
from repro_torch.serving import specs as specs_lib

__all__ = ["Request", "SchedulerConfig", "RequestResult", "Scheduler",
           "instrumented_decode_events"]


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival: float          # ticks
    prompt: np.ndarray      # (P,) int32 token ids
    max_new_tokens: int
    deadline_ticks: Optional[float] = None  # budget relative to arrival
    priority: int = 0       # higher survives load shedding longer

    @property
    def deadline(self) -> Optional[float]:
        if self.deadline_ticks is None:
            return None
        return self.arrival + self.deadline_ticks


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    n_slots: int = 4
    max_len: int = 64
    storage_dtype: Optional[str] = None  # e.g. "float8_e4m3fn" (FP8 KV cache)
    prefill_ticks: float = 1.0
    max_queue: Optional[int] = None      # bounded admission; None = unbounded
    audit_every: int = 0                 # KV checksum cadence; 0 = off
    shed: Optional[resilience.ShedPolicy] = None


@dataclasses.dataclass
class RequestResult:
    rid: int
    arrival: float
    first_token_tick: Optional[float] = None
    finish_tick: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    final_logits: Optional[np.ndarray] = None  # P(next token | full sequence)
    status: str = "pending"  # pending | finished | rejected | expired | shed

    @property
    def ttft(self) -> float:
        if self.first_token_tick is None:
            return float("nan")
        return self.first_token_tick - self.arrival

    @property
    def tokens_per_tick(self) -> float:
        if self.finish_tick is None:
            return float("nan")
        return len(self.tokens) / max(self.finish_tick - self.arrival, 1e-9)


@dataclasses.dataclass
class _Slot:
    rid: int
    pos: int        # next cache write position == rows currently valid
    emitted: int    # tokens emitted so far
    fed: int        # emitted tokens whose KV has been absorbed
    max_new: int
    last_token: int
    prompt: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    deadline: Optional[float] = None    # absolute tick
    priority: int = 0


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


class Scheduler:
    """FIFO admission -> per-request prefill -> pooled continuous decode,
    on the device the parameters live on."""

    def __init__(self, params, cfg, scfg: SchedulerConfig, injector=None, *,
                 rules=None, mesh=None):
        if cfg.block_kind not in ("attn", "moe"):
            raise ValueError(
                f"the serving scheduler drives attn/moe decode caches, "
                f"not {cfg.block_kind!r}")
        if scfg.n_slots < 1:
            raise ValueError("need at least one decode slot")
        if (injector is not None and injector.mode == "kv_corrupt"
                and scfg.audit_every < 1):
            raise ValueError(
                "kv_corrupt injection needs audit_every >= 1 — silent "
                "corruption with the checksum audit off is undetectable")
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.injector = injector
        # sharded serving: every model call runs under the rules and mesh;
        # a batch-1 prefill under them with the batch left whole
        self.rules, self.mesh = rules, mesh
        self.layout: Optional[kv_cache.Layout] = None
        self._mine = list(range(scfg.n_slots))      # the slots this rank holds
        self._batch_axes: Tuple[str, ...] = ()
        if mesh is not None and rules is not None and mesh.size > 1:
            self.layout = kv_cache.Layout(specs_lib.decode_cache_specs(
                cfg, rules, mesh, scfg.n_slots, scfg.max_len,
                storage_dtype=scfg.storage_dtype)[1], mesh)
            key, name, spec = next(
                (k, n, sub[n]) for k, sub in self.layout.specs.items()
                for n in ("k", "ckv") if n in sub)
            bax = 1 if key == "layers" else 0
            self._batch_axes = self.layout.axes(spec, (bax,))
            n_local = scfg.n_slots // math.prod(mesh.shape[a] for a in self._batch_axes)
            first = n_local * sharding.block_index(self._batch_axes, mesh) \
                if self._batch_axes else 0
            self._mine = list(range(first, first + n_local))
        self.prefill_rules = None if rules is None else dataclasses.replace(
            rules, overrides=rules.overrides + (("batch", None),))
        self.device = params["embed"].device
        self.clock = 0.0
        self.decode_steps = 0
        self.prefill_count = 0
        self.recovery_decode_steps = 0  # decode steps run by slot rebuilds
        self.compute_dtype = cfg.policy.compute_dtype
        with self._sharded(self.rules):
            self.cache = transformer.init_cache(
                cfg, scfg.n_slots, scfg.max_len, dtype=self.compute_dtype,
                storage_dtype=scfg.storage_dtype, device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * scfg.n_slots
        self.pending: List[Request] = []       # submitted, arrival in future
        self.queue: deque = deque()            # admitted, waiting for a slot
        self.trace: List[Tuple] = []           # (event, tick, rid, ...)
        self.health: List[Dict[str, float]] = []
        self.results: Dict[int, RequestResult] = {}
        self.rejections: List[resilience.Rejection] = []
        self.guards: Dict[int, resilience.SlotGuard] = {}
        self.goodput = resilience.ServeGoodputMeter(n_slots=scfg.n_slots)

    def _sharded(self, rules):
        """``rules`` (the pool's, or :attr:`prefill_rules`) and the mesh of a
        sharded scheduler (else no context)."""
        stack = contextlib.ExitStack()
        if rules is not None:
            stack.enter_context(sharding.use_rules(rules))
            if self.mesh is not None:
                stack.enter_context(sharding.use_mesh(self.mesh))
        return stack

    def _serve_step(self, toks, pos, sizes):
        """One decode step of the pool (``toks`` / ``pos`` / ``sizes`` for
        every slot; this rank runs its own) under the pool's rules; the
        logits of every slot on every rank (all-gathered over the data
        axes that cut the pool)."""
        mine = self._mine
        if len(mine) != self.scfg.n_slots:
            toks, pos, sizes = toks[mine[0]:mine[-1] + 1], pos[mine[0]:mine[-1] + 1], \
                sizes[mine[0]:mine[-1] + 1]
        with self._sharded(self.rules):
            logits, self.cache = transformer.serve_step(
                self.params, self.cfg, toks, self.cache, pos, kv_group_sizes=sizes,
                max_len=self.scfg.max_len)
        for a in reversed(self._batch_axes):
            logits = coll.all_gather(logits, self.mesh, a, 0)
        return logits

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # -- admission ------------------------------------------------------ #
    def _reject(self, r: Request, reason: str,
                retry_after: Optional[float]) -> None:
        self.rejections.append(resilience.Rejection(
            rid=r.rid, tick=self.clock, reason=reason, retry_after=retry_after))
        self.results[r.rid] = RequestResult(rid=r.rid, arrival=r.arrival,
                                            status="rejected")
        self.goodput.on_reject()
        self.trace.append(("reject", self.clock, r.rid, reason))

    def submit(self, requests: Sequence[Request]) -> None:
        """Validate and enqueue; an invalid request is rejected on its own
        (``retry_after=None``: retrying cannot help) and never aborts the
        rest of the batch."""
        accepted = []
        for r in requests:
            if r.max_new_tokens < 1:
                self._reject(r, "invalid", None)
                continue
            if len(r.prompt) + r.max_new_tokens > self.scfg.max_len:
                self._reject(r, "oversized", None)
                continue
            self.results[r.rid] = RequestResult(rid=r.rid, arrival=r.arrival)
            accepted.append(r)
        self.pending.extend(accepted)
        self.pending.sort(key=lambda r: (r.arrival, r.rid))

    def _expire(self, r: Request, where: str) -> None:
        self.results[r.rid].status = "expired"
        self.goodput.on_expire(0)
        self.trace.append(("expire", self.clock, r.rid, where))

    def _admit(self) -> None:
        while self.pending and self.pending[0].arrival <= self.clock:
            r = self.pending.pop(0)
            if r.deadline is not None and self.clock >= r.deadline:
                self._expire(r, "pending")
                continue
            if self.scfg.max_queue is not None:
                # free slots count toward capacity: _start hands them out
                # this very step, so only waiting work meets the bound
                cap = self.scfg.max_queue + sum(1 for s in self.slots if s is None)
                if len(self.queue) >= cap:
                    self._reject(r, "queue_full", resilience.retry_after_hint(
                        len(self.queue), self.scfg.prefill_ticks))
                    continue
            self.queue.append(r)
            self.trace.append(("admit", self.clock, r.rid))

    def _shed(self) -> None:
        # after _start: only work still waiting once the free slots were
        # handed out may be shed
        if self.scfg.shed is None or not self.queue:
            return
        victims = self.scfg.shed.select_shed(
            list(self.queue), self.clock, self.scfg.prefill_ticks)
        if not victims:
            return
        vids = {r.rid for r in victims}
        self.queue = deque(r for r in self.queue if r.rid not in vids)
        for r in sorted(victims, key=lambda v: v.rid):
            self.results[r.rid].status = "shed"
            self.goodput.on_shed()
            self.trace.append(("shed", self.clock, r.rid))

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _evict_expired(self) -> None:
        """Drop expired work, queued or mid-decode.  Mid-flight eviction is
        safe under the drain invariant (the slot's rows equal ``prompt +
        emitted[:fed]``); its emitted tokens are billed as waste."""
        for i, s in enumerate(self.slots):
            if s is None or s.deadline is None or self.clock < s.deadline:
                continue
            res = self.results[s.rid]
            res.status = "expired"
            self.goodput.on_expire(len(res.tokens))
            self.trace.append(("evict", self.clock, s.rid, i))
            self.slots[i] = None
            self.guards.pop(i, None)
        if self.queue:
            keep: deque = deque()
            for r in self.queue:
                if r.deadline is not None and self.clock >= r.deadline:
                    self._expire(r, "queued")
                else:
                    keep.append(r)
            self.queue = keep

    # -- prefill (batch 1, the request's real prompt length) ------------- #
    def _prefill(self, seq: np.ndarray, scope: str):
        with engine.op_scope(scope), self._sharded(self.prefill_rules):
            return transformer.prefill(
                self.params, self.cfg, {"inputs": self._tokens(seq)[None]},
                self.scfg.max_len, storage_dtype=self.scfg.storage_dtype)

    def _guarded_prefill(self, prompt: np.ndarray, rid: int):
        """One prefill with crash injection and a single retry: the
        injector's latch makes the retry run clean, so a crashed prefill
        costs one prefill's worth of waste slot-ticks."""
        self.prefill_count += 1
        try:
            if (self.injector is not None and self.injector.fires(
                    self.prefill_count, "prefill_crash")):
                raise InjectedFault("injected prefill crash")
            return self._prefill(prompt, "serve_prefill")
        except InjectedFault:
            self.trace.append(("prefill_retry", self.clock, rid))
            self.goodput.on_recovery(self.scfg.prefill_ticks)
            return self._prefill(prompt, "serve_prefill")

    def _insert(self, single, slot: int, scope: str) -> None:
        with engine.op_scope(scope), self._sharded(self.rules):
            kv_cache.insert_slot(self.cache, single, slot, self.compute_dtype,
                                 self.layout)

    def _start(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            r = self.queue.popleft()
            if r.deadline is not None and self.clock >= r.deadline:
                # expired while a co-resident prefill moved the clock
                self._expire(r, "queued")
                continue
            prompt = np.asarray(r.prompt, np.int32)
            logits, single = self._guarded_prefill(prompt, r.rid)
            self._insert(single, slot, "serve_admit")
            tok = int(np.argmax(_host_logits(logits[0])))
            self.clock += self.scfg.prefill_ticks
            res = self.results[r.rid]
            res.first_token_tick = self.clock
            res.tokens.append(tok)
            self.slots[slot] = _Slot(
                rid=r.rid, pos=len(prompt), emitted=1, fed=0,
                max_new=r.max_new_tokens, last_token=tok, prompt=prompt,
                deadline=r.deadline, priority=r.priority)
            self._arm_guards()
            self.trace.append(("prefill", self.clock, r.rid, slot, len(prompt)))
            self._admit()  # the clock moved; later arrivals may be due now

    # -- integrity: checksum guards, quarantine, slot rebuild ------------ #
    def _arm_guards(self) -> None:
        """(Re)checksum every occupied slot after a cache mutation: global,
        since under FP8 any insert may requantize the whole pool."""
        if self.scfg.audit_every < 1:
            return
        self.guards = {
            i: resilience.SlotGuard(
                rid=s.rid, length=s.pos,
                checksum=kv_cache.slot_checksum(self.cache, i, s.pos, self.layout))
            for i, s in enumerate(self.slots) if s is not None}

    def _audit_slots(self) -> None:
        """Compare every armed guard, then quarantine and rebuild the
        mismatches (all compared first: a rebuild may requantize the FP8
        pool and trip the still-armed guards of the other slots)."""
        bad = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            g = self.guards.get(i)
            if g is None or g.rid != s.rid:
                continue
            if kv_cache.slot_checksum(self.cache, i, g.length,
                                      self.layout) != g.checksum:
                bad.append(i)
        for i in bad:
            s = self.slots[i]
            self.trace.append(("kv_quarantine", self.clock, s.rid, i))
            self._rebuild_slot(i, s, rerun_decode=False)
            self.goodput.on_recovery(self.scfg.prefill_ticks)
            self.trace.append(("recover", self.clock, s.rid, i))
        if bad:
            self._arm_guards()

    def _rebuild_slot(self, slot: int, s: _Slot,
                      rerun_decode: bool) -> Optional[np.ndarray]:
        """Rebuild one slot's cache from exactly the tokens whose KV it
        holds, ``prompt + emitted[:fed]``, and re-insert it (see the
        module docstring for how).  With ``rerun_decode`` the poisoned
        decode step (``last_token`` at ``pos``) is replayed too and its
        logits row is returned to replace the poisoned one.  The clock
        does not move."""
        res = self.results[s.rid]
        absorbed = [int(t) for t in res.tokens[:s.fed]]
        assert len(s.prompt) + len(absorbed) == s.pos, "slot rows out of sync"
        if self.scfg.storage_dtype is not None:
            return self._rebuild_by_prefill(slot, s, absorbed, rerun_decode)
        feed = absorbed + ([s.last_token] if rerun_decode else [])
        _, single = self._prefill(s.prompt, "serve_recover")
        self._insert(single, slot, "serve_recover")
        # the replay parks every other slot at the last row (see
        # _step_inputs), which may hold a co-resident's newest row (on a
        # mesh: where this rank's block holds that position)
        last = self.scfg.max_len - 1
        held = [None if v is None else v.clone()
                for v in kv_cache.position_views(self.cache, last, self.layout)]
        logits = None
        for j, tok in enumerate(feed):
            toks, pos, sizes = self._step_inputs({slot: (tok, len(s.prompt) + j)})
            with engine.op_scope("serve_recover"):
                logits = self._serve_step(toks, pos, sizes)
            self.recovery_decode_steps += 1
        rows = kv_cache.position_views(self.cache, last, self.layout)
        for (key, name, leaf, bax), row, keep in zip(kv_cache.iter_kv_leaves(self.cache),
                                                     rows, held):
            if row is None:
                continue
            local = slot if self.layout is None else self.layout.slot(
                key, name, leaf, bax, slot)
            if local is not None:
                keep.narrow(bax, local, 1).copy_(row.narrow(bax, local, 1))
            row.copy_(keep)
        return _host_logits(logits[slot]) if rerun_decode else None

    def _rebuild_by_prefill(self, slot: int, s: _Slot, absorbed: List[int],
                            rerun_decode: bool) -> Optional[np.ndarray]:
        """The FP8 cache's rebuild: a batch-1 prefill of ``prompt +
        absorbed``, and with ``rerun_decode`` a batch-1 replay of the
        poisoned step."""
        seq = np.concatenate([np.asarray(s.prompt, np.int32),
                              np.asarray(absorbed, np.int32)])
        _, single = self._prefill(seq, "serve_recover")
        row = None
        if rerun_decode:
            with engine.op_scope("serve_recover"), self._sharded(self.prefill_rules):
                logits1, single = transformer.serve_step(
                    self.params, self.cfg, self._tokens([[s.last_token]]), single,
                    self._tokens([s.pos]),
                    kv_group_sizes=np.asarray([s.pos + 1], np.int32),
                    max_len=self.scfg.max_len)
            self.recovery_decode_steps += 1
            row = _host_logits(logits1[0])
        self._insert(single, slot, "serve_recover")
        return row

    def _victim_slot(self) -> Optional[int]:
        active = self._active()
        if not active:
            return None
        target = getattr(self.injector, "target", None)
        if target is not None:
            for i in active:
                if self.slots[i].rid == target:
                    return i
        return active[0]

    # -- decode (the whole slot pool, ragged over per-slot KV lengths) --- #
    def _active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _step_inputs(self, rows: Dict[int, Tuple[int, int]]):
        """A decode step's ``(tokens (n, 1), positions (n,), kv sizes
        (n,))`` for ``rows = {slot: (token, pos)}``; every other slot is
        parked at ``max_len - 1`` with no valid rows (an empty slot's row
        its next occupant overwrites anyway; a rebuild's replay puts the
        occupied slots' row back)."""
        n = self.scfg.n_slots
        toks = np.zeros((n, 1), np.int64)
        pos = np.full((n,), self.scfg.max_len - 1, np.int64)
        sizes = np.zeros((n,), np.int32)
        for i, (tok, p) in rows.items():
            toks[i, 0] = tok
            pos[i] = p
            sizes[i] = p + 1  # valid kv rows after this step's append
        return self._tokens(toks), self._tokens(pos), sizes

    def _decode_once(self) -> None:
        if (self.scfg.audit_every >= 1
                and self.decode_steps % self.scfg.audit_every == 0):
            self._audit_slots()
        n = self.scfg.n_slots
        toks, pos, sizes = self._step_inputs(
            {i: (s.last_token, s.pos) for i, s in enumerate(self.slots) if s is not None})
        with engine.op_scope("serve_decode"):
            logits = _host_logits(self._serve_step(toks, pos, sizes))
        self.clock += 1.0
        self.decode_steps += 1
        self.goodput.on_decode_step()
        if (self.injector is not None and self.injector.mode == "nan_logits"
                and self._active()
                and self.injector.fires(self.decode_steps, "nan_logits")):
            logits[self._victim_slot(), :] = np.nan
        for i, s in enumerate(self.slots):
            if s is None or np.all(np.isfinite(logits[i])):
                continue
            # NaN / inf guard: the slot's freshly appended KV row is as
            # suspect as its logits — quarantine, rebuild, replay
            self.trace.append(("nan_detect", self.clock, s.rid, i))
            logits[i] = self._rebuild_slot(i, s, rerun_decode=True)
            self.goodput.on_recovery(self.scfg.prefill_ticks + 1.0)
            self.trace.append(("recover", self.clock, s.rid, i))
        active = 0
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            active += 1
            s.fed += 1
            s.pos += 1
            res = self.results[s.rid]
            if s.emitted < s.max_new:
                tok = int(np.argmax(logits[i]))
                s.emitted += 1
                s.last_token = tok
                res.tokens.append(tok)
            if s.emitted >= s.max_new and s.fed >= s.emitted:
                # the last emitted token's KV was absorbed this step: the
                # cache is consistent with the emitted sequence at eviction
                res.finish_tick = self.clock
                res.final_logits = logits[i]
                res.status = "finished"
                self.goodput.on_finish(len(res.tokens))
                self.trace.append(("finish", self.clock, s.rid, i))
                self.slots[i] = None
                self.guards.pop(i, None)
        self._arm_guards()
        if (self.injector is not None and self.injector.mode == "kv_corrupt"
                and self._active()
                and self.injector.fires(self.decode_steps, "kv_corrupt")):
            # silent bit flips after the guards armed; the next audit
            # (before the corrupt rows are read) must flag exactly this slot
            v = self._victim_slot()
            sv = self.slots[v]
            self.cache = kv_cache.corrupt_slot_rows(self.cache, v,
                                                    [0, max(sv.pos - 1, 0)], self.layout)
        self.health.append({
            "tick": self.clock,
            "queue_depth": len(self.queue),
            "pending": len(self.pending),
            "active_slots": active,
            "batch_fill": active / n,
            "goodput": self.goodput.goodput,
            "recoveries": self.goodput.recoveries,
            "expired": self.goodput.expired,
            "rejected": self.goodput.rejected,
        })

    # -- drive ----------------------------------------------------------- #
    def step(self) -> bool:
        """Advance one scheduler event; False once fully drained."""
        self._evict_expired()
        self._admit()
        self._start()
        self._shed()
        if self._active():
            self._decode_once()
            return True
        if self.pending:  # idle until the next arrival
            self.clock = max(self.clock, self.pending[0].arrival)
            return True
        return False

    def run(self) -> List[RequestResult]:
        while self.step():
            pass
        return [self.results[rid] for rid in sorted(self.results)]


@torch.inference_mode()
def instrumented_decode_events(params, cfg, scfg: SchedulerConfig,
                               kv_lengths: Sequence[int]) -> List[Any]:
    """The engine events of one continuous-batching decode step, tagged
    under the ``serve_decode`` op scope: the step runs once on a fresh pool
    (zero tokens; a parked slot, length 0, at ``max_len - 1``), on the
    device the parameters live on.  ``kv_lengths`` are the per-slot valid
    rows after the step's append (0 for a parked slot), the group sizes
    the scheduler passes, so the ragged score GEMMs bill exactly them."""
    n = scfg.n_slots
    sizes = np.asarray(kv_lengths, np.int32)
    if sizes.shape != (n,):
        raise ValueError(f"need {n} per-slot lengths, got {sizes.shape}")
    dev = params["embed"].device
    cache = transformer.init_cache(cfg, n, scfg.max_len,
                                   dtype=cfg.policy.compute_dtype,
                                   storage_dtype=scfg.storage_dtype, device=dev)
    pos = torch.as_tensor(np.where(sizes > 0, sizes - 1, scfg.max_len - 1),
                          dtype=torch.long, device=dev)
    toks = torch.zeros((n, 1), dtype=torch.long, device=dev)
    with engine.instrument() as events, engine.op_scope("serve_decode"):
        transformer.serve_step(params, cfg, toks, cache, pos, kv_group_sizes=sizes)
    return events
