"""Continuous-batching request scheduler over the engine's decode path.

Counterpart of the core of ``repro.serving.scheduler.Scheduler``
(``scheduler.py:127``): requests enter a FIFO admission queue stamped with
arrival ticks; a free decode slot triggers a batch-1 prefill of the
request's real prompt, whose cache is inserted into the pooled decode
cache at that slot; all occupied slots then advance together through
batched decode steps with per-slot positions and per-slot KV lengths (the
ragged ``grouped_matmul`` path bills only valid rows).  A sequence that has
emitted its budget drains: one more step absorbs its last token's KV, so
the cache is always consistent with the emitted tokens, then the slot
frees for the next queued request.

Time is a virtual clock: one tick per batched decode step,
``prefill_ticks`` per prefill.  FIFO by ``(arrival, rid)``, lowest free slot
first and greedy argmax make a seeded arrival set pin the whole
``trace``.  The resilience layer of the reference (fault injection,
deadlines, a bounded queue, shedding, checksum guards, the goodput meter)
is not ported yet: a config or request that asks for it raises.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.models import transformer
from repro_torch.serving import kv_cache

__all__ = ["Request", "SchedulerConfig", "RequestResult", "Scheduler"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival: float          # ticks
    prompt: np.ndarray      # (P,) int32 token ids
    max_new_tokens: int
    deadline_ticks: Optional[float] = None  # resilience: must stay None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    n_slots: int = 4
    max_len: int = 64
    storage_dtype: Optional[str] = None   # FP8 KV cache: must stay None
    prefill_ticks: float = 1.0
    max_queue: Optional[int] = None       # resilience: must stay None
    audit_every: int = 0                  # resilience: must stay 0
    shed: Optional[Any] = None            # resilience: must stay None


@dataclasses.dataclass
class RequestResult:
    rid: int
    arrival: float
    first_token_tick: Optional[float] = None
    finish_tick: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    final_logits: Optional[np.ndarray] = None  # P(next token | full sequence)
    status: str = "pending"  # pending | finished | rejected


@dataclasses.dataclass
class _Slot:
    rid: int
    pos: int        # next cache write position == rows currently valid
    emitted: int    # tokens emitted so far
    fed: int        # emitted tokens whose KV has been absorbed
    max_new: int
    last_token: int


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


class Scheduler:
    """FIFO admission -> per-request prefill -> pooled continuous decode,
    on the device the parameters live on."""

    def __init__(self, params, cfg, scfg: SchedulerConfig):
        if cfg.block_kind not in ("attn", "moe"):
            raise ValueError(
                f"the serving scheduler drives attn/moe decode caches, "
                f"not {cfg.block_kind!r}")
        if scfg.n_slots < 1:
            raise ValueError("need at least one decode slot")
        if scfg.storage_dtype is not None:
            raise NotImplementedError(f"the FP8 KV cache is {_ROADMAP}")
        if (scfg.max_queue is not None or scfg.audit_every or
                scfg.shed is not None):
            raise NotImplementedError(
                f"the serving resilience layer (bounded queue, KV audits, "
                f"shedding) is {_ROADMAP}")
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.device = params["embed"].device
        self.clock = 0.0
        self.decode_steps = 0
        self.cache = transformer.init_cache(
            cfg, scfg.n_slots, scfg.max_len, dtype=cfg.policy.compute_dtype,
            device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * scfg.n_slots
        self.pending: List[Request] = []       # submitted, arrival in future
        self.queue: deque = deque()            # admitted, waiting for a slot
        self.trace: List[Tuple] = []           # (event, tick, rid, ...)
        self.results: Dict[int, RequestResult] = {}

    # -- admission ------------------------------------------------------ #
    def _reject(self, r: Request, reason: str) -> None:
        self.results[r.rid] = RequestResult(rid=r.rid, arrival=r.arrival,
                                            status="rejected")
        self.trace.append(("reject", self.clock, r.rid, reason))

    def submit(self, requests: Sequence[Request]) -> None:
        """Validate and enqueue; an invalid request is rejected on its own
        and never aborts the rest of the batch."""
        accepted = []
        for r in requests:
            if r.deadline_ticks is not None:
                raise NotImplementedError(f"request deadlines are {_ROADMAP}")
            if r.max_new_tokens < 1:
                self._reject(r, "invalid")
                continue
            if len(r.prompt) + r.max_new_tokens > self.scfg.max_len:
                self._reject(r, "oversized")
                continue
            self.results[r.rid] = RequestResult(rid=r.rid, arrival=r.arrival)
            accepted.append(r)
        self.pending.extend(accepted)
        self.pending.sort(key=lambda r: (r.arrival, r.rid))

    def _admit(self) -> None:
        while self.pending and self.pending[0].arrival <= self.clock:
            r = self.pending.pop(0)
            self.queue.append(r)
            self.trace.append(("admit", self.clock, r.rid))

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    # -- prefill (batch 1, the request's real prompt length) ------------- #
    def _start(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            r = self.queue.popleft()
            prompt_np = np.asarray(r.prompt, np.int32)
            prompt = torch.as_tensor(prompt_np, dtype=torch.long,
                                     device=self.device)[None]
            with engine.op_scope("serve_prefill"):
                logits, single = transformer.prefill(
                    self.params, self.cfg, {"inputs": prompt}, self.scfg.max_len)
            kv_cache.insert_slot(self.cache, single, slot)
            tok = int(np.argmax(_host_logits(logits[0])))
            self.clock += self.scfg.prefill_ticks
            res = self.results[r.rid]
            res.first_token_tick = self.clock
            res.tokens.append(tok)
            self.slots[slot] = _Slot(rid=r.rid, pos=len(prompt_np), emitted=1,
                                     fed=0, max_new=r.max_new_tokens,
                                     last_token=tok)
            self.trace.append(("prefill", self.clock, r.rid, slot, len(prompt_np)))
            self._admit()  # the clock moved; later arrivals may be due now

    # -- decode (the whole slot pool, ragged over per-slot KV lengths) --- #
    def _active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _decode_once(self) -> None:
        n = self.scfg.n_slots
        toks = np.zeros((n, 1), np.int64)
        pos = np.zeros((n,), np.int64)
        sizes = np.zeros((n,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                # parked: rewrites a row its next occupant overwrites anyway
                pos[i] = self.scfg.max_len - 1
                continue
            toks[i, 0] = s.last_token
            pos[i] = s.pos
            sizes[i] = s.pos + 1  # valid kv rows after this step's append
        with engine.op_scope("serve_decode"):
            logits, self.cache = transformer.serve_step(
                self.params, self.cfg,
                torch.as_tensor(toks, device=self.device), self.cache,
                torch.as_tensor(pos, device=self.device), kv_group_sizes=sizes)
        logits = _host_logits(logits)
        self.clock += 1.0
        self.decode_steps += 1
        for i, s in enumerate(self.slots):
            if s is None:
                continue
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
                self.trace.append(("finish", self.clock, s.rid, i))
                self.slots[i] = None

    # -- drive ----------------------------------------------------------- #
    def step(self) -> bool:
        """Advance one scheduler event; False once fully drained."""
        self._admit()
        self._start()
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
