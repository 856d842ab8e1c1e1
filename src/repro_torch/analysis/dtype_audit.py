"""Precision-policy conformance over a recorded run.

Counterpart of ``repro.analysis.dtype_audit``: storage dtypes (FP8 /
FP16) widen to the policy's ``compute_dtype`` and accumulate in
``accum_dtype``, never beyond.  Three things can break that silently,
and all three show in what :class:`~repro_torch.analysis.aten_audit.
AtenRecorder` records of one run:

* **fp64 anywhere** — no policy declares float64; any float64 output is
  a promotion (a NumPy default, a Python float into a ``torch.tensor``)
  that doubles the bytes on its path;
* **fp32 materialisation off the accumulation path** — a contraction
  producing float32 conforms only where some engine policy in the same
  run's events declares float32 (the router, the scores and the sweep
  policies do);
* **FP8 operands reaching a contraction** — the engine widens FP8
  storage before an aten contraction (``"aten"``) or inside its kernels
  (``"hopper"``, ``"operand_dtypes"``), so a recorded contraction with an
  FP8 operand always contracted raw storage.

Findings carry the op, the dtypes and the innermost ``repro_torch``
source frame; the audit CLI (:mod:`repro_torch.analysis.audit`) ratchets
them against the manifest.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import torch

from repro_torch.analysis.aten_audit import AtenTrace
from repro_torch.core import engine
from repro_torch.core import precision as prec

__all__ = ["DtypeFinding", "declared_dtypes", "audit_dtypes",
           "check_shipped_policies"]

_FP8 = prec.FP8_FORMATS
_SLOTS = ("compute_dtype", "accum_dtype", "out_dtype", "x_storage_dtype",
          "w_storage_dtype", "grad_storage_dtype")


@dataclasses.dataclass(frozen=True)
class DtypeFinding:
    kind: str        # "fp64" | "fp32_materialization" | "fp8_uncovered"
    detail: str
    where: str       # the source frame, "repro_torch/<file>:<line> (<fn>)"
    count: int = 1

    @property
    def key(self) -> str:
        """Manifest identity: kind, detail and the frame's file and
        function (the line may drift)."""
        file, _, rest = self.where.partition(":")
        fn = rest.partition(" ")[2]
        return f"[{self.kind}] {self.detail} (at {file}{' ' + fn if fn else ''})"

    def describe(self) -> str:
        return f"[{self.kind}] {self.detail} x{self.count} (at {self.where})"


def declared_dtypes(events: Sequence[engine.GemmEvent]) -> Set[str]:
    """Every dtype some engine policy in the events declares: compute,
    accumulator, output and each operand's storage."""
    return {prec.dtype_name(getattr(ev.spec.policy, f))
            for ev in events for f in _SLOTS}


def audit_dtypes(trace: AtenTrace, extra_allowed: Sequence[str] = ()
                 ) -> List[DtypeFinding]:
    """The three checks over one recorded run.  ``extra_allowed`` admits
    float32 contractions in runs with no engine events (toy traces in the
    tests)."""
    allowed = declared_dtypes(trace.events) | set(extra_allowed)
    merged: Dict[Tuple[str, str, str], int] = {}

    def add(kind: str, detail: str, where: str, n: int) -> None:
        merged[(kind, detail, where)] = merged.get((kind, detail, where), 0) + n

    for (detail, where), n in trace.fp64.items():
        add("fp64", detail, where, n)
    for s in trace.sites:
        ops = f"{s.op} " + " x ".join(f"{d}{list(sh)}"
                                      for d, sh in zip(s.dtypes, s.shapes))
        if any(d in _FP8 for d in s.dtypes):
            add("fp8_uncovered", f"{ops} contracts raw FP8 storage (the "
                "engine widens it before a contraction or in its kernels)",
                s.where[0], s.count)
        elif s.out_dtype == "float32" and "float32" not in allowed:
            add("fp32_materialization", f"{ops} -> float32, but no engine "
                "policy in this run declares an f32 slot", s.where[0], s.count)
    return sorted((DtypeFinding(kind=k, detail=d, where=w, count=n)
                   for (k, d, w), n in merged.items()),
                  key=lambda f: (f.kind, f.detail, f.where))


def check_shipped_policies() -> List[str]:
    """Static invariants of every policy in :mod:`repro_torch.core.
    precision`, no run needed: no float64 slot, an accumulator no narrower
    than the compute dtype, and FP8 storage only where a registered
    backend has ``"operand_dtypes"``.  Empty when all hold."""
    problems: List[str] = []
    for name in prec.known_policies():
        p = prec.resolve(name)
        for field in _SLOTS:
            dt = getattr(p, field)
            if dt in (torch.float64, torch.complex128):
                problems.append(f"policy {name!r}: {field} is {prec.dtype_name(dt)}")
        if p.accum_dtype.itemsize < p.compute_dtype.itemsize:
            problems.append(
                f"policy {name!r}: accumulator {prec.dtype_name(p.accum_dtype)} "
                f"narrower than compute {prec.dtype_name(p.compute_dtype)}")
        if p.scaled and not any(engine.backend_supports(b, "operand_dtypes")
                                for b in engine.registered_backends()):
            problems.append(f"policy {name!r} declares FP8 storage but no "
                            f"registered backend supports 'operand_dtypes'")
    return problems
