"""Static analysis of the engine's instrumentation contract.

Counterpart of ``repro.analysis``, over the port's own programs:

* :mod:`repro_torch.analysis.aten_audit` — run an entry point once under
  ``engine.instrument`` and a dispatch mode that records every aten
  contraction below autograd, and reconcile that multiset against the
  same run's ``GemmEvent`` s; contractions no engine dispatch accounts
  for are *escapes*;
* :mod:`repro_torch.analysis.dtype_audit` — precision conformance over
  the same run: fp64 anywhere, fp32 contractions off the declared
  policies, FP8 operands reaching a contraction;
* :mod:`repro_torch.analysis.lint` — AST rules over ``src/repro_torch``
  (no raw GEMMs in ``models/``, ``os._exit`` confinement, frozen
  ``GemmSpec`` s, no module-level event collectors) and the shipped
  artifacts (baselines, autotune caches, the manifest);
* :mod:`repro_torch.analysis.contract` — the backend registry's contract
  checks, runnable on CPU and CUDA tensors.

Known findings live in the ratchet manifest ``engine_escapes.json`` beside
this file; its lists only shrink.  CLIs: ``python -m
repro_torch.analysis.audit`` and ``python -m repro_torch.analysis.lint``.
"""

from repro_torch.analysis.aten_audit import (CONTRACTIONS, AtenRecorder,
                                             AuditResult, Site, reconcile,
                                             trace_entry)
from repro_torch.analysis.dtype_audit import DtypeFinding, audit_dtypes
from repro_torch.analysis.entries import ENTRY_POINTS, get_entry

__all__ = [
    "AtenRecorder", "AuditResult", "CONTRACTIONS", "DtypeFinding",
    "ENTRY_POINTS", "Site", "audit_dtypes", "get_entry", "reconcile",
    "trace_entry",
]
