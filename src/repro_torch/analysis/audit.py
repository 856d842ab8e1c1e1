"""Escape and dtype audit CLI: ``python -m repro_torch.analysis.audit``.

Counterpart of ``repro.analysis.audit``.  Runs the escape audit
(:mod:`repro_torch.analysis.aten_audit`) and the precision checks
(:mod:`repro_torch.analysis.dtype_audit`) over the registered entries
(:mod:`repro_torch.analysis.entries`) and holds both to the ratchet
manifest ``src/repro_torch/analysis/engine_escapes.json``.

Every entry runs under the ``"aten"`` backend on meta tensors (about a
second for all five, no card).  The card's program is audited by
``chip_smoke.py``'s audit phase through :func:`audit_entry`.

The exit status is non-zero when:

* an entry ran a contraction that neither an engine dispatch nor the
  manifest accounts for (route it through the engine);
* a manifest entry is no longer observed (stale: delete it, so the
  ratchet tightens);
* the dtype audit finds fp64, an off-policy fp32 contraction or a raw FP8
  operand beyond the manifest's ``dtype`` list, or fewer than it holds;
* a shipped precision policy violates its static invariants.

``--json PATH`` writes the whole report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import aten_audit, dtype_audit, entries
from repro_torch.core import engine

__all__ = ["DEFAULT_MANIFEST", "load_manifest", "ratchet_errors",
           "dtype_ratchet_errors", "audit_entry", "run", "main"]

DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "engine_escapes.json")


def load_manifest(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        m = json.load(fh)
    for k, empty in (("aten", {}), ("ast", []), ("dtype", [])):
        m.setdefault(k, empty)
    return m


def ratchet_errors(entry: str, result: aten_audit.AuditResult,
                   manifest: Dict[str, Any]) -> List[str]:
    """One entry's escapes against its ``aten`` section: new escapes and
    stale entries are both errors (the count only moves down, by editing
    the manifest in the same commit)."""
    known = {e["fingerprint"]: int(e.get("count", 1))
             for e in manifest.get("aten", {}).get(entry, [])}
    found: Dict[str, int] = {}
    for s in result.escapes:
        found[s.fingerprint] = found.get(s.fingerprint, 0) + s.count
    errors: List[str] = []
    for fp, n in sorted(found.items()):
        have = known.get(fp, 0)
        if n > have:
            errors.append(f"{entry}: NEW escaped contraction (+{n - have}): {fp} "
                          f"— route it through the engine")
    for fp, have in sorted(known.items()):
        if found.get(fp, 0) < have:
            errors.append(f"{entry}: STALE manifest entry ({found.get(fp, 0)}/"
                          f"{have} observed): {fp} — the escape was fixed, "
                          f"delete it from engine_escapes.json")
    return errors


def dtype_ratchet_errors(entry: str, backend: str,
                         findings: Sequence[dtype_audit.DtypeFinding],
                         manifest: Dict[str, Any]) -> List[str]:
    """One entry's dtype findings under ``backend`` against the manifest's
    ``dtype`` list, two-sided like :func:`ratchet_errors`."""
    known: Dict[str, int] = {}
    for e in manifest.get("dtype", []):
        if e["entry"] == entry and e["backend"] == backend:
            known[e["key"]] = known.get(e["key"], 0) + int(e.get("count", 1))
    found: Dict[str, int] = {}
    for f in findings:
        found[f.key] = found.get(f.key, 0) + f.count
    errors: List[str] = []
    for key, n in sorted(found.items()):
        have = known.get(key, 0)
        if n > have:
            errors.append(f"{entry}: dtype: NEW finding (+{n - have}) under "
                          f"{backend!r}: {key}")
    for key, have in sorted(known.items()):
        if found.get(key, 0) < have:
            errors.append(f"{entry}: dtype: STALE manifest entry "
                          f"({found.get(key, 0)}/{have} observed) under "
                          f"{backend!r}: {key} — delete it from "
                          f"engine_escapes.json")
    return errors


def audit_entry(name: str, backend: str = "aten", device: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build, run and audit one entry: its :class:`~aten_audit.AtenTrace`,
    :class:`~aten_audit.AuditResult` and dtype findings, and its events'
    footprint.  ``device`` defaults to meta under ``"aten"``.  Under
    ``"hopper"`` nothing reconciles: every recorded contraction is an
    escape."""
    device = device or ("meta" if backend == "aten" else "cpu")
    fn, args = entries.get_entry(name, device, overrides)
    trace = aten_audit.trace_entry(fn, args, backend)
    if backend == "aten":
        result = aten_audit.reconcile(name, trace.sites, trace.events)
    else:
        result = aten_audit.AuditResult(
            entry=name, escapes=tuple(trace.sites), unmatched_events={},
            n_sites=len(trace.sites), n_events=len(trace.events))
    return {"trace": trace, "result": result,
            "findings": dtype_audit.audit_dtypes(trace),
            "footprint": engine.dispatch_footprint(trace.events)}


def run(entry_names: Sequence[str], manifest_path: str = DEFAULT_MANIFEST,
        json_path: str = "") -> int:
    """Audit ``entry_names`` under ``"aten"`` against the manifest."""
    manifest = load_manifest(manifest_path)
    errors: List[str] = []
    report: Dict[str, Any] = {"backend": "aten", "entries": {}}
    for name in entry_names:
        a = audit_entry(name)
        result, findings = a["result"], a["findings"]
        errors += ratchet_errors(name, result, manifest)
        errors += dtype_ratchet_errors(name, "aten", findings, manifest)
        report["entries"][name] = dict(
            result.to_json(), dtype_findings=[f.describe() for f in findings],
            footprint={str(k): v for k, v in sorted(a["footprint"].items())})
        n_esc = sum(s.count for s in result.escapes)
        print(f"[audit] {name}: {result.n_sites} contraction site(s), "
              f"{result.n_events} engine event(s), footprint "
              f"{sum(a['footprint'].values())} dispatch(es), "
              f"{'clean' if not n_esc else f'{n_esc} escaped contraction(s)'}, "
              f"{len(findings)} dtype finding(s)")
        for s in result.escapes:
            print(f"[audit]   escape: {s.describe()}")
        for f in findings:
            print(f"[audit]   dtype: {f.describe()}")
    problems = dtype_audit.check_shipped_policies()
    errors += [f"policy: {p}" for p in problems]
    report["policy_problems"] = problems
    report["errors"] = errors
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"[audit] report written to {json_path}")
    if errors:
        print(f"[audit] FAIL — {len(errors)} error(s):", file=sys.stderr)
        for e in errors:
            print(f"[audit]   {e}", file=sys.stderr)
        return 1
    print("[audit] OK — every contraction is engine-accounted or "
          "manifest-covered, every dtype finding is the manifest's")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--entry", action="append", default=[],
                    choices=sorted(entries.ENTRY_POINTS),
                    help="entry to audit (repeatable; default: all)")
    ap.add_argument("--manifest", default=DEFAULT_MANIFEST,
                    help="ratchet manifest path")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the machine-readable report here")
    args = ap.parse_args(argv)
    names = args.entry or sorted(entries.ENTRY_POINTS)
    return run(names, args.manifest, args.json)


if __name__ == "__main__":
    sys.exit(main())
