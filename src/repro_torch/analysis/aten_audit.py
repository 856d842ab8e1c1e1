"""Escape audit: find contractions that bypass the engine.

Counterpart of ``repro.analysis.jaxpr_audit``.  The engine's bills (the
roofline, the cycle model, the dry run, the launch counts) are read off
its :class:`~repro_torch.core.engine.GemmEvent` stream; a contraction
that does not dispatch through :mod:`repro_torch.core.engine` is invisible
to all of them.  This module makes that checkable: run an entry point
once under :func:`engine.instrument` and a ``TorchDispatchMode``
(:class:`AtenRecorder`) that records every aten contraction reaching the
dispatcher below autograd — :data:`CONTRACTIONS`, the overloads that
``torch.matmul``, ``@``, ``einsum``, ``F.linear``, ``tensordot`` and
``F.scaled_dot_product_attention`` decompose into above the mode — and
reconcile that multiset against the events of the same run.

Reconciliation is by **dense flops**: on the ``"aten"`` backend every
non-pass dispatch issues exactly one aten contraction of
``GemmSpec.dense_flops`` (:func:`engine.dispatch_footprint`).  Sites left
after subtracting the footprint greedily are *escapes*, reported with
operand shapes, dtypes and the innermost ``repro_torch`` source frame
(where the reference reports the jaxpr path).  Autograd backward nodes,
``torch.utils.checkpoint`` recomputes and autograd's per-device thread on
the card all run below the mode, so it records them too.

On the card under ``"hopper"`` the kernels launch through ctypes and the
dispatcher never sees them: there every recorded contraction is an
escape, and what ran is read off the kernel wrappers' launch counters
(:func:`launches_implied` gives what the events imply).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import engine

__all__ = ["CONTRACTIONS", "AtenRecorder", "Site", "AuditResult", "AtenTrace",
           "trace_entry", "reconcile", "audit", "launches_implied", "source_frame"]

# (operand arg indices, flops rule) per contraction overload; "mm" is
# 2 * prod(a[:-1]) * a[-1] * b[-1] over the operands' batch-matching dims
_MM = ((0, 1), "mm")
_ADD = ((1, 2), "mm")
_SDPA = ((0, 1, 2), "sdpa")
_SDPA_BWD = ((1, 2, 3), "sdpa_bwd")
_OPS: Dict[str, Tuple[Tuple[int, ...], str]] = {
    "aten::mm": _MM, "aten::bmm": _MM, "aten::dot": _MM, "aten::vdot": _MM,
    "aten::mv": _MM, "aten::_int_mm": _MM, "aten::_scaled_mm": _MM,
    "aten::_grouped_mm": _MM, "aten::_scaled_grouped_mm": _MM,
    "aten::addmm": _ADD, "aten::addbmm": _ADD, "aten::baddbmm": _ADD,
    "aten::addmv": _ADD,
    "aten::convolution": ((0, 1), "conv"),
    "aten::convolution_backward": ((1, 2), "conv_bwd"),
    "aten::_scaled_dot_product_flash_attention": _SDPA,
    "aten::_scaled_dot_product_flash_attention_for_cpu": _SDPA,
    "aten::_scaled_dot_product_efficient_attention": _SDPA,
    "aten::_scaled_dot_product_cudnn_attention": _SDPA,
    "aten::_scaled_dot_product_fused_attention_overrideable": _SDPA,
    "aten::_flash_attention_forward": _SDPA,
    "aten::_efficient_attention_forward": _SDPA,
    "aten::_scaled_dot_product_flash_attention_backward": _SDPA_BWD,
    "aten::_scaled_dot_product_flash_attention_for_cpu_backward": _SDPA_BWD,
    "aten::_scaled_dot_product_efficient_attention_backward": _SDPA_BWD,
    "aten::_scaled_dot_product_cudnn_attention_backward": _SDPA_BWD,
    "aten::_scaled_dot_product_fused_attention_overrideable_backward": _SDPA_BWD,
    "aten::_flash_attention_backward": _SDPA_BWD,
    "aten::_efficient_attention_backward": _SDPA_BWD,
}
# every aten contraction the port must not call where the engine should:
# what the audit records and what chip_smoke.py's profiler check looks for
CONTRACTIONS: Tuple[str, ...] = tuple(_OPS)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.dirname(_PKG)
_SELF = os.path.abspath(__file__)
_IMPLICIT = torch._C.DispatchKey.CompositeImplicitAutograd
_WIDE = (torch.float64, torch.complex128)


def source_frame(skip: int = 1) -> str:
    """The innermost stack frame in the ``repro_torch`` package (this
    module excluded) as ``"repro_torch/<file>:<line> (<function>)"``;
    ``"<outside repro_torch>"`` where there is none (an autograd node
    running in autograd's device thread)."""
    f = sys._getframe(skip)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG + os.sep) and fn != _SELF:
            rel = os.path.relpath(fn, _SRC).replace(os.sep, "/")
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<outside repro_torch>"


def _flops(rule: str, shapes: Sequence[Tuple[int, ...]],
           out_shape: Tuple[int, ...]) -> int:
    if rule == "mm":
        a, b = shapes
        k = a[-1] if a else 1
        return 2 * math.prod(a[:-1]) * k * (b[-1] if len(b) >= 2 else 1)
    if rule in ("conv", "conv_bwd"):
        w = shapes[1]
        n = 2 * math.prod(out_shape) * math.prod(w[1:])
        return n if rule == "conv" else 2 * n
    q, k, v = shapes        # the forward's two GEMMs; twice that backward
    n = 2 * math.prod(q[:-1]) * k[-2] * (q[-1] + v[-1])
    return n if rule == "sdpa" else 2 * n


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Site:
    """One aten contraction overload at one operand signature, merged over
    the run: ``count`` executions, the distinct source frames that issued
    it in ``where``."""

    op: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    out_dtype: str
    flops: int
    count: int
    where: Tuple[str, ...]

    @property
    def fingerprint(self) -> str:
        """Manifest identity: overload, operand dtypes and shapes, output
        dtype — everything but multiplicity and source frame."""
        ops = "·".join(f"{d}{list(s)}" for d, s in zip(self.dtypes, self.shapes))
        return f"{self.op} {ops}->{self.out_dtype}"

    def describe(self) -> str:
        return (f"{self.fingerprint} x{self.count} [{self.flops} flops each, "
                f"at {'; '.join(self.where)}]")


class AtenRecorder(TorchDispatchMode):
    """Records, below autograd, every :data:`CONTRACTIONS` call and every
    op with a float64 output (for :mod:`repro_torch.analysis.dtype_audit`):
    ``sites`` (merged :class:`Site` s) and ``fp64`` (``(op, where) ->
    count``)."""

    def __init__(self):
        super().__init__()
        self._sites: Dict[Tuple, List[Any]] = {}
        self.fp64: Dict[Tuple[str, str], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _IMPLICIT):
            # under inference mode (serving) a composite op such as matmul
            # reaches the mode whole: decompose it here, as autograd does
            # elsewhere, so one program records one set of overloads
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func._schema.name
        spec = _OPS.get(name)
        if spec is not None:
            idx, rule = spec
            ts = [args[i] for i in idx]
            res = out[0] if isinstance(out, (tuple, list)) else out
            shapes = tuple(tuple(t.shape) for t in ts)
            key = (name, shapes, tuple(_dt(t) for t in ts), _dt(res))
            rec = self._sites.setdefault(
                key, [_flops(rule, shapes, tuple(res.shape)), 0, []])
            rec[1] += 1
            where = source_frame(2)
            if where not in rec[2]:
                rec[2].append(where)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        wide = [t for t in outs if isinstance(t, torch.Tensor) and t.dtype in _WIDE]
        if wide:
            k = (f"{name} -> {_dt(wide[0])}", source_frame(2))
            self.fp64[k] = self.fp64.get(k, 0) + 1
        return out

    @property
    def sites(self) -> List[Site]:
        out = [Site(op=k[0], shapes=k[1], dtypes=k[2], out_dtype=k[3], flops=f,
                    count=n, where=tuple(w)) for k, (f, n, w) in self._sites.items()]
        return sorted(out, key=lambda s: (-s.flops, s.fingerprint))


@dataclasses.dataclass
class AtenTrace:
    """One run of an entry: the recorded contractions, the float64
    outputs, the engine events of the same run, and what the run
    returned."""

    sites: List[Site]
    fp64: Dict[Tuple[str, str], int]
    events: List[engine.GemmEvent]
    out: Any = None


def trace_entry(fn: Callable, args: Sequence[Any], backend: str = "aten"
                ) -> AtenTrace:
    """Run ``fn(*args)`` once with ``backend`` pinned, collecting the
    engine's events and the recorder's contractions of the same run."""
    rec = AtenRecorder()
    with engine.use_backend(backend), engine.instrument() as events, rec:
        out = fn(*args)
    return AtenTrace(sites=rec.sites, fp64=dict(rec.fp64), events=list(events),
                     out=out)


@dataclasses.dataclass(frozen=True)
class AuditResult:
    """Outcome of one entry's reconciliation."""

    entry: str
    escapes: Tuple[Site, ...]          # contractions no dispatch accounts for
    unmatched_events: Dict[int, int]   # dense_flops -> dispatch surplus
    n_sites: int                       # distinct contraction sites recorded
    n_events: int                      # engine events observed

    @property
    def clean(self) -> bool:
        return not self.escapes

    def to_json(self) -> Dict[str, Any]:
        return {
            "entry": self.entry, "n_sites": self.n_sites,
            "n_engine_events": self.n_events,
            "escapes": [{"fingerprint": s.fingerprint, "flops": s.flops,
                         "count": s.count, "where": list(s.where)}
                        for s in self.escapes],
            "unmatched_engine_dispatches": {
                str(f): n for f, n in sorted(self.unmatched_events.items())},
        }


def reconcile(entry: str, sites: Sequence[Site],
              events: Sequence[engine.GemmEvent]) -> AuditResult:
    """Subtract the engine's dispatch footprint from the recorded sites,
    greedily by dense flops (the reference's ``jaxpr_audit.reconcile``):
    distinct contractions of equal dense flops are fungible."""
    foot = engine.dispatch_footprint(events)
    escapes: List[Site] = []
    for site in sites:
        if site.flops <= 0:
            continue   # an empty dimension: no MACs to bill
        avail = foot.get(site.flops, 0)
        take = min(avail, site.count)
        foot[site.flops] = avail - take
        if take < site.count:
            escapes.append(dataclasses.replace(site, count=site.count - take))
    return AuditResult(entry=entry, escapes=tuple(escapes),
                       unmatched_events={f: n for f, n in foot.items() if n > 0},
                       n_sites=len(sites), n_events=len(events))


def audit(entry: str, fn: Callable, args: Sequence[Any],
          backend: str = "aten") -> AuditResult:
    """Trace and reconcile in one call."""
    tr = trace_entry(fn, args, backend)
    return reconcile(entry, tr.sites, tr.events)


def launches_implied(events: Sequence[engine.GemmEvent]) -> Dict[str, int]:
    """The kernel launches an event stream implies on the card under
    ``"hopper"``: one GEMM launch (kernel 1 or 2) per GEMM dispatch with a
    non-empty contraction — a launch that splits its reduction is still
    one launch, as the wrappers count it — one flash launch per
    ``attention_score`` event and one sweep per ``linear_attention_score``
    event (their companion events ride on the same launch)."""
    out = {"gemm": 0, "flash_attention": 0, "chunked_linear_attention": 0}
    for ev in events:
        op = ev.spec.op.rsplit("/", 1)[-1]
        if op.startswith("linear_attention_"):
            out["chunked_linear_attention"] += op == "linear_attention_score"
        elif op.startswith("attention_"):
            out["flash_attention"] += op == "attention_score"
        elif ev.spec.dense_flops > 0:
            out["gemm"] += 1
    return out
