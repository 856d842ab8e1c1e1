"""The RedMulE Engine in PyTorch: GEMM specs, a backend registry, events.

Counterpart of ``repro.core.engine``.  Every contraction the models run
goes through this module:

* :class:`GemmSpec` — a frozen description of one contraction (tag,
  M/N/K, batch, groups, policy, tile, layout, ragged ``valid_rows``) with
  the reference's flop and byte formulas;
* a **backend registry** with capability flags.  One backend is
  registered, ``"hopper"`` — the hand-written CUDA kernels on a CUDA
  tensor, their plain PyTorch versions on a CPU tensor — with the
  capabilities ``fused_epilogue`` (bias + activation in the kernel's
  store), ``tiled`` (it runs ``spec.tile``), ``layouts`` (nn / nt / tn
  storage read in place), ``fused_bwd_epilogue`` (act' applied to the dZ
  tile on load, the bias gradient accumulated in the dW pass) and
  ``attention`` (the flash and the chunked linear-attention sweeps).  It
  plays the role of the reference's ``"pallas"`` and ``"interpret"``
  together and is the default;
* the ops :func:`matmul`, :func:`linear` (fused epilogue),
  :func:`grouped_matmul` (ragged groups), :func:`einsum2d` (two-operand
  contractions), :func:`attention` (the flash kernel path, its backward
  through the reference composition) and
  :func:`linear_attention` (the chunked state sweep);
* **the backward**: ``matmul``, ``einsum2d`` and epilogue-free ``linear``
  run through one ``torch.autograd.Function`` whose backward dispatches
  dX = dZ·Wᵀ ("nt") and dW = Xᵀ·dZ ("tn") through the same registry as
  ``matmul_dx`` / ``matmul_dw`` events (the reference's
  ``_gemm_call`` / ``_gemm_bwd``): residuals saved in the dispatch
  storage, grads held in the accumulator dtype until one cast to the
  primal operand's dtype.  ``linear`` with a bias or activation has its own
  Function (the reference's ``_linear_call``): on a
  ``fused_bwd_epilogue`` backend with a 2D weight its backward is one
  pass — the dX dispatch carries ``deriv``, the dW dispatch ``deriv`` and
  ``bias_grad`` — and elsewhere the two-pass fallback bills its
  standalone multiply and bias reduction as ``linear_dact`` /
  ``linear_dbias`` pass events.  ``linear_attention``'s backward recomputes through the
  reference composition of :func:`einsum2d` / :func:`matmul` calls on the
  same backend and differentiates it, so its GEMMs are fp32 dispatches of
  the GEMM kernels (the reference's ``_linear_attention_call_bwd``);
* **launch geometry** — every GEMM dispatch resolves its tile and split
  as the explicit ``tile`` > the autotune cache (``core/autotune.py``,
  keyed on the launch's own dims and batch) > the heuristic, the sweeps
  their block pair / chunk likewise, and the event carries what runs;
* **instrumentation** — every dispatch emits a :class:`GemmEvent` into the
  thread-local :func:`instrument` collectors; :func:`repeat` multiplies the
  count, :func:`op_scope` prefixes the op name, :func:`paused` suppresses
  emission, and events emitted while a remat region
  (:func:`checkpoint`) recomputes are tagged ``recompute=True``.  Autograd may run a backward in
  another thread (one per CUDA device), so each autograd node captures the
  emission context of its forward and restores it around its backward.

PyTorch runs eagerly, so an event is emitted each time an op runs (the
reference emits at trace time, once per scanned body with a multiplicity).
Under an fp16 accumulator (``paper_fp16``, ``mixed_fp8_e4m3``) every GEMM
dispatch carries the reference's reduction block (``GemmSpec.accum_block``,
from :func:`repro_torch.core.tiling.accum_block`), after which the kernel
re-rounds its accumulator.

**FP8 storage** (``mixed_fp8_e4m3`` / ``mixed_fp8_e5m2``, the reference's
scaled-dispatch contract): the engine quantizes each operand per tensor
(``q = v / amax``, :func:`repro_torch.core.precision.quantize_fp8`) right
before its dispatch, the kernel widens the FP8 tiles to fp16 on load, and
the engine multiplies the scale product back into the result — in fp32,
as JAX promotes an fp16 result times the reference's fp32 scale — before
the bias and activation, so a scaled ``linear`` never fuses its epilogue
and bills the post-op pass as a ``linear_postep`` event.  The residuals
stay in FP8 with their scales; the backward quantizes the cotangent to
the grad storage (E5M2) once and runs dX (grad storage in the x slot) and
dW (in the w slot).  Scales are device tensors: nothing on the dispatch
path syncs with the host.  Under ``torch.inference_mode`` (serving) an
operand made outside it and not requiring grad — a weight — keeps its
quantization until the tensor changes (:func:`_frozen_fp8`): the same
``(q, s)`` the dispatch would compute, once instead of every step.  ``attention`` casts q / k / v to the compute
dtype and runs flash without quantizing, as the reference does.
``attention``'s backward recomputes through the reference composition of
two :func:`einsum2d` dispatches and differentiates it (the reference's
``_attention_call_bwd``); the composition also serves operands the flash
kernel does not take.  ``grouped_matmul`` differentiates through the same
Function as ``matmul``: dX per group, dW one launch per group over all the
rows of its lead dims.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import autotune
from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec
from repro_torch.core import tiling

__all__ = [
    "GemmSpec", "GemmEvent", "Engine", "BackendSpec",
    "register_backend", "unregister_backend", "registered_backends",
    "get_backend", "backend_supports",
    "default_backend", "set_default_backend", "use_backend",
    "matmul", "linear", "grouped_matmul", "einsum2d", "attention",
    "linear_attention", "scores_policy", "is_backward_op", "is_pass_op",
    "instrument", "repeat", "op_scope", "paused", "checkpoint",
    "total_flops", "total_bytes", "summarize", "DEFAULT_ENGINE",
    "REMAT_POLICIES",
]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


def _itemsize(d) -> int:
    return prec.as_dtype(d).itemsize


# --------------------------------------------------------------------- #
# Spec / event
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """One contraction, fully described (the reference's fields).
    ``m, n, k`` keep their logical meaning in every ``layout``;
    ``valid_rows`` replaces ``groups * <ragged_dim>`` in ragged grouped
    GEMMs: ``ragged_dim == "m"`` on the forward and its dX, ``"n"`` (the
    contraction rows) on its dW; ``io_bytes`` carries the exact
    traffic of an attention sweep.  On a backward dispatch
    ``grad_epilogue`` names the activation whose derivative scales dZ,
    ``grad_mode`` how it is recovered ("output" or "preact"),
    ``fused_bwd`` that the kernel applies it on load and
    ``fused_bias_grad`` that the dW pass also accumulates db.
    ``x_dtype`` / ``w_dtype`` name the storage dtype each operand slot is
    dispatched in (None: the compute dtype) and ``scaled`` that per-tensor
    FP8 scales are applied around the dispatch.  ``accum_block`` is the
    faithful accumulator's rounding block (the reference's ``tile.bn``;
    None under fp32 accumulation)."""

    op: str
    tag: str
    m: int
    n: int
    k: int
    batch: int = 1
    groups: int = 1
    policy: prec.Policy = prec.TPU_BF16
    tile: Optional[tiling.TileConfig] = None
    epilogue: Optional[str] = None
    w_shared: bool = False
    layout: str = "nn"
    valid_rows: Optional[int] = None
    ragged_dim: str = "m"
    io_bytes: Optional[int] = None
    grad_epilogue: Optional[str] = None
    grad_mode: Optional[str] = None
    fused_bwd: bool = False
    fused_bias_grad: bool = False
    x_dtype: Optional[str] = None
    w_dtype: Optional[str] = None
    scaled: bool = False
    accum_block: Optional[int] = None

    def __post_init__(self):
        if self.layout not in ("nn", "nt", "tn"):
            raise ValueError(
                f"GemmSpec.layout = {self.layout!r}; known: ('nn', 'nt', 'tn')")
        if self.ragged_dim not in ("m", "n"):
            raise ValueError(
                f"GemmSpec.ragged_dim = {self.ragged_dim!r}; known: ('m', 'n')")
        for f in ("x_dtype", "w_dtype"):
            prec._validate_dtype("GemmSpec", f, getattr(self, f), optional=True)

    @property
    def flops(self) -> int:
        """2 * B * G * M * N * K; ragged GEMMs bill ``valid_rows`` instead of
        ``G * <ragged_dim>``; pass events carry no MACs."""
        if is_pass_op(self.op):
            return 0
        if self.valid_rows is None:
            return 2 * self.batch * self.groups * self.m * self.n * self.k
        if self.ragged_dim == "m":
            return 2 * self.batch * self.valid_rows * self.n * self.k
        return 2 * self.batch * self.m * self.valid_rows * self.k

    @property
    def bytes(self) -> int:
        """Operand + result bytes of one execution in device memory
        (``engine.py:320-396`` of the reference): a shared weight is read
        once per group, ragged GEMMs bill the valid rows of the ragged
        operand(s) only (and, ragged in M, of the output), each operand
        slot at its storage width (``x_dtype`` / ``w_dtype``: an FP8
        operand pays one byte per element) and the result at the output
        width.  A ``*_dact`` pass reads dZ and the residual and writes ds;
        a ``*_dbias`` pass re-reads the cotangent and writes the
        accumulator-dtype row; a ``*_postep`` pass (the scaled forward's
        post-op epilogue) round-trips the stored result and reads the bias
        row; a fused backward adds its streamed derivative operand
        (shadowing dZ: the x slot on dX, the w slot on dW, at the compute
        width) and its db row."""
        if self.io_bytes is not None:
            return self.io_bytes
        cb = _itemsize(self.policy.compute_dtype)
        ob = _itemsize(self.policy.out_dtype)
        ab = _itemsize(self.policy.accum_dtype)
        xb = _itemsize(self.x_dtype) if self.x_dtype else cb
        wb = _itemsize(self.w_dtype) if self.w_dtype else cb
        bg = self.batch * self.groups
        if self.op.endswith("_dact"):
            return 3 * bg * self.m * self.k * cb
        if self.op.endswith("_dbias"):
            return bg * self.m * self.k * cb + self.k * ab
        if self.op.endswith("_postep"):
            return 2 * bg * self.m * self.k * ob + self.k * ab
        if self.valid_rows is None:
            x_elems = bg * self.m * self.n
            z_elems = bg * self.m * self.k
            w_elems = (self.groups if self.w_shared else bg) * self.n * self.k
        elif self.ragged_dim == "m":
            x_elems = self.batch * self.valid_rows * self.n
            z_elems = self.batch * self.valid_rows * self.k
            w_elems = (self.groups if self.w_shared else bg) * self.n * self.k
        else:  # ragged contraction rows (the grouped dW dispatch)
            x_elems = self.batch * self.m * self.valid_rows
            z_elems = bg * self.m * self.k
            w_elems = (self.groups * self.n if self.w_shared
                       else self.batch * self.valid_rows) * self.k
        total = x_elems * xb + z_elems * ob + w_elems * wb
        if self.fused_bwd and self.grad_epilogue is not None:
            total += (x_elems if self.op.endswith("_dx") else w_elems) * cb
        if self.fused_bias_grad:
            total += self.k * ab
        return total


@dataclasses.dataclass(frozen=True)
class GemmEvent:
    """One engine dispatch as observed by :func:`instrument`; ``count`` is
    the :func:`repeat` multiplicity at emission (on a backward dispatch:
    at the forward's emission); ``recompute`` marks a forward dispatch that
    re-ran while a remat region recomputed during the backward."""

    spec: GemmSpec
    backend: str
    count: int = 1
    recompute: bool = False

    @property
    def flops(self) -> int:
        return self.spec.flops

    @property
    def bytes(self) -> int:
        return self.spec.bytes

    @property
    def total_flops(self) -> int:
        return self.spec.flops * self.count

    @property
    def total_bytes(self) -> int:
        return self.spec.bytes * self.count


def is_backward_op(op: str) -> bool:
    """True for the ops the backward emits (``*_dx`` / ``*_dw`` dispatches
    and the two-pass fallback's ``*_dact`` / ``*_dbias`` pass events);
    the single source of the fwd / bwd split."""
    return op.endswith(("_dx", "_dw", "_dact", "_dbias"))


def is_pass_op(op: str) -> bool:
    """True for the non-GEMM pass events: the two-pass backward's
    standalone ``ds = dZ * act'`` multiply (``*_dact``) and separate
    bias-grad reduction (``*_dbias``), and the scaled forward's post-op
    epilogue (``*_postep``, a forward event) — device bytes, no MACs."""
    return op.endswith(("_dact", "_dbias", "_postep"))


def total_flops(events: Sequence[GemmEvent]) -> int:
    return sum(ev.total_flops for ev in events)


def total_bytes(events: Sequence[GemmEvent]) -> int:
    return sum(ev.total_bytes for ev in events)


def summarize(events: Sequence[GemmEvent]) -> Dict[str, Dict[str, float]]:
    """Per-op totals plus a grand total (for CLI printouts)."""
    out: Dict[str, Dict[str, float]] = {}
    for ev in events:
        d = out.setdefault(ev.spec.op, {"calls": 0, "flops": 0, "bytes": 0})
        d["calls"] += ev.count
        d["flops"] += ev.total_flops
        d["bytes"] += ev.total_bytes
    out["total"] = {"calls": sum(d["calls"] for d in out.values()),
                    "flops": total_flops(events), "bytes": total_bytes(events)}
    return out


# --------------------------------------------------------------------- #
# Backend registry
# --------------------------------------------------------------------- #
_CAPABILITIES = frozenset({"fused_epilogue", "tiled", "layouts",
                           "fused_bwd_epilogue", "operand_dtypes", "attention"})


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A registered backend: ``fn(x, w, *, spec) -> tensor``.

    ``fn`` receives operands in ``spec.policy.compute_dtype``, stored
    as ``spec.layout`` names when the backend declares ``"layouts"`` (else
    always "nn"), with ``x (..., M, N)`` and ``w (N, K)`` or broadcast-
    compatible ``(..., N, K)``.  Capabilities, as in the reference:
    ``"fused_epilogue"`` — ``fn`` also takes ``bias`` (an accum-dtype
    ``(K,)`` row) and ``fuse_epilogue`` and applies both before its single
    store; ``"tiled"`` — ``fn`` runs ``spec.tile``;
    ``"fused_bwd_epilogue"`` (requires ``"layouts"``) — ``fn`` also takes
    ``deriv`` (stored like the dZ operand, scaled by ``act'`` per
    ``spec.grad_epilogue`` / ``spec.grad_mode`` on load) and ``bias_grad``
    (on the "tn" dW dispatch: return ``(dW, db)``); ``"attention"`` —
    ``attention_fn("attention", (q, k, v), **params)`` runs the flash sweep
    on ``(BH, S, D)`` / ``(BH_kv, T, D)`` operands; ``"operand_dtypes"`` —
    ``fn`` takes operands in their storage dtype (FP8 under the mixed
    policies, already quantized; ``spec.x_dtype`` / ``spec.w_dtype`` name
    it) and widens them on load."""

    name: str
    fn: Callable[..., torch.Tensor]
    available: Union[bool, Callable[[], bool]] = True
    description: str = ""
    capabilities: frozenset = frozenset()
    attention_fn: Optional[Callable[..., Any]] = None

    def is_available(self) -> bool:
        a = self.available
        return bool(a()) if callable(a) else bool(a)

    def supports(self, capability: str) -> bool:
        return capability in self.capabilities


_REGISTRY: Dict[str, BackendSpec] = {}


def register_backend(name: str, fn: Callable[..., torch.Tensor], *,
                     available: Union[bool, Callable[[], bool]] = True,
                     description: str = "", capabilities=(),
                     attention_fn: Optional[Callable[..., Any]] = None
                     ) -> BackendSpec:
    """Register (or replace) a GEMM backend under ``name``."""
    if not name or not isinstance(name, str):
        raise ValueError(f"backend name must be a non-empty string, got {name!r}")
    caps = frozenset(capabilities)
    unknown = caps - _CAPABILITIES
    if unknown:
        raise ValueError(f"unknown backend capabilities: {sorted(unknown)}")
    if "fused_bwd_epilogue" in caps and "layouts" not in caps:
        raise ValueError(f"backend {name!r}: 'fused_bwd_epilogue' requires "
                         "'layouts'")
    if "attention" in caps and attention_fn is None:
        raise ValueError(f"backend {name!r} declares the 'attention' "
                         "capability but provides no attention_fn")
    spec = BackendSpec(name=name, fn=fn, available=available,
                       description=description, capabilities=caps,
                       attention_fn=attention_fn)
    _REGISTRY[name] = spec
    return spec


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def registered_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{registered_backends()}") from e


def backend_supports(name: str, capability: str) -> bool:
    return get_backend(name).supports(capability)


# --------------------------------------------------------------------- #
# Thread-local state: backend override, instrumentation, repeat, scope
# --------------------------------------------------------------------- #
_state = threading.local()
_DEFAULT = "hopper"


def default_backend() -> str:
    """The thread-local override, else ``"hopper"``."""
    b = getattr(_state, "backend", None)
    return _DEFAULT if b is None else b


def set_default_backend(backend: Optional[str]) -> None:
    if backend is not None:
        get_backend(backend)
    _state.backend = backend


@contextlib.contextmanager
def use_backend(backend: str):
    """Thread-locally pin the default backend within the context."""
    old = getattr(_state, "backend", None)
    set_default_backend(backend)
    try:
        yield
    finally:
        set_default_backend(old)


def _collectors() -> List[List[GemmEvent]]:
    c = getattr(_state, "collectors", None)
    if c is None:
        c = _state.collectors = []
    return c


@contextlib.contextmanager
def instrument() -> Iterator[List[GemmEvent]]:
    """Collect every engine dispatch run in this thread (nested collectors
    each see all events)."""
    events: List[GemmEvent] = []
    stack = _collectors()
    stack.append(events)
    try:
        yield events
    finally:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is events:
                del stack[i]
                break


@contextlib.contextmanager
def repeat(n: int):
    """Multiply the ``count`` of events emitted in the context by ``n``
    (nesting multiplies)."""
    stack = getattr(_state, "repeat", None)
    if stack is None:
        stack = _state.repeat = []
    stack.append(int(n))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def op_scope(label: str):
    """Prefix the op of every event emitted in the context with ``label/``
    (nesting joins with "/", outermost first)."""
    prev = getattr(_state, "op_scope", None)
    _state.op_scope = label if prev is None else f"{prev}/{label}"
    try:
        yield
    finally:
        _state.op_scope = prev


@contextlib.contextmanager
def paused():
    """Suppress event emission within the context (shape probes and oracle
    runs that would otherwise double-count dispatches)."""
    prev = getattr(_state, "paused", False)
    _state.paused = True
    try:
        yield
    finally:
        _state.paused = prev


def _repeat_multiplier() -> int:
    return math.prod(getattr(_state, "repeat", None) or [1])


@dataclasses.dataclass(frozen=True)
class _EmitContext:
    """The emission state of one thread at one moment: collectors (the
    lists themselves), op scope, paused flag, repeat multiplier and the
    backend override (so a remat recompute in the autograd thread runs the
    forward's backend)."""

    collectors: Tuple[List[GemmEvent], ...]
    op_scope: Optional[str]
    paused: bool
    count: int
    backend: Optional[str]


def _capture() -> _EmitContext:
    return _EmitContext(collectors=tuple(_collectors()),
                        op_scope=getattr(_state, "op_scope", None),
                        paused=getattr(_state, "paused", False),
                        count=_repeat_multiplier(),
                        backend=getattr(_state, "backend", None))


@contextlib.contextmanager
def _restored(ctx: _EmitContext, *, recompute: bool = False):
    """Re-enter a captured emission context in the current thread.

    A backward (``recompute=False``) runs with no repeat multiplier — its
    dispatches pass the count captured at the forward, as the reference's
    VJP rules do; a remat recompute (``recompute=True``) re-enters the
    forward's multiplier and tags its events."""
    names = ("collectors", "op_scope", "paused", "repeat", "recompute", "backend")
    prev = {n: getattr(_state, n, None) for n in names}
    _state.backend = ctx.backend
    _state.collectors = list(ctx.collectors)
    _state.op_scope = ctx.op_scope
    _state.paused = ctx.paused
    _state.repeat = [ctx.count] if recompute else []
    _state.recompute = recompute
    try:
        yield
    finally:
        for n, v in prev.items():
            setattr(_state, n, v)


REMAT_POLICIES = ("full", "dots")


def checkpoint(fn: Callable[..., Any], *args, policy: str = "full"):
    """``fn(*args)`` as a remat region (``torch.utils.checkpoint``,
    non-reentrant): its activations are not kept, and the backward re-runs
    ``fn``.  The re-run emits its events in the emission context of the
    first run, tagged ``recompute=True`` (the reference detects its
    ``jax.checkpoint`` re-traces the same way, ``engine.py:85-91``), so a
    remat forward is not billed as new forward work.

    ``policy="dots"`` is JAX's ``dots_with_no_batch_dims_saveable``: the
    first run keeps, in order, the output of every dispatch with no batch
    dimension (:func:`_no_batch_dims`: ``matmul`` / ``linear`` on a 2D
    weight, an ``einsum2d`` with no batch labels), and the re-run hands
    those back instead of launching again — it emits no event for them —
    while every other dispatch (batched, grouped, attention and sweep),
    norm and activation re-runs.  The saved outputs belong to this region
    (its closure), so nested regions and repeated calls keep their own."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r}; known: {REMAT_POLICIES}")
    ctx = _capture()
    runs = [0]
    dots: Optional[List[torch.Tensor]] = [] if policy == "dots" else None

    def body(*a):
        runs[0] += 1
        prev = getattr(_state, "dots", None)
        try:
            if runs[0] == 1:
                _state.dots = None if dots is None else ("save", dots)
                return fn(*a)
            with _restored(ctx, recompute=True):
                _state.dots = None if dots is None else ("replay", iter(dots))
                return fn(*a)
        finally:
            _state.dots = prev

    return torch_checkpoint(body, *args, use_reentrant=False)


def _no_batch_dims(spec: GemmSpec) -> bool:
    """A dispatch whose contraction has no batch dimension (one shared 2D
    weight, no groups): what ``dots_with_no_batch_dims_saveable`` saves."""
    return spec.w_shared and spec.groups == 1


def _saved_dot(spec: GemmSpec) -> Optional[torch.Tensor]:
    """Inside a "dots" region's re-run, the first run's output of this
    no-batch dispatch (next in order); None where the dispatch runs."""
    d = getattr(_state, "dots", None)
    if d is None or d[0] != "replay" or not _no_batch_dims(spec):
        return None
    return next(d[1])


def _keep_dot(spec: GemmSpec, z: torch.Tensor) -> torch.Tensor:
    """Inside a "dots" region's first run, keep a no-batch dispatch's
    output for the re-run; returns ``z``."""
    d = getattr(_state, "dots", None)
    if d is not None and d[0] == "save" and _no_batch_dims(spec):
        d[1].append(z)
    return z


def _emit(spec: GemmSpec, backend: str, count: Optional[int] = None) -> None:
    """Append one event to every active collector; ``count`` overrides the
    live :func:`repeat` multiplier (backward dispatches pass the forward's)."""
    stack = _collectors()
    if not stack or getattr(_state, "paused", False):
        return
    scope = getattr(_state, "op_scope", None)
    if scope is not None:
        spec = dataclasses.replace(spec, op=f"{scope}/{spec.op}")
    ev = GemmEvent(spec=spec, backend=backend,
                   count=_repeat_multiplier() if count is None else count,
                   recompute=bool(getattr(_state, "recompute", False)))
    for events in stack:
        events.append(ev)


# --------------------------------------------------------------------- #
# The "hopper" backend
# --------------------------------------------------------------------- #
def _hopper_fn(x: torch.Tensor, w: torch.Tensor, *, spec: GemmSpec,
               bias: Optional[torch.Tensor] = None,
               fuse_epilogue: bool = False,
               deriv: Optional[torch.Tensor] = None,
               bias_grad: bool = False):
    """The RedMulE kernels (plain versions for CPU tensors).

    A 2D weight collapses the leading dims of x into rows and runs the 2D
    kernel; anything else runs the batched kernel, whose broadcast batch
    strides read a shared operand in place.  ``deriv`` / ``bias_grad`` run
    the fused backward epilogue on the 2D kernel (``(dW, db)`` with
    ``bias_grad``)."""
    from repro_torch.kernels import ops  # kernels depend on core

    kw = dict(policy=spec.policy, tile=spec.tile, layout=spec.layout,
              bias=bias if fuse_epilogue else None,
              epilogue=spec.epilogue if fuse_epilogue else None,
              accum_block=spec.accum_block)
    if w.ndim == 2 and (x.ndim == 2 or spec.layout != "tn"):
        lead = x.shape[:-2]
        if deriv is not None or bias_grad:
            kw.update(deriv=None if deriv is None
                      else deriv.reshape(-1, deriv.shape[-1]),
                      grad_epilogue=spec.grad_epilogue,
                      grad_from_output=spec.grad_mode == "output",
                      bias_grad=bias_grad)
        out = ops.redmule_matmul(x.reshape(-1, x.shape[-1]), w, **kw)
        z, db = out if bias_grad else (out, None)
        m = x.shape[-1] if spec.layout == "tn" else x.shape[-2]
        z = z.reshape(*lead, m, z.shape[-1])
        return (z, db) if bias_grad else z
    if deriv is not None or bias_grad:
        raise ValueError("the fused backward epilogue is a 2D-weight contract")
    return ops.redmule_matmul_batched(x, w, **kw)


def _hopper_attention(kind: str, operands, **params):
    """The "attention" capability: ``"attention"`` runs the flash kernel,
    ``"linear_attention"`` the chunked state sweep (operands pre-padded to
    a multiple of ``chunk``; returns ``(out, state)``)."""
    from repro_torch.kernels import chunked_linear_attention, flash_attention

    if kind == "attention":
        return flash_attention.flash_attention(*operands, **params)
    if kind == "linear_attention":
        return chunked_linear_attention.chunked_linear_attention(
            *operands, **params)
    raise ValueError(f"unknown attention kind {kind!r}")


register_backend(
    "hopper", _hopper_fn,
    capabilities=("fused_epilogue", "tiled", "layouts", "fused_bwd_epilogue",
                  "operand_dtypes", "attention"),
    attention_fn=_hopper_attention,
    description="hand-written sm_90a CUDA kernels: the RedMulE GEMM (2D and "
                "batched, nn/nt/tn strides, fused bias + activation store, "
                "the paper's fp16 accumulator, act' and db fused into the "
                "backward, FP8 storage widened to fp16 on load; bf16 / fp16 "
                "on the tensor cores, fp32 in SIMT FMAs), causal "
                "GQA flash attention and the chunked linear-attention sweep; "
                "plain PyTorch versions on CPU tensors")


# --------------------------------------------------------------------- #
# Launch geometry: explicit > autotune cache > heuristic
# --------------------------------------------------------------------- #
def _launch_dims(x_shape, w_shape, layout: str) -> Tuple[int, int, int, int]:
    """``(M, N, K, batch)`` of the kernel launch the "hopper" backend makes
    for these stored operands (:func:`_hopper_fn`): a 2D weight folds x's
    leading dims into M (kernel 1, batch 1); anything else is a batched
    launch over the broadcast leading dims (kernel 2)."""
    from repro_torch.kernels.redmule_matmul import logical_dims

    M, N, K = logical_dims(x_shape, w_shape, layout)
    if len(w_shape) == 2 and (len(x_shape) == 2 or layout != "tn"):
        return M * math.prod(x_shape[:-2]), N, K, 1
    lead = torch.broadcast_shapes(tuple(x_shape[:-2]), tuple(w_shape[:-2]))
    return M, N, K, math.prod(lead)


def _resolve_tile(tile: Optional[tiling.TileConfig], x_shape, w_shape,
                  layout: str, *, policy: prec.Policy, backend: str,
                  epilogue: Optional[str] = None, fused_bwd: bool = False,
                  x_dtype: Optional[str] = None,
                  w_dtype: Optional[str] = None) -> tiling.TileConfig:
    """The geometry a GEMM dispatch launches, stamped on its event: the
    explicit ``tile``, else the autotune cache's entry for the launch
    (keyed on its own dims and batch, ``core/autotune.py``), else
    ``choose_tiles`` with the heuristic split (``splits`` 0)."""
    if tile is not None:
        return tile
    M, N, K, batch = _launch_dims(x_shape, w_shape, layout)
    t = autotune.cached_tile(M, N, K, policy=policy, backend=backend,
                             epilogue=epilogue, layout=layout,
                             fused_bwd=fused_bwd, x_dtype=x_dtype,
                             w_dtype=w_dtype, batch=batch)
    return t if t is not None else tiling.choose_tiles(M, N, K)


# --------------------------------------------------------------------- #
# Dispatch helpers
# --------------------------------------------------------------------- #
def _check_policy(policy: prec.Policy) -> None:
    """Per-operand storage is FP8 (the two mixed policies) or the compute
    dtype; other narrow storage dtypes are not ported."""
    for d in (policy.x_dtype, policy.w_dtype, policy.grad_dtype):
        if d is not None and not prec.is_fp8(d) and d != policy.compute_dtype:
            raise NotImplementedError(
                f"{prec.dtype_name(d)} storage under policy {policy.name!r} "
                f"is {_ROADMAP}")


def _pretranspose(x, w, layout: str, backend: str):
    """Operands as an "nn" dispatch for a backend without ``layouts``."""
    if layout == "nn" or get_backend(backend).supports("layouts"):
        return x, w, layout
    if layout == "nt":
        w = w.transpose(-1, -2)
    else:
        x = x.transpose(-1, -2)
    return x, w, "nn"


# --------------------------------------------------------------------- #
# Per-operand storage: dispatch dtypes and per-tensor quantization
# --------------------------------------------------------------------- #
def _dispatch_storage(policy: prec.Policy, backend: str
                      ) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """``(x_store, w_store, grad_store)``: the dtype names one dispatch to
    ``backend`` carries (None: the compute dtype), ``engine.py:1001-1023``
    of the reference.  Narrow operands go only to backends with
    ``"operand_dtypes"``; others get the quantized values widened to the
    compute dtype — the same numbers, billed at the wide width."""
    if not policy.mixed_storage or not get_backend(backend).supports(
            "operand_dtypes"):
        return None, None, None
    comp = prec.dtype_name(policy.compute_dtype)

    def nm(d):
        n = prec.dtype_name(d)
        return None if n == comp else n

    return (nm(policy.x_storage_dtype), nm(policy.w_storage_dtype),
            nm(policy.grad_storage_dtype))


# quantized operands kept across dispatches, keyed by (id of the base
# tensor, view offset / shape / strides, FP8 dtype); each entry holds a
# weak reference to the base and its version, and dies with the base
_FP8_FROZEN: Dict[tuple, tuple] = {}


def _frozen_fp8(v: torch.Tensor, storage_dtype):
    """``prec.quantize_fp8(v, storage_dtype)``, kept while ``v``'s base
    tensor is alive and unmodified, for a tensor made outside inference
    mode that needs no grad, dispatched inside it (a weight while serving);
    None otherwise.  The values are the ones a fresh quantization gives:
    the key pins the view, the base's identity and its version counter
    (bumped by every in-place write)."""
    if not torch.is_inference_mode_enabled() or v.is_inference() or v.requires_grad:
        return None
    base = v if v._base is None else v._base
    key = (id(base), v.storage_offset(), tuple(v.shape), v.stride(),
           prec.dtype_name(storage_dtype))
    hit = _FP8_FROZEN.get(key)
    if hit is not None and hit[0]() is base and hit[1] == base._version:
        return hit[2]
    out = prec.quantize_fp8(v, storage_dtype)
    ref = weakref.ref(base, lambda _r, k=key: _FP8_FROZEN.pop(k, None))
    _FP8_FROZEN[key] = (ref, base._version, out)
    return out


def _prep_operand(v: torch.Tensor, storage_dtype, store_name: Optional[str],
                  policy: prec.Policy
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cast, or per-tensor quantize, one operand for dispatch
    (``engine.py:1026-1049``): FP8 storage returns ``(q, s)`` with ``q = v
    / amax`` in FP8 and ``s`` an fp32 scalar tensor on the operand's device
    (no host sync); anything else ``(v cast, None)``.  Without a narrow
    ``store_name`` the quantized values are widened back to the compute
    dtype, so the quantization point does not depend on the backend."""
    comp = policy.compute_dtype
    if prec.is_fp8(storage_dtype):
        q, s = _frozen_fp8(v, storage_dtype) or prec.quantize_fp8(v, storage_dtype)
        return (q.to(comp) if store_name is None else q), s
    q = v.to(storage_dtype)
    if store_name is None and q.dtype != comp:
        q = q.to(comp)
    return q, None


def _scale_product(*scales: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Product of the non-None per-tensor scales (None when there are none:
    the uniform policies skip every multiply)."""
    out = None
    for s in scales:
        if s is not None:
            out = s if out is None else out * s
    return out


def _unscale(z: torch.Tensor, pol: prec.Policy,
             sp: Optional[torch.Tensor]) -> torch.Tensor:
    """``z.astype(accum) * sp`` as the reference computes it: its scale is
    a strongly typed fp32 scalar, so JAX multiplies even an fp16
    accumulator in fp32 (PyTorch would keep fp16 for a 0-d tensor).
    Returns fp32 when scaled, else ``z`` unchanged."""
    if sp is None:
        return z
    return z.to(pol.accum_dtype).float() * sp


def _prep_xw(spec: GemmSpec, x, w):
    """Both GEMM operands cast or quantized per the spec's per-operand
    storage: ``(xd, wd, sx, sw)``, the scales None on uniform policies."""
    pol = spec.policy
    xd, sx = _prep_operand(x, pol.x_storage_dtype, spec.x_dtype, pol)
    wd, sw = _prep_operand(w, pol.w_storage_dtype, spec.w_dtype, pol)
    return xd, wd, sx, sw


def _dispatch(spec: GemmSpec, backend: str, x, w,
              extra_specs: Sequence[GemmSpec] = ()) -> torch.Tensor:
    """Emit one event (and its companion pass events) and run one GEMM on
    prepped operands (compute dtype, or FP8 storage); the result is cast
    to the policy's output dtype."""
    pol = spec.policy
    x, w, layout = _pretranspose(x, w, spec.layout, backend)
    if layout != spec.layout:
        spec = dataclasses.replace(spec, layout=layout)
    z = _saved_dot(spec)
    if z is None:
        _emit(spec, backend)
    for extra in extra_specs:
        _emit(extra, backend)
    if z is None:
        z = _keep_dot(spec, get_backend(backend).fn(x, w, spec=spec))
    return z.to(pol.out_dtype)


def _storage(policy: prec.Policy, backend: str) -> Dict[str, Any]:
    """A forward spec's per-operand storage fields."""
    xs, ws, _ = _dispatch_storage(policy, backend)
    return dict(x_dtype=xs, w_dtype=ws, scaled=policy.scaled)


def _gemm_forward(spec: GemmSpec, backend: str, x, w):
    """The pure GEMM (the reference's ``_gemm_call`` / ``_gemm_fwd``):
    prep, dispatch, undo the scales; returns ``(z, residuals)`` with the
    residuals ``(xd, wd, sx, sw)`` in the dispatch storage."""
    pol = spec.policy
    xd, wd, sx, sw = _prep_xw(spec, x, w)
    z = _dispatch(spec, backend, xd, wd)
    z = _unscale(z, pol, _scale_product(sx, sw)).to(pol.out_dtype)
    return z, (xd, wd, sx, sw)


def _static_valid_rows(group_sizes, m: int) -> Optional[int]:
    if group_sizes is None:
        return None
    if isinstance(group_sizes, torch.Tensor):
        group_sizes = group_sizes.cpu().numpy()
    return int(np.clip(np.asarray(group_sizes), 0, m).sum())


def _attention_specs(*, B: int, Hq: int, S: int, T: int, D: int, Dv: int,
                     bq: int, bkv: int, causal: bool, q_offset: int,
                     policy: prec.Policy) -> Tuple[GemmSpec, GemmSpec]:
    """The sweep's score / PV event specs, exactly as the reference bills
    them (``engine.py:1709-1734``): ``groups`` = executed block pairs,
    ``io_bytes`` = Q once per row, K/V once per executed pair, O once."""
    pairs = tiling.attn_pairs(S, T, bq, bkv, causal=causal, q_offset=q_offset)
    S_pad = -(-S // bq) * bq
    BHq = B * Hq
    cb = _itemsize(policy.compute_dtype)
    ob = _itemsize(policy.out_dtype)
    tile = tiling.TileConfig(bm=bq, bn=bkv, bk=bkv)
    score = GemmSpec(
        op="attention_score", tag="bsd,btd->bst", m=bq, n=D, k=bkv,
        batch=BHq, groups=pairs, policy=policy, tile=tile,
        io_bytes=BHq * (S_pad * D + pairs * bkv * D) * cb)
    pv = GemmSpec(
        op="attention_pv", tag="bst,btd->bsd", m=bq, n=bkv, k=Dv,
        batch=BHq, groups=pairs, policy=policy, tile=tile,
        io_bytes=BHq * (pairs * bkv * Dv * cb + S_pad * Dv * ob))
    return score, pv


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# --------------------------------------------------------------------- #
# The backward: one autograd Function around the GEMM dispatch
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _grad_policy(policy: prec.Policy) -> prec.Policy:
    """The backward dispatches' policy: the forward's datapath, output held
    in the accumulator dtype (one cast to the primal dtype at the end)."""
    return dataclasses.replace(policy, name=policy.name + "+grad",
                               output_dtype=policy.accum_dtype)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum a gradient down to the (possibly broadcast) primal shape."""
    extra = g.ndim - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(extra)))
    dims = tuple(i for i, (gs, ss) in enumerate(zip(g.shape, shape))
                 if ss == 1 and gs != 1)
    if dims:
        g = g.sum(dim=dims, keepdim=True)
    return g


def _faithful_block(policy: prec.Policy, m: int, n: int, k: int, *,
                    fused_bwd: bool = False, x_dtype: Optional[str] = None,
                    w_dtype: Optional[str] = None) -> Optional[int]:
    """The faithful accumulator's rounding block of one dispatch: the
    reference's (its ``tile.bn``, sized by the operands' storage); None
    under fp32 accumulation."""
    if not policy.blockwise_accum:
        return None
    return tiling.accum_block(m, n, k, compute_dtype=policy.compute_dtype,
                              accum_dtype=policy.accum_dtype,
                              fused_bwd=fused_bwd, x_dtype=x_dtype,
                              w_dtype=w_dtype)


def _grad_dispatch(spec: GemmSpec, backend: str, a, b, count: int, *,
                   launch: Optional[str] = None,
                   deriv: Optional[torch.Tensor] = None,
                   want_db: bool = False):
    """One backward GEMM through the registry (transpose layouts read the
    forward's storage in place); returns ``(grad, db)``, the grad in the
    grad policy's accum dtype.  ``launch`` names the layout ``a`` / ``b``
    are stored in when it is not the event's: the backward of an "nt" /
    "tn" forward bills the reference's spec (its forward multiplies by the
    transposed operand) and hands the kernel the forward's storage as it
    is.  The geometry is resolved for the launch's own operands and
    stamped on the event (:func:`_resolve_tile`).  ``deriv`` / ``want_db``
    run the fused backward epilogue (only ever on ``fused_bwd_epilogue``
    backends, which have ``layouts``); ``db`` is None otherwise."""
    run = spec
    if launch is not None and launch != spec.layout:
        run = dataclasses.replace(spec, layout=launch)
    a, b, layout = _pretranspose(a, b, run.layout, backend)
    if layout != run.layout:
        run = dataclasses.replace(run, layout=layout)
        spec = dataclasses.replace(spec, layout=layout)
    tile = _resolve_tile(None, a.shape, b.shape, run.layout,
                         policy=run.policy, backend=backend,
                         fused_bwd=run.fused_bwd or want_db,
                         x_dtype=run.x_dtype, w_dtype=run.w_dtype)
    run = dataclasses.replace(run, tile=tile)
    spec = dataclasses.replace(spec, tile=tile)
    _emit(spec, backend, count=count)
    fn = get_backend(backend).fn
    if run.fused_bwd or want_db:
        out = fn(a, b, spec=run, deriv=deriv, bias_grad=want_db)
        out, db = out if want_db else (out, None)
        return out.to(run.policy.out_dtype), db
    return fn(a, b, spec=run).to(run.policy.out_dtype), None


def _bwd_operands(layout: str, x, w, dz):
    """``((a, b, launch), (a, b, launch))`` of the dX and dW launches for a
    forward stored as ``layout``, each grad in its primal's storage:

    * "nn": dX = dZ·Wᵀ ("nt"), dW = Xᵀ·dZ ("tn");
    * "nt" (``w`` stored ``(K, N)``): dX = dZ·W ("nn"), and the stored
      dW = dZᵀ·X ("tn") — the tied head's embedding gradient, with no
      transposed copy of the table;
    * "tn" (``x`` stored ``(N, M)``): the stored dX = W·dZᵀ ("nt"), dW =
      X·dZ ("nn")."""
    if layout == "nn":
        return (dz, w, "nt"), (x, dz, "tn")
    if layout == "nt":
        return (dz, w, "nn"), (dz, x, "tn")
    return (w, dz, "nt"), (x, dz, "nn")


def _bwd_gemms(spec: GemmSpec, backend: str, count: int, xc, wc, dzc, *,
               deriv: Optional[torch.Tensor] = None,
               grad_mode: Optional[str] = None, want_db: bool = False):
    """dX and dW with the reference's specs (``engine.py:1256-1331``:
    dX = dZ·Wᵀ as "nt", dW = Xᵀ·dZ as "tn", on the logical operands);
    returns ``(dx, dw, db)``, each grad in its primal's storage shape.
    The residuals ``xc`` / ``wc`` keep the forward's dispatch storage and
    ``dzc`` rides in the grad storage (the x slot on dX, the w slot on
    dW); tiles and rounding blocks are sized by those storages.  A forward
    stored "nt" / "tn" launches the layouts :func:`_bwd_operands` names.
    A 2D weight's dW collapses every leading dim into one contraction;
    batched grads stay batched and are summed back over broadcast dims.
    ``deriv`` (the saved residual, compute dtype) makes both dispatches
    apply ``act'`` to dZ on load, ``want_db`` makes the dW dispatch return
    the bias gradient (2D weights, "nn" only)."""
    gpol = _grad_policy(spec.policy)
    if spec.valid_rows == 0:
        # every group empty: the masked cotangent is zero, no dispatch (the
        # reference's short-circuit, engine.py:1246)
        zeros = lambda t: torch.zeros(t.shape, dtype=gpol.out_dtype, device=t.device)
        return zeros(xc), zeros(wc), None
    g_store = _dispatch_storage(spec.policy, backend)[2]
    fb = deriv is not None
    act = spec.epilogue if fb else None
    dx_st = dict(x_dtype=g_store, w_dtype=spec.w_dtype)
    dw_st = dict(x_dtype=spec.x_dtype, w_dtype=g_store)
    if (fb or want_db) and (wc.ndim != 2 or spec.layout != "nn"):
        raise ValueError("the fused backward epilogue is a 2D-weight, "
                         "'nn'-layout contract")
    if wc.ndim == 2 and (spec.layout != "tn" or xc.ndim == 2):
        rows = spec.batch * spec.m
        dx_spec = GemmSpec(
            op="matmul_dx", tag="mk,nk->mn", layout="nt", m=spec.m, n=spec.k,
            k=spec.n, batch=spec.batch, policy=gpol, w_shared=True,
            grad_epilogue=act, grad_mode=grad_mode, fused_bwd=fb,
            **dx_st, scaled=spec.scaled,
            accum_block=_faithful_block(gpol, spec.m, spec.k, spec.n,
                                        fused_bwd=fb, **dx_st))
        dw_spec = GemmSpec(
            op="matmul_dw", tag="mn,mk->nk", layout="tn", m=spec.n, n=rows,
            k=spec.k, batch=1, policy=gpol, w_shared=False,
            grad_epilogue=act, grad_mode=grad_mode, fused_bwd=fb,
            fused_bias_grad=want_db, **dw_st, scaled=spec.scaled,
            accum_block=_faithful_block(gpol, spec.n, rows, spec.k,
                                        fused_bwd=fb or want_db, **dw_st))
        # dW collapses every leading dim of x / dZ into rows ("tn": x is 2D)
        x2 = xc.reshape(-1, xc.shape[-1])
        dz2 = dzc.reshape(-1, dzc.shape[-1])
        d2 = None if deriv is None else deriv.reshape(-1, deriv.shape[-1])
        ax, bx, lx = _bwd_operands(spec.layout, xc, wc, dzc)[0]
        aw, bw, lw = _bwd_operands(spec.layout, x2, wc, dz2)[1]
        dx, _ = _grad_dispatch(dx_spec, backend, ax, bx, count, launch=lx,
                               deriv=deriv)
        dw, db = _grad_dispatch(dw_spec, backend, aw, bw, count, launch=lw,
                                deriv=d2, want_db=want_db)
        return dx, dw, db
    # batched / grouped: the specs carry the forward's ragged rows (dX
    # ragged in M, dW in its contraction rows), as the reference bills them
    dx_spec = GemmSpec(
        op="matmul_dx", tag="bmk,bnk->bmn", layout="nt", m=spec.m, n=spec.k,
        k=spec.n, batch=spec.batch, groups=spec.groups, policy=gpol,
        w_shared=spec.w_shared, valid_rows=spec.valid_rows, ragged_dim="m",
        **dx_st, scaled=spec.scaled,
        accum_block=_faithful_block(gpol, spec.m, spec.k, spec.n, **dx_st))
    dw_spec = GemmSpec(
        op="matmul_dw", tag="bmn,bmk->bnk", layout="tn", m=spec.n, n=spec.m,
        k=spec.k, batch=spec.batch, groups=spec.groups, policy=gpol,
        w_shared=False, valid_rows=spec.valid_rows,
        ragged_dim="n" if spec.valid_rows is not None else "m",
        **dw_st, scaled=spec.scaled,
        accum_block=_faithful_block(gpol, spec.n, spec.m, spec.k, **dw_st))
    (ax, bx, lx), (aw, bw, lw) = _bwd_operands(spec.layout, xc, wc, dzc)
    dx, _ = _grad_dispatch(dx_spec, backend, ax, bx, count, launch=lx)
    if spec.groups > 1 and spec.layout == "nn" and not gpol.blockwise_accum:
        # grouped (the experts): one "tn" launch per group over all B·M rows
        # of x and dZ laid out (G, B·M, ·) — not a (B, G, N, K) fp32 grad
        # summed down afterwards (5.9 GB at the MoE training shape).  An fp16
        # accumulator keeps the reference's per-(b, g) rounding below.
        G = wc.shape[0]
        aw = xc.movedim(-3, 0).reshape(G, -1, xc.shape[-1])
        bw = dzc.movedim(-3, 0).reshape(G, -1, dzc.shape[-1])
    dw, _ = _grad_dispatch(dw_spec, backend, aw, bw, count, launch=lw)
    return _unbroadcast(dx, xc.shape), _unbroadcast(dw, wc.shape), None


def _quantized_bwd(spec: GemmSpec, backend: str, count: int, xd, wd, sx, sw,
                   dz_wide):
    """The two-pass backward's tail (``engine.py:1366-1388``): the
    cotangent cast, or quantized to the grad storage once, both backward
    GEMMs, then the scales undone — dX = dZ·Wᵀ by the dZ and W scales,
    dW = Xᵀ·dZ by the X and dZ scales (in fp32, as :func:`_unscale`).
    Returns ``(dx, dw)``: the grad policy's accum dtype, fp32 when
    scaled."""
    pol = spec.policy
    dzd, sdz = _prep_operand(dz_wide, pol.grad_storage_dtype,
                             _dispatch_storage(pol, backend)[2], pol)
    dx, dw, _ = _bwd_gemms(spec, backend, count, xd, wd, dzd)
    spx, spw = _scale_product(sdz, sw), _scale_product(sx, sdz)
    if spx is not None:
        dx = dx.float() * spx
    if spw is not None:
        dw = dw.float() * spw
    return dx, dw


class _GemmFn(torch.autograd.Function):
    """The pure-GEMM op with its backward (the reference's ``_gemm_call``
    / ``_gemm_fwd`` / ``_gemm_bwd``).  Residuals are the dispatched
    operands — FP8 with their per-tensor scales under a scaled policy, so
    the backward GEMMs re-read them narrow; both grads are computed
    whenever the node runs, as the reference's VJP does (the events are
    the same either way)."""

    @staticmethod
    def forward(ctx, spec: GemmSpec, backend: str, x, w):
        z, res = _gemm_forward(spec, backend, x, w)
        ctx.save_for_backward(*res)
        ctx.spec, ctx.backend = spec, backend
        ctx.dtypes = (x.dtype, w.dtype)
        ctx.emit = _capture()
        return z

    @staticmethod
    def backward(ctx, dz):
        xd, wd, sx, sw = ctx.saved_tensors
        with _restored(ctx.emit):
            dx, dw = _quantized_bwd(ctx.spec, ctx.backend, ctx.emit.count, xd,
                                    wd, sx, sw, dz)
        need_x, need_w = ctx.needs_input_grad[2:]
        return (None, None, dx.to(ctx.dtypes[0]) if need_x else None,
                dw.to(ctx.dtypes[1]) if need_w else None)


def _postep(spec: GemmSpec) -> Tuple[GemmSpec, ...]:
    """The scaled forward's post-op epilogue pass event (the scale must be
    undone before the bias / activation, so the epilogue never fuses),
    emitted beside its GEMM event; none on uniform policies."""
    if not spec.scaled:
        return ()
    return (dataclasses.replace(spec, op=spec.op + "_postep", tile=None),)


def _linear_forward(spec: GemmSpec, backend: str, xd, wd, bc, sp, *,
                    fuse: bool, epilogue: Optional[str]) -> torch.Tensor:
    """``epilogue(x @ w + bc)`` in the output dtype on prepped operands
    (the reference's ``_linear_primal_prepped``), ``spec``'s event emitted
    once: in the kernel's store with ``fuse``, else post-op — the scales
    ``sp`` undone (fp32), the result re-rounded to the accumulator dtype,
    then bias and epilogue there, then one downcast.  ``epilogue`` is
    ``spec.epilogue``, or None to fuse only the bias."""
    pol = spec.policy
    if fuse:
        z = _saved_dot(spec)
        if z is None:
            _emit(spec, backend)
            run = (spec if epilogue == spec.epilogue
                   else dataclasses.replace(spec, epilogue=epilogue))
            z = _keep_dot(spec, get_backend(backend).fn(xd, wd, spec=run, bias=bc,
                                                         fuse_epilogue=True))
        return z.to(pol.out_dtype)
    z = _unscale(_dispatch(spec, backend, xd, wd, _postep(spec)), pol, sp)
    z = z.to(pol.accum_dtype)
    if bc is not None:
        z = z + bc
    return epi.apply_epilogue(epilogue, z).to(pol.out_dtype)


def _linear_preact(spec: GemmSpec, backend: str, xd, wd, bc, sp, *,
                   fuse: bool) -> torch.Tensor:
    """The pre-activation ``x @ w + bc`` of an activation without an
    output-form derivative (gelu / silu), in the accumulator dtype — fp32
    when scaled, where the scales and the bias are applied in fp32 with no
    re-rounding (the reference's ``_linear_fwd_core``)."""
    pol = spec.policy
    if fuse:
        return _linear_forward(spec, backend, xd, wd, bc, sp, fuse=True,
                               epilogue=None).to(pol.accum_dtype)
    sa = _dispatch(spec, backend, xd, wd, _postep(spec)).to(pol.accum_dtype)
    sa = _unscale(sa, pol, sp)
    return sa if bc is None else sa + bc


class _LinearFn(torch.autograd.Function):
    """``linear`` with a bias and / or activation, with its backward (the
    reference's ``_linear_call`` / ``_linear_fwd_core`` /
    ``_linear_bwd_core``).

    Forward: relu / tanh (output-form derivative) keep the fully fused
    forward and save its output; gelu / silu fuse only the bias, apply the
    activation after and save the pre-activation (compute dtype).  Under
    a scaled (FP8) policy nothing fuses: the scales are undone post-op
    before the bias and activation, and the operands are saved in FP8
    with their scales.
    Backward, on a ``fused_bwd_epilogue`` backend with a 2D weight and a
    uniform policy: one pass — the raw cotangent goes to the dX / dW
    kernels, which apply ``act'`` to its tiles on load, and the dW kernel
    returns db.  Elsewhere the two-pass fallback: ``ds = dZ * act'`` in
    the accumulator dtype (a ``linear_dact`` pass event), db its row sum
    (``linear_dbias``, from the wide ``ds``), then ``ds`` cast or
    quantized once to the grad storage and the backward GEMMs."""

    @staticmethod
    def forward(ctx, spec: GemmSpec, backend: str, fuse: bool, fuse_bwd: bool,
                x, w, b):
        pol = spec.policy
        act = spec.epilogue
        xd, wd, sx, sw = _prep_xw(spec, x, w)
        sp = _scale_product(sx, sw)
        bc = None if b is None else b.to(pol.accum_dtype)
        if act is not None and epi.epilogue_grad(act).deriv_from_output is None:
            sa = _linear_preact(spec, backend, xd, wd, bc, sp, fuse=fuse)
            z = epi.apply_epilogue(act, sa).to(pol.out_dtype)
            aux = sa.to(pol.compute_dtype)
        else:
            z = _linear_forward(spec, backend, xd, wd, bc, sp, fuse=fuse,
                                epilogue=act)
            aux = z if act is not None else None
        ctx.save_for_backward(xd, wd, aux, sx, sw)
        ctx.spec, ctx.backend, ctx.fuse_bwd = spec, backend, fuse_bwd
        ctx.dtypes = (x.dtype, w.dtype, None if b is None else b.dtype)
        ctx.emit = _capture()
        return z

    @staticmethod
    def backward(ctx, dz):
        xd, wd, aux, sx, sw = ctx.saved_tensors
        spec, backend = ctx.spec, ctx.backend
        pol, act, count = spec.policy, spec.epilogue, ctx.emit.count
        has_b = ctx.dtypes[2] is not None
        with _restored(ctx.emit):
            if ctx.fuse_bwd:
                deriv = grad_mode = None
                if act is not None:
                    grad_mode = ("output" if epi.epilogue_grad(act)
                                 .deriv_from_output is not None else "preact")
                    deriv = aux.to(pol.compute_dtype)
                dx, dw, db = _bwd_gemms(spec, backend, count, xd, wd,
                                        dz.to(pol.compute_dtype), deriv=deriv,
                                        grad_mode=grad_mode, want_db=has_b)
            else:
                dza = dz.to(pol.accum_dtype)
                if act is not None:
                    g = epi.epilogue_grad(act)
                    a = aux.to(pol.accum_dtype)
                    dza = dza * (g.deriv_from_output(a)
                                 if g.deriv_from_output is not None else g.deriv(a))
                    _emit(dataclasses.replace(spec, op=spec.op + "_dact",
                                              tile=None), backend, count=count)
                db = None
                if has_b:
                    db = dza.sum(dim=tuple(range(dza.ndim - 1)))
                    _emit(dataclasses.replace(spec, op=spec.op + "_dbias",
                                              tile=None), backend, count=count)
                dx, dw = _quantized_bwd(spec, backend, count, xd, wd, sx, sw,
                                        dza)
        need_x, need_w, need_b = ctx.needs_input_grad[4:]
        return (None, None, None, None,
                dx.to(ctx.dtypes[0]) if need_x else None,
                dw.to(ctx.dtypes[1]) if need_w else None,
                db.to(ctx.dtypes[2]) if need_b else None)


def _gemm_call(spec: GemmSpec, backend: str, x, w) -> torch.Tensor:
    return _GemmFn.apply(spec, backend, x, w)


# --------------------------------------------------------------------- #
# Attention: reference composition, kernel path and its backward
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def scores_policy(policy: prec.Policy) -> prec.Policy:
    """The attention scores' policy (the reference's, field for field):
    the forward's datapath with an fp32 output and no faithful flag
    (clearing it changes nothing: ``Policy.blockwise_accum``)."""
    return dataclasses.replace(policy, name=policy.name + "_scores",
                               output_dtype=torch.float32, faithful_accum=False)


def _attention_reference(q, k, v, *, group: int, causal: bool, scale: float,
                         q_offset: int, t_valid: int, policy: prec.Policy,
                         backend: str) -> torch.Tensor:
    """Attention as a composition of two :func:`einsum2d` dispatches
    (``engine.py:1617-1651`` of the reference): fp32 scores under the
    scores policy, times ``scale``; the ``t_valid`` / causal mask filled
    with -1e30; an fp32 softmax, fully masked rows zeroed; P in the compute
    dtype times V.  Both GEMMs self-bill and differentiate through the
    registry (on "hopper", kernel 2).  Serves backends or operands the
    flash sweep does not take, and the kernel path's backward."""
    B, Hq, S, D = q.shape
    _, Hkv, T, Dv = v.shape
    eng = DEFAULT_ENGINE
    qg = q.reshape(B, Hkv, group, S, D)
    s = eng.einsum2d("bhgsd,bhtd->bhgst", qg, k,
                     policy=scores_policy(policy), backend=backend) * scale
    rows = q_offset + torch.arange(S, device=q.device)
    cols = torch.arange(T, device=q.device)
    mask = (cols < t_valid)[None, :].expand(S, T)
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, torch.zeros((), device=q.device))
    out = eng.einsum2d("bhgst,bhtd->bhgsd", p.to(policy.compute_dtype), v,
                       policy=policy, backend=backend)
    return out.reshape(B, Hq, S, Dv).to(policy.out_dtype)


@dataclasses.dataclass(frozen=True)
class _AttnCtx:
    specs: Tuple[GemmSpec, GemmSpec]
    backend: str
    group: int
    causal: bool
    scale: float
    q_offset: int
    t_valid: int
    bq: int
    bkv: int
    policy: prec.Policy


def _attention_kernel_dispatch(actx: _AttnCtx, q, k, v) -> torch.Tensor:
    """Emit the sweep's two events and run the backend's flash kernel on
    ``(B·H, S, D)`` views of the operands in the compute dtype."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    for spec in actx.specs:
        _emit(spec, actx.backend)
    comp = actx.policy.compute_dtype
    out = get_backend(actx.backend).attention_fn(
        "attention",
        (q.to(comp).reshape(B * Hq, S, D), k.to(comp).reshape(B * Hkv, T, D),
         v.to(comp).reshape(B * Hkv, T, D)),
        group=actx.group, causal=actx.causal, scale=actx.scale, bq=actx.bq,
        bkv=actx.bkv, t_valid=actx.t_valid, q_offset=actx.q_offset)
    return out.reshape(B, Hq, S, D).to(actx.policy.out_dtype)


class _AttentionFn(torch.autograd.Function):
    """The flash kernel path with the reference's backward
    (``engine.py:1810-1826``): only q, k, v are saved (no S x T tensor);
    the backward recomputes through :func:`_attention_reference` on the
    same backend and differentiates it, so the composition's two GEMMs and
    their four ``matmul_dx`` / ``matmul_dw`` dispatches run kernel 2 and
    self-bill under the forward's multiplicity (the composition's forward
    once and untagged, inside a remat region too, as the reference bills
    it)."""

    @staticmethod
    def forward(ctx, actx: _AttnCtx, q, k, v):
        out = _attention_kernel_dispatch(actx, q, k, v)
        ctx.save_for_backward(q, k, v)
        ctx.actx = actx
        ctx.emit = _capture()
        return out

    @staticmethod
    def backward(ctx, d_out):
        saved = ctx.saved_tensors
        a = ctx.actx
        with torch.enable_grad(), _restored(ctx.emit), repeat(ctx.emit.count):
            ins = [t.detach().requires_grad_(True) for t in saved]
            out = _attention_reference(
                *ins, group=a.group, causal=a.causal, scale=a.scale,
                q_offset=a.q_offset, t_valid=a.t_valid, policy=a.policy,
                backend=a.backend)
            grads = torch.autograd.grad(out, ins, d_out)
        return (None, *(g.to(p.dtype) for g, p in zip(grads, saved)))


# --------------------------------------------------------------------- #
# Chunked linear attention: reference composition, specs, kernel path
# --------------------------------------------------------------------- #
def _linear_attention_reference(q, k, v, log_g, *, chunk: int,
                                state: Optional[torch.Tensor],
                                backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked state sweep as a composition of registry dispatches
    (``engine.py:1654-1706``): per chunk an fp32 score GEMM with the decay
    matrix, the intra-chunk PV GEMM, the inter-chunk ``q·exp(L) @ state``
    read and the decayed ``kᵀv`` state update, all under the FP32 policy.
    Returns ``(out fp32, state fp32)``; differentiable.

    The decay matrix exponentiates ``L_i - L_j`` only where ``i >= j``
    (there it is <= 0); the reference exponentiates every entry and masks
    after, so where a chunk's decays sum below about -88 the masked
    entries overflow to inf and its gradient is 0 · inf = NaN (Mamba2's
    ``dt·exp(a_log)`` reaches that at full width).  The values are the
    same."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    f32 = prec.FP32
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_g = F.pad(log_g, (0, pad))
    n = (S + pad) // chunk
    qf = q.float().reshape(B, H, n, chunk, dk)
    kf = k.float().reshape(B, H, n, chunk, dk)
    vf = v.float().reshape(B, H, n, chunk, dv)
    gf = log_g.float().reshape(B, H, n, chunk)
    s_prev = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
              if state is None else state.float())
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    zero = torch.zeros((), device=q.device)
    eng = DEFAULT_ENGINE
    from repro_torch.kernels.chunked_linear_attention import chunk_cumsum
    outs = []
    for i in range(n):     # the reference's lax.scan over chunks
        qc, kc, vc, gc = qf[:, :, i], kf[:, :, i], vf[:, :, i], gf[:, :, i]
        L = chunk_cumsum(gc)
        ltot = L[..., -1:]
        A = torch.where(causal, torch.exp(torch.where(
            causal, L[..., :, None] - L[..., None, :], zero)), zero)
        s = eng.einsum2d("bhik,bhjk->bhij", qc, kc, policy=f32, backend=backend) * A
        out = eng.matmul(s, vc, policy=f32, backend=backend)
        out = out + eng.matmul(qc * torch.exp(L)[..., None], s_prev, policy=f32,
                               backend=backend)
        kdec = kc * torch.exp(ltot - L)[..., None]
        s_prev = torch.exp(ltot)[..., None] * s_prev + eng.matmul(
            kdec.transpose(-1, -2), vc, policy=f32, backend=backend)
        outs.append(out)
    out = torch.stack(outs, dim=2).reshape(B, H, n * chunk, dv)[:, :, :S]
    return out, s_prev


def _linear_attention_specs(*, B: int, H: int, S: int, dk: int, dv: int,
                            chunk: int, in_bytes: int) -> Tuple[GemmSpec, ...]:
    """The sweep's four per-chunk event specs exactly as the reference bills
    them (``engine.py:1737-1765``): ``groups`` = number of chunks, the
    state stored once in fp32."""
    S_pad = -(-S // chunk) * chunk
    n = S_pad // chunk
    BH = B * H
    f32 = prec.FP32
    tile = tiling.TileConfig(bm=chunk, bn=chunk, bk=chunk)
    return (
        GemmSpec(op="linear_attention_score", tag="bik,bjk->bij", m=chunk,
                 n=dk, k=chunk, batch=BH, groups=n, policy=f32, tile=tile,
                 io_bytes=BH * S_pad * (2 * dk * in_bytes + 4)),
        GemmSpec(op="linear_attention_pv", tag="bij,bjv->biv", m=chunk,
                 n=chunk, k=dv, batch=BH, groups=n, policy=f32, tile=tile,
                 io_bytes=BH * S_pad * dv * in_bytes),
        GemmSpec(op="linear_attention_inter", tag="bik,bkv->biv", m=chunk,
                 n=dk, k=dv, batch=BH, groups=n, policy=f32, tile=tile,
                 io_bytes=BH * S_pad * dv * in_bytes),
        GemmSpec(op="linear_attention_state", tag="bki,bkv->biv", m=dk,
                 n=chunk, k=dv, batch=BH, groups=n, policy=f32, tile=tile,
                 io_bytes=BH * dk * dv * 4))


@dataclasses.dataclass(frozen=True)
class _LinAttnCtx:
    specs: Tuple[GemmSpec, ...]
    backend: str
    chunk: int


def _linear_attention_kernel_dispatch(actx: _LinAttnCtx, q, k, v, log_g):
    """Pad to a multiple of the chunk (g = 0, k = 0: inert), emit the
    sweep's events and run the backend's kernel (``engine.py:1832-1854``)."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    pad = (-S) % actx.chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_g = F.pad(log_g, (0, pad))
    Sp = S + pad
    for spec in actx.specs:
        _emit(spec, actx.backend)
    out, st = get_backend(actx.backend).attention_fn(
        "linear_attention",
        (q.reshape(B * H, Sp, dk), k.reshape(B * H, Sp, dk),
         v.reshape(B * H, Sp, dv), log_g.float().reshape(B * H, Sp)),
        chunk=actx.chunk)
    out = out.reshape(B, H, Sp, dv)[:, :, :S].float()
    return out, st.reshape(B, H, dk, dv)


class _LinearAttentionFn(torch.autograd.Function):
    """The kernel path with the reference's backward
    (``engine.py:1867-1882``): only (q, k, v, log_g) are saved; the
    backward recomputes through :func:`_linear_attention_reference` on the
    same backend and differentiates it, so its GEMMs (fp32) and their
    ``matmul_dx`` / ``matmul_dw`` events go through the registry."""

    @staticmethod
    def forward(ctx, actx: _LinAttnCtx, q, k, v, log_g):
        out, st = _linear_attention_kernel_dispatch(actx, q, k, v, log_g)
        ctx.save_for_backward(q, k, v, log_g)
        ctx.actx = actx
        ctx.emit = _capture()
        return out, st

    @staticmethod
    def backward(ctx, d_out, d_state):
        saved = ctx.saved_tensors
        actx = ctx.actx
        with torch.enable_grad(), _restored(ctx.emit), repeat(ctx.emit.count):
            ins = [t.detach().requires_grad_(True) for t in saved]
            out, st = _linear_attention_reference(
                *ins, chunk=actx.chunk, state=None, backend=actx.backend)
            grads = torch.autograd.grad((out, st), ins, (d_out, d_state),
                                        allow_unused=True)
        return (None, *(None if g is None else g.to(p.dtype)
                        for g, p in zip(grads, saved)))


# --------------------------------------------------------------------- #
# The Engine
# --------------------------------------------------------------------- #
class Engine:
    """Resolves :class:`GemmSpec`\\ s to backends and dispatches them; an
    instance may pin a backend and/or a precision policy."""

    def __init__(self, *, backend: Optional[str] = None, policy=None):
        self._backend = backend
        self._policy = policy

    def resolve_backend(self, backend: Optional[str] = None) -> str:
        b = backend or self._backend or default_backend()
        spec = get_backend(b)
        if backend is None and self._backend is None and not spec.is_available():
            raise ValueError(f"default backend {b!r} is not available "
                             f"(registered: {registered_backends()})")
        return b

    def resolve_policy(self, policy=None) -> prec.Policy:
        p = prec.resolve(policy if policy is not None else self._policy)
        _check_policy(p)
        return p

    def matmul(self, x: torch.Tensor, w: torch.Tensor, *, policy=None,
               tile: Optional[tiling.TileConfig] = None,
               backend: Optional[str] = None,
               layout: str = "nn") -> torch.Tensor:
        """Z = X @ W with the RedMulE dataflow.

        ``x (..., M, N)`` with ``w (N, K)`` (weight GEMM) or broadcast-
        compatible ``(..., N, K)`` (batched GEMM), stored as ``layout``
        names; ``layout="nt"`` reads ``w`` stored ``(K, N)`` — the tied LM
        head multiplies by the ``(V, d)`` embedding as it is stored.
        Output ``(..., M, K)`` in the policy's output dtype.
        Differentiable in every layout: the backward reads the forward's
        storage in place (the tied head's embedding gradient is one "tn"
        launch, dZᵀ·h, with no transposed copy of the table) and bills the
        reference's ``matmul_dx`` / ``matmul_dw`` specs, whose forward
        multiplies by the transposed operand."""
        from repro_torch.kernels.redmule_matmul import logical_dims

        policy = self.resolve_policy(policy)
        b = self.resolve_backend(backend)
        if x.ndim < 2 or w.ndim < 2:
            raise ValueError(f"matmul needs >=2D operands, got "
                             f"{tuple(x.shape)} @ {tuple(w.shape)}")
        m, n, k = logical_dims(x.shape, w.shape, layout)
        if w.ndim == 2 and layout != "tn":
            lead, tag = tuple(x.shape[:-2]), "mn,nk->mk"
        else:
            lead = tuple(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
            tag = "bmn,bnk->bmk"
        st = _storage(policy, b)
        spec = GemmSpec(
            op="matmul", tag=tag, m=m, n=n, k=k, batch=math.prod(lead),
            policy=policy, w_shared=(w.ndim == 2), layout=layout, **st,
            tile=_resolve_tile(tile, x.shape, w.shape, layout, policy=policy,
                               backend=b, x_dtype=st["x_dtype"],
                               w_dtype=st["w_dtype"]),
            accum_block=_faithful_block(policy, m, n, k, x_dtype=st["x_dtype"],
                                        w_dtype=st["w_dtype"]))
        return _gemm_call(spec, b, x, w)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               activation: Optional[str] = None, policy=None,
               tile: Optional[tiling.TileConfig] = None,
               backend: Optional[str] = None) -> torch.Tensor:
        """Affine layer ``act(x @ w + b)``.

        With the ``"fused_epilogue"`` capability the bias and activation run
        on the accumulator inside the kernel, before its one store; other
        backends get the post-op path (epilogue in the accumulator dtype on
        the GEMM result, then one downcast) — the two agree to ~2 ulp of
        the output dtype, the reference's contract.  Under autograd the
        backward is one pass on ``fused_bwd_epilogue`` backends with a 2D
        weight and two-pass elsewhere (see :class:`_LinearFn`)."""
        policy = self.resolve_policy(policy)
        bk = self.resolve_backend(backend)
        epi.validate_epilogue(activation)
        if x.ndim < 2 or w.ndim < 2:
            raise ValueError(f"linear needs x>=2D, w>=2D; got "
                             f"{tuple(x.shape)} @ {tuple(w.shape)}")
        if x.shape[-1] != w.shape[-2]:
            raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                             f"{tuple(w.shape)}")
        if b is not None and tuple(b.shape) != (w.shape[-1],):
            raise ValueError(f"bias must have shape ({w.shape[-1]},), got "
                             f"{tuple(b.shape)}")
        if w.ndim == 2:
            lead, tag = tuple(x.shape[:-2]), "mn,nk->mk"
        else:
            lead = tuple(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
            tag = "bmn,bnk->bmk"
        m, n, k = x.shape[-2], x.shape[-1], w.shape[-1]
        st = _storage(policy, bk)
        spec = GemmSpec(
            op="linear", tag=tag, m=m, n=n, k=k, batch=math.prod(lead),
            policy=policy, epilogue=activation, w_shared=(w.ndim == 2), **st,
            tile=_resolve_tile(tile, x.shape, w.shape, "nn", policy=policy,
                               backend=bk, epilogue=activation,
                               x_dtype=st["x_dtype"], w_dtype=st["w_dtype"]),
            accum_block=_faithful_block(policy, m, n, k, x_dtype=st["x_dtype"],
                                        w_dtype=st["w_dtype"]))
        if b is None and activation is None:
            return _gemm_call(spec, bk, x, w)
        # a scaled (FP8) policy runs the epilogue post-op and the two-pass
        # backward: the scales must be undone before the bias / activation,
        # and ds is quantized once, in the engine (reference engine.py:2080)
        backend_spec = get_backend(bk)
        fuse = backend_spec.supports("fused_epilogue") and not policy.scaled
        if _needs_grad(x, w, b):
            fuse_bwd = (w.ndim == 2 and not policy.scaled
                        and backend_spec.supports("fused_bwd_epilogue"))
            return _LinearFn.apply(spec, bk, fuse, fuse_bwd, x, w, b)
        xd, wd, sx, sw = _prep_xw(spec, x, w)
        bc = None if b is None else b.to(policy.accum_dtype)
        return _linear_forward(spec, bk, xd, wd, bc, _scale_product(sx, sw),
                               fuse=fuse, epilogue=activation)

    def grouped_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                       group_sizes=None, policy=None,
                       tile: Optional[tiling.TileConfig] = None,
                       backend: Optional[str] = None) -> torch.Tensor:
        """Per-group GEMM ``Z[g] = X[g] @ W[g]``: ``x (..., G, M, N)``,
        ``w (G, N, K)``, output ``(..., G, M, K)``.

        ``group_sizes`` (``(G,)`` ints) marks the valid M rows per group:
        rows at or beyond a group's size come back zero, and the event
        bills ``valid_rows = sum(min(size, M))`` instead of ``G * M``.

        Differentiable: dX is an "nt" launch per group (W broadcast over
        the lead dims), dW one "tn" launch per group over the rows of every
        lead index, billed as the reference's per-(b, g) ``matmul_dx`` /
        ``matmul_dw`` specs with the forward's ``valid_rows``; the masked
        rows' cotangent is zeroed by the mask's own backward."""
        policy = self.resolve_policy(policy)
        b = self.resolve_backend(backend)
        if x.ndim < 3 or w.ndim != 3:
            raise ValueError(f"grouped_matmul needs x (..., G, M, N) and w "
                             f"(G, N, K); got {tuple(x.shape)} @ {tuple(w.shape)}")
        if x.shape[-3] != w.shape[0]:
            raise ValueError(f"group mismatch: x has {x.shape[-3]} groups, "
                             f"w has {w.shape[0]}")
        if x.shape[-1] != w.shape[-2]:
            raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                             f"{tuple(w.shape)}")
        lead = tuple(x.shape[:-3])
        m, n, k = x.shape[-2], x.shape[-1], w.shape[-1]
        st = _storage(policy, b)
        spec = GemmSpec(
            op="grouped_matmul", tag="gmn,gnk->gmk", m=m, n=n, k=k,
            batch=math.prod(lead), groups=w.shape[0], policy=policy,
            tile=_resolve_tile(tile, x.shape, w.shape, "nn", policy=policy,
                               backend=b, x_dtype=st["x_dtype"],
                               w_dtype=st["w_dtype"]), w_shared=True,
            valid_rows=_static_valid_rows(group_sizes, m), **st,
            accum_block=_faithful_block(policy, m, n, k, x_dtype=st["x_dtype"],
                                        w_dtype=st["w_dtype"]))
        z = _gemm_call(spec, b, x, w)
        if group_sizes is not None:
            sizes = torch.as_tensor(group_sizes, device=z.device)
            valid = (torch.arange(m, device=z.device)[None, :]
                     < sizes[:, None])                          # (G, M)
            z = z.masked_fill(~valid[..., None], 0)
        return z

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  q_offset: int = 0, t_valid: Optional[int] = None,
                  bq: Optional[int] = None, bkv: Optional[int] = None,
                  policy=None, backend: Optional[str] = None) -> torch.Tensor:
        """Fused scaled-dot-product attention.

        ``q (B, Hq, S, D)``, ``k (B, Hkv, T, D)``, ``v (B, Hkv, T, Dv)``
        with ``Hq % Hkv == 0``; ``t_valid`` masks the KV tail,
        ``q_offset`` is the absolute position of query row 0 for the
        causal mask; rows with no visible KV are exact zeros.  Output
        ``(B, Hq, S, Dv)`` in the policy's output dtype.

        Where the backend's flash sweep takes the operands (the
        ``"attention"`` capability and ``Dv == D``),
        it runs, billed as ``attention_score`` / ``attention_pv`` events
        whose ``groups`` count executed ``(bq, bkv)`` block pairs; ``bq`` /
        ``bkv`` resolve explicit > the autotune cache (sweep key ``attnc``
        / ``attn``) > the flash kernel's own tiles (``tiling.FLASH_BQ`` /
        ``FLASH_BKV``, the one pair it is compiled for).  Its backward recomputes
        through the reference composition (:class:`_AttentionFn`).
        Elsewhere the composition itself runs, its two GEMMs self-billing
        and differentiable (:func:`_attention_reference`)."""
        policy = self.resolve_policy(policy)
        b = self.resolve_backend(backend)
        if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
            raise ValueError(f"attention needs (B, H, S, D) operands, got "
                             f"{tuple(q.shape)} / {tuple(k.shape)} / "
                             f"{tuple(v.shape)}")
        B, Hq, S, D = q.shape
        _, Hkv, T, Dv = v.shape
        if tuple(k.shape) != (B, Hkv, T, D):
            raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                             f"{tuple(v.shape)}")
        if Hq % Hkv != 0:
            raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
        scale = float(D ** -0.5 if scale is None else scale)
        q_offset = int(q_offset)
        t_valid = T if t_valid is None else min(int(t_valid), T)
        be = get_backend(b)
        if Dv != D or not be.supports("attention"):
            return _attention_reference(
                q, k, v, group=Hq // Hkv, causal=causal, scale=scale,
                q_offset=q_offset, t_valid=t_valid, policy=policy, backend=b)
        if bq is None or bkv is None:
            t = autotune.cached_tile(S, T, D, policy=policy, backend=b,
                                     sweep="attnc" if causal else "attn")
            if t is not None:
                bq, bkv = bq or t.bm, bkv or t.bn
        bq = int(bq or tiling.FLASH_BQ)
        bkv = int(bkv or tiling.FLASH_BKV)
        actx = _AttnCtx(
            specs=_attention_specs(B=B, Hq=Hq, S=S, T=T, D=D, Dv=Dv, bq=bq,
                                   bkv=bkv, causal=causal, q_offset=q_offset,
                                   policy=policy),
            backend=b, group=Hq // Hkv, causal=causal, scale=scale,
            q_offset=q_offset, t_valid=t_valid, bq=bq, bkv=bkv, policy=policy)
        if _needs_grad(q, k, v):
            return _AttentionFn.apply(actx, q, k, v)
        return _attention_kernel_dispatch(actx, q, k, v)

    def einsum2d(self, eq: str, x: torch.Tensor, w: torch.Tensor, *,
                 policy=None, tile: Optional[tiling.TileConfig] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Two-operand einsum lowered onto the GEMM dispatch.

        Any equation with exactly two operands, single-letter axes, no
        repeated labels within an operand and no ellipsis (e.g.
        ``"bhd,hde->bhe"``).  Shared labels absent from the output are
        contracted; labels of one operand absent from the output are summed
        out first.  Shared labels kept in the output become the batch of a
        batched GEMM; differentiable like :meth:`matmul`."""
        policy = self.resolve_policy(policy)
        b = self.resolve_backend(backend)
        (batch_l, m_l, k_l, c_l, sum_x, sum_w, a_lab, b_lab, out_lab,
         dims) = _plan_einsum2d(eq, x.shape, w.shape)
        if sum_x:
            x = x.sum(dim=tuple(a_lab.index(l) for l in sum_x))
            a_lab = [l for l in a_lab if l not in sum_x]
        if sum_w:
            w = w.sum(dim=tuple(b_lab.index(l) for l in sum_w))
            b_lab = [l for l in b_lab if l not in sum_w]
        xt = x.permute([a_lab.index(l) for l in batch_l + m_l + c_l])
        wt = w.permute([b_lab.index(l) for l in batch_l + c_l + k_l])
        size = lambda labels: math.prod(dims[l] for l in labels)
        bsz, m, k, c = size(batch_l), size(m_l), size(k_l), size(c_l)
        if batch_l:
            x2, w2 = xt.reshape(bsz, m, c), wt.reshape(bsz, c, k)
        else:
            x2, w2 = xt.reshape(m, c), wt.reshape(c, k)
        st = _storage(policy, b)
        spec = GemmSpec(
            op="einsum2d", tag=eq.replace(" ", ""), m=m, n=c, k=k, batch=bsz,
            policy=policy, w_shared=not batch_l, **st,
            tile=_resolve_tile(tile, x2.shape, w2.shape, "nn", policy=policy,
                               backend=b, x_dtype=st["x_dtype"],
                               w_dtype=st["w_dtype"]),
            accum_block=_faithful_block(policy, m, c, k, x_dtype=st["x_dtype"],
                                        w_dtype=st["w_dtype"]))
        z = _gemm_call(spec, b, x2, w2)
        cur = batch_l + m_l + k_l
        z = z.reshape([dims[l] for l in cur])
        return z.permute([cur.index(l) for l in out_lab])

    def linear_attention(self, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, log_g: torch.Tensor, *,
                         chunk: Optional[int] = None,
                         state: Optional[torch.Tensor] = None,
                         backend: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunked linear attention (the mLSTM / SSD state sweep).

        ``q / k (B, H, S, dk)``, ``v (B, H, S, dv)``, ``log_g (B, H, S)``
        per-step log decays (<= 0); an optional ``state (B, H, dk, dv)``
        is carried in.  Returns ``(out (B, H, S, dv) fp32, state
        (B, H, dk, dv) fp32)``.  With the ``"attention"`` capability and no
        state carried in, the sweep kernel runs, billed as four
        ``linear_attention_{score,pv,inter,state}`` events; otherwise — and
        in the kernel path's backward — the reference composition of fp32
        GEMM dispatches runs, each self-billing.  The chunk resolves
        explicit ``chunk`` > the autotune cache (sweep key ``lattn``,
        keyed on S, dk, dv and B·H) > 64; it changes the sweep's summation,
        so it is numerics as well as speed."""
        b = self.resolve_backend(backend)
        if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or log_g.ndim != 3:
            raise ValueError(
                f"linear_attention needs (B, H, S, d) q/k/v and (B, H, S) "
                f"log_g, got {tuple(q.shape)} / {tuple(k.shape)} / "
                f"{tuple(v.shape)} / {tuple(log_g.shape)}")
        B, H, S, dk = q.shape
        dv = v.shape[-1]
        if k.shape != q.shape or v.shape[:3] != q.shape[:3] \
                or log_g.shape != q.shape[:3]:
            raise ValueError(
                f"operand shape mismatch: {tuple(q.shape)} / {tuple(k.shape)} "
                f"/ {tuple(v.shape)} / {tuple(log_g.shape)}")
        if chunk is None:
            t = autotune.cached_tile(S, dk, dv, policy=prec.FP32, backend=b,
                                     sweep="lattn", batch=B * H)
            chunk = t.bm if t is not None else tiling.SWEEP_CHUNK
        chunk = int(chunk)
        if not (get_backend(b).supports("attention") and state is None):
            return _linear_attention_reference(q, k, v, log_g, chunk=chunk,
                                               state=state, backend=b)
        actx = _LinAttnCtx(
            specs=_linear_attention_specs(B=B, H=H, S=S, dk=dk, dv=dv,
                                          chunk=chunk, in_bytes=q.element_size()),
            backend=b, chunk=chunk)
        return _LinearAttentionFn.apply(actx, q, k, v, log_g)


def _plan_einsum2d(eq: str, x_shape, w_shape):
    """Parse an einsum2d equation into (batch, m, k, contract, summed-out,
    operand, output) labels and the label sizes (the reference's parser)."""
    e = eq.replace(" ", "")
    if "->" not in e or "..." in e:
        raise ValueError(f"einsum2d needs an explicit '->' and no ellipsis: {eq!r}")
    lhs, out = e.split("->")
    terms = lhs.split(",")
    if len(terms) != 2:
        raise ValueError(f"einsum2d takes exactly two operands: {eq!r}")
    a, bt = terms
    for t in (a, bt, out):
        if len(set(t)) != len(t):
            raise ValueError(f"repeated labels are not supported: {eq!r}")
    if len(a) != len(x_shape) or len(bt) != len(w_shape):
        raise ValueError(f"equation {eq!r} does not match operand ranks "
                         f"{len(x_shape)} and {len(w_shape)}")
    dims: Dict[str, int] = {}
    for labels, shape in ((a, x_shape), (bt, w_shape)):
        for lab, size in zip(labels, shape):
            if lab in dims and dims[lab] != size:
                raise ValueError(f"size mismatch for label {lab!r} in {eq!r}: "
                                 f"{dims[lab]} vs {size}")
            dims[lab] = int(size)
    for lab in out:
        if lab not in dims:
            raise ValueError(f"output label {lab!r} not in any operand: {eq!r}")
    batch_l = [l for l in a if l in bt and l in out]
    c_l = [l for l in a if l in bt and l not in out]
    m_l = [l for l in a if l not in bt and l in out]
    k_l = [l for l in bt if l not in a and l in out]
    sum_x = [l for l in a if l not in bt and l not in out]
    sum_w = [l for l in bt if l not in a and l not in out]
    return (batch_l, m_l, k_l, c_l, sum_x, sum_w, list(a), list(bt),
            list(out), dims)


DEFAULT_ENGINE = Engine()


def matmul(x, w, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.matmul(x, w, **kwargs)


def linear(x, w, b=None, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.linear(x, w, b, **kwargs)


def grouped_matmul(x, w, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.grouped_matmul(x, w, **kwargs)


def einsum2d(eq, x, w, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.einsum2d(eq, x, w, **kwargs)


def attention(q, k, v, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.attention(q, k, v, **kwargs)


def linear_attention(q, k, v, log_g, **kwargs):
    return DEFAULT_ENGINE.linear_attention(q, k, v, log_g, **kwargs)


matmul.__doc__ = Engine.matmul.__doc__
linear.__doc__ = Engine.linear.__doc__
grouped_matmul.__doc__ = Engine.grouped_matmul.__doc__
einsum2d.__doc__ = Engine.einsum2d.__doc__
attention.__doc__ = Engine.attention.__doc__
linear_attention.__doc__ = Engine.linear_attention.__doc__
