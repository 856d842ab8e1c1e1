"""The RedMulE Engine in PyTorch: GEMM specs, a backend registry, events.

Counterpart of ``repro.core.engine``, forward half.  Every contraction the
models run goes through this module:

* :class:`GemmSpec` — a frozen description of one contraction (tag,
  M/N/K, batch, groups, policy, tile, layout, ragged ``valid_rows``) with
  the reference's flop and byte formulas;
* a **backend registry** with capability flags.  One backend is
  registered, ``"hopper"`` — the hand-written CUDA kernels on a CUDA
  tensor, their plain PyTorch versions on a CPU tensor — with the
  capabilities ``fused_epilogue`` (bias + activation in the kernel's
  store), ``tiled`` (it runs ``spec.tile``), ``layouts`` (nn / nt / tn
  storage read in place) and ``attention`` (the flash sweep).  It plays
  the role of the reference's ``"pallas"`` and ``"interpret"`` together
  and is the default;
* the ops :func:`matmul`, :func:`linear` (forward, fused epilogue),
  :func:`grouped_matmul` (ragged groups) and :func:`attention` (the
  kernel path);
* **instrumentation** — every dispatch emits a :class:`GemmEvent` into the
  thread-local :func:`instrument` collectors; :func:`repeat` multiplies the
  count and :func:`op_scope` prefixes the op name.

PyTorch runs eagerly, so an event is emitted each time an op runs (the
reference emits at trace time, once per scanned body with a multiplicity).
The backward ops (``torch.autograd.Function`` dispatches), ``einsum2d``,
``linear_attention``, the reference attention composition and the FP8
policies arrive with later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec
from repro_torch.core import tiling

__all__ = [
    "GemmSpec", "GemmEvent", "Engine", "BackendSpec",
    "register_backend", "unregister_backend", "registered_backends",
    "get_backend", "backend_supports",
    "default_backend", "set_default_backend", "use_backend",
    "matmul", "linear", "grouped_matmul", "attention",
    "instrument", "repeat", "op_scope",
    "total_flops", "total_bytes", "summarize", "DEFAULT_ENGINE",
]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


def _itemsize(d) -> int:
    return prec.as_dtype(d).itemsize


# --------------------------------------------------------------------- #
# Spec / event
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """One contraction, fully described (the reference's forward fields;
    the backward and per-operand-storage fields arrive with their slices).
    ``m, n, k`` keep their logical meaning in every ``layout``;
    ``valid_rows`` replaces ``groups * M`` in ragged grouped GEMMs (the
    reference's ``ragged_dim == "m"``); ``io_bytes`` carries the exact
    traffic of an attention sweep."""

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
    io_bytes: Optional[int] = None

    def __post_init__(self):
        if self.layout not in ("nn", "nt", "tn"):
            raise ValueError(
                f"GemmSpec.layout = {self.layout!r}; known: ('nn', 'nt', 'tn')")

    @property
    def flops(self) -> int:
        """2 * B * G * M * N * K; ragged GEMMs bill ``valid_rows`` instead of
        ``G * M``."""
        if self.valid_rows is None:
            return 2 * self.batch * self.groups * self.m * self.n * self.k
        return 2 * self.batch * self.valid_rows * self.n * self.k

    @property
    def bytes(self) -> int:
        """Operand + result bytes of one execution in device memory: a
        shared weight is read once per group, ragged GEMMs bill valid rows
        only, operands at the compute width and the result at the output
        width."""
        if self.io_bytes is not None:
            return self.io_bytes
        cb = _itemsize(self.policy.compute_dtype)
        ob = _itemsize(self.policy.out_dtype)
        bg = self.batch * self.groups
        rows = bg * self.m if self.valid_rows is None else self.batch * self.valid_rows
        w_elems = (self.groups if self.w_shared else bg) * self.n * self.k
        return rows * self.n * cb + rows * self.k * ob + w_elems * cb


@dataclasses.dataclass(frozen=True)
class GemmEvent:
    """One engine dispatch as observed by :func:`instrument`; ``count`` is
    the :func:`repeat` multiplicity at emission."""

    spec: GemmSpec
    backend: str
    count: int = 1

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

    ``fn`` receives operands cast to ``spec.policy.compute_dtype``, stored
    as ``spec.layout`` names when the backend declares ``"layouts"`` (else
    always "nn"), with ``x (..., M, N)`` and ``w (N, K)`` or broadcast-
    compatible ``(..., N, K)``.  Capabilities, as in the reference:
    ``"fused_epilogue"`` — ``fn`` also takes ``bias`` (an accum-dtype
    ``(K,)`` row) and ``fuse_epilogue`` and applies both before its single
    store; ``"tiled"`` — ``fn`` runs ``spec.tile``; ``"attention"`` —
    ``attention_fn("attention", (q, k, v), **params)`` runs the flash sweep
    on ``(BH, S, D)`` / ``(BH_kv, T, D)`` operands.  ``fused_bwd_epilogue``
    and ``operand_dtypes`` are known names for later slices."""

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


def _emit(spec: GemmSpec, backend: str) -> None:
    stack = _collectors()
    if not stack:
        return
    scope = getattr(_state, "op_scope", None)
    if scope is not None:
        spec = dataclasses.replace(spec, op=f"{scope}/{spec.op}")
    ev = GemmEvent(spec=spec, backend=backend,
                   count=math.prod(getattr(_state, "repeat", None) or [1]))
    for events in stack:
        events.append(ev)


# --------------------------------------------------------------------- #
# The "hopper" backend
# --------------------------------------------------------------------- #
def _hopper_fn(x: torch.Tensor, w: torch.Tensor, *, spec: GemmSpec,
               bias: Optional[torch.Tensor] = None,
               fuse_epilogue: bool = False) -> torch.Tensor:
    """The RedMulE kernels (plain versions for CPU tensors).

    A 2D weight collapses the leading dims of x into rows and runs the 2D
    kernel; anything else runs the batched kernel, whose broadcast batch
    strides read a shared operand in place."""
    from repro_torch.kernels import ops  # kernels depend on core

    kw = dict(policy=spec.policy, tile=spec.tile, layout=spec.layout,
              bias=bias if fuse_epilogue else None,
              epilogue=spec.epilogue if fuse_epilogue else None)
    if w.ndim == 2 and (x.ndim == 2 or spec.layout != "tn"):
        lead = x.shape[:-2]
        z = ops.redmule_matmul(x.reshape(-1, x.shape[-1]), w, **kw)
        m = x.shape[-1] if spec.layout == "tn" else x.shape[-2]
        return z.reshape(*lead, m, z.shape[-1])
    return ops.redmule_matmul_batched(x, w, **kw)


def _hopper_attention(kind: str, operands, **params) -> torch.Tensor:
    from repro_torch.kernels import flash_attention

    if kind != "attention":
        raise NotImplementedError(f"attention kind {kind!r} is {_ROADMAP}")
    return flash_attention.flash_attention(*operands, **params)


register_backend(
    "hopper", _hopper_fn,
    capabilities=("fused_epilogue", "tiled", "layouts", "attention"),
    attention_fn=_hopper_attention,
    description="hand-written sm_90a CUDA kernels: the RedMulE GEMM (2D and "
                "batched, nn/nt/tn strides, fused bias + activation store) "
                "and causal GQA flash attention; plain PyTorch versions on "
                "CPU tensors")


# --------------------------------------------------------------------- #
# Dispatch helpers
# --------------------------------------------------------------------- #
def _check_policy(policy: prec.Policy) -> None:
    if policy.mixed_storage:
        raise NotImplementedError(
            f"mixed-storage / FP8 policy {policy.name!r} is {_ROADMAP}")


def _pretranspose(x, w, layout: str, backend: str):
    """Operands as an "nn" dispatch for a backend without ``layouts``."""
    if layout == "nn" or get_backend(backend).supports("layouts"):
        return x, w, layout
    if layout == "nt":
        w = w.transpose(-1, -2)
    else:
        x = x.transpose(-1, -2)
    return x, w, "nn"


def _dispatch(spec: GemmSpec, backend: str, x, w, *, bias=None,
              fuse: bool = False) -> torch.Tensor:
    """Emit one event and run one GEMM on compute-dtype operands; the
    result is cast to the policy's output dtype."""
    pol = spec.policy
    x, w, layout = _pretranspose(x.to(pol.compute_dtype),
                                 w.to(pol.compute_dtype), spec.layout, backend)
    if layout != spec.layout:
        spec = dataclasses.replace(spec, layout=layout)
    _emit(spec, backend)
    fn = get_backend(backend).fn
    if fuse:
        return fn(x, w, spec=spec, bias=bias, fuse_epilogue=True).to(pol.out_dtype)
    return fn(x, w, spec=spec).to(pol.out_dtype)


def _static_valid_rows(group_sizes, m: int) -> Optional[int]:
    if group_sizes is None:
        return None
    if isinstance(group_sizes, torch.Tensor):
        group_sizes = group_sizes.cpu().numpy()
    return int(np.clip(np.asarray(group_sizes), 0, m).sum())


def _attn_pairs(s: int, t: int, bq: int, bkv: int, *, causal: bool,
                q_offset: int = 0) -> int:
    """Executed (q-block, kv-block) pairs of one flash sweep (causally dead
    KV blocks are skipped)."""
    s_pad = -(-max(int(s), 1) // bq) * bq
    t_pad = -(-max(int(t), 1) // bkv) * bkv
    if not causal:
        return (s_pad // bq) * (t_pad // bkv)
    return sum(1 for qi in range(s_pad // bq) for ki in range(t_pad // bkv)
               if ki * bkv < q_offset + qi * bq + bq)


def _attention_specs(*, B: int, Hq: int, S: int, T: int, D: int, Dv: int,
                     bq: int, bkv: int, causal: bool, q_offset: int,
                     policy: prec.Policy) -> Tuple[GemmSpec, GemmSpec]:
    """The sweep's score / PV event specs, exactly as the reference bills
    them (``engine.py:1709-1734``): ``groups`` = executed block pairs,
    ``io_bytes`` = Q once per row, K/V once per executed pair, O once."""
    pairs = _attn_pairs(S, T, bq, bkv, causal=causal, q_offset=q_offset)
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
        Output ``(..., M, K)`` in the policy's output dtype."""
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
        spec = GemmSpec(
            op="matmul", tag=tag, m=m, n=n, k=k, batch=math.prod(lead),
            policy=policy, tile=tile or tiling.choose_tiles(m, n, k),
            w_shared=(w.ndim == 2), layout=layout)
        return _dispatch(spec, b, x, w)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               activation: Optional[str] = None, policy=None,
               tile: Optional[tiling.TileConfig] = None,
               backend: Optional[str] = None) -> torch.Tensor:
        """Affine layer ``act(x @ w + b)`` (forward).

        With the ``"fused_epilogue"`` capability the bias and activation run
        on the fp32 accumulator inside the kernel, before its one store;
        other backends get the post-op path (epilogue in the accumulator
        dtype on the GEMM result, then one downcast) — the two agree to
        ~2 ulp of the output dtype, the reference's contract."""
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
        spec = GemmSpec(
            op="linear", tag=tag, m=m, n=n, k=k, batch=math.prod(lead),
            policy=policy, tile=tile or tiling.choose_tiles(m, n, k),
            epilogue=activation, w_shared=(w.ndim == 2))
        has_epilogue = b is not None or activation is not None
        if not has_epilogue:
            return _dispatch(spec, bk, x, w)
        bc = None if b is None else b.to(policy.accum_dtype)
        if get_backend(bk).supports("fused_epilogue"):
            return _dispatch(spec, bk, x, w, bias=bc, fuse=True)
        z = _dispatch(spec, bk, x, w).to(policy.accum_dtype)
        if bc is not None:
            z = z + bc
        return epi.apply_epilogue(activation, z).to(policy.out_dtype)

    def grouped_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                       group_sizes=None, policy=None,
                       tile: Optional[tiling.TileConfig] = None,
                       backend: Optional[str] = None) -> torch.Tensor:
        """Per-group GEMM ``Z[g] = X[g] @ W[g]``: ``x (..., G, M, N)``,
        ``w (G, N, K)``, output ``(..., G, M, K)``.

        ``group_sizes`` (``(G,)`` ints) marks the valid M rows per group:
        rows at or beyond a group's size come back zero, and the event
        bills ``valid_rows = sum(min(size, M))`` instead of ``G * M``."""
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
        spec = GemmSpec(
            op="grouped_matmul", tag="gmn,gnk->gmk", m=m, n=n, k=k,
            batch=math.prod(lead), groups=w.shape[0], policy=policy,
            tile=tile or tiling.choose_tiles(m, n, k), w_shared=True,
            valid_rows=_static_valid_rows(group_sizes, m))
        z = _dispatch(spec, b, x, w)
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
        """Fused scaled-dot-product attention (the kernel path).

        ``q (B, Hq, S, D)``, ``k / v (B, Hkv, T, D)`` with ``Hq % Hkv ==
        0``; ``t_valid`` masks the KV tail, ``q_offset`` is the absolute
        position of query row 0 for the causal mask; rows with no visible
        KV are exact zeros.  Billed as ``attention_score`` /
        ``attention_pv`` events whose ``groups`` count executed
        ``(bq, bkv)`` block pairs; ``bq`` / ``bkv`` default to the flash
        kernel's own tiles (``tiling.FLASH_BQ`` / ``FLASH_BKV``)."""
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
        if not (get_backend(b).supports("attention") and Dv == D):
            raise NotImplementedError(
                f"the reference attention composition is {_ROADMAP}")
        scale = float(D ** -0.5 if scale is None else scale)
        q_offset = int(q_offset)
        t_valid = T if t_valid is None else min(int(t_valid), T)
        bq = int(bq or tiling.FLASH_BQ)
        bkv = int(bkv or tiling.FLASH_BKV)
        for spec in _attention_specs(B=B, Hq=Hq, S=S, T=T, D=D, Dv=Dv, bq=bq,
                                     bkv=bkv, causal=causal,
                                     q_offset=q_offset, policy=policy):
            _emit(spec, b)
        comp = policy.compute_dtype
        out = get_backend(b).attention_fn(
            "attention",
            (q.to(comp).reshape(B * Hq, S, D), k.to(comp).reshape(B * Hkv, T, D),
             v.to(comp).reshape(B * Hkv, T, D)),
            group=Hq // Hkv, causal=causal, scale=scale, bq=bq, bkv=bkv,
            t_valid=t_valid, q_offset=q_offset)
        return out.reshape(B, Hq, S, D).to(policy.out_dtype)


DEFAULT_ENGINE = Engine()


def matmul(x, w, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.matmul(x, w, **kwargs)


def linear(x, w, b=None, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.linear(x, w, b, **kwargs)


def grouped_matmul(x, w, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.grouped_matmul(x, w, **kwargs)


def attention(q, k, v, **kwargs) -> torch.Tensor:
    return DEFAULT_ENGINE.attention(q, k, v, **kwargs)


matmul.__doc__ = Engine.matmul.__doc__
linear.__doc__ = Engine.linear.__doc__
grouped_matmul.__doc__ = Engine.grouped_matmul.__doc__
attention.__doc__ = Engine.attention.__doc__
