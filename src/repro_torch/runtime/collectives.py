"""Collectives over one axis of a mesh of ranks, differentiable.

The port's counterpart of the collectives GSPMD inserts for the
reference (``jax.lax.psum`` / ``all_gather`` / ``all_to_all`` and the
layout changes behind ``sharding.constrain``).  Each is a
``torch.autograd.Function`` whose backward is the transpose JAX would
give it: a sum's is a sum, a gather's a sum then this rank's block, an
all-to-all's the inverse all-to-all.  Gradients follow JAX's convention
for values replicated over an axis: each rank holds a share and the
gradient is their sum, so a train step seeds its backward with ``1 /
model`` and sums a replicated leaf's gradient over the axes it is
replicated on (``launch/train.py``).

The group is gloo, one sub-group per mesh axis (``launch/mesh.py``).  On
one card every rank runs on ``cuda:0`` and NCCL refuses two ranks on a
device, so each collective copies its operand to the host, runs there
and copies the result back: these times are those of a layout check, not
of tensor parallelism.  Data moves as raw bytes (any dtype, FP8
included); sums and maxima run in fp32 (fp64 stays fp64).  An axis of
size 1 makes every collective the identity.

:data:`STATS` counts each kind's calls, payload bytes (what this rank
sends) and host seconds; :func:`reset_stats` clears it.

:func:`dry_run` is the dry run's recording context (``launch/dryrun.py``):
inside it a mesh needs no process group (a description mesh will do),
every collective takes meta tensors only, records one entry (kind, axis,
group size, payload bytes as :data:`STATS` counts them, this rank's result
bytes, and where its group lies) and returns an empty meta tensor of its
result's shape; the backwards record theirs the same way.  Outside it
nothing changes: a description mesh raises, as it always has.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["psum", "pmax", "pmax_over", "pmean", "all_gather", "psum_scatter", "all_to_all",
           "redistribute_last", "STATS", "reset_stats", "dry_run", "dry_trace",
           "dry_contract", "DryCollective", "NODE_SIZE"]

STATS: Dict[str, Dict[str, float]] = {}

# cards per NVLink node (an 8-GPU HGX / DGX H100 board)
NODE_SIZE = 8


def reset_stats() -> None:
    STATS.clear()


# --------------------------------------------------------------------- #
# The dry run: record, do not run
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DryCollective:
    """One collective a dry-run rank would run: ``kind`` as :data:`STATS`
    names it, the mesh ``axis`` and its ``group_size``, the ``payload``
    bytes :data:`STATS` counts, this rank's ``result_bytes`` and whether
    the group stays inside one NVLink node (``intra_node``)."""

    kind: str
    axis: str
    group_size: int
    payload: int
    result_bytes: int
    intra_node: bool


@dataclasses.dataclass(frozen=True)
class _DryGroup:
    """The stand-in for a process group inside :func:`dry_run`."""

    axis: str
    size: int
    intra_node: bool


# the active dry runs, innermost last: (entries, contract)
_DRY: List[Tuple[List[DryCollective], str]] = []
CONTRACTS = ("card", "cpu")


def dry_trace() -> Optional[List[DryCollective]]:
    """The entries of the innermost active :func:`dry_run`, else None."""
    return _DRY[-1][0] if _DRY else None


def dry_contract() -> Optional[str]:
    """The contract of the innermost active :func:`dry_run`, else None."""
    return _DRY[-1][1] if _DRY else None


@contextlib.contextmanager
def dry_run(contract: str = "card"):
    """Record the collectives run in the context instead of running them
    (see the module docstring); yields the list of :class:`DryCollective`
    entries.  Process-wide, so a backward run by another thread records
    into it too.  ``contract`` is the run it predicts: ``"card"`` holds
    meta tensors to the CUDA kernels' contract (the kernel wrappers'
    checks), ``"cpu"`` to the plain versions' (none: a CPU run takes any
    head size or dtype the plain versions take)."""
    if contract not in CONTRACTS:
        raise ValueError(f"dry-run contract {contract!r}; known: {CONTRACTS}")
    entries: List[DryCollective] = []
    item = (entries, contract)
    _DRY.append(item)
    try:
        yield entries
    finally:
        _DRY.remove(item)


def _intra_node(mesh, axis: str) -> bool:
    """True when this rank's line along ``axis`` lies inside one node of
    :data:`NODE_SIZE` consecutive ranks (row-major rank order, as
    ``launch.mesh.make_mesh`` lays the ranks out)."""
    names = list(mesh.shape)
    stride = math.prod(mesh.shape[a] for a in names[names.index(axis) + 1:])
    coord = mesh.coords.get(axis, 0)
    first = mesh.rank - coord * stride
    last = first + (mesh.shape[axis] - 1) * stride
    return first // NODE_SIZE == last // NODE_SIZE


def _dry(kind: str, group: _DryGroup, x: torch.Tensor, payload: int,
         out_shape, result_bytes: Optional[int] = None) -> torch.Tensor:
    """Record one entry and return the empty meta result (``result_bytes``:
    the rank's part of it where that is less, a scatter's block)."""
    if x.device.type != "meta":
        raise ValueError(f"the dry run takes meta tensors; {kind} got one on "
                         f"{x.device}")
    out = x.new_empty(tuple(out_shape))
    with _record(kind, payload):
        _DRY[-1][0].append(DryCollective(
            kind=kind, axis=group.axis, group_size=group.size, payload=int(payload),
            result_bytes=(out.numel() * out.element_size() if result_bytes is None
                          else int(result_bytes)),
            intra_node=group.intra_node))
    return out


@contextlib.contextmanager
def _record(kind: str, nbytes: int):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = STATS.setdefault(kind, {"count": 0, "bytes": 0, "seconds": 0.0})
        s["count"] += 1
        s["bytes"] += int(nbytes)
        s["seconds"] += time.perf_counter() - t0


def _dist():
    import torch.distributed as dist
    return dist


def _group(mesh, axis: str):
    """``(group, size, index)`` of this rank along ``axis`` (inside
    :func:`dry_run` the group is a recording stand-in)."""
    n, idx = mesh.shape.get(axis, 1), mesh.coords.get(axis, 0)
    if _DRY and n > 1:
        return _DryGroup(axis, n, _intra_node(mesh, axis)), n, idx
    return mesh.group(axis), n, idx


def _reduce(x: torch.Tensor, group, op: str, kind: str) -> torch.Tensor:
    if isinstance(group, _DryGroup):
        nbytes = x.numel() * x.element_size()
        return _dry(kind, group, x, nbytes, x.shape,
                    nbytes // group.size if kind == "psum_scatter" else None)
    dist = _dist()
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    with _record(kind, x.numel() * x.element_size()):
        # a copy, always: the reduction runs in place, and autograd hands
        # one gradient buffer to several consumers
        h = x.detach().to("cpu", wide, copy=True).contiguous()
        dist.all_reduce(h, op=getattr(dist.ReduceOp, op), group=group)
        return h.to(x.device, x.dtype)


def _bytes_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, ...) on the host as ``(rows, row_bytes)`` uint8."""
    h = x.detach().to("cpu").contiguous()
    row = math.prod(h.shape[1:]) * h.element_size()
    return h.reshape(-1).view(torch.uint8).reshape(h.shape[0], row)


def _a2a_rows(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
              group, kind: str) -> torch.Tensor:
    """All-to-all of ``x``'s leading rows: ``send[s]`` consecutive rows go
    to rank s of the group; returns the rows received, source by source,
    on ``x``'s device."""
    rest = tuple(x.shape[1:])
    if isinstance(group, _DryGroup):
        return _dry(kind, group, x, x.numel() * x.element_size(), (sum(recv), *rest))
    dist = _dist()
    with _record(kind, x.numel() * x.element_size()):
        h = _bytes_rows(x)
        out = torch.empty((sum(recv), h.shape[1]), dtype=torch.uint8)
        dist.all_to_all_single(out, h, list(recv), list(send), group=group)
        return out.view(x.dtype).reshape(sum(recv), *rest).to(x.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group, "SUM", "psum")

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, "SUM", "psum"), None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis``; backward sums the cotangent."""
    group, n, _ = _group(mesh, axis)
    return x if n == 1 else _PSum.apply(x, group)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    n = mesh.shape.get(axis, 1)
    return x if n == 1 else psum(x, mesh, axis) / n


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Maximum over ``axis``, not differentiated (a softmax shift)."""
    group, n, _ = _group(mesh, axis)
    return x.detach() if n == 1 else _reduce(x, group, "MAX", "pmax")


def pmax_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Maximum over every axis of ``axes`` (the ones the mesh has), not
    differentiated; a NaN counts as +inf, so a non-finite element on any
    rank stays non-finite everywhere (gloo's MAX keeps or drops a NaN by
    operand order)."""
    x = torch.nan_to_num(x.detach(), nan=math.inf, posinf=math.inf, neginf=-math.inf)
    for a in axes:
        x = pmax(x, mesh, a)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.dim, ctx.group, ctx.idx, ctx.size = dim, group, idx, x.shape[dim]
        if isinstance(group, _DryGroup):
            shape = list(x.shape)
            shape[dim] *= n
            return _dry("all_gather", group, x, x.numel() * x.element_size(), shape)
        dist = _dist()
        with _record("all_gather", x.numel() * x.element_size()):
            h = _bytes_rows(x.movedim(dim, 0))
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            full = torch.cat(parts).view(x.dtype)
            moved = x.movedim(dim, 0).shape
            full = full.reshape(n * moved[0], *moved[1:]).movedim(0, dim)
            return full.to(x.device)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, ctx.group, "SUM", "psum")
        return g.narrow(ctx.dim, ctx.idx * ctx.size, ctx.size), None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in axis order (JAX's
    tiled ``all_gather``); backward: the summed cotangent's own block."""
    group, n, idx = _group(mesh, axis)
    return x if n == 1 else _AllGather.apply(x, dim % x.ndim, group, n, idx)


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.dim, ctx.group, ctx.n, ctx.idx = dim, group, n, idx
        size = x.shape[dim] // n
        return _reduce(x, group, "SUM", "psum_scatter").narrow(dim, idx * size, size)

    @staticmethod
    def backward(ctx, g):
        return (_AllGather.apply(g, ctx.dim, ctx.group, ctx.n, ctx.idx),
                None, None, None, None)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over ``axis``, of which this rank keeps its contiguous block
    of ``dim`` (JAX's tiled ``psum_scatter``; on gloo an all-reduce and a
    narrow); backward: the all-gather of the cotangent."""
    group, n, idx = _group(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    return _PSumScatter.apply(x, dim % x.ndim, group, n, idx)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        rows = [x.shape[0] // n] * n
        return _a2a_rows(x, rows, rows, group, "all_to_all")

    @staticmethod
    def backward(ctx, g):
        rows = [g.shape[0] // ctx.n] * ctx.n
        return _a2a_rows(g, rows, rows, ctx.group, "all_to_all"), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x (n, ...)``: slice s goes to rank s, and slice s of the result
    came from rank s (JAX's tiled ``all_to_all`` with split and concat on
    axis 0); its own transpose."""
    group, n, _ = _group(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all wants a leading dim of {n}, got {x.shape[0]}")
    return _AllToAll.apply(x, group, n)


# --------------------------------------------------------------------- #
# Redistributing the blocks of one dim
# --------------------------------------------------------------------- #
Intervals = Tuple[Tuple[int, int], ...]


def _cut(a: Intervals, b: Intervals) -> List[Tuple[int, int]]:
    out = []
    for s0, e0 in a:
        for s1, e1 in b:
            s, e = max(s0, s1), min(e0, e1)
            if s < e:
                out.append((s, e))
    return sorted(out)


def _local(layout: Intervals, s: int, e: int) -> Tuple[int, int]:
    """Where global ``[s, e)`` lies in a rank's local concatenation."""
    off = 0
    for a, b in layout:
        if a <= s and e <= b:
            return off + s - a, off + e - a
        off += b - a
    raise ValueError(f"[{s}, {e}) is not held by {layout}")


def _exchange(x: torch.Tensor, src: Sequence[Intervals], dst: Sequence[Intervals],
              me: int, group) -> torch.Tensor:
    """``x``'s leading dim holds ``src[me]``; return ``dst[me]``."""
    n = len(src)
    send_pieces = [_cut(src[me], dst[s]) for s in range(n)]
    recv_pieces = [_cut(src[r], dst[me]) for r in range(n)]
    rows = []
    for pieces in send_pieces:
        for s, e in pieces:
            a, b = _local(src[me], s, e)
            rows.append(x[a:b])
    send = [sum(e - s for s, e in p) for p in send_pieces]
    recv = [sum(e - s for s, e in p) for p in recv_pieces]
    got = _a2a_rows(torch.cat(rows) if rows else x[:0], send, recv, group,
                    "redistribute")
    out = torch.empty((sum(e - s for s, e in dst[me]), *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    off = 0
    for pieces in recv_pieces:
        for s, e in pieces:
            a, b = _local(dst[me], s, e)
            out[a:b] = got[off:off + e - s]
            off += e - s
    return out


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, me, group):
        ctx.plan = (src, dst, me, group)
        return _exchange(x.movedim(-1, 0), src, dst, me, group).movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        src, dst, me, group = ctx.plan
        gx = _exchange(g.movedim(-1, 0), dst, src, me, group).movedim(0, -1)
        return gx, None, None, None, None


def redistribute_last(x: torch.Tensor, mesh, axis: str, src: Sequence[Intervals],
                      dst: Sequence[Intervals]) -> torch.Tensor:
    """Move the last dim from one partition to another inside the
    ``axis`` group: rank r holds the global indices ``src[r]`` (a tuple of
    ``[start, stop)`` intervals, concatenated in order) and gets
    ``dst[r]``.  One all-to-all; its backward is the inverse one."""
    group, n, me = _group(mesh, axis)
    if n == 1:
        return x
    return _Redistribute.apply(x, tuple(src), tuple(dst), me, group)


def blocks(n_global: int, n: int) -> List[Intervals]:
    """The contiguous partition of ``[0, n_global)`` into ``n`` blocks."""
    b = n_global // n
    return [((r * b, (r + 1) * b),) for r in range(n)]


def segment_blocks(sizes: Sequence[int], n: int) -> List[Intervals]:
    """Rank r's block of every segment of a fused dim (segments of
    ``sizes`` laid side by side, each cut into ``n`` contiguous blocks):
    the layout that puts a fused ``[q | k | v]`` or ``[gate | up]``
    column block's own heads / rows on each rank."""
    out = []
    for r in range(n):
        ivs, start = [], 0
        for size in sizes:
            b = size // n
            ivs.append((start + r * b, start + (r + 1) * b))
            start += size
        out.append(tuple(ivs))
    return out
