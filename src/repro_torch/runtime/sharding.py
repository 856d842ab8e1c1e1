"""Logical-axis sharding rules (DP / TP / EP / SP / FSDP).

Counterpart of ``repro.runtime.sharding``.  Model code names the axes of
its parameters and caches logically ("batch", "embed", "heads",
"experts", ...); :class:`Rules` maps them onto the mesh axes ``("pod",
"data", "model")`` of ``launch/mesh.py``:

* DP   — "batch" over ``("pod", "data")``;
* TP   — "heads" / "ff" / "vocab" over ``"model"``;
* EP   — "experts" over ``"model"``;
* SP   — "seq_sharded" over ``"model"`` when ``sequence_parallel``;
* FSDP — "embed" also over ``("pod", "data")`` when ``fsdp``.

:func:`logical_spec`, :func:`sanitize_spec` and the rule table are the
reference's, value for value: a spec is a :class:`PartitionSpec`, a plain
tuple of mesh-axis names (or tuples of them, or None) per dim.

Execution differs from the reference's.  There, GSPMD partitions one
global program and ``constrain`` pins an intermediate's layout.  Here each
rank of a process group holds plain local tensors (the block of every dim
a spec cuts, at the rank's mesh coordinate), runs the kernels on them, and
the model code calls the collectives of ``runtime/collectives.py`` where
the layout changes.  So :func:`constrain` and its variants return their
input unchanged: outside a rules context and on a one-rank mesh they are
the reference's no-op, and on a mesh the layout they would pin is the one
the surrounding code has already built.  Under FSDP a block all-gathers
its layer's data-cut weights inside its remat region (:func:`gather_over`;
the backward is the reduce-scatter), and under sequence parallelism the
residual stream holds the rank's positions between blocks
(:meth:`ShardCtx.enter` / :meth:`ShardCtx.leave`, Megatron's gather
before the column-parallel GEMMs and reduce-scatter after the row-parallel
ones).

Rules and the mesh live in thread-local contexts (:func:`use_rules`,
:func:`use_mesh`).  The model entry points read them once, into a
:class:`ShardCtx` (:func:`context`), and hand that down explicitly, so a
remat recompute run by the autograd thread sees the forward's layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.runtime import collectives as coll

__all__ = [
    "PartitionSpec", "P", "Rules", "use_rules", "current_rules", "use_mesh",
    "current_mesh", "logical_spec", "sanitize_spec", "constrain",
    "constrain_fb", "constrain_both", "DATA_AXES", "MODEL_AXIS", "ShardCtx",
    "context", "with_sequence", "gather_over", "local_shape", "shard_block",
    "sanitize_tree", "spec_leaves", "axes_of", "refuse",
]

DATA_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"
ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names, or
    None (replicated); trailing dims not listed are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axes mapping."""

    fsdp: bool = False
    sequence_parallel: bool = False
    # decode-time: attention reads the sequence-sharded KV layout
    serve_attention: bool = False
    # overrides win over the built-in table
    overrides: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = ()

    def table(self) -> Dict[Optional[str], Optional[Tuple[str, ...]]]:
        t: Dict[Optional[str], Optional[Tuple[str, ...]]] = {
            "batch": DATA_AXES,
            "seq": None,
            "seq_sharded": (MODEL_AXIS,) if self.sequence_parallel else None,
            "embed": DATA_AXES if self.fsdp else None,
            "embed_unsharded": None,
            "vocab": (MODEL_AXIS,),
            "heads": (MODEL_AXIS,),
            "kv_heads": (MODEL_AXIS,),
            "head_dim": None,
            "ff": (MODEL_AXIS,),
            "experts": (MODEL_AXIS,),
            "expert_ff": None,
            "kv_rank": None,
            # the decode KV cache's sequence dim; serve rules map it to
            # ("model",) (KV heads rarely divide the model axis)
            "kv_seq": None,
            "state": None,
            "layers": None,
            "ae_hidden": None,
            None: None,
        }
        t.update(dict(self.overrides))
        return t


_state = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    old = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = old


def current_mesh():
    """The mesh of :func:`use_mesh` (``launch.mesh.Mesh``), or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    old = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = old


def logical_spec(axes: Tuple[Optional[str], ...],
                 rules: Optional[Rules] = None) -> PartitionSpec:
    """Translate logical axis names to a spec under the rules (a mesh axis
    is claimed by the first logical axis that names it)."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return P()
    table = rules.table()
    parts = []
    used: set = set()
    for a in axes:
        mesh_axes = table.get(a)
        if mesh_axes is None:
            parts.append(None)
            continue
        free = tuple(m for m in mesh_axes if m not in used)
        used.update(free)
        parts.append(free if len(free) != 1 else free[0])
        if not free:
            parts[-1] = None
    return P(*parts)


def _filter_known(part, mesh):
    """Drop mesh-axis names the mesh does not have (e.g. 'pod' on one pod)."""
    if part is None:
        return None
    if isinstance(part, tuple):
        kept = tuple(n for n in part if n in mesh.shape)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept
    return part if part in mesh.shape else None


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def sanitize_spec(spec, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Drop mesh axes the mesh does not define, and entries that do not
    divide their dim (e.g. 5 KV heads on a 16-way model axis replicate).
    Reads only ``mesh.shape`` (a name -> size mapping)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        part = _filter_known(part, mesh)
        if part is None:
            out.append(None)
        elif dim % _axis_size(mesh, part) == 0:
            out.append(part)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def constrain(x, *axes: Optional[str]):
    """The reference's ``with_sharding_constraint`` under the rules.  The
    port's tensors are already in the layout the model code built (see the
    module docstring), so this returns ``x``."""
    return x


def constrain_fb(x, fwd_axes: Tuple[Optional[str], ...],
                 bwd_axes: Optional[Tuple[Optional[str], ...]] = None):
    """Constrain the value and its cotangent (reference signature); ``x``."""
    return constrain(x, *fwd_axes)


def constrain_both(x, *axes: Optional[str]):
    """Constrain the value and its cotangent to one layout; ``x``."""
    return constrain_fb(x, axes)


# --------------------------------------------------------------------- #
# Local blocks of a spec
# --------------------------------------------------------------------- #
def _parts(spec, ndim: int) -> Tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def axes_of(part) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def sanitize_tree(spec_tree, shape_tree, mesh):
    """:func:`sanitize_spec` over a tree of specs and one of shapes (dicts
    of ``PartitionSpec`` / tensors with a ``.shape``)."""
    if isinstance(spec_tree, PartitionSpec):
        return sanitize_spec(spec_tree, tuple(shape_tree.shape), mesh)
    return {k: sanitize_tree(spec_tree[k], shape_tree[k], mesh) for k in spec_tree}


def spec_leaves(specs) -> list:
    """A spec tree's ``PartitionSpec`` leaves in the order of
    ``checkpoint.tree_flatten`` (dict keys sorted; NamedTuples in field
    order)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def local_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    """This rank's block shape of a (sanitized) spec on ``mesh``."""
    return tuple(d // math.prod(mesh.shape[n] for n in axes_of(p))
                 for d, p in zip(shape, _parts(spec, len(shape))))


def _block_index(part, mesh) -> int:
    """The rank's block along a dim cut over ``part`` (row-major over the
    named axes, as a device mesh flattens them)."""
    idx = 0
    for n in axes_of(part):
        idx = idx * mesh.shape[n] + mesh.coords[n]
    return idx


def shard_block(x, spec, mesh):
    """The rank's contiguous block of every dim the spec cuts (what
    ``jax.device_put(x, NamedSharding(mesh, spec))`` leaves on a device)."""
    out = x
    for dim, part in enumerate(_parts(spec, x.ndim)):
        n = math.prod(mesh.shape[a] for a in axes_of(part))
        if n > 1:
            size = x.shape[dim] // n
            out = out.narrow(dim, _block_index(part, mesh) * size, size)
    return out


# --------------------------------------------------------------------- #
# The execution context handed down the model
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Rules and mesh of a sharded run, as the model code reads them.

    ``seq`` is the global sequence length while the residual stream is cut
    over it (sequence parallelism: ``"seq_sharded"`` over the model axis,
    the rank holding its contiguous block of positions), else 0.  A block
    takes its input through :meth:`enter` (the whole sequence, for the
    column-parallel GEMMs) and hands its output back through :meth:`leave`
    (the rank's positions again)."""

    rules: Rules
    mesh: Any
    seq: int = 0

    @property
    def model(self) -> int:
        return self.mesh.shape.get(MODEL_AXIS, 1)

    @property
    def model_index(self) -> int:
        return self.mesh.coords.get(MODEL_AXIS, 0)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.mesh.shape)

    @property
    def data(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    def block(self, n_global: int, n_local: int) -> Optional[int]:
        """The start of this rank's block of a dim of ``n_global`` held as
        ``n_local`` (cut over ``model``), or None when it is whole."""
        if n_local == n_global:
            return None
        if n_local * self.model != n_global:
            raise ValueError(f"a local dim of {n_local} is no model block "
                             f"of {n_global} on a {self.model}-way model axis")
        return self.model_index * n_local

    def enter(self, x):
        """``x (B, S', ...)`` over the whole sequence: all-gathered over the
        model axis when it holds this rank's positions (Megatron's gather
        before a column-parallel GEMM); as it is otherwise."""
        if self.seq and x.shape[1] != self.seq:
            return coll.all_gather(x, self.mesh, MODEL_AXIS, 1)
        return x

    def leave(self, y, partial: bool):
        """A block's output ``y (B, S, ...)`` in the stream's layout.
        ``partial``: each rank holds a partial sum (a row-parallel GEMM's,
        a vocab block's lookup), summed over the model axis — and, under
        sequence parallelism, scattered over the positions.  Otherwise
        ``y`` is replicated and the rank keeps its positions."""
        if partial:
            if self.seq:
                return coll.psum_scatter(y, self.mesh, MODEL_AXIS, 1)
            return coll.psum(y, self.mesh, MODEL_AXIS)
        if self.seq and y.shape[1] == self.seq:
            n = self.seq // self.model
            return y.narrow(1, self.model_index * n, n)
        return y


def context() -> Optional[ShardCtx]:
    """The active sharded run: rules and a mesh of more than one rank set,
    else None (the reference's no-op outside a mesh)."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or mesh.size <= 1:
        return None
    return ShardCtx(rules, mesh)


def with_sequence(sh: Optional[ShardCtx], seq_len: int) -> Optional[ShardCtx]:
    """``sh`` for a stream of ``seq_len`` positions: cut over them under
    sequence parallelism when the model axis divides them (the reference's
    ``sanitize_spec`` drops the cut otherwise: a decode step, an odd
    prompt)."""
    if sh is None:
        return None
    m = sh.model
    cut = sh.rules.sequence_parallel and m > 1 and seq_len % m == 0
    return dataclasses.replace(sh, seq=seq_len if cut else 0)


def gather_over(tree, specs, mesh, axes: Tuple[str, ...], lead: int = 0):
    """Every dim of every leaf that its spec cuts over one of ``axes``,
    all-gathered (inside autograd: the backward sums the cotangent over
    those axes and keeps the rank's block, a reduce-scatter).  ``lead``
    spec entries are skipped: a stacked tree's spec read for one layer's
    slice."""
    if isinstance(tree, torch.Tensor):
        x = tree
        for dim, part in enumerate(tuple(specs)[lead:]):
            names = axes_of(part)
            if any(a in axes for a in names) and any(a not in axes for a in names):
                raise NotImplementedError(f"a dim cut over {names} gathered over "
                                          f"{axes} alone")
            # the innermost named axis varies fastest along the dim
            for ax in reversed(names):
                if ax in axes:
                    x = coll.all_gather(x, mesh, ax, dim)
        return x
    return {k: gather_over(v, specs[k], mesh, axes, lead) for k, v in tree.items()}


def refuse(what: str) -> None:
    raise NotImplementedError(f"{what} under a mesh is {ROADMAP}")
