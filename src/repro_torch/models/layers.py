"""Primitive layers and the parameter-schema machinery.

Counterpart of ``repro.models.layers``.  A parameter is declared as a
:class:`Param` inside a nested-dict schema; :func:`init_tree` materialises
it with a ``torch.Generator`` seeded per path (adding a parameter never
reshuffles its siblings).  ``jax.random`` and ``torch.Generator`` give
different numbers from one seed, so the tests carry the reference's own
initial parameters across (``repro_torch.convert``) instead.

Weights keep the reference's storage layout: a projection is ``(d_in,
d_out)`` and ``x @ W`` is the GEMM kernel's "nn".  All GEMMs go through
:mod:`repro_torch.core.engine`.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding

__all__ = ["Param", "init_tree", "spec_tree", "abstract_tree", "stack_schema", "rmsnorm", "layernorm",
           "rope", "apply_rope", "activation", "gather_cols", "row_parallel",
           "mlp_glu", "mlp_plain", "cross_entropy"]


@dataclasses.dataclass(frozen=True)
class Param:
    """One parameter: shape, logical sharding axes (one name or None per
    dim; ``runtime/sharding.py`` maps them onto a mesh), initializer
    (proj | he | embed | zeros | ones) and the dim its fan-in is read
    from.  Axes left out are all None.  A leaf with the ``"experts"`` axis
    is a routed expert's weight: ``count_params(active_only=True)`` counts
    only ``top_k`` of ``n_routed`` of it."""

    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "proj"
    fan_in_dim: int = -2

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def experts(self) -> bool:
        return "experts" in self.axes


# a stacked leaf (>= 3 dims) above this many elements is drawn one slice of
# its leading dim at a time: the fp32 draw and its scaled copy are then one
# slice, not the whole leaf (deepseek-v2-lite-16b's stacked expert w_in is
# 9.6e9 elements: 38 GB in fp32, twice over, beside the 31 GB bf16 model)
SLICE_DRAW_ELEMS = 1 << 30


def _path_seed(seed: int, path: Tuple[str, ...]) -> int:
    """Deterministic across processes (Python's hash() is salted).  The
    seed enters the low 32 bits (a CPU generator's Mersenne twister reads
    only those) and the high ones (CUDA's Philox reads all 64); seed 0
    gives the path's CRC alone."""
    s = int(seed)
    crc = zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF
    return crc ^ ((s * 0x9E3779B1) & 0xFFFFFFFF) ^ (s << 32)


def init_tree(schema: Dict[str, Any], *, seed: int, device: torch.device,
              dtype: torch.dtype, place=None) -> Dict[str, Any]:
    """Materialise a schema on ``device``: normal * fan_in^-0.5 for
    projections, normal * (2 / fan_in)^0.5 for He init, normal * 0.02 for
    embeddings, drawn in fp32 and cast to ``dtype``.  A stacked leaf above
    :data:`SLICE_DRAW_ELEMS` is drawn slice by slice along its leading dim,
    slice ``i`` from the seed of its path extended by ``i``.  ``place(path,
    leaf)`` (a sharded init) maps each whole leaf, as soon as it is drawn,
    to what is kept of it, so no more than one whole leaf lives beside the
    kept ones."""
    gen = torch.Generator(device=device)
    keep = place or (lambda path, x: x)

    def draw(shape, path, scale):
        gen.manual_seed(_path_seed(seed, path))
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def go(node, path):
        if isinstance(node, Param):
            return keep(path, leaf(node, path))
        return {k: go(v, path + (k,)) for k, v in node.items()}

    def leaf(node, path):
        if node.init == "zeros":
            return torch.zeros(node.shape, dtype=dtype, device=device)
        if node.init == "ones":
            return torch.ones(node.shape, dtype=dtype, device=device)
        if node.init == "embed":
            scale = 0.02
        else:
            fan_in = node.shape[node.fan_in_dim] if node.shape else 1
            scale = (2.0 / fan_in) ** 0.5 if node.init == "he" else fan_in ** -0.5
        if len(node.shape) < 3 or math.prod(node.shape) <= SLICE_DRAW_ELEMS:
            return draw(node.shape, path, scale)
        out = torch.empty(node.shape, dtype=dtype, device=device)
        for i in range(node.shape[0]):
            out[i] = draw(node.shape[1:], path + (str(i),), scale)
        return out

    return go(schema, ())


def spec_tree(schema: Dict[str, Any], rules):
    """The schema's tree of logical specs under ``rules`` (``P()`` for
    every leaf without rules)."""

    def go(node):
        if isinstance(node, Param):
            return sharding.logical_spec(node.axes, rules) if rules else sharding.P()
        return {k: go(v) for k, v in node.items()}

    return go(schema)


def abstract_tree(schema: Dict[str, Any], dtype=torch.float32):
    """The schema as meta tensors (shape and dtype, no storage; a
    description, which no dry-run memory tracker counts)."""
    from repro_torch.roofline.memory import described

    def go(node):
        if isinstance(node, Param):
            return torch.empty(node.shape, dtype=dtype, device="meta")
        return {k: go(v) for k, v in node.items()}

    with described():
        return go(schema)


def stack_schema(schema: Dict[str, Any], n: int, axis_name: str = "layers"
                 ) -> Dict[str, Any]:
    """Prepend a stacked-layers dimension to every Param."""

    def go(node):
        if isinstance(node, Param):
            fd = node.fan_in_dim if node.fan_in_dim < 0 else node.fan_in_dim + 1
            return Param(shape=(n, *node.shape), axes=(axis_name, *node.axes),
                         init=node.init, fan_in_dim=fd)
        return {k: go(v) for k, v in node.items()}

    return go(schema)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in fp32, application in the activation dtype — the
    reference's dtype order (``layers.py:129-135``)."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance (E[x²] - E[x]²) in fp32, application in the
    activation dtype, op for op as the reference (``layers.py:138-148``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mu.square()
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype) * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default form
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def rope(positions: torch.Tensor, dim: int, theta: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., dim/2), in fp32."""
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=positions.device) / dim)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D); cos/sin (B, S, D/2) or (S, D/2); rotated in fp32."""
    if cos.ndim == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _tp(shard, n: int) -> bool:
    """Whether a dim of ``n`` is cut over the model axis of ``shard``."""
    return shard is not None and shard.model > 1 and n % shard.model == 0


def gather_cols(y: torch.Tensor, n: int, shard) -> torch.Tensor:
    """A column-parallel GEMM's output ``y (..., n / model)`` made whole
    (all-gathered over the model axis); ``y`` when it already is."""
    if shard is None or y.shape[-1] == n:
        return y
    return coll.all_gather(y, shard.mesh, sharding.MODEL_AXIS, -1)


def row_parallel(o: torch.Tensor, w: torch.Tensor, n_rows: int, *, policy,
                 shard) -> torch.Tensor:
    """``o @ w`` for a ``w`` of ``n_rows`` rows cut over the model axis by
    its ``("ff" | "heads", "embed")`` spec, handed back in the stream's
    layout (``ShardCtx.leave``).  A cut ``w`` takes this rank's block of
    ``o``'s columns (all of them when ``o`` holds only this rank's block)
    and the partial products are summed; a whole ``w`` gives every rank
    the whole product."""
    if shard is None:
        return engine.matmul(o, w, policy=policy)
    n = w.shape[0]
    if n != n_rows and o.shape[-1] != n:
        o = o[..., shard.model_index * n:(shard.model_index + 1) * n]
    return shard.leave(engine.matmul(o, w, policy=policy), partial=n != n_rows)


def mlp_glu(params: Dict[str, torch.Tensor], x: torch.Tensor, *, act: str,
            policy, shard=None, ff: Optional[int] = None) -> torch.Tensor:
    """Gated MLP ``(act(x @ w_gate) * (x @ w_up)) @ w_down``; ``w_in``
    holds gate and up side by side as one ``(d, 2 * ff)`` GEMM.

    On a mesh (``shard``, with the global width ``ff``) ``w_in``'s fused
    columns are cut contiguously, as the reference's ``("embed", "ff")``
    spec cuts them: with two ranks rank 0 holds every gate column and rank
    1 every up column.  One all-to-all gives each rank the gate and up
    columns of its own ff block, the block of ``w_out``'s ``("ff",
    "embed")`` rows it holds; the partial products are summed after (under
    sequence parallelism: reduce-scattered over the positions, the input
    gathered over them first)."""
    if shard is not None:
        x = shard.enter(x)
    h = engine.matmul(x, params["w_in"], policy=policy)
    if _tp(shard, ff):
        h = coll.redistribute_last(
            h, shard.mesh, sharding.MODEL_AXIS, coll.blocks(2 * ff, shard.model),
            coll.segment_blocks((ff, ff), shard.model))
    elif shard is not None:
        h = gather_cols(h, 2 * ff, shard)
    gate, up = h.chunk(2, dim=-1)
    y = engine.matmul(activation(gate, act) * up, params["w_out"], policy=policy)
    return y if shard is None else shard.leave(y, partial=_tp(shard, ff))


def mlp_plain(params: Dict[str, torch.Tensor], x: torch.Tensor, *, act: str,
              policy, shard=None, ff: Optional[int] = None) -> torch.Tensor:
    """Plain MLP ``act(x @ w_in) @ w_out`` as the reference's attention
    block writes it (``transformer.py:202-207``): the activation rides in
    the ``linear`` dispatch (kernel 1's fused epilogue; under autograd its
    derivative is fused into the backward launches).  On a mesh the ff
    columns and rows are cut alike and the partial products summed."""
    if shard is not None:
        x = shard.enter(x)
    h = engine.linear(x, params["w_in"], activation=act, policy=policy)
    y = engine.matmul(h, params["w_out"], policy=policy)
    return y if shard is None else shard.leave(y, partial=_tp(shard, ff))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE in fp32; labels < 0 are masked out
    (``layers.py:197-209`` of the reference)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    return loss, {"loss": loss, "ntokens": denom}
