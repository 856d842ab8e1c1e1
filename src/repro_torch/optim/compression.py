"""Gradient compression with error feedback, for the data-parallel wire.

Counterpart of ``repro.optim.compression`` (``compression.py:62-275``).
Each rank compresses its gradients plus an fp32 error-feedback residual
before the all-reduce and keeps the quantization residual for the next
step (EF-SGD).  The wires:

* ``none`` — fp32;
* ``fp16`` — a plain downcast, reduced on the 16-bit dtype;
* ``int8`` — a symmetric per-tensor scale, quantized to ±127;
* ``fp8_e4m3`` (``fp8`` is an alias) and ``fp8_e5m2`` — quantized through
  ``core.precision.quantize_fp8`` under **delayed scaling**: a per-leaf
  :class:`~repro_torch.optim.scale.Fp8ScaleState` window supplies the
  scale, the value is clipped at the format's max times that scale, and
  the residual (clipped mass included) lands in the error feedback.

Scaled wires (int8 / FP8) reduce the per-rank dequantized terms ``q_i ·
s_i`` in fp32, so a rank with tiny gradients is never reweighted by
another's scale; :meth:`Compressor.wire_bytes` prices the wire that a ring
all-reduce of the 8-bit payload would move (one fp32 scale per tensor
added), analytically.

The all-reduce runs over a ``torch.distributed`` group (gloo, one process
per data-parallel rank; ``runtime/procs.py``): every wire of one dtype is
packed into one flat host buffer, reduced once and split back, so the
rank's device tensors cross to the host once a step.  Without an
initialised group the world is one rank and the reduce is the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import precision as prec
from repro_torch.optim.optimizer import tree_map
from repro_torch.optim.scale import (Fp8ScaleState, fp8_scale_of, init_fp8_scale,
                                     update_fp8_scale)

__all__ = ["Compressor", "Fp8LeafState", "collective_wire_bytes",
           "compressed_mean_allreduce", "all_reduce_sum",
           "NONE", "FP16", "INT8", "FP8_E4M3", "FP8_E5M2", "KINDS"]

KINDS = ("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2")

_WIRE_BITS = {"none": 32, "fp16": 16, "int8": 8, "fp8_e4m3": 8, "fp8_e5m2": 8}
_FP8_DTYPES = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


class Fp8LeafState(NamedTuple):
    """Per-leaf state of an FP8 wire: the fp32 error-feedback buffer and
    the delayed-scaling window the next quantization reads."""
    ef: torch.Tensor
    scale: Fp8ScaleState


def _map(fn, tree, *rest):
    """``fn`` over the leaves of dict trees whose leaves may be tuples
    (wire pairs, ``Fp8LeafState``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _world(group) -> int:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum each tensor over the group's ranks, returned in its own dtype on
    its own device.  Tensors of one dtype are packed into one flat host
    buffer and reduced once (gloo); one rank returns them unchanged."""
    if _world(group) == 1:
        return list(tensors)
    import torch.distributed as dist
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dt in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        flat = torch.cat([tensors[i].reshape(-1).cpu() for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[off:off + t.numel()].reshape(t.shape).to(t.device)
            off += t.numel()
    return out


@dataclasses.dataclass(frozen=True)
class Compressor:
    kind: str = "none"  # none | fp16 | int8 | fp8[_e4m3] | fp8_e5m2
    history_len: int = 16  # delayed-scaling window (fp8 kinds)

    def __post_init__(self):
        kind = "fp8_e4m3" if self.kind == "fp8" else self.kind
        if kind not in KINDS:
            raise ValueError(f"unknown compression kind {self.kind!r}; known: "
                             f"{KINDS + ('fp8',)}")
        object.__setattr__(self, "kind", kind)

    @property
    def is_fp8(self) -> bool:
        return self.kind in _FP8_DTYPES

    @property
    def fp8_dtype(self) -> torch.dtype:
        return _FP8_DTYPES[self.kind]

    @property
    def wire_bits(self) -> int:
        return _WIRE_BITS[self.kind]

    @property
    def scaled(self) -> bool:
        """True when the wire carries a per-tensor fp32 scale next to q."""
        return self.kind == "int8" or self.is_fp8

    # ------------------------------------------------------------- #
    def init(self, params) -> Any:
        """The rank's compressor state, a dict tree like ``params`` (None
        on the fp32 wire)."""
        if self.kind == "none":
            return None
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if self.is_fp8:
            return tree_map(lambda p: Fp8LeafState(
                ef=zeros(p), scale=init_fp8_scale(self.history_len, device=p.device)),
                params)
        return tree_map(zeros, params)

    def compress(self, grads, ef) -> Tuple[Any, Any]:
        """``(wire, new_state)``: the wire crosses the network (reduce it
        with :meth:`psum_wire`); the new state stays on this rank."""
        if self.kind == "none":
            return grads, ef
        if self.is_fp8:
            return self._compress_fp8(grads, ef)

        def comp(g, e):
            g = g.float() + e
            if self.kind == "fp16":
                wire = g.half()
                return wire, g - wire.float()
            # int8: symmetric per-tensor scale
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            return (q, scale), g - q.float() * scale

        pairs = _map(comp, grads, ef)
        return (_map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs))

    def _compress_fp8(self, grads, state) -> Tuple[Any, Any]:
        """The FP8 wire: the delayed scale in, the residual (clipping
        included) out, the window fed ``amax(|g + ef|)``."""
        dt = self.fp8_dtype
        fmax = prec.fp8_max(dt)

        def comp(g, st: Fp8LeafState):
            g32 = g.float() + st.ef
            s = fp8_scale_of(st.scale)
            # clip at the format max under the delayed scale: a sudden amax
            # growth saturates, and the clipped mass rides in the residual
            q, s = prec.quantize_fp8(torch.clamp(g32, -fmax * s, fmax * s), dt, scale=s)
            resid = g32 - prec.dequantize_fp8(q, s)
            new = Fp8LeafState(ef=resid, scale=update_fp8_scale(
                st.scale, g32.abs().max()))
            return (q, s), new

        pairs = _map(comp, grads, state)
        return (_map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs))

    def decompress(self, wire) -> Any:
        if self.kind == "none":
            return wire
        if self.kind == "fp16":
            return _map(lambda w: w.float(), wire)
        return _map(lambda leaf: leaf[0].float() * leaf[1], wire)

    def psum_wire(self, wire, group=None) -> Any:
        """The mean over the group's ranks of the wire, in fp32.  Scaled
        wires reduce the per-rank dequantized terms ``q_i · s_i`` in fp32;
        the fp16 wire reduces on fp16 (the error feedback bounds its
        summation error over steps), the fp32 wire on fp32."""
        n = _world(group)
        # each term crosses to the host as it is made (gloo reduces host
        # buffers), so the device never holds all of them at once
        move = (lambda t: t.cpu()) if n > 1 else (lambda t: t)
        if self.scaled:
            terms = [move(q.float() * s) for q, s in _leaves(wire)]
        else:
            terms = [move(g) for g in _leaves(wire)]
        sums = iter(all_reduce_sum(terms, group))
        return _map(lambda leaf: next(sums).to((leaf[0] if self.scaled else leaf).device)
                    .float() / float(n), wire)

    # ------------------------------------------------------------- #
    def wire_bytes(self, tree) -> int:
        """Network bytes one all-reduce of ``tree`` (tensors, or anything
        with a ``shape``) puts on the wire under this compressor: the
        elements at ``wire_bits`` each, plus one fp32 scale per tensor on
        the scaled wires."""
        total = 0
        for leaf in _leaves(tree):
            n = int(math.prod(getattr(leaf, "shape", ()) or (1,)))
            total += n * self.wire_bits // 8
            if self.scaled:
                total += 4
        return total


def collective_wire_bytes(kind: str, tree) -> int:
    """:meth:`Compressor.wire_bytes` for a kind name."""
    return Compressor(kind).wire_bytes(tree)


NONE = Compressor("none")
FP16 = Compressor("fp16")
INT8 = Compressor("int8")
FP8_E4M3 = Compressor("fp8_e4m3")
FP8_E5M2 = Compressor("fp8_e5m2")


def compressed_mean_allreduce(grads, ef, compressor: Compressor, group=None):
    """The mean of every rank's gradients over the group, on the
    compressor's wire: each rank compresses ``grads + ef``, the wire is
    reduced, the residual stays on the rank.  Returns ``(mean_grads fp32,
    new_ef)``."""
    wire, ef = compressor.compress(grads, ef)
    if compressor.kind == "none":
        wire = _map(lambda g: g.float(), wire)
    return compressor.psum_wire(wire, group), ef
