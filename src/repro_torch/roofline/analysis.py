"""Roofline terms on H100s: the engine's flop / byte accounting and the
dry run's three-term roofline.

Counterpart of ``repro.roofline.analysis``.  The first half reads
:class:`repro_torch.core.engine.GemmEvent` streams: the total and the
forward / backward split of a workload's GEMM flops and device-memory
bytes, and the analytic ``model_flops`` of a configuration and shape.
The second half is the dry run's (``launch/dryrun.py``).  The reference
reads XLA's compiled text; the port has no compiler, so it reads a
:class:`DryTrace` of one rank's program run on meta tensors: the
collectives it recorded (``runtime/collectives.py::dry_run``), the engine
events and the aten ops :class:`repro_torch.roofline.memory.MemoryTracker`
saw.  Eager code runs every call, so every multiplier is 1.

* :class:`CollectiveOp` — the reference's ring model, letter for letter
  (R the per-rank result bytes, g the group size)::

      all-reduce        2 * R * (g-1)/g      (psum, pmax)
      all-gather        R * (g-1)/g          (R = gathered result bytes)
      reduce-scatter    R * (g-1)            (psum_scatter; R = the block)
      all-to-all        R * (g-1)/g          (all_to_all, redistribute_last)
      collective-permute R

* :func:`structural_costs` — ``(flops, bytes)`` of the rank: flops are
  the engine events' ``flops * count`` plus any aten ``mm`` / ``bmm`` /
  ``addmm`` / ``baddbmm`` outside the engine; bytes are the engine
  events' bytes plus every aten op's traffic by the reference's rules
  (``structural_costs`` of the reference, ``:320-351``):

      ==============================  ====================================
      aten op                         bytes
      ==============================  ====================================
      a view (shares its operand's    0 (plumbing)
      storage), ``empty*``,
      ``new_empty*``, ``lift_fresh``
      ``zeros`` / ``ones`` / ``full``  the result (a write)
      / ``fill_`` / ``zero_`` /
      ``arange`` and their ``_like``
      ``index`` / ``gather`` /        2 x the result (reads only the
      ``index_select`` /              picked region)
      ``embedding``
      ``index_put_`` / ``scatter*`` /  2 x the update (an in-place region
      ``index_add_`` /                write)
      ``index_copy_`` /
      ``slice_scatter``
      ``copy_`` / ``_to_copy`` /      result + operand
      ``clone``
      any other op                    result + every tensor operand
      ==============================  ====================================

  The kernels' own traffic is the events' (the wrappers' meta route runs
  only allocations, which are plumbing).
* :func:`roofline` — the :class:`RooflineReport` of one trace.

Constants: one NVIDIA H100 SXM's (NVIDIA's H100 data sheet, dense rates
without sparsity, at the full 700 W power limit), and the links of a
DGX H100 (NVIDIA's DGX H100 data sheet: NVLink 4 inside an 8-card node,
eight ConnectX-7 400 Gb/s NDR InfiniBand ports for its eight cards)::

    compute    = flops / PEAK_FLOPS      989 TFLOP/s bf16 / fp16 tensor cores
    memory     = bytes / HBM_BW          3.35 TB/s HBM3
    collective = wire bytes / link       NVLINK_BW 450 GB/s each way, a
                                         group inside one node; IB_BW
                                         50 GB/s each way (one NDR port a
                                         card), a group that spans nodes

beside them the fp8 tensor-core rate (1979 TFLOP/s) and float32 outside
the tensor cores (67 TFLOP/s).  A group's ranks follow ``launch.mesh``'s
row-major order, :data:`repro_torch.runtime.collectives.NODE_SIZE` to a
node.  The reference's ``ICI_BW`` is a TPU figure and is not carried
over.  Every term is an estimate from these data-sheet constants, not a
measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from repro_torch.core.engine import is_backward_op

__all__ = [
    "PEAK_FLOPS", "FP8_PEAK_FLOPS", "FP32_PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
    "IB_BW", "CollectiveOp", "DryTrace", "parse_collectives",
    "collective_bytes_per_device", "aten_costs", "structural_costs",
    "RooflineReport", "roofline", "model_flops", "flops_from_events",
    "is_backward_event", "flops_by_direction", "bytes_by_direction",
]

PEAK_FLOPS = 989e12        # FLOP/s, bf16 / fp16 dense tensor cores, H100 SXM
FP8_PEAK_FLOPS = 1979e12   # FLOP/s, fp8 dense tensor cores
FP32_PEAK_FLOPS = 67e12    # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
NVLINK_BW = 450e9          # bytes/s each way, one card to the others of its node
IB_BW = 50e9               # bytes/s each way, one 400 Gb/s NDR port per card

# the port's collective kinds (runtime/collectives.py) -> the reference's
KIND = {"psum": "all-reduce", "pmax": "all-reduce", "all_gather": "all-gather",
        "psum_scatter": "reduce-scatter", "all_to_all": "all-to-all",
        "redistribute": "all-to-all"}


# --------------------------------------------------------------------- #
# Collectives
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int     # per-device result bytes
    group_size: int
    computation: str      # the mesh axis the group runs over
    multiplier: int = 1   # eager code records every call: 1
    link_bw: float = NVLINK_BW

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        R = self.result_bytes
        if self.kind == "collective-permute":
            # pairwise sends, no group amortization
            return float(R)
        if g == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * R * (g - 1) / g
        if self.kind == "all-gather":
            return R * (g - 1) / g
        if self.kind == "reduce-scatter":
            return float(R) * (g - 1)
        if self.kind == "all-to-all":
            return R * (g - 1) / g
        return float(R)  # collective-permute

    @property
    def seconds(self) -> float:
        return self.wire_bytes * self.multiplier / self.link_bw


@dataclasses.dataclass
class DryTrace:
    """What the dry run saw of one rank's step: the collectives it
    recorded (``runtime.collectives.DryCollective``), the engine's events
    and the aten ops of the memory tracker (name -> ``[calls, flops,
    bytes]``), with the tracker's memory summary."""

    collectives: List
    events: List
    ops: Dict[str, list]
    memory: Dict[str, int]


def parse_collectives(trace: DryTrace) -> List[CollectiveOp]:
    """One :class:`CollectiveOp` per recorded collective, priced at the
    link its group runs over."""
    return [CollectiveOp(kind=KIND[c.kind], result_bytes=c.result_bytes,
                         group_size=c.group_size, computation=c.axis,
                         link_bw=NVLINK_BW if c.intra_node else IB_BW)
            for c in trace.collectives]


def collective_bytes_per_device(trace: DryTrace) -> float:
    return sum(op.wire_bytes * op.multiplier for op in parse_collectives(trace))


# --------------------------------------------------------------------- #
# Structural per-rank costs
# --------------------------------------------------------------------- #
_PLUMBING = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "lift_fresh", "lift_fresh_copy", "sym_size",
             "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense"}
_WRITES = {"zeros", "ones", "full", "fill_", "zero_", "arange", "zeros_like",
           "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
           "scalar_tensor", "fill"}
_GATHERS = {"index", "gather", "index_select", "embedding"}
_SCATTERS = {"index_put_", "index_put", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_add_",
             "index_add", "index_copy_", "index_copy", "slice_scatter",
             "select_scatter", "scatter_reduce", "scatter_reduce_"}
_COPIES = {"copy_", "_to_copy", "clone", "copy"}
_GEMMS = {"mm", "bmm", "addmm", "baddbmm"}
# the update operand of each scatter-like op
_UPDATE = {"index_put_": "values", "index_put": "values",
           "_index_put_impl_": "values", "slice_scatter": "src",
           "select_scatter": "src"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_VIEW: Dict[object, bool] = {}


def _is_view(func) -> bool:
    v = _VIEW.get(func)
    if v is None:
        v = _VIEW[func] = any(r.alias_info is not None and not r.alias_info.is_write
                              for r in func._schema.returns)
    return v


def aten_costs(func, args, kwargs, out, ins: Sequence[torch.Tensor]):
    """``(flops, bytes)`` of one aten op by the table of the module
    docstring (``ins``: its tensor operands)."""
    name = func.overloadpacket.__name__
    if name in _PLUMBING or _is_view(func):
        return 0, 0
    outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]
    res = sum(_nbytes(t) for t in outs)
    flops = 0
    if name in _GEMMS:
        a, b = (args[-2], args[-1]) if name in ("addmm", "baddbmm") else args[:2]
        flops = 2 * a.numel() * b.shape[-1]
    if name in _WRITES:
        return flops, res
    if name in _GATHERS:
        return flops, 2 * res
    if name in _SCATTERS:
        key = _UPDATE.get(name, "src")
        upd = kwargs.get(key)
        if upd is None:
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            upd = tensors[-1] if tensors else None
        if isinstance(upd, (list, tuple)):
            upd = None
        return flops, 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor) else res)
    if name in _COPIES:
        src = [t for t in ins if t is not None]
        return flops, res + (_nbytes(src[-1]) if src else 0)
    return flops, res + sum(_nbytes(t) for t in ins)


def structural_costs(trace: DryTrace):
    """``(flops, bytes)`` of the rank's step (module docstring)."""
    flops = sum(ev.flops * ev.count for ev in trace.events)
    byts = sum(ev.bytes * ev.count for ev in trace.events)
    for _, f, b in trace.ops.values():
        flops += f
        byts += b
    return float(flops), float(byts)


# --------------------------------------------------------------------- #
# Report
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    collectives: Dict[str, float]
    memory_analysis: Dict[str, float]
    # GEMM flops of the engine's events for the same program; a train
    # step's events include the backward (``matmul_dx`` / ``matmul_dw``)
    # and the remat recompute, split by direction in _fwd / _bwd.  0.0
    # when no events were supplied.
    engine_flops: float = 0.0
    engine_flops_fwd: float = 0.0
    engine_flops_bwd: float = 0.0
    # device-memory bytes of the same events, each operand at its storage
    # width (``GemmSpec.x_dtype`` / ``w_dtype``: an FP8 operand pays one
    # byte per element while the flops do not change), split likewise.
    engine_bytes: float = 0.0
    engine_bytes_fwd: float = 0.0
    engine_bytes_bwd: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the program ran at
        the max-term bound: useful_model_flops / (bound_s * cards * peak)."""
        denom = self.bound_s * self.n_devices * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction, bound_s=self.bound_s)
        return d


# --------------------------------------------------------------------- #
# The engine's events
# --------------------------------------------------------------------- #
def flops_from_events(events) -> float:
    """Total GEMM flops of the engine's events (``count`` multiplies each);
    the events of a loss and its gradients include the backward's
    ``matmul_dx`` / ``matmul_dw`` dispatches, so this is the whole step."""
    return float(sum(ev.flops * ev.count for ev in events))


def is_backward_event(ev) -> bool:
    """True for events the backward emits (dX / dW GEMMs and the two-pass
    epilogue ``*_dact`` / ``*_dbias`` pass events) and for remat recompute
    events: the recompute re-runs the forward during the backward pass,
    so its flops and bytes belong to the backward direction."""
    return is_backward_op(ev.spec.op) or getattr(ev, "recompute", False)


def flops_by_direction(events) -> Dict[str, float]:
    """{"fwd": ..., "bwd": ...} GEMM flops of an instrumented workload."""
    fwd = bwd = 0.0
    for ev in events:
        if is_backward_event(ev):
            bwd += ev.flops * ev.count
        else:
            fwd += ev.flops * ev.count
    return {"fwd": fwd, "bwd": bwd}


def bytes_by_direction(events) -> Dict[str, float]:
    """{"fwd": ..., "bwd": ...} device-memory bytes of an instrumented
    workload.

    Backward bytes include the epilogue traffic wherever it flows: the
    two-pass fallback's ``ds`` round trip and separate bias-grad reduction
    ride on ``*_dact`` / ``*_dbias`` pass events, the fused one-pass
    backward's derivative stream and db output on the dX / dW events
    themselves — so this split compares the two honestly."""
    fwd = bwd = 0.0
    for ev in events:
        if is_backward_event(ev):
            bwd += ev.bytes * ev.count
        else:
            fwd += ev.bytes * ev.count
    return {"fwd": fwd, "bwd": bwd}


def roofline(
    trace: DryTrace,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_devices: int,
    model_flops_val: float,
    gemm_events=None,
) -> RooflineReport:
    """The three-term roofline of one rank's traced step (the reference's
    ``roofline(compiled, ...)`` over a :class:`DryTrace`)."""
    flops, byts = structural_costs(trace)
    ops = parse_collectives(trace)
    coll = sum(op.wire_bytes * op.multiplier for op in ops)
    per_kind: Dict[str, float] = {}
    for op in ops:
        per_kind[op.kind] = per_kind.get(op.kind, 0.0) + op.wire_bytes * op.multiplier
    mem = {k: trace.memory[k] for k in ("argument_bytes", "output_bytes",
                                        "temp_bytes", "alias_bytes")}
    events = gemm_events if gemm_events is not None else trace.events
    direction = (flops_by_direction(events) if events
                 else {"fwd": 0.0, "bwd": 0.0})
    bdirection = (bytes_by_direction(events) if events
                  else {"fwd": 0.0, "bwd": 0.0})
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=coll,
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=sum(op.seconds for op in ops),
        model_flops=model_flops_val,
        collectives=per_kind,
        memory_analysis=mem,
        engine_flops=flops_from_events(events) if events else 0.0,
        engine_flops_fwd=direction["fwd"],
        engine_flops_bwd=direction["bwd"],
        engine_bytes=bdirection["fwd"] + bdirection["bwd"],
        engine_bytes_fwd=bdirection["fwd"],
        engine_bytes_bwd=bdirection["bwd"],
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode),
    N = active non-embedding params (MoE counts top-k + shared only)."""
    n_active = cfg.active_param_count() if cfg.moe else cfg.param_count()
    # drop the embedding gather (not a GEMM) but keep the LM-head GEMM;
    # with tied embeddings the one table IS the head, so nothing is dropped
    n_embed = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    n = max(n_active - n_embed, 1)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
