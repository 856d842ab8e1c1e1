"""Roofline terms and the engine's flop / byte accounting on one H100.

Counterpart of ``repro.roofline.analysis``, the half that reads
:class:`repro_torch.core.engine.GemmEvent` streams: the total and the
forward / backward split of a workload's GEMM flops and device-memory
bytes, the analytic ``model_flops`` of a configuration and shape, and the
:class:`RooflineReport` record with its derived terms.  The other half —
``roofline(compiled, ...)``, the collective parser and the structural
costs — reads XLA's compiled text, which the port does not have; it waits
for the port's dry run (ROADMAP.md Queue A 6).

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit):

    compute    = flops / PEAK_FLOPS      989 TFLOP/s bf16 / fp16 tensor cores
    memory     = bytes / HBM_BW          3.35 TB/s HBM3
    collective = link bytes / NVLINK_BW  450 GB/s each way to the other
                                         cards of the host (NVLink 4)

beside them the fp8 tensor-core rate (1979 TFLOP/s) and float32 outside
the tensor cores (67 TFLOP/s), the rates the port's fp32 route and FP8
operands would be held to.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.engine import is_backward_op

__all__ = [
    "PEAK_FLOPS", "FP8_PEAK_FLOPS", "FP32_PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
    "RooflineReport", "model_flops", "flops_from_events", "is_backward_event",
    "flops_by_direction", "bytes_by_direction",
]

PEAK_FLOPS = 989e12        # FLOP/s, bf16 / fp16 dense tensor cores, H100 SXM
FP8_PEAK_FLOPS = 1979e12   # FLOP/s, fp8 dense tensor cores
FP32_PEAK_FLOPS = 67e12    # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
NVLINK_BW = 450e9          # bytes/s each way, one card to the others


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
