"""Roofline accounting (counterpart of ``repro.roofline``): the engine's
events, the dry run's three-term roofline over a traced rank
(``analysis``) and the device memory of a traced step (``memory``)."""

from repro_torch.roofline.analysis import (
    FP8_PEAK_FLOPS, FP32_PEAK_FLOPS, HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS,
    CollectiveOp, DryTrace, RooflineReport, bytes_by_direction,
    collective_bytes_per_device, flops_by_direction, flops_from_events,
    is_backward_event, model_flops, parse_collectives, roofline,
    structural_costs,
)

__all__ = [
    "PEAK_FLOPS", "FP8_PEAK_FLOPS", "FP32_PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
    "IB_BW", "CollectiveOp", "DryTrace", "parse_collectives",
    "collective_bytes_per_device", "structural_costs", "RooflineReport",
    "roofline", "model_flops", "flops_from_events", "is_backward_event",
    "flops_by_direction", "bytes_by_direction",
]
