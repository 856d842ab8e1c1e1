"""Roofline accounting from the engine's events (counterpart of
``repro.roofline``; the compiled-program half waits for the port's dry
run, ROADMAP.md Queue A 6)."""

from repro_torch.roofline.analysis import (
    FP8_PEAK_FLOPS, FP32_PEAK_FLOPS, HBM_BW, NVLINK_BW, PEAK_FLOPS,
    RooflineReport, bytes_by_direction, flops_by_direction, flops_from_events,
    is_backward_event, model_flops,
)

__all__ = [
    "PEAK_FLOPS", "FP8_PEAK_FLOPS", "FP32_PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
    "RooflineReport", "model_flops", "flops_from_events", "is_backward_event",
    "flops_by_direction", "bytes_by_direction",
]
