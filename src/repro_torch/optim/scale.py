"""Dynamic loss scaling for FP16 training.

Counterpart of the FP16 half of ``repro.optim.scale``: binary16 overflows
at 65504 and small gradients underflow, so the loss is multiplied by
``scale`` before the backward; a step whose gradients are not all finite
is skipped and halves the scale (never below 1); ``growth_interval``
finite steps in a row double it.  The state's values are fp32 / int32
tensors, updated exactly as the reference's ``adjust``.  (The FP8
per-tensor delayed scaling waits for the FP8 slice.)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.optimizer import tree_leaves, tree_map

__all__ = ["LossScaleState", "init_scale", "scale_loss", "unscale_and_check",
           "adjust"]


class LossScaleState(NamedTuple):
    scale: torch.Tensor            # fp32
    good_steps: torch.Tensor       # int32
    growth_interval: torch.Tensor  # int32
    overflow_count: torch.Tensor   # int32, telemetry


def init_scale(initial: float = 2.0 ** 15, growth_interval: int = 2000,
               device="cpu") -> LossScaleState:
    i32 = dict(dtype=torch.int32, device=device)
    return LossScaleState(
        scale=torch.tensor(initial, dtype=torch.float32, device=device),
        good_steps=torch.zeros((), **i32),
        growth_interval=torch.tensor(growth_interval, **i32),
        overflow_count=torch.zeros((), **i32))


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def unscale_and_check(grads: Any, state: LossScaleState
                      ) -> Tuple[Any, torch.Tensor]:
    """Divide the grads (in fp32) by the scale; return ``(grads,
    all_finite)``."""
    inv = 1.0 / state.scale
    grads = tree_map(lambda g: g.float() * inv, grads)
    finite = torch.stack([torch.isfinite(g).all()
                          for g in tree_leaves(grads)]).all()
    return grads, finite


def adjust(state: LossScaleState, finite: torch.Tensor) -> LossScaleState:
    """The next state after a step whose gradients were ``finite``."""
    good = torch.where(finite, state.good_steps + 1, torch.zeros_like(state.good_steps))
    grow = good >= state.growth_interval
    scale = torch.where(finite,
                        torch.where(grow, state.scale * 2.0, state.scale),
                        torch.clamp(state.scale * 0.5, min=1.0))
    good = torch.where(grow, torch.zeros_like(good), good)
    return LossScaleState(
        scale=scale, good_steps=good, growth_interval=state.growth_interval,
        overflow_count=state.overflow_count + (~finite).to(torch.int32))
