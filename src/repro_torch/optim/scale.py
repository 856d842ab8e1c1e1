"""Dynamic scaling for reduced-precision training and storage.

Counterpart of ``repro.optim.scale`` (``scale.py:10-72`` and the FP8
state of ``:89-150``):

* **FP16 loss scaling**: binary16 overflows at 65504 and small gradients
  underflow, so the loss is multiplied by ``scale`` before the backward; a
  step whose gradients are not all finite is skipped and halves the scale
  (never below 1); ``growth_interval`` finite steps in a row double it.
  The state's values are fp32 / int32 tensors, updated exactly as the
  reference's ``adjust``.
* **FP8 per-tensor delayed scaling** (:class:`Fp8ScaleState`): a rolling
  window of observed amax values per tensor; the scale the next
  quantization divides by is the window maximum.  A non-finite or
  negative observation is dropped and counted as an overflow; an all-zero
  window keeps the previous scale.  The functions work elementwise over
  any leading dims (the reference vmaps them over layers and heads), so
  the FP8 KV cache keeps one state per head and layer in three tensors.

The tree helpers (``init_fp8_scale_tree``, ``observe_amax_tree``,
``scale.py:153-165`` of the reference) keep one state per leaf of a
parameter tree, as the FP8 gradient wire (``optim/compression.py``) does.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.optimizer import tree_leaves, tree_map

__all__ = ["LossScaleState", "init_scale", "scale_loss", "unscale_and_check",
           "adjust", "Fp8ScaleState", "init_fp8_scale", "observe_amax",
           "fp8_scale_of", "update_fp8_scale", "init_fp8_scale_tree",
           "observe_amax_tree"]


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


class Fp8ScaleState(NamedTuple):
    """Rolling amax window for FP8 delayed scaling: ``scale`` (fp32, the
    divisor of the next quantization, ``q = v / scale``), ``amax_history``
    (fp32, the window along the last dim) and ``overflow_count`` (int32,
    dropped non-finite observations).  Leading dims, if any, index
    independent states."""
    scale: torch.Tensor
    amax_history: torch.Tensor
    overflow_count: torch.Tensor


def init_fp8_scale(history_len: int = 16, lead=(), device="cpu") -> Fp8ScaleState:
    return Fp8ScaleState(
        scale=torch.ones(lead, dtype=torch.float32, device=device),
        amax_history=torch.zeros((*lead, history_len), dtype=torch.float32,
                                 device=device),
        overflow_count=torch.zeros(lead, dtype=torch.int32, device=device))


def observe_amax(state: Fp8ScaleState, v: torch.Tensor) -> Fp8ScaleState:
    """Record ``amax(|v|)`` of one tensor into the window."""
    return update_fp8_scale(state, v.float().abs().max())


def fp8_scale_of(state: Fp8ScaleState, *, margin: float = 1.0) -> torch.Tensor:
    """The window maximum times ``margin``; an all-zero window gives the
    state's current scale."""
    amax = state.amax_history.max(dim=-1).values
    return torch.where(amax > 0, amax * margin, state.scale)


def update_fp8_scale(state: Fp8ScaleState, amax, *,
                     margin: float = 1.0) -> Fp8ScaleState:
    """Fold one amax observation per state into the window and refresh the
    scale, as the reference's ``update_fp8_scale``: the new observation
    enters at index 0 and the oldest leaves; a non-finite or negative one
    enters as 0 and counts as an overflow."""
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=state.amax_history.device)
    bad = ~torch.isfinite(amax) | (amax < 0)
    clean = torch.where(bad, torch.zeros_like(amax), amax)
    hist = torch.cat([clean[..., None], state.amax_history[..., :-1]], dim=-1)
    top = hist.max(dim=-1).values
    return Fp8ScaleState(
        scale=torch.where(top > 0, top * margin, state.scale),
        amax_history=hist,
        overflow_count=state.overflow_count + bad.to(torch.int32))


def init_fp8_scale_tree(tree: Any, history_len: int = 16) -> Any:
    """A dict tree shaped like ``tree`` with one fresh
    :class:`Fp8ScaleState` per leaf, on that leaf's device."""
    return tree_map(lambda t: init_fp8_scale(history_len, device=t.device), tree)


def observe_amax_tree(states: Any, tree: Any) -> Any:
    """Fold each leaf's amax into its matching scale state."""
    if isinstance(states, Fp8ScaleState):
        return observe_amax(states, tree)
    return {k: observe_amax_tree(states[k], tree[k]) for k in tree}
