"""The epilogue registry: activations fusable into the GEMM store, and
their derivatives for the fused backward.

Counterpart of ``repro.core.epilogues``.  ``gelu`` is the tanh
approximation, ``jax.nn.gelu``'s default.  ``EPILOGUE_GRADS`` holds each
activation's derivative from the pre-activation (``deriv``) and, for relu
and tanh, from the output (``deriv_from_output``), which lets the linear
backward keep the fully fused forward and save its output.
``EPILOGUE_IDS`` numbers each entry for the CUDA kernel, whose
``apply_epilogue`` / ``epilogue_grad`` implement the same functions in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

__all__ = ["EPILOGUES", "EPILOGUE_IDS", "EPILOGUE_GRADS", "EpilogueGrad",
           "validate_epilogue", "apply_epilogue", "epilogue_grad"]

EPILOGUES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}

# the kernel's switch (csrc/redmule_matmul.cu, enum Epilogue)
EPILOGUE_IDS: Dict[object, int] = {None: 0, "relu": 1, "gelu": 2,
                                   "silu": 3, "tanh": 4}


def validate_epilogue(name) -> None:
    """Raise ValueError for an unknown epilogue name (None is allowed)."""
    if name is not None and name not in EPILOGUES:
        raise ValueError(
            f"unknown epilogue {name!r}; known: {sorted(EPILOGUES)}")


def apply_epilogue(name, z: torch.Tensor) -> torch.Tensor:
    if name is None:
        return z
    return EPILOGUES[name](z)


@dataclasses.dataclass(frozen=True)
class EpilogueGrad:
    """``deriv(s)`` is ``act'(s)`` from the pre-activation;
    ``deriv_from_output(z)`` (optional) the same from ``z = act(s)``."""

    deriv: Callable[[torch.Tensor], torch.Tensor]
    deriv_from_output: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _relu_deriv(s: torch.Tensor) -> torch.Tensor:
    return (s > 0).to(s.dtype)


def _tanh_deriv(s: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(s)
    return 1.0 - t * t


def _silu_deriv(s: torch.Tensor) -> torch.Tensor:
    sig = torch.sigmoid(s)
    return sig * (1.0 + s * (1.0 - sig))


_GELU_C = 0.7978845608028654  # sqrt(2 / pi)
_GELU_A = 0.044715


def _gelu_deriv(s: torch.Tensor) -> torch.Tensor:
    # g(s) = 0.5 s (1 + tanh(u)),  u = sqrt(2/pi) (s + 0.044715 s^3)
    u = _GELU_C * (s + _GELU_A * s * s * s)
    t = torch.tanh(u)
    du = _GELU_C * (1.0 + 3.0 * _GELU_A * s * s)
    return 0.5 * (1.0 + t) + 0.5 * s * (1.0 - t * t) * du


EPILOGUE_GRADS: Dict[str, EpilogueGrad] = {
    "relu": EpilogueGrad(deriv=_relu_deriv,
                         deriv_from_output=lambda z: (z > 0).to(z.dtype)),
    "tanh": EpilogueGrad(deriv=_tanh_deriv,
                         deriv_from_output=lambda z: 1.0 - z * z),
    "silu": EpilogueGrad(deriv=_silu_deriv),
    "gelu": EpilogueGrad(deriv=_gelu_deriv),
}


def epilogue_grad(name: str) -> EpilogueGrad:
    """The derivative entry of epilogue ``name`` (KeyError if unknown)."""
    return EPILOGUE_GRADS[name]
