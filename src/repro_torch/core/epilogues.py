"""The forward epilogue registry: activations fusable into the GEMM store.

Counterpart of ``repro.core.epilogues`` (forward half; the derivatives
arrive with the training slice).  ``gelu`` is the tanh approximation,
``jax.nn.gelu``'s default.  ``EPILOGUE_IDS`` numbers each entry for the
CUDA kernel, whose ``apply_epilogue`` implements the same functions in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

__all__ = ["EPILOGUES", "EPILOGUE_IDS", "validate_epilogue", "apply_epilogue"]

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
