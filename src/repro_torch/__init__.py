"""RedMulE in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

The counterpart of the JAX package ``repro``: the same module names and
layout, written in PyTorch, with every Pallas TPU kernel on the ported path
rewritten by hand in CUDA C++ (``csrc/``).  The package never imports JAX or
``repro``.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, where each kernel wrapper takes its plain
PyTorch version instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device must exist.

    There is no silent CPU fallback: asking for the card on a machine
    without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return dev
