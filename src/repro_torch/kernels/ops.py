"""The GEMM kernel wrappers behind the engine's "hopper" backend.

Counterpart of ``repro.kernels.ops``.  A tensor on the CPU takes the
kernel's plain version (:func:`redmule_matmul_plain`); a CUDA tensor
launches the kernel or raises — there is no fallback.  Unlike the
reference there is no host-side padding: the kernel masks ragged M / N / K
edges itself.  Each wrapper counts its kernel launches in ``.launches``.

fp32 operands (the FP32 policy) run on the card through the kernel's SIMT
fp32 route (no TF32); those launches are also counted in
``.launches_fp32``.  Features of the reference kernel that belong to later
slices raise ``NotImplementedError``: ``faithful_accum`` (the
``paper_fp16`` policy), the fused backward (``deriv`` / ``bias_grad``) and
FP8 operands.  Model code goes through :mod:`repro_torch.core.engine`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec
from repro_torch.core import tiling
from repro_torch.kernels import redmule_matmul as rm

__all__ = ["redmule_matmul", "redmule_matmul_batched"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


def _check(x: torch.Tensor, w: torch.Tensor, policy: prec.Policy,
           bias: Optional[torch.Tensor], epilogue: Optional[str],
           deriv, bias_grad: bool) -> None:
    epi.validate_epilogue(epilogue)
    if policy.faithful_accum:
        raise NotImplementedError(
            f"faithful_accum (policy {policy.name!r}) is {_ROADMAP}")
    if deriv is not None or bias_grad:
        raise NotImplementedError(f"the fused backward epilogue is {_ROADMAP}")
    if prec.is_fp8(x.dtype) or prec.is_fp8(w.dtype):
        raise NotImplementedError(f"FP8 operands are {_ROADMAP}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if policy.compute_dtype == torch.float32 and policy.out_dtype != torch.float32:
        raise NotImplementedError(
            f"fp32 operands with a {policy.out_dtype} output (policy "
            f"{policy.name!r}) are {_ROADMAP}")
    if x.dtype != policy.compute_dtype or w.dtype != policy.compute_dtype:
        raise TypeError(f"operands must be {policy.compute_dtype}, got "
                        f"{x.dtype} and {w.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.device != x.device):
        raise TypeError("bias must be a float32 row on the operands' device")


def _empty_problem(lead, M, N, K, *, policy, bias, epilogue, device):
    """The result of a GEMM with an empty dimension, with no launch: empty,
    or (N == 0) the epilogue of the bias alone."""
    z = torch.zeros((*lead, M, K), dtype=policy.accum_dtype, device=device)
    if bias is not None:
        z = z + bias.reshape(-1).to(policy.accum_dtype)
    return epi.apply_epilogue(epilogue, z).to(policy.out_dtype)


def redmule_matmul(x: torch.Tensor, w: torch.Tensor, *, policy: prec.Policy,
                   tile: Optional[tiling.TileConfig] = None,
                   bias: Optional[torch.Tensor] = None,
                   epilogue: Optional[str] = None, layout: str = "nn",
                   deriv: Optional[torch.Tensor] = None,
                   bias_grad: bool = False) -> torch.Tensor:
    """2D ``Z = act(X @ W + bias)`` (kernel 1).

    ``x`` / ``w`` are stored as ``layout`` names ("nn" | "nt" | "tn"); the
    result is the logical ``(M, K)``.  ``bias`` is a ``(K,)`` row, fused
    with ``epilogue`` into the kernel's single store in fp32."""
    _check(x, w, policy, bias, epilogue, deriv, bias_grad)
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"2D operands expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    M, N, K = rm.logical_dims(x.shape, w.shape, layout)
    if x.device.type == "cpu":
        return rm.redmule_matmul_plain(x, w, policy=policy, bias=bias,
                                       epilogue=epilogue, layout=layout)
    if min(M, N, K) == 0:
        return _empty_problem((), M, N, K, policy=policy, bias=bias,
                              epilogue=epilogue, device=x.device)
    z = rm.launch(x, w, policy=policy,
                  tile=tile or tiling.choose_tiles(M, N, K), bias=bias,
                  epilogue=epilogue, layout=layout)
    redmule_matmul.launches += 1
    if x.dtype == torch.float32:
        redmule_matmul.launches_fp32 += 1
    return z


redmule_matmul.launches = 0
redmule_matmul.launches_fp32 = 0


def redmule_matmul_batched(x: torch.Tensor, w: torch.Tensor, *,
                           policy: prec.Policy,
                           tile: Optional[tiling.TileConfig] = None,
                           bias: Optional[torch.Tensor] = None,
                           epilogue: Optional[str] = None,
                           layout: str = "nn") -> torch.Tensor:
    """Batched ``Z[b] = act(X[b] @ W[b] + bias)`` (kernel 2).

    ``x`` is ``(..., M, N)`` and ``w`` ``(..., N, K)`` as stored under
    ``layout``, with broadcast-compatible leading dims; the result is
    ``(*lead, M, K)``.  A broadcast operand is read through a batch stride
    of 0, never materialised per batch element; ``bias`` (``(K,)``) is
    shared across the batch."""
    _check(x, w, policy, bias, epilogue, None, False)
    if x.ndim < 2 or w.ndim < 2:
        raise ValueError(f">=2D operands expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    M, N, K = rm.logical_dims(x.shape, w.shape, layout)
    if x.device.type == "cpu":
        return rm.redmule_matmul_plain(x, w, policy=policy, bias=bias,
                                       epilogue=epilogue, layout=layout)
    lead = tuple(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
    if min(M, N, K, *lead) == 0:
        return _empty_problem(lead, M, N, K, policy=policy, bias=bias,
                              epilogue=epilogue, device=x.device)
    z = rm.launch(x, w, policy=policy,
                  tile=tile or tiling.choose_tiles(M, N, K), bias=bias,
                  epilogue=epilogue, layout=layout)
    redmule_matmul_batched.launches += 1
    if x.dtype == torch.float32:
        redmule_matmul_batched.launches_fp32 += 1
    return z


redmule_matmul_batched.launches = 0
redmule_matmul_batched.launches_fp32 = 0
