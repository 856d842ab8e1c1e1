"""The GEMM kernel wrappers behind the engine's "hopper" backend.

Counterpart of ``repro.kernels.ops``.  A tensor on the CPU takes the
kernel's plain version (:func:`redmule_matmul_plain`); a CUDA tensor
launches the kernel or raises — there is no fallback.  Unlike the
reference there is no host-side padding: the kernel masks ragged M / N / K
edges itself.  Each wrapper counts its kernel launches in ``.launches``.

fp32 operands (the FP32 policy) run on the card through the kernel's SIMT
fp32 route (no TF32); those launches are also counted in
``.launches_fp32``.  The ``paper_fp16`` policy's faithful fp16 accumulator
runs on the fp16 route, re-rounded after every ``accum_block`` reduction
rows (default: the reference's reduction block,
:func:`repro_torch.core.tiling.accum_block`).  The fused backward epilogue
(``deriv`` / ``grad_epilogue`` / ``bias_grad``, 2D only) runs on every
route.  ``redmule_matmul`` also counts its faithful launches in
``.launches_faithful`` (those whose reduction spans more than one block
again in ``.launches_multiblock``) and its fused-backward ones in
``.launches_fused_bwd`` (those on the fp32 route again in
``.launches_fused_bwd_fp32``).  Every fp16 accumulator is faithful
(``policy.blockwise_accum``): the reference kernel keeps its accumulator
in ``accum_dtype``, so the ``*_scores`` policy of the decode scores (fp16
accumulator, fp32 store) rounds per block too.

FP8 operands (``float8_e4m3fn`` / ``float8_e5m2``, in either slot) are
upcast to the fp16 compute dtype on load; a launch with one is also
counted in ``.launches_fp8``.  On the card only the pairs the kernel is
compiled for run (declared in
:data:`repro_torch.kernels.redmule_matmul.FP8_KERNELS`); the kernel's
dispatch refuses any other and the launch raises — nothing is widened
behind the caller's back.

A launch whose reduction the kernel splits inside the launch
(:func:`repro_torch.core.tiling.split_plan`: few output tiles for the
card) is also counted in ``.launches_split``; it is still one launch.
Model code goes through :mod:`repro_torch.core.engine`.
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
# the kernel's reduction step: a faithful block must end on one
_KERNEL_BN = tiling.GEMM_TILES[0].bn


def _is_fp8(x: torch.Tensor, w: torch.Tensor) -> bool:
    return prec.is_fp8(x.dtype) or prec.is_fp8(w.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, policy: prec.Policy,
           bias: Optional[torch.Tensor], epilogue: Optional[str]) -> None:
    epi.validate_epilogue(epilogue)
    if _is_fp8(x, w) and policy.compute_dtype != torch.float16:
        raise NotImplementedError(
            f"FP8 operands widen to an fp16 compute dtype; policy "
            f"{policy.name!r} computes in {prec.dtype_name(policy.compute_dtype)}")
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
    if policy.blockwise_accum and not (
            policy.compute_dtype == policy.accum_dtype == torch.float16
            and policy.out_dtype in (torch.float16, torch.float32)):
        raise NotImplementedError(
            f"faithful accumulation outside fp16 (policy {policy.name!r}) is "
            f"{_ROADMAP}")
    for t in (x, w):
        if t.dtype != policy.compute_dtype and not prec.is_fp8(t.dtype):
            raise TypeError(f"operands must be {policy.compute_dtype} or FP8, "
                            f"got {x.dtype} and {w.dtype}")
    if bias is not None and bias.device != x.device:
        raise TypeError("bias must lie on the operands' device")


def _check_bwd(x, w, layout: str, policy: prec.Policy, deriv, grad_epilogue,
               grad_from_output: bool, bias_grad: bool) -> None:
    """The fused backward epilogue's contract (the reference kernel's
    asserts): transpose layouts only, ``deriv`` shaped like the dZ operand,
    ``bias_grad`` on "tn"; on the card the derivative is in the compute
    dtype and the output in the accumulator dtype (the "+grad" policy)."""
    if grad_epilogue is None and deriv is not None:
        raise ValueError("deriv without a grad_epilogue")
    if grad_epilogue is not None:
        epi.validate_epilogue(grad_epilogue)
        if layout not in ("nt", "tn"):
            raise ValueError("the fused backward epilogue is a transpose-"
                             f"layout contract, got layout {layout!r}")
        want = x.shape if layout == "nt" else w.shape
        if deriv is None or tuple(deriv.shape) != tuple(want):
            raise ValueError(f"deriv must be shaped like the dZ operand "
                             f"{tuple(want)}, got "
                             f"{None if deriv is None else tuple(deriv.shape)}")
        if grad_from_output and \
                epi.epilogue_grad(grad_epilogue).deriv_from_output is None:
            raise ValueError(f"{grad_epilogue!r} has no output-form derivative")
    if bias_grad and layout != "tn":
        raise ValueError("bias_grad rides on the dW (tn) dispatch")
    if x.device.type == "cuda" and (grad_epilogue is not None or bias_grad):
        if policy.out_dtype != policy.accum_dtype:
            raise NotImplementedError(
                f"a fused backward with a {policy.out_dtype} output under "
                f"{policy.accum_dtype} accumulation is {_ROADMAP}")
        if deriv is not None and (deriv.dtype != policy.compute_dtype
                                  or deriv.device != x.device):
            raise TypeError(f"deriv must be {policy.compute_dtype} on "
                            f"{x.device}, got {deriv.dtype} on {deriv.device}")


def _block(policy: prec.Policy, x, w, M: int, N: int, K: int,
           accum_block: Optional[int], fused_bwd: bool) -> Optional[int]:
    """The faithful accumulator's rounding block: the caller's, else the
    reference's for this dispatch (sized by the operands' storage); None
    without an fp16 accumulator."""
    if not policy.blockwise_accum:
        return None
    if accum_block is None:
        return tiling.accum_block(M, N, K, compute_dtype=policy.compute_dtype,
                                  accum_dtype=policy.accum_dtype,
                                  fused_bwd=fused_bwd,
                                  x_dtype=rm.storage_dtype(x),
                                  w_dtype=rm.storage_dtype(w))
    if accum_block <= 0 or accum_block % _KERNEL_BN:
        raise ValueError(f"accum_block must be a positive multiple of "
                         f"{_KERNEL_BN}, got {accum_block}")
    return int(accum_block)


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
                   grad_epilogue: Optional[str] = None,
                   grad_from_output: bool = False,
                   bias_grad: bool = False,
                   accum_block: Optional[int] = None):
    """2D ``Z = act(X @ W + bias)`` (kernel 1).

    ``x`` / ``w`` are stored as ``layout`` names ("nn" | "nt" | "tn"); the
    result is the logical ``(M, K)``.  ``bias`` is a ``(K,)`` row, fused
    with ``epilogue`` into the kernel's single store in the accumulator
    dtype.  ``accum_block`` sets the faithful accumulator's rounding block
    (a multiple of 32; default: the reference's).

    The fused backward (the reference's ``"fused_bwd_epilogue"`` contract):
    ``grad_epilogue`` + ``deriv`` (stored like the dZ operand: the x slot
    on "nt", the w slot on "tn") scale dZ by ``act'(deriv)`` on load
    (``grad_from_output``: ``deriv`` is the activation's output);
    ``bias_grad`` (on "tn") returns ``(z, db)``, ``db`` the
    accumulator-dtype ``(K,)`` column sums of the scaled dZ."""
    _check(x, w, policy, bias, epilogue)
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"2D operands expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    M, N, K = rm.logical_dims(x.shape, w.shape, layout)
    _check_bwd(x, w, layout, policy, deriv, grad_epilogue, grad_from_output,
               bias_grad)
    fused_bwd = grad_epilogue is not None or bias_grad
    block = _block(policy, x, w, M, N, K, accum_block, fused_bwd)
    bwd = dict(deriv=deriv, grad_epilogue=grad_epilogue,
               grad_from_output=grad_from_output, bias_grad=bias_grad)
    if x.device.type == "cpu":
        return rm.redmule_matmul_plain(x, w, policy=policy, bias=bias,
                                       epilogue=epilogue, layout=layout,
                                       accum_block=block, **bwd)
    if min(M, N, K) == 0 and not (bias_grad and K):
        # no output to compute (db, when asked for, is empty too)
        z = _empty_problem((), M, N, K, policy=policy, bias=bias,
                           epilogue=epilogue, device=x.device)
        if not bias_grad:
            return z
        return z, torch.zeros((0,), dtype=policy.accum_dtype, device=x.device)
    # db over an empty M (or N) still launches: the kernel runs one M-tile
    # row of blocks, which sums (N == 0: zeroes) db and stores no z
    out, splits = rm.launch(x, w, policy=policy,
                            tile=tile or tiling.choose_tiles(M, N, K),
                            bias=bias, epilogue=epilogue, layout=layout,
                            accum_block=block or 0, **bwd)
    redmule_matmul.launches += 1
    if splits > 1:
        redmule_matmul.launches_split += 1
    if x.dtype == torch.float32:
        redmule_matmul.launches_fp32 += 1
    if _is_fp8(x, w):
        redmule_matmul.launches_fp8 += 1
    if block:
        redmule_matmul.launches_faithful += 1
        if N > block:
            redmule_matmul.launches_multiblock += 1
    if fused_bwd:
        redmule_matmul.launches_fused_bwd += 1
        if x.dtype == torch.float32:
            redmule_matmul.launches_fused_bwd_fp32 += 1
    return out


redmule_matmul.launches = 0
redmule_matmul.launches_fp32 = 0
redmule_matmul.launches_fp8 = 0
redmule_matmul.launches_faithful = 0
redmule_matmul.launches_multiblock = 0
redmule_matmul.launches_fused_bwd = 0
redmule_matmul.launches_fused_bwd_fp32 = 0
redmule_matmul.launches_split = 0


def redmule_matmul_batched(x: torch.Tensor, w: torch.Tensor, *,
                           policy: prec.Policy,
                           tile: Optional[tiling.TileConfig] = None,
                           bias: Optional[torch.Tensor] = None,
                           epilogue: Optional[str] = None,
                           layout: str = "nn",
                           accum_block: Optional[int] = None) -> torch.Tensor:
    """Batched ``Z[b] = act(X[b] @ W[b] + bias)`` (kernel 2).

    ``x`` is ``(..., M, N)`` and ``w`` ``(..., N, K)`` as stored under
    ``layout``, with broadcast-compatible leading dims; the result is
    ``(*lead, M, K)``.  A broadcast operand is read through a batch stride
    of 0, never materialised per batch element; ``bias`` (``(K,)``) is
    shared across the batch.  Under faithful accumulation each batch
    element rounds like the 2D kernel, every ``accum_block`` rows."""
    _check(x, w, policy, bias, epilogue)
    if x.ndim < 2 or w.ndim < 2:
        raise ValueError(f">=2D operands expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    M, N, K = rm.logical_dims(x.shape, w.shape, layout)
    block = _block(policy, x, w, M, N, K, accum_block, False)
    if x.device.type == "cpu":
        return rm.redmule_matmul_plain(x, w, policy=policy, bias=bias,
                                       epilogue=epilogue, layout=layout,
                                       accum_block=block)
    lead = tuple(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
    if min(M, N, K, *lead) == 0:
        return _empty_problem(lead, M, N, K, policy=policy, bias=bias,
                              epilogue=epilogue, device=x.device)
    z, splits = rm.launch(x, w, policy=policy,
                          tile=tile or tiling.choose_tiles(M, N, K), bias=bias,
                          epilogue=epilogue, layout=layout,
                          accum_block=block or 0)
    redmule_matmul_batched.launches += 1
    if splits > 1:
        redmule_matmul_batched.launches_split += 1
    if x.dtype == torch.float32:
        redmule_matmul_batched.launches_fp32 += 1
    if _is_fp8(x, w):
        redmule_matmul_batched.launches_fp8 += 1
    return z


redmule_matmul_batched.launches = 0
redmule_matmul_batched.launches_fp32 = 0
redmule_matmul_batched.launches_fp8 = 0
redmule_matmul_batched.launches_split = 0
