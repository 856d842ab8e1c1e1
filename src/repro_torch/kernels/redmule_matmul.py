"""The RedMulE GEMM on Hopper: the CUDA launcher and the plain version.

Counterpart of ``repro.kernels.redmule_matmul``.  The logical contraction
is always ``Z[M, K] = act(X[M, N] @ W[N, K] + bias)``; ``layout`` names how
the operands are stored:

* ``"nn"``: x (M, N), w (N, K) — the forward;
* ``"nt"``: x (M, N), w (K, N) — e.g. the tied LM head reads the (V, d)
  embedding as it is stored;
* ``"tn"``: x (N, M), w (N, K).

The CUDA kernel (``csrc/redmule_matmul.cu``) addresses every operand
through element strides, so a layout is index arithmetic only and any
strided view — a transposed one, or a broadcast one with stride 0 — is
consumed in place.  :func:`redmule_matmul_plain` is the same function in
plain PyTorch: upcast to the accumulator dtype, ``torch.matmul``, bias and
epilogue, one cast.  It serves tensors on the CPU and is what the kernel is
held against on the card.

Three modes of the reference kernel ride on the same contraction:

* **faithful accumulation** (an fp16 accumulator, ``policy.blockwise_accum``:
  ``paper_fp16``, ``mixed_fp8_e4m3`` and its fp32-out ``*_scores``):
  the accumulator is fp16 and re-rounded after every ``accum_block`` rows
  of the reduction — the partial product of a block is an fp32 sum rounded
  once, then added into the fp16 running sum — and the bias, the epilogue
  and the store run in fp16 too;
* **the fused backward epilogue**: ``deriv`` (stored like the dZ operand:
  the x slot on "nt", the w slot on "tn") multiplies the dZ operand by
  ``act'(deriv)`` in the accumulator dtype before the product
  (``grad_from_output`` picks the output form of the derivative), and
  ``bias_grad`` (on "tn") also returns ``db``, the column sums of that
  scaled dZ over the reduction rows, accumulated per block like the GEMM;
* **FP8 storage, upcast on load** (the ``mixed_fp8_*`` policies): either
  operand may be ``float8_e4m3fn`` / ``float8_e5m2`` (the per-tensor scale
  is the engine's business); it is widened to the compute dtype (fp16) on
  its way into the kernel's shared-memory tile, so the bytes in device
  memory stay narrow and the values are those of the pre-widened operand.
  The kernel is compiled for the pairs the two policies produce
  (declared in :data:`FP8_KERNELS`); a launch on any other pair raises.

A launch with few output tiles splits its reduction inside the kernel
(the plan its caller resolved, :func:`repro_torch.core.tiling.launch_plan`:
the heuristic's from the shapes alone, or a tuned S): S slices, each block's fp32 partial written to a workspace
(``S x batch x M x K``, allocated per call), the last block of each output
tile summing them in split order and storing once.  The tile counters that
find that last block live in one int32 buffer per device, zeroed when it is
allocated or grown and reset by the kernel itself, so no memset runs per
call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels import ref

__all__ = ["LAYOUTS", "FP8_KERNELS", "logical_dims", "redmule_matmul_plain",
           "launch", "storage_dtype", "check_split"]

LAYOUTS = ("nn", "nt", "tn")
_E4, _E5 = torch.float8_e4m3fn, torch.float8_e5m2
_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2, _E4: 3,
               _E5: 4}
# The FP8 instantiations, declared: csrc/redmule_matmul.cu's `kFp8Pair`
# decides what runs, this set names it (for error messages, and for the
# tests that hold the paths' dispatches to it; chip_smoke.py launches each
# pair and checks that an undeclared one fails).  (x storage, w storage,
# output, ext), ext = the faithful fp16 accumulator or the fused backward
# epilogue.  mixed_fp8_e4m3 (faithful): forward, tied head, PV and
# the fp32-out decode scores (E4M3 x E4M3), dX (E5M2 dZ x E4M3 W) and dW
# (E4M3 X x E5M2 dZ), the last two also with deriv / db.  mixed_fp8_e5m2
# (fp32 accumulator): E5M2 x E5M2 with an fp16 (forward) or fp32 ("+grad")
# output.
FP8_KERNELS = frozenset({
    (_E4, _E4, torch.float16, True), (_E4, _E4, torch.float32, True),
    (_E5, _E4, torch.float16, True), (_E4, _E5, torch.float16, True),
    (_E5, _E5, torch.float16, False), (_E5, _E5, torch.float32, False)})


def _fp8_pairs():
    name = prec.dtype_name
    return sorted((name(a), name(b), name(o), e) for a, b, o, e in FP8_KERNELS)


def check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: {LAYOUTS}")


def logical_dims(x_shape: Sequence[int], w_shape: Sequence[int],
                 layout: str) -> Tuple[int, int, int]:
    """(M, N, K) of the logical contraction from the stored trailing dims;
    raises on a contraction mismatch."""
    check_layout(layout)
    (xa, xb), (wa, wb) = tuple(x_shape[-2:]), tuple(w_shape[-2:])
    if layout == "nn":
        M, N, N2, K = xa, xb, wa, wb
    elif layout == "nt":
        M, N, K, N2 = xa, xb, wa, wb
    else:  # tn
        N, M, N2, K = xa, xb, wa, wb
    if N != N2:
        raise ValueError(f"contraction mismatch under layout {layout!r}: "
                         f"{tuple(x_shape)} x {tuple(w_shape)}")
    return M, N, K


def _logical(x: torch.Tensor, w: torch.Tensor, layout: str):
    """Views of x as (..., M, N) and w as (..., N, K)."""
    if layout == "tn":
        x = x.transpose(-1, -2)
    if layout == "nt":
        w = w.transpose(-1, -2)
    return x, w


def storage_dtype(t: torch.Tensor) -> Optional[torch.dtype]:
    """An operand's dtype where it is FP8 storage, else None (the compute
    dtype), as the tile heuristic keys it."""
    return t.dtype if prec.is_fp8(t.dtype) else None


def _deriv_scaled(dz: torch.Tensor, deriv: Optional[torch.Tensor],
                  grad_epilogue: Optional[str], grad_from_output: bool,
                  acc) -> torch.Tensor:
    """``dZ * act'(deriv)`` in the accumulator dtype (``dZ`` alone without
    a ``grad_epilogue``)."""
    dsa = dz.to(acc)
    if grad_epilogue is None:
        return dsa
    g = epi.epilogue_grad(grad_epilogue)
    d = deriv.to(acc)
    return dsa * (g.deriv_from_output(d) if grad_from_output else g.deriv(d))


def redmule_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         policy: prec.Policy,
                         bias: Optional[torch.Tensor] = None,
                         epilogue: Optional[str] = None,
                         layout: str = "nn",
                         deriv: Optional[torch.Tensor] = None,
                         grad_epilogue: Optional[str] = None,
                         grad_from_output: bool = False,
                         bias_grad: bool = False,
                         accum_block: Optional[int] = None):
    """``act(X @ W + bias)`` in plain PyTorch; leading dims broadcast.

    Operands are upcast to the accumulator dtype, multiplied with
    ``torch.matmul`` (per ``accum_block`` under faithful accumulation, see
    the module docstring), the bias and epilogue applied in that dtype, and
    the result cast once to ``policy.out_dtype`` — the kernel's store-once
    contract.  With ``grad_epilogue`` / ``bias_grad`` the dZ operand is
    first scaled by ``act'(deriv)``; ``bias_grad`` returns ``(z, db)``
    with ``db`` the accumulator-dtype ``(K,)`` row.  FP8 operands are
    widened first (exactly: every FP8 value is an fp16 and an fp32)."""
    if policy.blockwise_accum and accum_block is None:
        M, N, K = logical_dims(x.shape, w.shape, layout)
        accum_block = tiling.accum_block(
            M, N, K, compute_dtype=policy.compute_dtype,
            accum_dtype=policy.accum_dtype,
            fused_bwd=grad_epilogue is not None or bias_grad,
            x_dtype=storage_dtype(x), w_dtype=storage_dtype(w))
    xl, wl = _logical(x, w, layout)
    acc = policy.accum_dtype
    db = None
    if grad_epilogue is not None or bias_grad:
        on_x = layout == "nt"
        dsa = _deriv_scaled(xl if on_x else wl, deriv, grad_epilogue,
                            grad_from_output, acc)
        if bias_grad:
            db = (ref.faithful_row_sum(dsa, acc, accum_block)
                  if policy.blockwise_accum else dsa.sum(dim=-2))
        ds = dsa.to(policy.compute_dtype)
        xl, wl = (ds, wl) if on_x else (xl, ds)
    if policy.blockwise_accum:
        z = ref.faithful_matmul(xl.to(policy.compute_dtype),
                                wl.to(policy.compute_dtype), acc, accum_block)
    else:
        z = torch.matmul(xl.to(acc), wl.to(acc))
    if bias is not None:
        z = z + bias.reshape(-1).to(acc)
    z = epi.apply_epilogue(epilogue, z).to(policy.out_dtype)
    return (z, db) if bias_grad else z


def _lib() -> ctypes.CDLL:
    lib = _build.load("redmule_matmul")
    if lib.redmule_gemm.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.redmule_gemm.argtypes = [
            i, i, i, i, p, p, p, p, i, i, i, i, i,
            ll, ll, ll, ll, i, ll, ll, ll, ll, i, i,
            i, p, ll, ll, i, i, i, p, i, i, p, p, p]
        lib.redmule_gemm.restype = i
        lib.redmule_error_string.argtypes = [i]
        lib.redmule_error_string.restype = ctypes.c_char_p
    return lib


def _collapse(t: torch.Tensor, lead: Sequence[int]) -> Tuple[torch.Tensor, int, int]:
    """``(t, outer, inner)``: element strides of a tensor expanded to
    ``(*lead, r, c)`` over the two batch levels the kernel knows — all lead
    dims but the last (collapsed into one) and the last.  A broadcast level
    has stride 0.  If the outer dims do not collapse into one stride the
    operand is made contiguous first."""
    t = t.expand(*lead, *t.shape[-2:])
    if not lead:
        return t, 0, 0
    outer_dims = [(n, s) for n, s in zip(lead[:-1], t.stride()[:-3]) if n > 1]
    inner = t.stride(-3) if lead[-1] > 1 else 0
    outer = outer_dims[-1][1] if outer_dims else 0
    span = outer
    for n, s in reversed(outer_dims):
        if s != span:
            return _collapse(t.contiguous(), lead)
        span = s * n
    return t, outer, inner


def _vec_ok(t: torch.Tensor, batch_strides, s_row: int, s_col: int,
            rows: int, cols: int) -> int:
    """Whether the kernel may copy ``t`` in 16-byte runs (see
    ``issue_tile`` in csrc/redmule_matmul.cu): 16-byte aligned runs along
    the contiguous axis — 8 elements of fp16 / bf16, 4 of fp32, 16 of FP8 —
    and an extent there that is a multiple of one."""
    n = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % n for s in batch_strides):
        return 0
    if s_col == 1:
        return int(cols % n == 0 and (rows == 1 or s_row % n == 0))
    if s_row == 1:
        return int(rows % n == 0 and (cols == 1 or s_col % n == 0))
    return 0


def check_split(plan: tiling.SplitPlan, N: int, *, route: str,
                accum_block: int = 0, fused_bwd: bool = False) -> None:
    """Raise ValueError on a split the kernel does not take (its own
    argument check, csrc/redmule_matmul.cu ``redmule_gemm``): S slices of
    a depth that is a multiple of the route's step and covers ``N`` with
    the last slice non-empty; none with the fused backward; under a
    faithful accumulator, slices inside one rounding block."""
    S, depth = plan
    if S == 1:
        return
    step = tiling.SPLIT_STEP[route]
    why = None
    if not 1 < S <= 65535:
        why = "S outside [1, 65535]"
    elif depth <= 0 or depth % step:
        why = f"a depth that is not a positive multiple of the {route} step {step}"
    elif not (S - 1) * depth < N <= S * depth:
        why = f"{S} slices of {depth} do not cover N = {N} with a non-empty last one"
    elif fused_bwd:
        why = "a split of the fused backward (deriv / db)"
    elif accum_block and accum_block % depth:
        why = f"slices straddling the rounding block {accum_block}"
    if why:
        raise ValueError(f"split plan {tuple(plan)} is not one the kernel takes: {why}")


# the split's tile counters, one int32 buffer per device (zero between launches)
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _tile_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        grown = max(n, 2 * (0 if buf is None else buf.numel()))
        buf = _COUNTERS[device] = torch.zeros(grown, dtype=torch.int32,
                                              device=device)
    return buf


def launch(x: torch.Tensor, w: torch.Tensor, *, policy: prec.Policy,
           tile: tiling.TileConfig, plan: tiling.SplitPlan,
           bias: Optional[torch.Tensor], epilogue: Optional[str], layout: str,
           accum_block: int = 0, deriv: Optional[torch.Tensor] = None,
           grad_epilogue: Optional[str] = None, grad_from_output: bool = False,
           bias_grad: bool = False):
    """Run the CUDA kernel on CUDA operands with broadcast-compatible
    leading dims; returns ``(out, S)``: ``out`` is ``(*lead, M, K)`` in
    ``policy.out_dtype``, and with ``bias_grad`` ``(z, db)``, ``db`` a
    ``(K,)`` row in the accumulator dtype; ``S`` the number of slices the
    reduction was split into.

    ``tile`` is a menu tile (its block shape; ValueError otherwise) and
    ``plan`` the resolved split (:func:`tiling.launch_plan`), which
    :func:`check_split` guards: the kernel's own refusals raise here
    first.  The split's tile counters grow to the launch's output tiles.

    ``accum_block`` > 0 runs the faithful fp16 accumulator (re-rounded
    every ``accum_block`` reduction rows).  ``deriv`` is read through its
    own strides, walking exactly like the dZ operand.  The caller has
    validated dtypes, devices and shapes and handled degenerate (empty)
    problems."""
    lead = tuple(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
    M, N, K = logical_dims(x.shape, w.shape, layout)
    x, xs_o, xs_i = _collapse(x, lead)
    w, ws_o, ws_i = _collapse(w, lead)
    xl, wl = _logical(x, w, layout)
    xs_m, xs_n = xl.stride(-2), xl.stride(-1)
    ws_n, ws_k = wl.stride(-2), wl.stride(-1)
    z = torch.empty((*lead, M, K), dtype=policy.out_dtype, device=x.device)
    if bias is not None:
        # the kernel reads bias[k] as fp32 holding accumulator-dtype values
        bias = bias.reshape(-1).to(policy.accum_dtype).float().contiguous()
    # which operand slot holds dZ: 1 = x ("nt"), 2 = w ("tn")
    slot = 0
    if grad_epilogue is not None or bias_grad:
        slot = 1 if layout == "nt" else 2
    db = (torch.empty((K,), dtype=torch.float32, device=x.device)
          if bias_grad else None)
    tile_id = tiling.tile_index(tile)
    batch = math.prod(lead)
    route = "simt" if x.dtype == torch.float32 else "tensor"
    check_split(plan, N, route=route, accum_block=int(accum_block),
                fused_bwd=slot != 0)
    part = counters = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, batch, M, K), dtype=torch.float32,
                           device=x.device)
        counters = _tile_counters(
            x.device, batch * -(-M // tile.bm) * -(-K // tile.bk))
    if x.device.type == "meta":     # the dry run: the allocations, no launch
        return ((z, db.to(policy.accum_dtype)) if bias_grad else z), plan.splits
    lib = _lib()
    err = lib.redmule_gemm(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
        _DTYPE_CODE[policy.out_dtype], tile_id,
        x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), z.data_ptr(),
        batch, lead[-1] if lead else 1, M, N, K,
        xs_o, xs_i, xs_m, xs_n, _vec_ok(x, (xs_o, xs_i), xs_m, xs_n, M, N),
        ws_o, ws_i, ws_n, ws_k, _vec_ok(w, (ws_o, ws_i), ws_n, ws_k, N, K),
        epi.EPILOGUE_IDS[epilogue], int(accum_block),
        None if deriv is None else deriv.data_ptr(),
        0 if deriv is None else deriv.stride(-2),
        0 if deriv is None else deriv.stride(-1), slot,
        epi.EPILOGUE_IDS[grad_epilogue], int(grad_from_output),
        None if db is None else db.data_ptr(), plan.splits, plan.depth,
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        ext = bool(accum_block) or slot != 0
        raise RuntimeError(
            f"redmule_gemm launch failed ({prec.dtype_name(x.dtype)} x "
            f"{prec.dtype_name(w.dtype)} -> {prec.dtype_name(policy.out_dtype)}"
            f"{', faithful / fused backward' if ext else ''}): "
            f"{lib.redmule_error_string(err).decode()}; FP8 pairs compiled "
            f"(x, w, out, faithful / fused): {_fp8_pairs()}")
    if bias_grad:
        return (z, db.to(policy.accum_dtype)), plan.splits
    return z, plan.splits
