"""Chunked linear attention on Hopper: wrapper, launcher, plain version.

Counterpart of ``repro.kernels.chunked_linear_attention``: the mLSTM /
Mamba2-SSD state sweep

    S_t = exp(g_t) S_{t-1} + k_t v_t^T ;   out_t = q_t S_t

evaluated chunk by chunk, with the fp32 state starting at zero and stored
once at the end.  q, k ``(BH, S, dk)``, v ``(BH, S, dv)``, log_g ``(BH, S)``
(log decays, <= 0) -> ``(out (BH, S, dv) in q's dtype, state (BH, dk, dv)
fp32)``.  ``S`` must be a multiple of ``chunk``: callers pad with g = 0,
k = 0, which is inert (``repro_torch.core.engine`` does).

q and k share a dtype; v has q's, or, with fp32 q / k, bf16 or fp16 (the
Mamba2 / SSD mixer's C and B come from an fp32 GEMM, its v = dt·x in the
compute dtype: the reference kernel widens every operand to fp32 on load).

A CPU tensor takes :func:`chunked_linear_attention_plain`; a CUDA tensor
launches ``csrc/chunked_linear_attention.cu`` (the dtype pairs of
:data:`DTYPE_PAIRS`, chunk in {16, 32, 64, 128}, dk up to 1024, any dv)
or raises: first its
scores kernel (``L`` and the decayed masked scores of every chunk, into
scratch — :func:`chunk_scores_plain` is their plain version), then the
sweep on the tensor cores, with the fp32 operands split into TF32 pieces.
``chunked_linear_attention.launches`` counts wrapper calls that launched
the pair.
A meta tensor inside the dry run takes the card's checks (all but the
shared-memory budget, which only the compiled library answers) and the
launch's allocations, with no launch and no count (``kernels/ops.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build

__all__ = ["chunked_linear_attention", "chunked_linear_attention_plain",
           "chunk_scores_plain", "chunk_cumsum", "CHUNKS", "MAX_DK", "DTYPE_PAIRS"]

CHUNKS = (16, 32, 64, 128)     # the kernel's compiled chunk sizes
MAX_DK = 1024                  # the sweep holds S^T (32 x dk) in registers
_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
# the kernel's compiled (q / k, v) dtype pairs; out takes q's dtype
DTYPE_PAIRS = ((torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.float32, torch.float16))


def chunk_cumsum(log_g: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum over the last dim, accumulated in fp64 and
    rounded once to fp32: the same values on every device (PyTorch's CPU
    cumsum of fp32 accumulates in fp64, its CUDA one in fp32) and the
    kernel's for fp32 inputs.  exp(L) turns an error in L into a relative
    error of the same size, and an fp32 scan is off by a few ulps of |L|."""
    return torch.cumsum(log_g.double(), dim=-1).float()


def chunked_linear_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, log_g: torch.Tensor, *,
                                   chunk: int = 128):
    """The kernel's function in plain PyTorch, chunk by chunk in fp32 (the
    reference kernel's per-chunk step, batched over heads): every operand
    widened to fp32, out in q's dtype (the dtype rule of
    :data:`DTYPE_PAIRS`)."""
    BH, S, dk = q.shape
    dv = v.shape[-1]
    _check_shapes(q, k, v, log_g, chunk)
    _check_dtypes(q, k, v)
    state = torch.zeros((BH, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    for s0 in range(0, S, chunk):
        qc = q[:, s0:s0 + chunk].float()
        kc = k[:, s0:s0 + chunk].float()
        vc = v[:, s0:s0 + chunk].float()
        L = chunk_cumsum(log_g[:, s0:s0 + chunk])                # (BH, c)
        ltot = L[:, -1:]
        A = torch.where(causal, torch.exp(L[:, :, None] - L[:, None, :]),
                        torch.zeros((), device=q.device))
        s = torch.matmul(qc, kc.transpose(1, 2)) * A
        out = torch.matmul(s, vc) + torch.matmul(qc * torch.exp(L)[..., None], state)
        kdec = kc * torch.exp(ltot - L)[..., None]
        state = (torch.exp(ltot)[..., None] * state
                 + torch.matmul(kdec.transpose(1, 2), vc))
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1), state


def chunk_scores_plain(q: torch.Tensor, k: torch.Tensor, log_g: torch.Tensor,
                       *, chunk: int = 128):
    """What the kernel's first launch writes, in plain PyTorch: ``L``
    ``(BH, S)``, the inclusive cumsum of ``log_g`` within each chunk, and
    ``A`` ``(BH, S // chunk, chunk, chunk)``, the decayed, causally masked
    scores ``(q k^T) * exp(L_i - L_j) [i >= j]`` of each chunk, in fp32."""
    BH, S, _ = q.shape
    if chunk <= 0 or S % chunk or tuple(k.shape) != tuple(q.shape) \
            or tuple(log_g.shape) != (BH, S):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, log_g "
                         f"{tuple(log_g.shape)} at chunk {chunk}")
    n = S // chunk
    L = chunk_cumsum(log_g.reshape(BH, n, chunk))
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    decay = torch.where(causal, torch.exp(L[..., :, None] - L[..., None, :]),
                        torch.zeros((), device=q.device))
    qc = q.float().reshape(BH, n, chunk, -1)
    kc = k.float().reshape(BH, n, chunk, -1)
    return L.reshape(BH, S), torch.matmul(qc, kc.transpose(-1, -2)) * decay


def _check_shapes(q, k, v, log_g, chunk: int) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.ndim != 3 \
            or v.shape[:2] != q.shape[:2] or tuple(log_g.shape) != q.shape[:2]:
        raise ValueError(
            f"expected q, k (BH, S, dk), v (BH, S, dv), log_g (BH, S); got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)} / "
            f"{tuple(log_g.shape)}")
    if chunk <= 0 or q.shape[1] % chunk:
        raise ValueError(f"S = {q.shape[1]} must be a positive multiple of "
                         f"chunk = {chunk} (pad with g = 0, k = 0)")


def _check_dtypes(q, k, v) -> None:
    if (q.dtype, v.dtype) not in DTYPE_PAIRS or k.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype} / {k.dtype} / {v.dtype}: q and "
                        "k share one, v has q's or, with fp32 q / k, bf16 / fp16")


def _lib() -> ctypes.CDLL:
    lib = _build.load("chunked_linear_attention")
    if lib.chunked_linear_attention.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.chunked_linear_attention.argtypes = [i, i, i, p, p, p, p, p, p, p,
                                                 p, i, i, i, i, p]
        lib.chunked_linear_attention.restype = i
        lib.cla_smem_bytes.argtypes = [i, i, i, i]
        lib.cla_smem_bytes.restype = ctypes.c_longlong
        lib.cla_error_string.argtypes = [i]
        lib.cla_error_string.restype = ctypes.c_char_p
    return lib


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_g: torch.Tensor, *,
                             chunk: int = 128):
    """``(out, state)`` of the chunked sweep (see the module docstring)."""
    _check_shapes(q, k, v, log_g, chunk)
    if not (q.device == k.device == v.device == log_g.device):
        raise ValueError("operands on different devices")
    from repro_torch.kernels.ops import card_contract, on_card

    if not on_card(q):
        return chunked_linear_attention_plain(q, k, v, log_g, chunk=chunk)
    if not card_contract(q):
        BH, S, dk = q.shape
        return (q.new_empty((BH, S, v.shape[-1])),
                q.new_empty((BH, dk, v.shape[-1]), dtype=torch.float32))
    _check_dtypes(q, k, v)
    if log_g.dtype != torch.float32:
        raise TypeError(f"log_g must be float32, got {log_g.dtype}")
    if chunk not in CHUNKS:
        raise NotImplementedError(f"chunk {chunk}: the kernel is compiled for "
                                  f"{CHUNKS}")
    BH, S, dk = q.shape
    dv = v.shape[-1]
    if BH > 65535:
        raise ValueError(f"BH = {BH} exceeds the kernel's grid (65535)")
    if dk > MAX_DK:
        raise NotImplementedError(f"dk = {dk}: the sweep holds its state in "
                                  f"registers up to dk = {MAX_DK}")
    meta = q.device.type == "meta"      # the dry run: no library to ask
    lib = None if meta else _lib()
    codes = (_DTYPE_CODE[q.dtype], _DTYPE_CODE[v.dtype])
    smem = 0 if meta else lib.cla_smem_bytes(*codes, chunk, dk)
    if smem > tiling.SMEM_BUDGET:
        raise NotImplementedError(
            f"dk = {dk} at chunk {chunk} needs {smem} B of shared memory "
            f"(budget {tiling.SMEM_BUDGET})")
    out = torch.empty((BH, S, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((BH, dk, dv), dtype=torch.float32, device=q.device)
    if min(BH, S, dk, dv) == 0:
        return out.zero_(), state.zero_()
    q, k, v, log_g = (t.contiguous() for t in (q, k, v, log_g))
    # scratch of the scores launch: L (BH, S) and the scores (BH, S, chunk)
    scratch = torch.empty(BH * S * (chunk + 1), dtype=torch.float32,
                          device=q.device)
    if meta:
        return out, state
    err = lib.chunked_linear_attention(
        *codes, chunk, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        log_g.data_ptr(), out.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + BH * S * 4, BH, S, dk, dv,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("chunked_linear_attention launch failed: "
                           f"{lib.cla_error_string(err).decode()}")
    chunked_linear_attention.launches += 1
    return out, state


chunked_linear_attention.launches = 0
