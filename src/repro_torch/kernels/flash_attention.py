"""Causal GQA flash attention on Hopper: wrapper, launcher, plain version.

Counterpart of ``repro.kernels.flash_attention``.  q ``(BHq, S, D)``,
k / v ``(BHkv, T, D)`` with ``BHq == BHkv * group`` (KV head = q head //
group, never materialised per q head).  ``t_valid`` masks the KV tail
(col >= t_valid is dead), ``q_offset`` is the absolute position of query
row 0 for the causal mask (col <= q_offset + row); a row with no visible
column returns exact zeros; the output is in q's dtype.

A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor launches
``csrc/flash_attention.cu`` (D in {64, 128}; bf16 / fp16 on tensor-core
``mma.sync`` products, four warps on 16 query rows, each taking 16 KV rows
at a time — the ``tiling.FLASH_BQ`` x ``FLASH_BKV`` the engine bills;
fp32, as the reference's kernel takes it, in SIMT FMAs over the same 16
query rows) or raises.  The kernel masks ragged S and T itself, so nothing
is padded.  ``flash_attention.launches`` counts kernel launches.
A meta tensor inside the dry run takes the card's checks and returns an
empty output, with no launch and no count (``kernels/ops.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain"]

NEG_INF = -1e30
_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}


def _visible(S: int, T: int, *, causal: bool, t_valid: int, q_offset: int,
             device) -> torch.Tensor:
    """(S, T) bool: which KV columns each query row sees."""
    cols = torch.arange(T, device=device)
    mask = (cols < t_valid)[None, :].expand(S, T)
    if causal:
        rows = q_offset + torch.arange(S, device=device)
        mask = mask & (cols[None, :] <= rows[:, None])
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          group: int = 1, causal: bool = True,
                          scale: Optional[float] = None,
                          t_valid: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores and softmax over
    the visible columns (masked scores -1e30), rows with no visible column
    exact zeros, fp32 PV, one cast to q's dtype."""
    BHq, S, D = q.shape
    T = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    t_valid = T if t_valid is None else t_valid
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * scale
    mask = _visible(S, T, causal=causal, t_valid=t_valid, q_offset=q_offset,
                    device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)
    return torch.matmul(p, vf).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.flash_attention_fwd.argtypes = [
            i, i, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_error_string.argtypes = [i]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, causal: bool = True,
                    scale: Optional[float] = None,
                    bq: Optional[int] = None, bkv: Optional[int] = None,
                    t_valid: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention forward (kernel 3); see the module docstring.

    ``bq`` / ``bkv`` name the block geometry the caller billed; the kernel
    runs ``(tiling.FLASH_BQ, tiling.FLASH_BKV)`` and refuses any other."""
    BHq, S, D = q.shape
    BHkv, T, Dk = k.shape
    if Dk != D or v.shape != k.shape or BHq != BHkv * group:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} with group {group}")
    scale = float(D ** -0.5 if scale is None else scale)
    t_valid = T if t_valid is None else min(int(t_valid), T)
    from repro_torch.kernels.ops import card_contract, on_card

    if not on_card(q):
        return flash_attention_plain(q, k, v, group=group, causal=causal,
                                     scale=scale, t_valid=t_valid,
                                     q_offset=q_offset)
    if not card_contract(q):
        return torch.empty_like(q)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if (bq or tiling.FLASH_BQ, bkv or tiling.FLASH_BKV) != (
            tiling.FLASH_BQ, tiling.FLASH_BKV):
        raise ValueError(f"the flash kernel runs bq={tiling.FLASH_BQ}, "
                         f"bkv={tiling.FLASH_BKV}; got bq={bq}, bkv={bkv}")
    if D not in (64, 128):
        raise ValueError(f"the flash kernel supports D in (64, 128), got {D}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"bf16/fp16/fp32 operands of one dtype expected, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("the flash kernel needs 16-byte aligned operands")
    out = torch.empty_like(q)
    if BHq == 0 or S == 0 or q.device.type == "meta":   # meta: the dry run
        return out
    lib = _lib()
    err = lib.flash_attention_fwd(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), BHq, S, T, group, scale, t_valid, int(q_offset),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
