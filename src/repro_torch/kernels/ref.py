"""Plain-PyTorch oracles (counterpart of ``repro.kernels.ref``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import precision as prec
from repro_torch.core import tiling

__all__ = ["matmul_ref", "matmul_exact", "attention_ref", "faithful_matmul",
           "faithful_row_sum"]


def faithful_matmul(x: torch.Tensor, w: torch.Tensor, accum_dtype,
                    block: int) -> torch.Tensor:
    """``x @ w`` through a faithful accumulator: for each ``block`` of the
    reduction, the fp32 partial product rounded to ``accum_dtype`` and
    added into a running sum in ``accum_dtype`` (the reference kernel's
    ``acc_ref += dot(..., preferred_element_type=fp16)``, whose dot is an
    fp32 sum rounded once).  Leading dims broadcast."""
    N = x.shape[-1]
    z = None
    for b0 in range(0, max(N, 1), block):
        part = torch.matmul(x[..., b0:b0 + block].float(),
                            w[..., b0:b0 + block, :].float()).to(accum_dtype)
        z = part if z is None else (z + part).to(accum_dtype)
    return z


def faithful_row_sum(v: torch.Tensor, accum_dtype, block: int) -> torch.Tensor:
    """The column sums of ``v`` (..., N, K) over N the same way: each
    ``block`` of rows summed in fp32, rounded, added into an
    ``accum_dtype`` running sum."""
    N = v.shape[-2]
    db = None
    for b0 in range(0, max(N, 1), block):
        part = v[..., b0:b0 + block, :].float().sum(dim=-2).to(accum_dtype)
        db = part if db is None else (db + part).to(accum_dtype)
    return db


def matmul_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ground truth, ignoring the policy (for error measurements)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, policy: prec.Policy,
               tile: Optional[tiling.TileConfig] = None) -> torch.Tensor:
    """Oracle with the kernel's accumulation semantics: one accum-dtype
    product and one downcast, or — under an fp16 accumulator — partial
    products per ``bn`` block re-rounded to the accumulator dtype."""
    xc = x.to(policy.compute_dtype).to(policy.accum_dtype)
    wc = w.to(policy.compute_dtype).to(policy.accum_dtype)
    if not policy.blockwise_accum:
        return torch.matmul(xc, wc).to(policy.out_dtype)
    bn = tile.bn if tile is not None else 128
    return faithful_matmul(xc, wc, policy.accum_dtype, bn).to(policy.out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention, (B, H, S, D) operands, fp32 softmax; the
    causal mask aligns the last query with the last key."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        S, T = s.shape[-2], s.shape[-1]
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril(T - S)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
