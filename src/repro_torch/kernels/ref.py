"""Plain-PyTorch oracles (counterpart of ``repro.kernels.ref``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import precision as prec
from repro_torch.core import tiling

__all__ = ["matmul_ref", "matmul_exact", "attention_ref"]


def matmul_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ground truth, ignoring the policy (for error measurements)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, policy: prec.Policy,
               tile: Optional[tiling.TileConfig] = None) -> torch.Tensor:
    """Oracle with the kernel's accumulation semantics: one accum-dtype
    product and one downcast, or — under ``faithful_accum`` — partial
    products per ``bn`` block re-rounded to the accumulator dtype."""
    xc = x.to(policy.compute_dtype).to(policy.accum_dtype)
    wc = w.to(policy.compute_dtype).to(policy.accum_dtype)
    if not policy.faithful_accum:
        return torch.matmul(xc, wc).to(policy.out_dtype)
    bn = tile.bn if tile is not None else 128
    N = x.shape[-1]
    acc = torch.zeros((*xc.shape[:-1], wc.shape[-1]), dtype=policy.accum_dtype,
                      device=x.device)
    for b0 in range(0, N, bn):
        part = torch.matmul(xc[..., b0:b0 + bn].float(),
                            wc[b0:b0 + bn].float()).to(policy.accum_dtype)
        acc = (acc + part).to(policy.accum_dtype)
    return acc.to(policy.out_dtype)


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
