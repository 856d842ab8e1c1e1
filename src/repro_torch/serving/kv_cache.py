"""Slot admission into the pooled decode cache.

Counterpart of ``repro.serving.kv_cache.insert_slot`` for fp16 / bf16 /
fp32 GQA and MLA caches, stacked or not (the MoE kind's ``layer0``); the
FP8 pool, byte accounting and slot checksums are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import precision as prec

__all__ = ["insert_slot"]

CacheTree = Dict[str, Any]


# leaf names and unstacked rank of each attention cache: GQA k / v
# (B, Hkv, T, hd), MLA ckv / kr (B, T, c); a stacked leaf has one more dim
_LEAVES = {"k": (("k", "v"), 4), "ckv": (("ckv", "kr"), 3)}


@torch.inference_mode()
def insert_slot(pool: CacheTree, single: CacheTree, slot: int) -> CacheTree:
    """Write a single-request cache (batch 1) into ``slot`` of the pool, in
    place, and return the pool.  Subtrees are GQA (``k`` / ``v``) or MLA
    (``ckv`` / ``kr``), stacked over layers (batch dim 1) or not (0)."""
    for key, sub in pool.items():
        kind = next((k for k in _LEAVES if k in sub), None)
        if kind is None:
            raise ValueError("slot insertion supports attn/moe (GQA / MLA) "
                             "caches only")
        names, rank = _LEAVES[kind]
        for name in names:
            leaf, new = sub[name], single[key][name]
            if prec.is_fp8(leaf.dtype):
                raise NotImplementedError(
                    "the FP8 KV cache is not yet ported (see ROADMAP.md)")
            bax = leaf.ndim - rank
            leaf.select(bax, slot).copy_(new.select(bax, 0))
    return pool
