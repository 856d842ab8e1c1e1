"""Slot admission into the pooled decode cache.

Counterpart of ``repro.serving.kv_cache.insert_slot`` for fp16 / bf16 /
fp32 GQA caches; the FP8 pool, byte accounting and slot checksums are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import precision as prec

__all__ = ["insert_slot"]

CacheTree = Dict[str, Any]


@torch.inference_mode()
def insert_slot(pool: CacheTree, single: CacheTree, slot: int) -> CacheTree:
    """Write a single-request cache (batch 1) into ``slot`` of the pool, in
    place, and return the pool.  Leaves are ``(L, B, Hkv, T, hd)``."""
    for key, sub in pool.items():
        if "k" not in sub:
            raise ValueError("slot insertion supports GQA caches only")
        for name in ("k", "v"):
            leaf, new = sub[name], single[key][name]
            if prec.is_fp8(leaf.dtype):
                raise NotImplementedError(
                    "the FP8 KV cache is not yet ported (see ROADMAP.md)")
            leaf[:, slot] = new[:, 0].to(leaf.dtype)
    return pool
