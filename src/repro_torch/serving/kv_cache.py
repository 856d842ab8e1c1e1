"""The serving side of the KV cache: slot admission, integrity, accounting.

Counterpart of ``repro.serving.kv_cache`` (the quantized cache itself lives
in the model layer: :func:`repro_torch.models.transformer.init_cache` with
``storage_dtype``, see :mod:`repro_torch.models.attention`):

* :func:`insert_slot` writes a prefilled single-request cache (batch 1)
  into one slot of the pooled decode cache, in place.  An FP8 pool is
  dequantized whole, merged wide, its delayed scales refreshed from the
  merged amax and requantized under the ratcheted scale, as the
  reference's does: an admission is one more delayed-scaling observation.
* :func:`slot_checksum` / :func:`corrupt_slot_rows`: CRC32 over the
  *stored* bytes of one slot's valid rows (FP8 codes or 16-bit halves
  alike; the scale leaves are left out, since any admission may
  requantize the whole pool), and the matching deterministic corruptor of
  the fault injector.  The bytes are the reference's for the same values
  (C order, little-endian), so the digests are equal.
* Byte accounting (:func:`decode_step_kv_bytes`, :func:`cache_size_bytes`
  and their parts): what a serving memory system moves and holds, counted
  from the configuration; the engine's events price GEMM operands in the
  compute dtype, so the cache's storage width needs its own model.  These
  reproduce ``benchmarks/baselines/serve_bytes.json``.

Caches are GQA (``k`` / ``v`` ``(B, Hkv, T, hd)``) or MLA (``ckv`` /
``kr`` ``(B, T, c)``) subtrees, stacked over layers (one more leading dim)
or not (the MoE kind's ``layer0``).
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.core import precision as prec
from repro_torch.models import attention

__all__ = [
    "is_fp8_cache", "insert_slot", "n_cache_layers", "token_elems",
    "n_scale_elems", "storage_width", "decode_step_kv_bytes",
    "cache_size_bytes", "scale_health", "iter_kv_leaves",
    "slot_checksum", "corrupt_slot_rows",
]

CacheTree = Dict[str, Any]

# leaf names and unstacked rank of each attention cache: GQA k / v
# (B, Hkv, T, hd), MLA ckv / kr (B, T, c)
_LEAVES = {"k": (("k", "v"), 4), "ckv": (("ckv", "kr"), 3)}


def _kind(sub) -> Optional[str]:
    return next((k for k in _LEAVES if isinstance(sub, dict) and k in sub), None)


def is_fp8_cache(cache: CacheTree) -> bool:
    sub = cache.get("layers", cache.get("layer0", {}))
    return "k_scale" in sub or "ckv_scale" in sub


# --------------------------------------------------------------------- #
# Slot admission
# --------------------------------------------------------------------- #
@torch.inference_mode()
def insert_slot(pool: CacheTree, single: CacheTree, slot: int,
                dtype=torch.float16) -> CacheTree:
    """Write a single-request cache (batch 1) into ``slot`` of the pool, in
    place, and return the pool.  FP8 pools dequantize both sides to
    ``dtype``, merge, refresh the pool's delayed scales with the merged
    amax (per layer and KV head for GQA, per layer for MLA) and
    requantize under the ratcheted scale."""
    for key, sub in pool.items():
        kind = _kind(sub)
        if kind is None:
            raise ValueError("slot insertion supports attn/moe (GQA / MLA) "
                             "caches only")
        names, rank = _LEAVES[kind]
        for name in names:
            leaf, new = sub[name], single[key][name]
            bax = leaf.ndim - rank
            sc = sub.get(f"{name}_scale")
            if sc is None:
                leaf.select(bax, slot).copy_(new.select(bax, 0))
                continue
            # a scale leaf (layers..., [Hkv]) against its data leaf: GQA
            # (layers..., 1, Hkv, 1, 1), MLA (layers..., 1, 1, 1)
            tail = (1, -1, 1, 1) if kind == "k" else (1, 1, 1)
            bshape = lambda s: s.reshape(*leaf.shape[:bax], *tail)
            wide = prec.dequantize_fp8(leaf, bshape(sc["scale"]), dtype)
            one = prec.dequantize_fp8(
                new, bshape(single[key][f"{name}_scale"]["scale"]), dtype)
            wide.select(bax, slot).copy_(one.select(bax, 0))
            keep = (bax, *range(bax + 2, leaf.ndim)) if kind == "k" else \
                tuple(range(bax, leaf.ndim))
            new_sc, applied = attention._refresh_scale(sc, wide, keep)
            q, _ = prec.quantize_fp8(wide, leaf.dtype, scale=bshape(applied))
            leaf.copy_(q)
            for k, v in new_sc.items():
                sc[k].copy_(v)
    return pool


# --------------------------------------------------------------------- #
# Slot integrity: checksums and deterministic corruption
# --------------------------------------------------------------------- #
def iter_kv_leaves(cache: CacheTree) -> Iterator[Tuple[str, str, torch.Tensor, int]]:
    """Yield ``(key, name, leaf, batch_axis)`` for every KV data leaf (the
    scale leaves are skipped); the sequence axis is the second to last."""
    for key, sub in cache.items():
        kind = _kind(sub)
        if kind is None:
            continue
        names, rank = _LEAVES[kind]
        for name in names:
            leaf = sub[name]
            yield key, name, leaf, leaf.ndim - rank


def _slot_rows_bytes(leaf: torch.Tensor, bax: int, slot: int, length: int) -> bytes:
    rows = leaf.select(bax, int(slot))[..., :int(length), :].contiguous()
    return rows.view(torch.uint8).cpu().numpy().tobytes()


def slot_checksum(cache: CacheTree, slot: int, length: int) -> int:
    """CRC32 over the raw stored bytes of one slot's first ``length`` rows,
    every cached layer, leaf by leaf in tree order (FP8 codes or 16-bit
    halves); the pool-wide scale state is left out."""
    crc = 0
    for _key, _name, leaf, bax in iter_kv_leaves(cache):
        crc = zlib.crc32(_slot_rows_bytes(leaf, bax, slot, length), crc)
    return crc


def corrupt_slot_rows(cache: CacheTree, slot: int, rows: Sequence[int]) -> CacheTree:
    """Flip every stored bit (XOR 0xFF on each byte) of ``rows`` of one slot
    in every cached layer.  Returns a new cache tree (the KV leaves copied,
    the scale leaves shared and untouched): the matching
    :func:`slot_checksum` audit must flag exactly this slot."""
    idx = torch.as_tensor(sorted({int(r) for r in rows}), dtype=torch.long)
    flipped = {}
    for key, name, leaf, bax in iter_kv_leaves(cache):
        out = leaf.clone()
        u = out.view(torch.uint8).select(bax, int(slot))
        sel = idx.to(u.device)
        u[..., sel, :] = u[..., sel, :] ^ 0xFF
        flipped[(key, name)] = out
    return {key: ({name: flipped.get((key, name), leaf) for name, leaf in sub.items()}
                  if isinstance(sub, dict) else sub)
            for key, sub in cache.items()}


# --------------------------------------------------------------------- #
# Analytic byte accounting
# --------------------------------------------------------------------- #
def n_cache_layers(cfg) -> int:
    """The number of attention caches in the tree (as ``init_cache``)."""
    if cfg.block_kind == "attn":
        return cfg.n_layers
    if cfg.block_kind == "moe":
        return 1 + (cfg.n_layers - cfg.moe.first_dense)
    raise ValueError(
        f"serving byte accounting supports attn/moe, not {cfg.block_kind!r}")


def token_elems(cfg) -> int:
    """KV-cache elements appended per token, summed over the cached layers."""
    if cfg.mla:
        per = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    else:
        per = 2 * cfg.n_kv_heads * cfg.head_dim
    return n_cache_layers(cfg) * per


def n_scale_elems(cfg) -> int:
    """Delayed-scale scalars over the tree (k and v per head, or 2 per-tensor)."""
    return n_cache_layers(cfg) * (2 if cfg.mla else 2 * cfg.n_kv_heads)


def storage_width(cfg, storage_dtype=None) -> int:
    return prec.as_dtype(storage_dtype or cfg.policy.compute_dtype).itemsize


def decode_step_kv_bytes(cfg, lengths: Sequence[int],
                         storage_dtype: Optional[str] = None) -> int:
    """KV traffic of one continuous-batching decode step: each active slot
    with ``l`` cached tokens reads its ``l + 1`` merged rows and writes one
    new row at the storage width; an FP8 cache adds the fp32 scales' read
    and write-back.  It prices what a serving memory system moves, not the
    whole-cache requantize of this implementation (nor the reference's)."""
    w = storage_width(cfg, storage_dtype)
    rows = sum(int(n) + 2 for n in lengths)  # (l + 1) reads + 1 write
    data = w * token_elems(cfg) * rows
    if storage_dtype is None:
        return data
    return data + 2 * 4 * n_scale_elems(cfg)


def cache_size_bytes(cfg, batch: int, max_len: int,
                     storage_dtype: Optional[str] = None) -> int:
    """Resident bytes of ``init_cache``'s output (data and scale leaves)."""
    data = storage_width(cfg, storage_dtype) * token_elems(cfg) * batch * max_len
    if storage_dtype is None:
        return data
    # scale, amax_history and overflow_count per quantized tensor, 4 B each
    return data + n_scale_elems(cfg) * (1 + attention.SCALE_HISTORY + 1) * 4


def scale_health(cache: CacheTree) -> Dict[str, Dict[str, float]]:
    """The largest applied scale and the total overflow count per
    quantized cache leaf."""
    out: Dict[str, Dict[str, float]] = {}
    for key, sub in cache.items():
        for name in ("k", "v", "ckv", "kr"):
            sc = sub.get(f"{name}_scale") if isinstance(sub, dict) else None
            if sc is None:
                continue
            out[f"{key}/{name}"] = {
                "max_scale": float(sc["scale"].max()),
                "overflow_total": int(sc["overflow_count"].sum()),
            }
    return out
