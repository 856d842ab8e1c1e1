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

On a mesh of ranks the pool is this rank's block (a :class:`Layout`: the
sanitized spec tree of ``serving.specs.decode_cache_specs`` and the mesh):
its slots where the batch is cut over the data axes, its positions (the
serving rules) or KV heads (``Rules()``) where the model axis cuts them.
:func:`insert_slot` writes the slot on the rank that holds it and reduces
an FP8 pool's merged amax over the axes that cut the data but not its
scale leaf; :func:`slot_checksum` gathers the slot's stored bytes to every
rank, so each digest is the unsharded one; :func:`corrupt_slot_rows`
flips the same global rows; :func:`scale_health` reports the global
scales.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import precision as prec
from repro_torch.models import attention
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding

__all__ = [
    "is_fp8_cache", "insert_slot", "n_cache_layers", "token_elems",
    "n_scale_elems", "storage_width", "decode_step_kv_bytes",
    "cache_size_bytes", "scale_health", "iter_kv_leaves",
    "slot_checksum", "corrupt_slot_rows", "Layout", "position_views",
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


@dataclasses.dataclass(frozen=True)
class Layout:
    """A cache tree's blocks on a mesh: ``specs`` its sanitized spec tree
    (``serving.specs.decode_cache_specs`` at the tree's global shape) and
    the ``mesh`` whose rank holds them."""

    specs: Any
    mesh: Any

    def spec(self, key: str, name: str, field: Optional[str] = None):
        sp = self.specs[key][name]
        return sp if field is None else sp[field]

    def axes(self, spec, dims) -> Tuple[str, ...]:
        """The mesh axes ``spec`` cuts over at ``dims`` (longer than one)."""
        parts = tuple(spec) + (None,) * 8
        return tuple(a for d in dims for a in sharding.axes_of(parts[d])
                     if self.mesh.shape.get(a, 1) > 1)

    def slot(self, key: str, name: str, leaf: torch.Tensor, bax: int,
             slot: int) -> Optional[int]:
        """This rank's index of global ``slot`` in ``leaf``, or None where
        another rank's block holds it."""
        spec = self.spec(key, name)
        if not self.axes(spec, (bax,)):
            return slot
        nl = leaf.shape[bax]
        first = nl * sharding.block_index((tuple(spec) + (None,) * leaf.ndim)[bax],
                                          self.mesh)
        return slot - first if first <= slot < first + nl else None

    def seq_start(self, key: str, name: str, leaf: torch.Tensor) -> int:
        """The first global position this rank's block of ``leaf`` holds."""
        seq = leaf.ndim - 2
        part = (tuple(self.spec(key, name)) + (None,) * leaf.ndim)[seq]
        if not self.axes(self.spec(key, name), (seq,)):
            return 0
        return leaf.shape[seq] * sharding.block_index(part, self.mesh)


def _slot_index(layout: Optional[Layout], key, name, leaf, bax, slot) -> Optional[int]:
    return slot if layout is None else layout.slot(key, name, leaf, bax, slot)


# --------------------------------------------------------------------- #
# Slot admission
# --------------------------------------------------------------------- #
@torch.inference_mode()
def insert_slot(pool: CacheTree, single: CacheTree, slot: int,
                dtype=torch.float16, layout: Optional[Layout] = None) -> CacheTree:
    """Write a single-request cache (batch 1) into ``slot`` of the pool, in
    place, and return the pool.  FP8 pools dequantize both sides to
    ``dtype``, merge, refresh the pool's delayed scales with the merged
    amax (per layer and KV head for GQA, per layer for MLA) and
    requantize under the ratcheted scale.  With a ``layout`` the pool is
    this rank's block and ``single`` its batch-1 block in the same cut of
    positions or heads; the rank holding the slot writes it, and every
    rank requantizes its block under the amax reduced over the axes that
    cut the data leaf but not its scale leaf (the merged pool's amax)."""
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
            local = _slot_index(layout, key, name, leaf, bax, slot)
            if sc is None:
                if local is not None:
                    leaf.select(bax, local).copy_(new.select(bax, 0))
                continue
            # a scale leaf (layers..., [Hkv]) against its data leaf: GQA
            # (layers..., 1, Hkv, 1, 1), MLA (layers..., 1, 1, 1)
            tail = (1, -1, 1, 1) if kind == "k" else (1, 1, 1)
            bshape = lambda s: s.reshape(*leaf.shape[:bax], *tail)
            wide = prec.dequantize_fp8(leaf, bshape(sc["scale"]), dtype)
            if local is not None:
                one = prec.dequantize_fp8(
                    new, bshape(single[key][f"{name}_scale"]["scale"]), dtype)
                wide.select(bax, local).copy_(one.select(bax, 0))
            keep = (bax, *range(bax + 2, leaf.ndim)) if kind == "k" else \
                tuple(range(bax, leaf.ndim))
            axes = ()
            if layout is not None:
                cut = set(layout.axes(layout.spec(key, f"{name}_scale", "scale"),
                                      range(leaf.ndim)))
                axes = tuple(a for a in layout.axes(layout.spec(key, name),
                                                    range(leaf.ndim)) if a not in cut)
            new_sc, applied = attention._refresh_scale(
                sc, wide, keep, layout.mesh if axes else None, axes)
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


def _gathered_slot(key: str, name: str, leaf: torch.Tensor, bax: int, slot: int,
                   layout: Optional[Layout]) -> torch.Tensor:
    """The slot's stored rows of ``leaf`` whole, on every rank: the block
    of the rank holding the slot, all-gathered over the axes that cut it
    (a rank not holding the slot sends a stand-in block)."""
    local = _slot_index(layout, key, name, leaf, bax, slot)
    if layout is None:
        return leaf.select(bax, local)
    mesh, spec = layout.mesh, tuple(layout.spec(key, name)) + (None,) * leaf.ndim
    rows = leaf.select(bax, 0 if local is None else local)
    b_axes = layout.axes(spec, (bax,))
    if b_axes:          # the holder's block, picked out of every rank's
        got = rows[None]
        for a in reversed(b_axes):
            got = coll.all_gather(got, mesh, a, 0)
        owner = slot // leaf.shape[bax]
        rows = got[owner]
    for d in range(leaf.ndim):
        if d == bax:
            continue
        dim = d - (d > bax)
        for a in reversed(layout.axes(spec, (d,))):
            rows = coll.all_gather(rows, mesh, a, dim)
    return rows


def _slot_rows_bytes(rows: torch.Tensor, length: int) -> bytes:
    return rows[..., :int(length), :].contiguous().view(torch.uint8).cpu().numpy().tobytes()


def slot_checksum(cache: CacheTree, slot: int, length: int,
                  layout: Optional[Layout] = None) -> int:
    """CRC32 over the raw stored bytes of one slot's first ``length`` rows,
    every cached layer, leaf by leaf in tree order (FP8 codes or 16-bit
    halves); the pool-wide scale state is left out.  With a ``layout``
    the slot's rows are gathered whole first (collectives every rank of
    the mesh runs), so each rank computes the unsharded digest."""
    crc = 0
    for key, name, leaf, bax in iter_kv_leaves(cache):
        rows = _gathered_slot(key, name, leaf, bax, int(slot), layout)
        crc = zlib.crc32(_slot_rows_bytes(rows, length), crc)
    return crc


def corrupt_slot_rows(cache: CacheTree, slot: int, rows: Sequence[int],
                      layout: Optional[Layout] = None) -> CacheTree:
    """Flip every stored bit (XOR 0xFF on each byte) of ``rows`` of one slot
    in every cached layer.  Returns a new cache tree (the KV leaves copied,
    the scale leaves shared and untouched): the matching
    :func:`slot_checksum` audit must flag exactly this slot.  With a
    ``layout`` ``rows`` are global positions, flipped where this rank
    holds them."""
    flipped = {}
    for key, name, leaf, bax in iter_kv_leaves(cache):
        out = leaf.clone()
        local = _slot_index(layout, key, name, leaf, bax, int(slot))
        start = 0 if layout is None else layout.seq_start(key, name, leaf)
        T = leaf.shape[-2]
        idx = torch.as_tensor(sorted({int(r) - start for r in rows
                                      if 0 <= int(r) - start < T}), dtype=torch.long)
        if local is not None and idx.numel():
            u = out.view(torch.uint8).select(bax, local)
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


def scale_health(cache: CacheTree, layout: Optional[Layout] = None
                 ) -> Dict[str, Dict[str, float]]:
    """The largest applied scale and the total overflow count per
    quantized cache leaf (with a ``layout``: over every rank's block of a
    scale leaf cut with the KV heads)."""
    out: Dict[str, Dict[str, float]] = {}
    for key, sub in cache.items():
        for name in ("k", "v", "ckv", "kr"):
            sc = sub.get(f"{name}_scale") if isinstance(sub, dict) else None
            if sc is None:
                continue
            top, over = sc["scale"].max(), sc["overflow_count"].sum().float()
            if layout is not None:
                axes = layout.axes(layout.spec(key, f"{name}_scale", "scale"),
                                   range(sc["scale"].ndim))
                top = coll.pmax_over(top, layout.mesh, axes)
                for a in axes:
                    over = coll.psum(over, layout.mesh, a)
            out[f"{key}/{name}"] = {"max_scale": float(top),
                                    "overflow_total": int(over)}
    return out


def position_views(cache: CacheTree, pos: int, layout: Optional[Layout] = None
                   ) -> List[Optional[torch.Tensor]]:
    """Per KV data leaf (:func:`iter_kv_leaves` order), the view of global
    position ``pos`` in this rank's block, or None where another rank's
    positions hold it."""
    views = []
    for key, name, leaf, _bax in iter_kv_leaves(cache):
        start = 0 if layout is None else layout.seq_start(key, name, leaf)
        T = leaf.shape[-2]
        views.append(leaf.select(-2, pos - start) if 0 <= pos - start < T else None)
    return views
