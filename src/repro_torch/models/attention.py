"""GQA attention (+ qk-norm) and MLA on the engine, with the serving caches.

Counterpart of ``repro.models.attention``.  :func:`chunked_attention`
routes as the reference does (``attention.py:240-296``):

* static offsets, no window and ``Dv == D`` (prefill and training of the
  GQA / MHA models) go to the engine's flash op, whose backward
  recomputes through the engine's reference composition;
* a continuous-batching decode step with per-slot KV lengths
  (``kv_group_sizes``) takes the ragged route of ``attention.py:299-339``:
  scores through the engine's ``grouped_matmul`` with one group per (slot,
  KV head), PV through the batched ``matmul`` with V broadcast over the
  query heads of a group;
* everything else — ``Dv != D`` (MLA's prefill and training), a sliding
  ``window``, per-slot offsets without group sizes — takes the q-chunked
  path: per chunk of ``q_chunk`` query rows an fp32 score GEMM (K read
  through a transposed view), the masked fp32 softmax, P cast to the
  compute dtype and one PV GEMM, both on the batched GEMM kernel and
  differentiable through the engine.

MLA (DeepSeek-V2) caches the compressed ``(c_kv, k_rope)`` pair; prefill and
training re-expand it through ``wuk`` / ``wuv`` into the q-chunked path, and
a decode step attends the compressed cache directly (the absorbed form:
five fp32-out ``einsum2d`` contractions).

The GQA cache is ``k`` / ``v`` ``(B, Hkv, T, hd)``, the MLA cache ``ckv``
``(B, T, r)`` / ``kr`` ``(B, T, dr)``.  New rows are written in place at
their positions; the reference's decode merges with a whole-cache
``jnp.where`` (``attention.py:393-402``) instead — the values are the
same.

With ``storage_dtype`` (an FP8 format) the cache stores the k / v (MLA:
``ckv`` / ``kr``) codes narrow, beside delayed-scaling leaves
``{name}_scale = {"scale", "amax_history", "overflow_count"}`` — per KV
head for GQA, per tensor for MLA (the compressed latent has no head dim).
A step does what the reference does (``attention.py:383-421, 485-520``):
it dequantizes the whole cache to the compute dtype under the stored
scales, writes the new rows, folds the new rows' amax into the window, and
requantizes the whole cache under the applied scale, which ratchets (the
larger of the stored and the refreshed scale, so rows quantized under an
older scale can only shrink).  Attention reads the wide merged cache; the
codes and scales are written back in place.  The dequantize, refresh and
requantize are plain PyTorch, as the reference's are plain ``jnp``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.models import layers
from repro_torch.models.layers import Param
from repro_torch.optim import scale as oscale
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding

__all__ = ["gqa_schema", "mla_schema", "init_gqa_cache", "init_mla_cache",
           "chunked_attention", "gqa_attention", "mla_attention",
           "SCALE_HISTORY"]

NEG_INF = -1e30
SCALE_HISTORY = 16  # the delayed-scaling amax window of a cache scale leaf


def gqa_schema(cfg) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: Dict[str, Any] = {
        # fused qkv: one fat RedMulE GEMM; split after
        "wqkv": Param((d, (hq + 2 * hkv) * hd), ("embed", "heads")),
        "wo": Param((hq * hd, d), ("heads", "embed")),
    }
    if cfg.use_bias:
        s["bqkv"] = Param(((hq + 2 * hkv) * hd,), ("heads",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = Param((hd,), (None,), init="ones")
        s["k_norm"] = Param((hd,), (None,), init="ones")
    return s


def mla_schema(cfg) -> Dict[str, Any]:
    m = cfg.mla
    d, hq = cfg.d_model, cfg.n_heads
    return {
        "wq": Param((d, hq * (m.qk_nope_dim + m.qk_rope_dim)), ("embed", "heads")),
        # fused down-projection: compressed kv rank + shared rope key
        "wdkv": Param((d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "kv_rank")),
        "kv_norm": Param((m.kv_lora_rank,), (None,), init="ones"),
        "wuk": Param((m.kv_lora_rank, hq * m.qk_nope_dim), ("kv_rank", "heads")),
        "wuv": Param((m.kv_lora_rank, hq * m.v_head_dim), ("kv_rank", "heads")),
        "wo": Param((hq * m.v_head_dim, d), ("heads", "embed")),
    }


def _init_scale_leaves(lead, device) -> Dict[str, torch.Tensor]:
    """The delayed-scaling state of one quantized cache tensor, per head
    (``lead = (Hkv,)``) or per tensor (``()``): the three fields of
    :class:`repro_torch.optim.scale.Fp8ScaleState` as cache leaves."""
    st = oscale.init_fp8_scale(SCALE_HISTORY, lead, device)
    return {"scale": st.scale, "amax_history": st.amax_history,
            "overflow_count": st.overflow_count}


def scale_leaf_axes(head_axes: Tuple) -> Dict[str, Tuple]:
    """The logical axes of one quantized tensor's scale leaves (the
    reference's ``_scale_leaf_axes``)."""
    return {"scale": head_axes, "amax_history": (*head_axes, None),
            "overflow_count": head_axes}


def _refresh_scale(sc: Dict[str, torch.Tensor], new_rows: torch.Tensor,
                   reduce_dims) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Fold the amax of ``new_rows`` over ``reduce_dims`` into the window
    (one observation per leading layer / head) and return ``(updated
    leaves, applied scale)``; the applied scale ratchets: the larger of the
    stored scale and the refreshed one."""
    amax = new_rows.float().abs().amax(dim=reduce_dims)
    st = oscale.update_fp8_scale(oscale.Fp8ScaleState(
        sc["scale"], sc["amax_history"], sc["overflow_count"]), amax)
    applied = torch.maximum(sc["scale"], st.scale)
    return ({"scale": applied, "amax_history": st.amax_history,
             "overflow_count": st.overflow_count}, applied)


def _fp8_storage(storage_dtype) -> torch.dtype:
    st = prec.as_dtype(storage_dtype)
    if not prec.is_fp8(st):
        raise ValueError(f"storage_dtype must be an FP8 format {prec.FP8_FORMATS}, "
                         f"got {prec.dtype_name(st)!r}")
    return st


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, storage_dtype=None,
                   *, device) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if storage_dtype is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    st = _fp8_storage(storage_dtype)
    return {"k": torch.zeros(shape, dtype=st, device=device),
            "v": torch.zeros(shape, dtype=st, device=device),
            "k_scale": _init_scale_leaves((cfg.n_kv_heads,), device),
            "v_scale": _init_scale_leaves((cfg.n_kv_heads,), device)}


def init_mla_cache(cfg, batch: int, max_len: int, dtype, storage_dtype=None,
                   *, device) -> Dict[str, torch.Tensor]:
    """The compressed MLA cache: ``ckv (B, T, r)`` and ``kr (B, T, dr)``
    (FP8: per-tensor scales, the latent has no head dim)."""
    m = cfg.mla
    st = dtype if storage_dtype is None else _fp8_storage(storage_dtype)
    out = {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=st,
                              device=device),
           "kr": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=st,
                             device=device)}
    if storage_dtype is not None:
        out["ckv_scale"] = _init_scale_leaves((), device)
        out["kr_scale"] = _init_scale_leaves((), device)
    return out


def _masked_softmax_block(s: torch.Tensor, rows: torch.Tensor, kv_valid,
                          causal: bool, window=None, *, start: int = 0,
                          shard=None) -> torch.Tensor:
    """fp32 softmax of scores ``s (B, Hkv, G, qc, T)`` over the columns
    each query row sees; ``rows`` (qc,) or (B, qc), ``kv_valid`` an int or
    a scalar or (B,) tensor; ``window`` keeps ``col > row - window``.

    With ``shard`` the columns are this rank's slice ``[start, start +
    T)`` of a sequence-sharded cache and the softmax runs over every
    rank's: the row maximum and the rescaled sum are combined over the
    model axis in fp32."""
    cols = start + torch.arange(s.shape[-1], device=s.device)
    rows2 = rows if rows.ndim == 2 else rows[None]              # (Bm, qc)
    kv = torch.as_tensor(kv_valid, device=s.device).reshape(-1, 1, 1)
    mask = cols[None, None, :] < kv                              # (Bm, 1, T)
    if causal:
        mask = mask & (cols[None, None, :] <= rows2[:, :, None])
    if window is not None:
        mask = mask & (cols[None, None, :] > rows2[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, torch.full((), NEG_INF, device=s.device))
    if shard is None:
        return torch.softmax(s, dim=-1)
    mx = coll.pmax(s.amax(dim=-1, keepdim=True), shard.mesh, sharding.MODEL_AXIS)
    e = torch.exp(s - mx)
    return e / coll.psum(e.sum(dim=-1, keepdim=True), shard.mesh, sharding.MODEL_AXIS)


def _pv(p: torch.Tensor, v: torch.Tensor, policy: prec.Policy, shard) -> torch.Tensor:
    """``p @ v`` in the policy's output dtype; on a sequence-sharded cache
    each rank's partial product comes out in fp32 and is summed over the
    model axis before the cast."""
    if shard is None:
        return engine.matmul(p.to(policy.compute_dtype), v, policy=policy)
    o = engine.matmul(p.to(policy.compute_dtype), v,
                      policy=engine.scores_policy(policy))
    return coll.psum(o, shard.mesh, sharding.MODEL_AXIS).to(policy.out_dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset, kv_valid, causal: bool = True, window=None,
                      q_chunk: int = 1024, scale: Optional[float] = None,
                      kv_group_sizes=None, policy: prec.Policy, kv_start: int = 0,
                      shard=None) -> torch.Tensor:
    """q ``(B, Hkv, G, S, hd)``, k ``(B, Hkv, T, hd)``, v ``(B, Hkv, T,
    hdv)`` -> ``(B, Hkv, G, S, hdv)``; ``q_offset`` / ``kv_valid`` are ints
    or ``(B,)`` tensors (per-slot decode).

    ``kv_group_sizes`` (decode, S == 1): per-slot valid KV lengths; the
    score GEMM then bills only those rows (ragged ``grouped_matmul``).
    Static offsets with no window and ``hdv == hd`` run the engine's flash
    op; anything else the q-chunked path (see the module docstring).

    ``shard``: k / v are this rank's positions ``[kv_start, kv_start + T)``
    of a cache sharded over the model axis (the reference's serving
    layout, ``serve_attention``).  As in the reference, that pins the
    q-chunked (or ragged) path, never flash; the softmax and PV are
    combined across ranks."""
    B, Hkv, G, S, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if kv_group_sizes is not None:
        if S != 1:
            raise ValueError("kv_group_sizes is a decode-only (S == 1) path")
        return _ragged_decode_attention(
            q, k, v, q_offset=q_offset, kv_valid=kv_valid, window=window,
            kv_group_sizes=kv_group_sizes, scale=scale,
            scores_policy=engine.scores_policy(policy), policy=policy,
            start=kv_start, shard=shard)
    if (shard is None and window is None and v.shape[-1] == hd
            and isinstance(q_offset, int) and isinstance(kv_valid, int)
            and engine.backend_supports(engine.default_backend(), "attention")):
        out = engine.attention(q.reshape(B, Hkv * G, S, hd), k, v,
                               causal=causal, scale=scale, q_offset=q_offset,
                               t_valid=kv_valid, policy=policy)
        return out.reshape(B, Hkv, G, S, -1)
    return _q_chunked_attention(q, k, v, q_offset=q_offset, kv_valid=kv_valid,
                                causal=causal, window=window, q_chunk=q_chunk,
                                scale=scale, policy=policy, kv_start=kv_start,
                                shard=shard)


def _q_chunked_attention(q, k, v, *, q_offset, kv_valid, causal: bool, window,
                         q_chunk: int, scale: float, policy: prec.Policy,
                         kv_start: int = 0, shard=None) -> torch.Tensor:
    """The reference's q-chunked path (``attention.py:257-296``): scores
    never materialised beyond one chunk of query rows; ``S > q_chunk``
    pads q to whole chunks and drops the pad rows after."""
    B, Hkv, G, S, hd = q.shape
    spol = engine.scores_policy(policy)
    kt = k.transpose(-1, -2)[:, :, None]          # (B, Hkv, 1, hd, T), a view
    vb = v[:, :, None]
    per_slot = isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1
    n_rows = min(q_chunk, S)

    def block(q_blk, start):
        r = torch.arange(n_rows, device=q.device) + start
        rows = q_offset[:, None] + r[None] if per_slot else q_offset + r
        s = engine.matmul(q_blk, kt, policy=spol) * scale
        p = _masked_softmax_block(s, rows, kv_valid, causal, window,
                                  start=kv_start, shard=shard)
        return _pv(p, vb, policy, shard)

    if S <= q_chunk:
        return block(q, 0)
    n = -(-S // q_chunk)
    q = F.pad(q, (0, 0, 0, n * q_chunk - S))
    out = torch.cat([block(q[:, :, :, i * q_chunk:(i + 1) * q_chunk], i * q_chunk)
                     for i in range(n)], dim=3)
    return out[:, :, :, :S]


def _ragged_decode_attention(q, k, v, *, q_offset, kv_valid, window,
                             kv_group_sizes, scale: float,
                             scores_policy: prec.Policy, policy: prec.Policy,
                             start: int = 0, shard=None) -> torch.Tensor:
    """Mixed-length decode batch (the reference's ``attention.py:299``).

    Scores run transposed, ``scores^T[g] = K[g] @ q[g]^T``, one group per
    (slot, KV head) with the slot's KV length as group size, so only valid
    rows are billed; rows past a group's size come back zero and are
    masked again by the softmax.  PV is a batched GEMM with M = 1, N = T,
    K = hd, V broadcast over the G query heads of its KV head.  On a
    sequence-sharded cache (``shard``) a slot's group is its KV length
    clipped to this rank's slice ``[start, start + T)``, which may be
    empty."""
    B, Hkv, G, S, hd = q.shape
    T = k.shape[2]
    x = k.reshape(B * Hkv, T, hd)
    w = q[:, :, :, 0, :].transpose(-1, -2).reshape(B * Hkv, hd, G)
    sizes = np.clip(np.asarray(kv_group_sizes, np.int64) - start, 0, T)
    sizes = np.repeat(sizes.astype(np.int32), Hkv)
    st = engine.grouped_matmul(x, w, group_sizes=sizes, policy=scores_policy)
    s = st.reshape(B, Hkv, T, G).transpose(-1, -2)[:, :, :, None, :] * scale
    rows = q_offset[:, None] if q_offset.ndim == 1 else q_offset + torch.arange(
        1, device=q.device)
    p = _masked_softmax_block(s, rows, kv_valid, True, window, start=start,
                              shard=shard)
    return _pv(p, v[:, :, None], policy, shard)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, pos,
                start: Optional[int] = None) -> None:
    """Write ``rows (B, ..., S, c)`` into ``cache (B, ..., T, c)`` (a GQA
    leaf with its head dim, or an MLA leaf without) in place at position
    ``pos`` (int) or per-slot positions ``(B,)`` (S == 1).  With ``start``
    the cache holds positions ``[start, start + T)`` of a sequence-sharded
    one and takes only the rows that fall there."""
    T, off = cache.shape[-2], start or 0
    if isinstance(pos, int):
        lo, hi = max(pos, off), min(pos + rows.shape[-2], off + T)
        if lo < hi:
            cache[..., lo - off:hi - off, :] = rows[..., lo - pos:hi - pos, :].to(
                cache.dtype)
        return
    if start is None:
        slots = torch.arange(cache.shape[0], device=cache.device)
    else:   # the slots whose position this rank holds (a host sync)
        slots = torch.nonzero((pos >= off) & (pos < off + T)).flatten()
    cache.movedim(-2, 1)[slots, pos[slots] - off] = \
        rows.movedim(-2, 1)[slots, 0].to(cache.dtype)


def _update_cache(cache: Dict[str, Any], names, rows, pos, scale_shape,
                  reduce_dims, dtype) -> list:
    """Write the new ``rows`` (one per name) into the cache at ``pos`` and
    return the full caches in ``dtype`` that attention reads.  A wide
    cache is written in place and read as it is; an FP8 cache is
    dequantized whole, merged, its scales refreshed from the new rows and
    requantized whole under the applied scale, codes and scale leaves
    written back in place (the reference's read / write-back)."""
    if f"{names[0]}_scale" not in cache:
        for name, r in zip(names, rows):
            _write_rows(cache[name], r, pos)
        return [cache[name] for name in names]
    out = []
    for name, r in zip(names, rows):
        sc = cache[f"{name}_scale"]
        wide = prec.dequantize_fp8(cache[name], sc["scale"].reshape(scale_shape), dtype)
        _write_rows(wide, r, pos)
        new_sc, applied = _refresh_scale(sc, r, reduce_dims)
        q, _ = prec.quantize_fp8(wide, cache[name].dtype,
                                 scale=applied.reshape(scale_shape))
        cache[name].copy_(q)
        for key, val in new_sc.items():
            sc[key].copy_(val)
        out.append(wide)
    return out


def _qkv_heads(params, qkv: torch.Tensor, cfg, hq: int, hkv: int, pos_offset):
    """Split ``[q | k | v]`` columns of ``hq`` / ``hkv`` heads into ``(B,
    H, S, hd)`` tensors, qk-normed and rotated at their positions."""
    B, S, _ = qkv.shape
    hd = cfg.head_dim
    q, kk, vv = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(B, S, hq, hd).transpose(1, 2)          # (B, Hq, S, hd)
    kk = kk.reshape(B, S, hkv, hd).transpose(1, 2)       # (B, Hkv, S, hd)
    vv = vv.reshape(B, S, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, params["q_norm"])
        kk = layers.rmsnorm(kk, params["k_norm"])
    steps = torch.arange(S, device=qkv.device)
    per_slot = isinstance(pos_offset, torch.Tensor)
    positions = pos_offset[:, None] + steps[None] if per_slot else pos_offset + steps
    cos, sin = layers.rope(positions, hd, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(kk, cos, sin), vv


def _gqa_sharded(params, x, cfg, *, pos_offset, cache, window, policy, q_chunk,
                 kv_group_sizes, shard) -> torch.Tensor:
    """The rank's part of GQA attention with "heads" over the model axis.

    ``wqkv``'s fused ``[q | k | v]`` columns are cut contiguously by its
    ``("embed", "heads")`` spec (qwen3-1.7b on two ranks: rank 0 holds all
    of q, rank 1 all of k and v; hymba-1.5b's 2240 columns are cut inside
    q head 17).  Kernel 1 runs on the rank's block of the whole sequence
    (:meth:`ShardCtx.enter`), then by layout:

    * the serving cache (``serve_attention``: cut over its positions):
      :func:`_gqa_seq_sharded`;
    * the query and KV heads divide the model axis (a cache, if any, holds
      the rank's KV heads): one all-to-all gives each rank its own heads
      of q, k and v, and qk-norm, RoPE, the cache write and attention run
      on those;
    * otherwise (hymba's 25 / 5 heads): the columns are gathered whole and
      every rank runs every head, on a whole cache if any.

    ``wo`` is row-parallel (:func:`layers.row_parallel`)."""
    hq, hkv, hd, m = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, shard.model
    x = shard.enter(x)
    B, S, _ = x.shape
    n = (hq + 2 * hkv) * hd
    qkv = engine.matmul(x, params["wqkv"], policy=policy)
    if "bqkv" in params:
        qkv = qkv + params["bqkv"].to(qkv.dtype)
    if cache is not None and "k_scale" in cache:
        sharding.refuse("the FP8 KV cache")
    if cache is not None and shard.rules.serve_attention:
        return _gqa_seq_sharded(params, layers.gather_cols(qkv, n, shard), cfg,
                                pos_offset=pos_offset, cache=cache, window=window,
                                policy=policy, q_chunk=q_chunk,
                                kv_group_sizes=kv_group_sizes, shard=shard)
    if hq % m == 0 and hkv % m == 0:
        qkv = coll.redistribute_last(qkv, shard.mesh, sharding.MODEL_AXIS,
                                     coll.blocks(n, m),
                                     coll.segment_blocks((hq * hd, hkv * hd, hkv * hd), m))
        hq_l, hkv_l = hq // m, hkv // m
    else:
        qkv, hq_l, hkv_l = layers.gather_cols(qkv, n, shard), hq, hkv
    q, kk, vv = _qkv_heads(params, qkv, cfg, hq_l, hkv_l, pos_offset)
    kv_valid = S
    if cache is not None:
        _write_rows(cache["k"], kk, pos_offset)
        _write_rows(cache["v"], vv, pos_offset)
        kk, vv, kv_valid = cache["k"], cache["v"], pos_offset + S
    o = chunked_attention(q.reshape(B, hkv_l, hq // hkv, S, hd), kk, vv,
                          q_offset=pos_offset, kv_valid=kv_valid, causal=True,
                          window=window, q_chunk=q_chunk, policy=policy,
                          kv_group_sizes=kv_group_sizes)
    o = o.reshape(B, hq_l, S, hd).transpose(1, 2).reshape(B, S, hq_l * hd)
    return layers.row_parallel(o, params["wo"], hq * hd, policy=policy, shard=shard)


def _gqa_seq_sharded(params, qkv, cfg, *, pos_offset, cache, window, policy,
                     q_chunk, kv_group_sizes, shard) -> torch.Tensor:
    """Prefill / decode on the serving layout (``serve_rules``): the KV
    cache ``(B, Hkv, T / model, hd)`` holds this rank's positions of every
    KV head.  From the whole ``qkv`` columns every rank computes every
    head; the new rows are written by the rank that owns their positions
    (under sequence parallelism too: the stream was gathered before
    ``wqkv``), scores and PV run on the local slice and the softmax is
    combined across ranks (:func:`chunked_attention`, with the global
    positions of the slice, so a sliding window reaches across ranks);
    ``wo`` is row-parallel."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S, _ = qkv.shape
    q, kk, vv = _qkv_heads(params, qkv, cfg, hq, hkv, pos_offset)
    start = shard.model_index * cache["k"].shape[2]
    _write_rows(cache["k"], kk, pos_offset, start)
    _write_rows(cache["v"], vv, pos_offset, start)
    o = chunked_attention(q.reshape(B, hkv, hq // hkv, S, hd), cache["k"],
                          cache["v"], q_offset=pos_offset, kv_valid=pos_offset + S,
                          causal=True, window=window, q_chunk=q_chunk,
                          policy=policy, kv_group_sizes=kv_group_sizes,
                          kv_start=start, shard=shard)
    o = o.reshape(B, hq, S, hd).transpose(1, 2).reshape(B, S, hq * hd)
    return layers.row_parallel(o, params["wo"], hq * hd, policy=policy, shard=shard)


def gqa_attention(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                  pos_offset, cache: Optional[Dict[str, torch.Tensor]] = None,
                  window=None, policy: prec.Policy, q_chunk: int = 1024,
                  kv_group_sizes=None, shard=None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x ``(B, S, d)`` -> ``(B, S, d)``; ``pos_offset`` is an int or, for
    a decode step, a ``(B,)`` tensor of per-slot positions.  With a cache
    the new k / v rows are written into it in place (and it is returned);
    an FP8 cache is requantized in place (:func:`_update_cache`).
    ``shard`` (``runtime.sharding.ShardCtx``) runs the rank's part of a
    sharded forward (:func:`_gqa_sharded`)."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    per_slot = isinstance(pos_offset, torch.Tensor)
    if per_slot and S != 1:
        raise ValueError("per-slot pos_offset is a decode-only (S == 1) path")

    if shard is not None and shard.model > 1:
        return _gqa_sharded(params, x, cfg, pos_offset=pos_offset, cache=cache,
                            window=window, policy=policy, q_chunk=q_chunk,
                            kv_group_sizes=kv_group_sizes, shard=shard), cache

    qkv = engine.matmul(x, params["wqkv"], policy=policy)
    if "bqkv" in params:
        qkv = qkv + params["bqkv"].to(qkv.dtype)
    q, kk, vv = _qkv_heads(params, qkv, cfg, hq, hkv, pos_offset)

    if cache is not None:
        k_all, v_all = _update_cache(cache, ("k", "v"), (kk, vv), pos_offset,
                                     (1, -1, 1, 1), (0, 2, 3), kk.dtype)
        kv_valid = pos_offset + S
    else:
        k_all, v_all, kv_valid = kk, vv, S

    o = chunked_attention(q.reshape(B, hkv, g, S, hd), k_all, v_all,
                          q_offset=pos_offset, kv_valid=kv_valid, causal=True,
                          window=window, q_chunk=q_chunk, policy=policy,
                          kv_group_sizes=kv_group_sizes)
    o = o.reshape(B, hq, S, hd).transpose(1, 2).reshape(B, S, hq * hd)
    return engine.matmul(o, params["wo"], policy=policy), cache


def _mla_whole_heads(params, cfg, shard) -> Dict[str, torch.Tensor]:
    """MLA's weights for a model axis that does not divide the heads: the
    head-cut ``wq`` / ``wuk`` / ``wuv`` columns gathered whole, so every
    rank runs every head (``wo`` stays row-parallel)."""
    m, hq = cfg.mla, cfg.n_heads
    width = {"wq": hq * (m.qk_nope_dim + m.qk_rope_dim), "wuk": hq * m.qk_nope_dim,
             "wuv": hq * m.v_head_dim}
    return {k: layers.gather_cols(v, width[k], shard) if k in width else v
            for k, v in params.items()}


def mla_attention(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                  pos_offset, cache: Optional[Dict[str, torch.Tensor]] = None,
                  policy: prec.Policy, q_chunk: int = 1024, kv_group_sizes=None,
                  shard=None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """MLA (reference ``attention.py:447-570``): x ``(B, S, d)`` -> ``(B,
    S, d)``.  The compressed ``ckv`` / ``kr`` rows are written into the
    cache in place.  A decode step (S == 1 with a cache) runs the absorbed
    form; prefill and training re-expand k / v and take the q-chunked path
    (qk dim ``dn + dr`` != v dim).  ``kv_group_sizes`` is accepted for the
    GQA signature: the absorbed decode is einsum-shaped, so per-slot
    lengths drive only the mask, as in the reference.

    On a mesh (``shard``) the rank runs its heads: ``wq``'s head-major
    columns and ``wuk`` / ``wuv``'s are cut at head boundaries when the
    model axis divides the heads (else gathered whole:
    :func:`_mla_whole_heads`), ``wdkv`` is whole, so every rank computes
    the latent rows, and ``wo`` is row-parallel.  A whole cache (the
    training rules) is written by every rank.  The serving cache
    (``serve_attention``) holds the rank's positions: the rank that owns a
    row writes it; prefill gathers the latent cache whole before the
    re-expansion; the absorbed decode gathers the absorbed query over the
    heads, scores the rank's positions for every head, combines the
    softmax across ranks (max / sum exchange) and sums the context over
    them, and ``wuv`` / ``wo`` follow on the rank's heads."""
    del kv_group_sizes
    m = cfg.mla
    hq = cfg.n_heads
    dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    pos_cut = False
    if shard is not None and shard.model > 1:
        if cache is not None and "ckv_scale" in cache:
            sharding.refuse("the FP8 KV cache")
        x = shard.enter(x)
        if hq % shard.model:
            params = _mla_whole_heads(params, cfg, shard)
        pos_cut = cache is not None and shard.rules.serve_attention
    else:
        shard = None
    B, S, _ = x.shape
    per_slot = isinstance(pos_offset, torch.Tensor)
    if per_slot and S != 1:
        raise ValueError("per-slot pos_offset is a decode-only (S == 1) path")

    q = engine.matmul(x, params["wq"], policy=policy).reshape(B, S, -1, dn + dr)
    hl = q.shape[2]                                         # the rank's heads
    q = q.transpose(1, 2)                                   # (B, Hl, S, dn+dr)
    qn, qr = q[..., :dn], q[..., dn:]
    dkv = engine.matmul(x, params["wdkv"], policy=policy)  # (B, S, r + dr)
    ckv = layers.rmsnorm(dkv[..., :r], params["kv_norm"])
    kr = dkv[..., r:]

    steps = torch.arange(S, device=x.device)
    positions = pos_offset[:, None] + steps[None] if per_slot else pos_offset + steps
    cos, sin = layers.rope(positions, dr, cfg.rope_theta)
    qr = layers.apply_rope(qr, cos, sin)
    kr = layers.apply_rope(kr[:, None], cos, sin)[:, 0]     # (B, S, dr)

    start = 0
    if pos_cut:
        start = shard.model_index * cache["ckv"].shape[1]
        _write_rows(cache["ckv"], ckv, pos_offset, start)
        _write_rows(cache["kr"], kr, pos_offset, start)
        ckv_all, kr_all, kv_valid = cache["ckv"], cache["kr"], pos_offset + S
    elif cache is not None:
        ckv_all, kr_all = _update_cache(cache, ("ckv", "kr"), (ckv, kr),
                                        pos_offset, (), (0, 1, 2), ckv.dtype)
        kv_valid = pos_offset + S
    else:
        ckv_all, kr_all, kv_valid = ckv, kr, S
    scale = (dn + dr) ** -0.5

    def out(o):
        if shard is None:
            return engine.matmul(o, params["wo"], policy=policy)
        return layers.row_parallel(o, params["wo"], hq * dv, policy=policy,
                                   shard=shard)

    if S == 1 and cache is not None:
        # absorbed decode: W_uk folds into the query and W_uv into the
        # context, so the compressed cache is attended directly; every
        # contraction accumulates and returns fp32 (the operands are cast
        # to the compute dtype in the engine)
        abs_policy = prec.Policy(policy.name + "_absorbed", policy.compute_dtype,
                                 torch.float32, torch.float32)
        wuk = params["wuk"].reshape(r, hl, dn)
        wuv = params["wuv"].reshape(r, hl, dv)
        q_abs = engine.einsum2d("bhsd,rhd->bhsr", qn, wuk, policy=abs_policy)
        if pos_cut and hl != hq:    # every head scores the rank's positions
            q_abs = coll.all_gather(q_abs, shard.mesh, sharding.MODEL_AXIS, 1)
            qr = coll.all_gather(qr, shard.mesh, sharding.MODEL_AXIS, 1)
        T = ckv_all.shape[1]
        s = engine.einsum2d("bhsr,btr->bhst", q_abs, ckv_all, policy=abs_policy)
        s = s + engine.einsum2d("bhsd,btd->bhst", qr, kr_all, policy=abs_policy)
        s = s * scale
        if pos_cut:
            p = _masked_softmax_block(s[:, None], positions, kv_valid, False,
                                      start=start, shard=shard)[:, 0]
        else:
            kv = torch.as_tensor(kv_valid, device=x.device).reshape(-1, 1, 1, 1)
            mask = torch.arange(T, device=x.device)[None, None, None, :] < kv
            s = torch.where(mask, s, torch.full((), NEG_INF, device=x.device))
            p = torch.softmax(s, dim=-1)
        ctx = engine.einsum2d("bhst,btr->bhsr", p, ckv_all, policy=abs_policy)
        if pos_cut:
            ctx = coll.psum(ctx, shard.mesh, sharding.MODEL_AXIS)
            if hl != hq:
                ctx = ctx[:, shard.model_index * hl:(shard.model_index + 1) * hl]
        o = engine.einsum2d("bhsr,rhd->bhsd", ctx, wuv, policy=abs_policy)
        o = o.to(policy.compute_dtype).transpose(1, 2).reshape(B, S, hl * dv)
        return out(o), cache

    # prefill / training: re-expand the compressed rows (the MLA trade:
    # a small cache, an extra GEMM)
    if pos_cut:
        ckv_all = coll.all_gather(ckv_all, shard.mesh, sharding.MODEL_AXIS, 1)
        kr_all = coll.all_gather(kr_all, shard.mesh, sharding.MODEL_AXIS, 1)
    T = ckv_all.shape[1]
    kn = engine.matmul(ckv_all, params["wuk"], policy=policy)
    vv = engine.matmul(ckv_all, params["wuv"], policy=policy)
    kn = kn.reshape(B, T, hl, dn).transpose(1, 2)           # (B, Hl, T, dn)
    vv = vv.reshape(B, T, hl, dv).transpose(1, 2)
    k_full = torch.cat([kn, kr_all[:, None].expand(B, hl, T, dr)], dim=-1)
    q_full = torch.cat([qn, qr], dim=-1)
    o = chunked_attention(q_full[:, :, None], k_full, vv, q_offset=pos_offset,
                          kv_valid=kv_valid, causal=True, q_chunk=q_chunk,
                          scale=scale, policy=policy)
    o = o[:, :, 0].transpose(1, 2).reshape(B, S, hl * dv)
    return out(o), cache
