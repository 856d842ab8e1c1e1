"""GQA attention (+ qk-norm) on the engine, with the serving KV cache.

Counterpart of ``repro.models.attention`` for the paths serving and
training run:

* prefill, training and any call with static offsets go to the engine's
  flash op (the reference's routing rule at ``attention.py:240-256``:
  static offsets, no window, ``Dv == D``), whose backward recomputes
  through the engine's reference composition;
* a continuous-batching decode step, with per-slot positions and per-slot
  KV lengths, takes the ragged route of ``attention.py:299-339``: scores
  through the engine's ``grouped_matmul`` with one group per (slot, KV
  head), PV through the batched ``matmul`` with V broadcast over the query
  heads of a group.

The cache is ``k`` / ``v`` of shape ``(B, Hkv, T, hd)``.  New rows are
written in place at their positions; the reference's decode merges with a
whole-cache ``jnp.where`` (``attention.py:393-402``) instead — the values
are the same.  MLA, sliding windows, the q-chunked fallback and the FP8 KV
cache are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.models import layers
from repro_torch.models.layers import Param

__all__ = ["gqa_schema", "init_gqa_cache", "chunked_attention", "gqa_attention"]

NEG_INF = -1e30
_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


def gqa_schema(cfg) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: Dict[str, Any] = {
        # fused qkv: one fat RedMulE GEMM; split after
        "wqkv": Param((d, (hq + 2 * hkv) * hd)),
        "wo": Param((hq * hd, d)),
    }
    if cfg.use_bias:
        s["bqkv"] = Param(((hq + 2 * hkv) * hd,), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = Param((hd,), init="ones")
        s["k_norm"] = Param((hd,), init="ones")
    return s


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, storage_dtype=None,
                   *, device) -> Dict[str, torch.Tensor]:
    if storage_dtype is not None:
        raise NotImplementedError(f"the FP8 KV cache is {_ROADMAP}")
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _masked_softmax_block(s: torch.Tensor, rows: torch.Tensor,
                          kv_valid: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 softmax of scores ``s (B, Hkv, G, qc, T)`` over the columns
    each query row sees; ``rows`` (qc,) or (B, qc), ``kv_valid`` scalar or
    (B,)."""
    cols = torch.arange(s.shape[-1], device=s.device)
    rows2 = rows if rows.ndim == 2 else rows[None]              # (Bm, qc)
    kv = kv_valid.reshape(-1, 1, 1)                              # (Bm, 1, 1)
    mask = cols[None, None, :] < kv
    if causal:
        mask = mask & (cols[None, None, :] <= rows2[:, :, None])
    s = torch.where(mask[:, None, None], s, torch.full((), NEG_INF, device=s.device))
    return torch.softmax(s, dim=-1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset, kv_valid, causal: bool = True, window=None,
                      scale: Optional[float] = None, kv_group_sizes=None,
                      policy: prec.Policy) -> torch.Tensor:
    """q ``(B, Hkv, G, S, hd)``, k / v ``(B, Hkv, T, hd)`` -> ``(B, Hkv, G,
    S, hd)``.

    ``kv_group_sizes`` (decode, S == 1): per-slot valid KV lengths; the
    score GEMM then bills only those rows (ragged ``grouped_matmul``).
    Otherwise ``q_offset`` and ``kv_valid`` must be ints and the engine's
    flash op runs."""
    B, Hkv, G, S, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if kv_group_sizes is not None:
        if S != 1:
            raise ValueError("kv_group_sizes is a decode-only (S == 1) path")
        return _ragged_decode_attention(
            q, k, v, q_offset=q_offset, kv_valid=kv_valid,
            kv_group_sizes=kv_group_sizes, scale=scale,
            scores_policy=engine.scores_policy(policy), policy=policy)
    if (window is not None or v.shape[-1] != hd
            or not isinstance(q_offset, int) or not isinstance(kv_valid, int)
            or not engine.backend_supports(engine.default_backend(), "attention")):
        raise NotImplementedError(
            f"the q-chunked attention path (windows, Dv != D, per-slot "
            f"offsets without kv_group_sizes) is {_ROADMAP}")
    out = engine.attention(q.reshape(B, Hkv * G, S, hd), k, v, causal=causal,
                           scale=scale, q_offset=q_offset, t_valid=kv_valid,
                           policy=policy)
    return out.reshape(B, Hkv, G, S, -1)


def _ragged_decode_attention(q, k, v, *, q_offset, kv_valid, kv_group_sizes,
                             scale: float, scores_policy: prec.Policy,
                             policy: prec.Policy) -> torch.Tensor:
    """Mixed-length decode batch (the reference's ``attention.py:299``).

    Scores run transposed, ``scores^T[g] = K[g] @ q[g]^T``, one group per
    (slot, KV head) with the slot's KV length as group size, so only valid
    rows are billed; rows past a group's size come back zero and are
    masked again by the softmax.  PV is a batched GEMM with M = 1, N = T,
    K = hd, V broadcast over the G query heads of its KV head."""
    B, Hkv, G, S, hd = q.shape
    T = k.shape[2]
    x = k.reshape(B * Hkv, T, hd)
    w = q[:, :, :, 0, :].transpose(-1, -2).reshape(B * Hkv, hd, G)
    sizes = np.repeat(np.asarray(kv_group_sizes, np.int32), Hkv)
    st = engine.grouped_matmul(x, w, group_sizes=sizes, policy=scores_policy)
    s = st.reshape(B, Hkv, T, G).transpose(-1, -2)[:, :, :, None, :] * scale
    rows = q_offset[:, None] if q_offset.ndim == 1 else q_offset + torch.arange(
        1, device=q.device)
    p = _masked_softmax_block(s, rows, kv_valid, True)
    return engine.matmul(p.to(policy.compute_dtype), v[:, :, None], policy=policy)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, pos) -> None:
    """Write ``rows (B, Hkv, S, hd)`` into ``cache (B, Hkv, T, hd)`` in
    place at position ``pos`` (int) or per-slot positions ``(B,)`` (S == 1)."""
    if isinstance(pos, int):
        cache[:, :, pos:pos + rows.shape[2]] = rows.to(cache.dtype)
    else:
        slots = torch.arange(cache.shape[0], device=cache.device)
        cache[slots, :, pos] = rows[:, :, 0].to(cache.dtype)


def gqa_attention(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                  pos_offset, cache: Optional[Dict[str, torch.Tensor]] = None,
                  window=None, policy: prec.Policy, kv_group_sizes=None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x ``(B, S, d)`` -> ``(B, S, d)``; ``pos_offset`` is an int or, for
    a decode step, a ``(B,)`` tensor of per-slot positions.  With a cache
    the new k / v rows are written into it in place (and it is returned)."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    per_slot = isinstance(pos_offset, torch.Tensor)
    if per_slot and S != 1:
        raise ValueError("per-slot pos_offset is a decode-only (S == 1) path")

    qkv = engine.matmul(x, params["wqkv"], policy=policy)
    if "bqkv" in params:
        qkv = qkv + params["bqkv"].to(qkv.dtype)
    q, kk, vv = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(B, S, hq, hd).transpose(1, 2)          # (B, Hq, S, hd)
    kk = kk.reshape(B, S, hkv, hd).transpose(1, 2)       # (B, Hkv, S, hd)
    vv = vv.reshape(B, S, hkv, hd).transpose(1, 2)

    if cfg.qk_norm:
        q = layers.rmsnorm(q, params["q_norm"])
        kk = layers.rmsnorm(kk, params["k_norm"])

    steps = torch.arange(S, device=x.device)
    positions = pos_offset[:, None] + steps[None] if per_slot else pos_offset + steps
    cos, sin = layers.rope(positions, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    kk = layers.apply_rope(kk, cos, sin)

    if cache is not None:
        _write_rows(cache["k"], kk, pos_offset)
        _write_rows(cache["v"], vv, pos_offset)
        k_all, v_all = cache["k"], cache["v"]
        kv_valid = pos_offset + S
    else:
        k_all, v_all, kv_valid = kk, vv, S

    o = chunked_attention(q.reshape(B, hkv, g, S, hd), k_all, v_all,
                          q_offset=pos_offset, kv_valid=kv_valid, causal=True,
                          window=window, policy=policy,
                          kv_group_sizes=kv_group_sizes)
    o = o.reshape(B, hq, S, hd).transpose(1, 2).reshape(B, S, hq * hd)
    return engine.matmul(o, params["wo"], policy=policy), cache
