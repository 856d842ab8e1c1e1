"""Mixture-of-Experts on the engine (DeepSeek-style).

Counterpart of ``repro.models.moe`` (``moe_schema`` and ``moe_forward``).
Fine-grained experts are the small-GEMM regime of the paper's Fig 3d: one
1408-wide expert over a few tokens cannot fill the array, so the dispatch
groups tokens by expert (a stable sort and a capacity buffer) and runs
every expert as one grouped GEMM ``(B, E, C, d) x (E, d, f)`` (kernel 2),
the batching restoration of Fig 4d.

The dispatch is the reference's sort-based, dropping one: top-k, a stable
sort of the slots by expert, each slot's rank within its expert, the
capacity clamp (``C = ceil(S k / E * capacity_factor)`` rounded up to 8),
a scatter into ``(E C + 1, d)`` rows whose last row takes every dropped
slot, the two grouped GEMMs, a permutation gather and the gate-weighted
combine over the k slots (an ``einsum2d``, kernel 2).  The reference
vmaps it over batch rows; here every step runs over the whole ``(B, S k)``
batch at once.  The routing index work (softmax, sort, counts, gather,
scatter) is plain PyTorch, as it is plain ``jnp`` in the reference.

``jax.lax.top_k`` puts the lower expert index first among equal
probabilities and ``torch.topk`` promises no order on ties, so top-k is a
stable descending sort cut at k.

Expert parallelism ("experts" over the model axis of a mesh, ``shard``)
takes one of the reference's two routes, by ``cfg.moe_impl``:

* ``"gspmd"`` (:func:`moe_forward`): every rank routes all of its tokens,
  runs the grouped GEMMs on its ``E / model`` experts' slots, and the
  combine's partial sums are summed over the model axis;
* ``"shard_map"`` (:func:`moe_forward_shard_map`): the token rows are
  sliced across model peers first, two all-to-alls carry the dispatched
  slots to their experts' rank and back, and an all-gather restores the
  rows.  Where ``n_routed`` or the local batch does not divide by the
  model axis, it falls back to :func:`moe_forward`, as the reference does.

:data:`ROUTES` counts the routes taken (``"gspmd"``, ``"shard_map"``,
``"shard_map_fallback"``), so a run can report which one ran.
"""

from __future__ import annotations

import collections
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.models import layers
from repro_torch.models.layers import Param
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding

__all__ = ["moe_schema", "moe_forward", "moe_forward_shard_map", "top_k",
           "capacity", "METRICS", "ROUTES"]

METRICS = ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")
ROUTES: collections.Counter = collections.Counter()


def _router_policy(policy: prec.Policy) -> prec.Policy:
    """Router logits: the compute dtype in, fp32 accumulated and out —
    routing decisions want full precision."""
    return prec.Policy("router", policy.compute_dtype, torch.float32,
                       torch.float32)


def _combine_policy(policy: prec.Policy) -> prec.Policy:
    """The gate-weighted slot reduction: operands in the compute dtype, an
    fp32 accumulator and output (the reference's, whatever FP8 storage the
    expert GEMMs declare)."""
    return prec.Policy("moe_combine", policy.compute_dtype, torch.float32,
                       torch.float32)


def moe_schema(cfg) -> Dict[str, Any]:
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.n_routed, mo.d_expert
    s: Dict[str, Any] = {
        "router": Param((d, E), ("embed", None)),
        "w_in": Param((E, d, 2 * f), ("experts", "embed_unsharded", "expert_ff")),
        "w_out": Param((E, f, d), ("experts", "expert_ff", "embed_unsharded")),
    }
    if mo.n_shared:
        fs = mo.n_shared * f
        s["shared"] = {"w_in": Param((d, 2 * fs), ("embed", "ff")),
                       "w_out": Param((fs, d), ("ff", "embed"))}
    return s


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest entries of the last dim,
    largest first and the lower index first among equals
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Rows per expert and batch row: ``ceil(S k / E * cf)`` rounded up to
    a multiple of 8 (the reference's sublane alignment)."""
    C = int(math.ceil(S * k / E * capacity_factor))
    return -(-C // 8) * 8


def _dispatch(x: torch.Tensor, ids: torch.Tensor, *, E: int, k: int, C: int,
              dtype: torch.dtype):
    """The sort-based dispatch of every batch row at once (the reference's
    ``_dispatch_row`` under ``vmap``).  ``x (B, S, d)``, ``ids (B, S, k)``.

    Returns ``(bufs (B, E, C, d), dest (B, S k))``: ``dest`` is each slot's
    buffer row in slot order (token t holds slots t k .. t k + k - 1),
    ``E C`` for a slot dropped past its expert's capacity."""
    B, S, d = x.shape
    flat_e = ids.reshape(B, S * k)
    order = torch.sort(flat_e, dim=1, stable=True).indices       # (B, S k)
    se = torch.gather(flat_e, 1, order)
    # rank within the expert: the slot's sorted position less the number
    # of slots routed to lower experts (an exclusive cumsum of the counts)
    counts = F.one_hot(se, E).sum(dim=1)                          # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(S * k, device=x.device)[None] - torch.gather(starts, 1, se)
    dest_sorted = torch.where(rank < C, se * C + rank, E * C)
    # replicate each token over its k slots, then permute into sorted order
    x_sorted = torch.gather(x.to(dtype), 1, (order // k)[..., None].expand(-1, -1, d))
    buf = x.new_zeros((B, E * C + 1, d), dtype=dtype).scatter(
        1, dest_sorted[..., None].expand(-1, -1, d), x_sorted)
    dest = torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)
    return buf[:, :E * C].reshape(B, E, C, d), dest


def _route(params, x: torch.Tensor, mo, policy: prec.Policy):
    """Router logits (fp32), probabilities, and the top-k gates and ids."""
    logits = engine.matmul(x, params["router"], policy=_router_policy(policy))
    probs = torch.softmax(logits, dim=-1)
    gate, ids = top_k(probs, mo.top_k)                            # (B, S, k)
    if mo.norm_topk_prob:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, ids


def _experts(params, bufs: torch.Tensor, cfg, policy: prec.Policy) -> torch.Tensor:
    """The two grouped GEMMs (kernel 2) over ``(..., E, C, d)`` slots."""
    h = engine.grouped_matmul(bufs, params["w_in"], policy=policy)
    g_, u_ = h.chunk(2, dim=-1)
    h = layers.activation(g_, cfg.act) * u_
    return engine.grouped_matmul(h, params["w_out"], policy=policy)


def _combine(out: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor,
             first_row: int, policy: prec.Policy) -> torch.Tensor:
    """The gate-weighted sum over each token's k slots, in fp32: one
    permutation gather from ``out (B, rows, d)`` (buffer rows ``first_row
    ..``; a slot whose row lies elsewhere, or was dropped, reads zero) and
    the k-slot contraction (an ``einsum2d``, kernel 2)."""
    B, rows, d = out.shape
    S, k = gate.shape[1], gate.shape[2]
    local = dest - first_row
    local = torch.where((local >= 0) & (local < rows), local, rows)
    flat = torch.cat([out, out.new_zeros((B, 1, d))], dim=1)
    slot = torch.gather(flat, 1, local[..., None].expand(-1, -1, d))  # (B, S k, d)
    w_slot = (gate.reshape(B, S * k) * (local < rows)).to(torch.float32)
    return engine.einsum2d("bskd,bsk->bsd", slot.reshape(B, S, k, d),
                           w_slot.reshape(B, S, k), policy=_combine_policy(policy))


def _expert_block(params, cfg, shard) -> Tuple[int, int]:
    """``(first expert, experts held)`` of this rank."""
    E = cfg.moe.n_routed
    n = params["w_in"].shape[0]
    start = shard.block(E, n) if shard is not None else None
    return (0, E) if start is None else (start, n)


def _expert_counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """fp32 ``(E,)`` counts of the routed slots per expert: ones summed
    into E zeros (``bincount``'s integers, with an output size that does
    not depend on the values, so it traces on meta tensors too)."""
    flat = ids.reshape(-1).long()
    return torch.zeros(E, dtype=torch.float32, device=ids.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=ids.device))


def moe_forward(params: Dict[str, Any], x: torch.Tensor, cfg, *,
                policy: prec.Policy, shard=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(B, S, d)`` -> ``(y (B, S, d), metrics)``: the routed experts'
    gate-weighted sum plus the shared experts, and the Switch load-balance
    loss, the router z-loss and the fraction of slots dropped past
    capacity.  On a mesh (``shard``) every rank routes all of ``x`` (the
    whole sequence under sequence parallelism), runs its own experts and
    the combine's partial sums are summed over the model axis (the
    reference's GSPMD route)."""
    mo = cfg.moe
    if shard is not None:
        ROUTES["gspmd"] += 1
        x = shard.enter(x)
    B, S, d = x.shape
    E, k = mo.n_routed, mo.top_k

    # ---- router (fp32 logits), softmax, top-k ----
    logits, probs, gate, ids = _route(params, x, mo, policy)

    # ---- load-balance aux (Switch-style) + router z-loss ----
    counts = _expert_counts(ids, E)
    mean_prob = probs.mean(dim=(0, 1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    n_slots = B * S * k
    for a in (shard.data_axes if shard is not None else ()):
        # a batch cut over data: the statistics of the global batch
        counts = coll.psum(counts, shard.mesh, a)
        mean_prob = coll.pmean(mean_prob, shard.mesh, a)
        z_loss = coll.pmean(z_loss, shard.mesh, a)
        n_slots *= shard.mesh.shape[a]
    aux_loss = E * torch.sum(counts / n_slots * mean_prob)

    # ---- sort-based dispatch with capacity, all experts as one GEMM ----
    C = capacity(S, k, E, mo.capacity_factor)
    bufs, dest = _dispatch(x, ids, E=E, k=k, C=C, dtype=policy.compute_dtype)
    e0, n_e = _expert_block(params, cfg, shard)
    if n_e != E:
        bufs = bufs[:, e0:e0 + n_e]
    out = _experts(params, bufs, cfg, policy)                 # (B, E_l, C, d)

    # ---- combine: one permutation gather + the k-slot contraction ----
    y = _combine(out.reshape(B, n_e * C, d), dest, gate, e0 * C, policy)
    if shard is not None:
        y = shard.leave(y, partial=n_e != E)
    y = y.to(x.dtype)

    if "shared" in params:
        y = y + _shared(params, x, cfg, policy, shard)
    drop = (dest >= E * C).to(torch.float32).mean()
    for a in (shard.data_axes if shard is not None else ()):
        drop = coll.pmean(drop, shard.mesh, a)
    return y, {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_drop_frac": drop}


def _shared(params, x, cfg, policy, shard):
    mo = cfg.moe
    return layers.mlp_glu(params["shared"], x, act=cfg.act, policy=policy,
                          shard=shard, ff=mo.n_shared * mo.d_expert)


def moe_forward_shard_map(params: Dict[str, Any], x: torch.Tensor, cfg, *,
                          policy: prec.Policy, shard=None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert parallelism with explicit all-to-alls (the reference's
    ``moe_forward_shard_map``, ``moe.py:184-314``).

    ``x (B, S, d)`` is this rank's batch (cut over the data axes,
    replicated over model).  Each model peer takes its ``B / model`` rows,
    routes and dispatches them; the ``(rows, E, C, d)`` slots go to the
    rank of their experts in one all-to-all, the grouped GEMMs run there
    on every peer's slots, a second all-to-all brings the results back,
    the combine runs on the rank's rows and an all-gather restores every
    row.  Each all-to-all's backward is one of the same shape.  The aux
    loss reduces its counts and mean probabilities over every axis, z and
    drop are means over the model axis.  Outside a mesh, or where
    ``n_routed`` or ``B`` does not divide by the model axis, this is
    :func:`moe_forward`."""
    mo = cfg.moe
    if shard is not None:
        x = shard.enter(x)
    B, S, d = x.shape
    E, k = mo.n_routed, mo.top_k
    if shard is None or shard.model == 1 or E % shard.model or B % shard.model:
        if shard is not None:
            ROUTES["shard_map_fallback"] += 1
        return moe_forward(params, x, cfg, policy=policy, shard=shard)
    ROUTES["shard_map"] += 1
    ep, mi, mesh, ax = shard.model, shard.model_index, shard.mesh, sharding.MODEL_AXIS
    El, Bl = E // ep, B // ep
    # slice the rows across model peers first: no two peers dispatch or
    # compute the same token
    x_l = x[mi * Bl:(mi + 1) * Bl]
    logits, probs, gate, ids = _route(params, x_l, mo, policy)
    C = capacity(S, k, E, mo.capacity_factor)
    bufs, dest = _dispatch(x_l, ids, E=E, k=k, C=C, dtype=policy.compute_dtype)
    # (Bl, E, C, d) -> peer-major -> the expert owners; slice s of the
    # result came from peer s
    t = coll.all_to_all(bufs.reshape(Bl, ep, El, C, d).movedim(1, 0), mesh, ax)
    t = t.movedim(2, 0).reshape(El, ep * Bl * C, d)            # (El, ep Bl C, d)
    out = _experts(params, t, cfg, policy)
    out = out.reshape(El, ep, Bl, C, d).movedim(0, 2)          # (ep, Bl, El, C, d)
    out = coll.all_to_all(out.contiguous(), mesh, ax)          # expert-major again
    out = out.movedim(0, 1).reshape(Bl, E * C, d)
    y = _combine(out, dest, gate, 0, policy).to(x.dtype)
    y = shard.leave(coll.all_gather(y, mesh, ax, 0), partial=False)   # (B, S, d)

    # every rank routed its own tokens: the stats reduce over every axis
    counts = _expert_counts(ids, E)
    n_slots = torch.tensor(float(S * k * Bl), device=x.device)
    mean_prob = probs.mean(dim=(0, 1))
    for a in (*shard.data_axes, ax):
        counts = coll.psum(counts, mesh, a)
        n_slots = coll.psum(n_slots, mesh, a)
        mean_prob = coll.pmean(mean_prob, mesh, a)
    aux = E * torch.sum(counts / n_slots * mean_prob)
    z = coll.pmean(torch.mean(torch.logsumexp(logits, dim=-1) ** 2), mesh, ax)
    drop = coll.pmean((dest >= E * C).to(torch.float32).mean(), mesh, ax)
    if "shared" in params:
        y = y + _shared(params, x, cfg, policy, shard)
    return y, {"moe_aux_loss": aux, "moe_z_loss": z, "moe_drop_frac": drop}
