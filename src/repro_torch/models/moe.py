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
stable descending sort cut at k.  The reference's ``moe_forward_shard_map``
(manual expert parallelism) needs the sharding runtime and is not ported
(ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.models import layers
from repro_torch.models.layers import Param

__all__ = ["moe_schema", "moe_forward", "top_k", "capacity", "METRICS"]

METRICS = ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")


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
        "router": Param((d, E)),
        "w_in": Param((E, d, 2 * f), experts=True),
        "w_out": Param((E, f, d), experts=True),
    }
    if mo.n_shared:
        fs = mo.n_shared * f
        s["shared"] = {"w_in": Param((d, 2 * fs)), "w_out": Param((fs, d))}
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


def moe_forward(params: Dict[str, Any], x: torch.Tensor, cfg, *,
                policy: prec.Policy
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(B, S, d)`` -> ``(y (B, S, d), metrics)``: the routed experts'
    gate-weighted sum plus the shared experts, and the Switch load-balance
    loss, the router z-loss and the fraction of slots dropped past
    capacity."""
    mo = cfg.moe
    B, S, d = x.shape
    E, k = mo.n_routed, mo.top_k

    # ---- router (fp32 logits), softmax, top-k ----
    logits = engine.matmul(x, params["router"], policy=_router_policy(policy))
    probs = torch.softmax(logits, dim=-1)
    gate, ids = top_k(probs, k)                                   # (B, S, k)
    if mo.norm_topk_prob:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance aux (Switch-style) + router z-loss ----
    counts = torch.bincount(ids.reshape(-1), minlength=E).to(torch.float32)
    aux_loss = E * torch.sum(counts / (B * S * k) * probs.mean(dim=(0, 1)))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- sort-based dispatch with capacity, all experts as one GEMM ----
    C = capacity(S, k, E, mo.capacity_factor)
    bufs, dest = _dispatch(x, ids, E=E, k=k, C=C, dtype=policy.compute_dtype)
    h = engine.grouped_matmul(bufs, params["w_in"], policy=policy)  # (B, E, C, 2f)
    g_, u_ = h.chunk(2, dim=-1)
    h = layers.activation(g_, cfg.act) * u_
    out = engine.grouped_matmul(h, params["w_out"], policy=policy)  # (B, E, C, d)

    # ---- combine: one permutation gather + the k-slot contraction ----
    flat = torch.cat([out.reshape(B, E * C, d), out.new_zeros((B, 1, d))], dim=1)
    slot = torch.gather(flat, 1, dest[..., None].expand(-1, -1, d))  # (B, S k, d)
    w_slot = (gate.reshape(B, S * k) * (dest < E * C)).to(torch.float32)
    y = engine.einsum2d("bskd,bsk->bsd", slot.reshape(B, S, k, d),
                        w_slot.reshape(B, S, k),
                        policy=_combine_policy(policy)).to(x.dtype)

    if "shared" in params:
        y = y + layers.mlp_glu(params["shared"], x, act=cfg.act, policy=policy)
    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_drop_frac": (dest >= E * C).to(torch.float32).mean()}
    return y, metrics
