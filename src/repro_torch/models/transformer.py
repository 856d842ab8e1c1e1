"""Decoder LM composition: the reference's ``"attn"`` block kind.

Counterpart of ``repro.models.transformer`` for dense GQA models.  Layer
parameters are stacked along a leading layer dim as in the reference (so
its parameter trees carry across, see ``repro_torch.convert``); the
reference's ``lax.scan`` over that dim is a Python loop here.  The tied LM
head multiplies by the ``(V, d)`` embedding as stored, through the GEMM
kernel's "nt" layout — no transposed copy.  The serving entry points run
under ``torch.inference_mode()``.  MoE, xLSTM and hybrid blocks, MLA,
plain (non-gated) MLPs, training and the loss are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import engine
from repro_torch.models import attention, layers
from repro_torch.models.layers import Param

__all__ = ["schema", "init_params", "forward", "serve_step", "prefill",
           "init_cache"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


def _check_kind(cfg) -> None:
    if cfg.block_kind != "attn" or cfg.mla is not None or cfg.mlp != "glu":
        raise NotImplementedError(
            f"block kind {cfg.block_kind!r} / mlp {cfg.mlp!r} (arch "
            f"{cfg.name!r}) is {_ROADMAP}")


def _norm_param(cfg) -> Param:
    return Param((cfg.d_model,), init="ones")


def _mlp_schema(cfg) -> Dict[str, Any]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_in": Param((d, 2 * ff)), "w_out": Param((ff, d))}


def schema(cfg) -> Dict[str, Any]:
    _check_kind(cfg)
    block = {"ln1": _norm_param(cfg), "attn": attention.gqa_schema(cfg),
             "ln2": _norm_param(cfg), "mlp": _mlp_schema(cfg)}
    s: Dict[str, Any] = {
        "embed": Param((cfg.vocab_size, cfg.d_model), init="embed"),
        "final_norm": _norm_param(cfg),
        "layers": layers.stack_schema(block, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Param((cfg.d_model, cfg.vocab_size))
    return s


def init_params(cfg, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device``.

    ``dtype`` defaults to the policy's compute dtype: every engine dispatch
    casts its operands to that dtype anyway (the reference's
    ``engine._prep_operand``) and rmsnorm / the embedding cast to the
    activation dtype, so holding the weights in it on the card computes
    exactly what fp32 weights would."""
    return layers.init_tree(schema(cfg), seed=seed, device=resolve_device(device),
                            dtype=dtype or cfg.policy.compute_dtype)


def _norm(cfg, x, scale):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is {_ROADMAP}")
    return layers.rmsnorm(x, scale)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views: in-place cache writes
    land in the stacked tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _attn_block(p, h, cfg, *, pos, cache, policy, kv_group_sizes=None):
    a, cache = attention.gqa_attention(
        p["attn"], _norm(cfg, h, p["ln1"]), cfg, pos_offset=pos, cache=cache,
        policy=policy, kv_group_sizes=kv_group_sizes)
    h = h + a
    m = layers.mlp_glu(p["mlp"], _norm(cfg, h, p["ln2"]), act=cfg.act,
                       policy=policy)
    return h + m, cache


def forward(params: Dict[str, Any], cfg, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, Any]] = None, pos=0,
            last_only: bool = False,
            kv_group_sizes=None) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Logits ``(B, S', V)`` (``S' = 1`` with ``last_only``) and the cache
    (updated in place).  ``pos`` is an int or a ``(B,)`` tensor of
    per-slot decode positions."""
    _check_kind(cfg)
    policy = cfg.policy
    h = params["embed"][batch["inputs"]].to(policy.compute_dtype)
    for i in range(cfg.n_layers):
        h, _ = _attn_block(
            _layer(params["layers"], i), h, cfg, pos=pos,
            cache=None if cache is None else _layer(cache["layers"], i),
            policy=policy, kv_group_sizes=kv_group_sizes)
    if last_only:
        h = h[:, -1:]   # serving: never materialise (B, S, V) prompt logits
    h = _norm(cfg, h, params["final_norm"])
    if cfg.tie_embeddings:
        logits = engine.matmul(h, params["embed"], policy=policy, layout="nt")
    else:
        logits = engine.matmul(h, params["lm_head"], policy=policy)
    return logits, cache


@torch.inference_mode()
def serve_step(params, cfg, tokens: torch.Tensor, cache, pos, *,
               kv_group_sizes=None):
    """One decode step: tokens ``(B, 1)`` + cache at ``pos`` -> (logits
    ``(B, V)``, cache).  ``pos`` is an int (uniform batch) or a ``(B,)``
    tensor (the scheduler's continuous batch, with ``kv_group_sizes`` the
    per-slot valid KV lengths after this step's append)."""
    logits, cache = forward(params, cfg, {"inputs": tokens}, cache=cache,
                            pos=pos, kv_group_sizes=kv_group_sizes)
    return logits[:, -1], cache


@torch.inference_mode()
def prefill(params, cfg, batch, max_len: int, storage_dtype=None):
    """Run the prompt ``batch["inputs"] (B, S)``, build a ``max_len``
    cache, return (last-token logits ``(B, V)``, cache)."""
    B = batch["inputs"].shape[0]
    cache = init_cache(cfg, B, max_len, dtype=cfg.policy.compute_dtype,
                       storage_dtype=storage_dtype,
                       device=params["embed"].device)
    logits, cache = forward(params, cfg, batch, cache=cache, pos=0,
                            last_only=True)
    return logits[:, -1], cache


def init_cache(cfg, batch: int, max_len: int, dtype=None, storage_dtype=None,
               *, device="cuda"):
    """The decode cache ``{"layers": {"k", "v": (L, B, Hkv, T, hd)}}``."""
    _check_kind(cfg)
    one = attention.init_gqa_cache(
        cfg, batch, max_len, dtype or cfg.policy.compute_dtype, storage_dtype,
        device=resolve_device(device))
    return {"layers": {k: v[None].repeat(cfg.n_layers, *([1] * v.ndim))
                       for k, v in one.items()}}
