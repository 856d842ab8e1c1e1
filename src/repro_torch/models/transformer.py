"""Decoder LM composition: the reference's ``"attn"`` and ``"xlstm"``
block kinds.

Counterpart of ``repro.models.transformer``.  Layer parameters are
stacked along a leading layer dim as in the reference (so its parameter
trees carry across, see ``repro_torch.convert``); the reference's
``lax.scan`` over that dim is a Python loop over ``torch.unbind`` views
here, so the backward stacks each parameter's gradient once.  Attention
blocks take rmsnorm or layernorm, a GLU or plain MLP, token ids or
precomputed embeddings (``batch["embeddings"]``: the audio / vision
front-end stubs); xLSTM stacks super-blocks of (7 mLSTM + 1 sLSTM).  With
``remat="full"`` each block of the layer loop (each super-block for
xLSTM) is a :func:`repro_torch.core.engine.checkpoint` region when it is
trained, as the reference checkpoints its layer-scan body.  The tied LM
head multiplies by the ``(V, d)`` embedding as stored, through the GEMM
kernel's "nt" layout, and its backward reads the table in place — no
transposed copy.  ``ce_chunk`` runs the chunked cross-entropy.  The
serving entry points run under ``torch.inference_mode()``.  MoE and
hybrid blocks, MLA, the xLSTM decode state and ``remat="dots"`` are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import engine
from repro_torch.models import attention, layers, ssm
from repro_torch.models.layers import Param

__all__ = ["schema", "init_params", "count_params", "forward", "loss_fn",
           "serve_step", "prefill", "init_cache"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"


def _check_kind(cfg, *, serving: bool = False) -> None:
    if cfg.block_kind == "xlstm" and not serving:
        return
    if (cfg.block_kind != "attn" or cfg.mla is not None
            or cfg.mlp not in ("glu", "plain")):
        what = ("the xlstm decode state" if cfg.block_kind == "xlstm" else
                f"block kind {cfg.block_kind!r} / mlp {cfg.mlp!r}")
        raise NotImplementedError(f"{what} (arch {cfg.name!r}) is {_ROADMAP}")


def _norm_param(cfg) -> Param:
    return Param((cfg.d_model,), init="ones")


def _mlp_schema(cfg) -> Dict[str, Any]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_in": Param((d, 2 * ff if cfg.mlp == "glu" else ff)),
            "w_out": Param((ff, d))}


def _xlstm_super_schema(cfg) -> Dict[str, Any]:
    n_m = cfg.ssm.slstm_period - 1
    m_block = {"ln": _norm_param(cfg), "cell": ssm.mlstm_schema(cfg)}
    s_block = {"ln": _norm_param(cfg), "cell": ssm.slstm_schema(cfg)}
    return {"mlstm": layers.stack_schema(m_block, n_m), "slstm": s_block}


def schema(cfg) -> Dict[str, Any]:
    _check_kind(cfg)
    s: Dict[str, Any] = {
        "embed": Param((cfg.vocab_size, cfg.d_model), init="embed"),
        "final_norm": _norm_param(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Param((cfg.d_model, cfg.vocab_size))
    if cfg.block_kind == "xlstm":
        n_super, rem = divmod(cfg.n_layers, cfg.ssm.slstm_period)
        if rem:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"slstm_period {cfg.ssm.slstm_period}")
        s["layers"] = layers.stack_schema(_xlstm_super_schema(cfg), n_super)
    else:
        block = {"ln1": _norm_param(cfg), "attn": attention.gqa_schema(cfg),
                 "ln2": _norm_param(cfg), "mlp": _mlp_schema(cfg)}
        s["layers"] = layers.stack_schema(block, cfg.n_layers)
    return s


def count_params(cfg) -> int:
    """Total parameters (embedding included), from the schema."""
    def go(node):
        if isinstance(node, Param):
            return math.prod(node.shape)
        return sum(go(v) for v in node.values())

    return go(schema(cfg))


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
    if cfg.norm == "layernorm":
        return layers.layernorm(x, scale)
    return layers.rmsnorm(x, scale)


def _unbind(tree) -> List[Any]:
    """The slices of a stacked tree along its leading dim, as views
    (``torch.unbind``: in-place cache writes land in the stacked tensors,
    and the backward stacks the slices' gradients once)."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unbind(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _remat(cfg, fn):
    """``remat="full"``: the block is an engine checkpoint region (the
    reference's ``jax.checkpoint`` of the layer-scan body).  ``"dots"``
    (save the GEMM outputs, recompute the rest) needs a saving policy that
    sees the ctypes kernels' outputs and is not ported."""
    if cfg.remat == "none":
        return fn
    if cfg.remat != "full":
        raise NotImplementedError(f"remat {cfg.remat!r} is {_ROADMAP}")
    return lambda *args: engine.checkpoint(fn, *args)


def _xlstm_super_block(p, h, cfg, *, policy):
    """7 mLSTM blocks + 1 sLSTM block, no state carried in (training and
    prefill from zero: the in-sequence state starts at zero inside the
    chunked sweep)."""
    for lp in _unbind(p["mlstm"]):
        out, _ = ssm.mlstm_block(lp["cell"], _norm(cfg, h, lp["ln"]), cfg,
                                 policy=policy)
        h = h + out
    out, _ = ssm.slstm_block(p["slstm"]["cell"], _norm(cfg, h, p["slstm"]["ln"]),
                             cfg, policy=policy)
    return h + out


def _attn_block(p, h, cfg, *, pos, cache, policy, kv_group_sizes=None):
    a, cache = attention.gqa_attention(
        p["attn"], _norm(cfg, h, p["ln1"]), cfg, pos_offset=pos, cache=cache,
        policy=policy, kv_group_sizes=kv_group_sizes)
    h = h + a
    mlp = layers.mlp_glu if cfg.mlp == "glu" else layers.mlp_plain
    m = mlp(p["mlp"], _norm(cfg, h, p["ln2"]), act=cfg.act, policy=policy)
    return h + m, cache


def _head(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """The LM head: the tied ``(V, d)`` embedding read in place ("nt"), or
    the ``(d, V)`` ``lm_head``."""
    if cfg.tie_embeddings:
        return engine.matmul(h, params["embed"], policy=cfg.policy, layout="nt")
    return engine.matmul(h, params["lm_head"], policy=cfg.policy)


def forward(params: Dict[str, Any], cfg, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, Any]] = None, pos=0,
            last_only: bool = False, head: bool = True,
            kv_group_sizes=None) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Logits ``(B, S', V)`` (``S' = 1`` with ``last_only``; with ``head``
    False the final-normed hidden states) and the cache (updated in
    place).  The input is ``batch["embeddings"]`` ``(B, S, d)`` where the
    batch carries it, else the embedded ``batch["inputs"]``.  ``pos`` is an
    int or a ``(B,)`` tensor of per-slot decode positions."""
    _check_kind(cfg, serving=cache is not None)
    policy = cfg.policy
    if "embeddings" in batch:
        h = batch["embeddings"].to(policy.compute_dtype)
    else:
        h = params["embed"][batch["inputs"]].to(policy.compute_dtype)
    if cfg.block_kind == "xlstm":
        block = _remat(cfg, lambda lp, hh: _xlstm_super_block(
            lp, hh, cfg, policy=policy))
        for lp in _unbind(params["layers"]):
            h = block(lp, h)
    elif cache is None:
        block = _remat(cfg, lambda lp, hh: _attn_block(
            lp, hh, cfg, pos=pos, cache=None, policy=policy)[0])
        for lp in _unbind(params["layers"]):
            h = block(lp, h)
    else:
        for lp, lc in zip(_unbind(params["layers"]), _unbind(cache["layers"])):
            h, _ = _attn_block(lp, h, cfg, pos=pos, cache=lc, policy=policy,
                               kv_group_sizes=kv_group_sizes)
    if last_only:
        h = h[:, -1:]   # serving: never materialise (B, S, V) prompt logits
    h = _norm(cfg, h, params["final_norm"])
    return (_head(params, cfg, h) if head else h), cache


def _chunked_ce(params, cfg, h: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The chunked cross-entropy (reference ``transformer.py:394-433``):
    ``ce_chunk`` batch rows at a time (the batch padded with rows labelled
    -1), each chunk's head GEMM and fp32 log-softmax one engine checkpoint
    region, so the backward recomputes a chunk's logits instead of keeping
    ``(B, S, V)`` of them.  The reference traces the chunk body once under
    ``repeat(n)``; here it runs n times, so the events sum the same."""
    B = h.shape[0]
    c = max(1, min(cfg.ce_chunk, B))
    n = -(-B // c)
    pad = n * c - B
    if pad:
        h = torch.cat([h, h.new_zeros((pad, *h.shape[1:]))])
        labels = torch.cat([labels, labels.new_full((pad, labels.shape[1]), -1)])

    def chunk(h_c, y_c):
        lf = _head(params, cfg, h_c).to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, y_c.clamp(min=0)[..., None])[..., 0]
        mask = (y_c >= 0).to(torch.float32)
        return ((lse - gold) * mask).sum(), mask.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for h_c, y_c in zip(h.split(c), labels.split(c)):
        s, m = engine.checkpoint(chunk, h_c, y_c)
        tot, cnt = tot + s, cnt + m
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"loss": loss, "ntokens": cnt}


def loss_fn(params: Dict[str, Any], cfg, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy of the batch's inputs (token ids or
    embeddings) against ``batch["labels"]`` (labels < 0 masked), with its
    metrics; chunked over batch rows when ``cfg.ce_chunk`` is set."""
    if cfg.ce_chunk:
        h, _ = forward(params, cfg, batch, head=False)
        loss, metrics = _chunked_ce(params, cfg, h, batch["labels"])
    else:
        logits, _ = forward(params, cfg, batch)
        loss, metrics = layers.cross_entropy(logits, batch["labels"])
    metrics["loss"] = loss
    return loss, metrics


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
    _check_kind(cfg, serving=True)
    one = attention.init_gqa_cache(
        cfg, batch, max_len, dtype or cfg.policy.compute_dtype, storage_dtype,
        device=resolve_device(device))
    return {"layers": {k: v[None].repeat(cfg.n_layers, *([1] * v.ndim))
                       for k, v in one.items()}}
