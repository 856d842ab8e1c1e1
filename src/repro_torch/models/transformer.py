"""Decoder LM composition: the reference's ``"attn"``, ``"moe"``,
``"xlstm"`` and ``"hymba"`` block kinds.

Counterpart of ``repro.models.transformer``.  Layer parameters are
stacked along a leading layer dim as in the reference (so its parameter
trees carry across, see ``repro_torch.convert``); the reference's
``lax.scan`` over that dim is a Python loop over ``torch.unbind`` views
here, so the backward stacks each parameter's gradient once.  Attention
blocks take rmsnorm or layernorm, a GLU or plain MLP, token ids or
precomputed embeddings (``batch["embeddings"]``: the audio / vision
front-end stubs) and GQA or MLA attention; the MoE kind (DeepSeek) is an
unstacked dense ``layer0`` (FFN width ``moe.dense_ff``) and a stack of
MoE blocks, whose router metrics ``forward`` sums over layers and
``loss_fn`` adds (``aux_weight`` / ``z_weight`` per MoE layer); xLSTM
stacks super-blocks of (7 mLSTM + 1 sLSTM); hymba stacks blocks of
attention and a Mamba2 / SSD mixer in parallel on the same normed input,
with a per-layer window (:func:`window_array`, ``BIG_WINDOW`` on the full
layers).  With ``remat="full"`` each
block of the layer loop (each super-block for xLSTM) is a
:func:`repro_torch.core.engine.checkpoint` region when it is trained, as
the reference checkpoints its layer-scan body (``layer0`` stays outside,
as in the reference).  The tied LM head multiplies by the ``(V, d)``
embedding as stored, through the GEMM kernel's "nt" layout, and its
backward reads the table in place — no transposed copy.  ``ce_chunk``
runs the chunked cross-entropy.  The serving entry points run under
``torch.inference_mode()``; the cache is updated in place, the recurrent
states (xLSTM's mLSTM / sLSTM, hymba's SSD) by ``copy_`` into the stacked
tensors.  A fresh prefill (``pos`` 0) hands the sweeps no state, so they
run the sweep kernel from zero (the reference hands them the zero state
of its cache and runs the composition: the same values up to fp32
rounding).  ``moe_impl="shard_map"`` and ``remat="dots"`` are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import engine
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.layers import Param

__all__ = ["schema", "init_params", "count_params", "forward", "loss_fn",
           "serve_step", "prefill", "init_cache", "window_array", "BIG_WINDOW"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"

BIG_WINDOW = 1 << 30     # the window of hymba's full-attention layers


def _check_kind(cfg) -> None:
    what = None
    if cfg.mlp not in ("glu", "plain"):
        what = f"mlp {cfg.mlp!r}"
    elif cfg.block_kind == "moe" and cfg.moe_impl != "gspmd":
        what = (f"moe_impl {cfg.moe_impl!r} (manual expert parallelism needs "
                "the sharding runtime)")
    if what:
        raise NotImplementedError(f"{what} (arch {cfg.name!r}) is {_ROADMAP}")


def _norm_param(cfg) -> Param:
    return Param((cfg.d_model,), init="ones")


def _mlp_schema(cfg, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"w_in": Param((d, 2 * ff if cfg.mlp == "glu" else ff)),
            "w_out": Param((ff, d))}


def _attn_schema(cfg) -> Dict[str, Any]:
    return attention.mla_schema(cfg) if cfg.mla else attention.gqa_schema(cfg)


def _attn_block_schema(cfg, d_ff: Optional[int] = None) -> Dict[str, Any]:
    return {"ln1": _norm_param(cfg), "attn": _attn_schema(cfg),
            "ln2": _norm_param(cfg), "mlp": _mlp_schema(cfg, d_ff)}


def _hymba_block_schema(cfg) -> Dict[str, Any]:
    return {"ln1": _norm_param(cfg), "attn": attention.gqa_schema(cfg),
            "attn_out_norm": _norm_param(cfg), "mamba": ssm.mamba_schema(cfg),
            "mamba_out_norm": _norm_param(cfg), "ln2": _norm_param(cfg),
            "mlp": _mlp_schema(cfg)}


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
    elif cfg.block_kind == "moe":
        if cfg.moe.first_dense != 1:
            raise ValueError(f"moe.first_dense {cfg.moe.first_dense}: only 1 "
                             "leading dense layer is supported (as in the "
                             "reference)")
        s["layer0"] = _attn_block_schema(cfg, cfg.moe.dense_ff)
        block = {"ln1": _norm_param(cfg), "attn": _attn_schema(cfg),
                 "ln2": _norm_param(cfg), "moe": moe.moe_schema(cfg)}
        s["layers"] = layers.stack_schema(block, cfg.n_layers - 1)
    elif cfg.block_kind == "hymba":
        s["layers"] = layers.stack_schema(_hymba_block_schema(cfg), cfg.n_layers)
    else:
        s["layers"] = layers.stack_schema(_attn_block_schema(cfg), cfg.n_layers)
    return s


def count_params(cfg, active_only: bool = False) -> int:
    """Total parameters (embedding included), from the schema; with
    ``active_only`` a token's active ones (``top_k`` of ``n_routed`` of the
    routed experts' weights, as the reference rounds it)."""
    total = routed = 0

    def go(node):
        nonlocal total, routed
        if isinstance(node, Param):
            n = math.prod(node.shape)
            total += n
            routed += n if node.experts else 0
            return
        for v in node.values():
            go(v)

    go(schema(cfg))
    if active_only and cfg.moe:
        return int(total - routed * (cfg.moe.n_routed - cfg.moe.top_k)
                   / cfg.moe.n_routed)
    return total


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


def window_array(cfg, device=None) -> Optional[torch.Tensor]:
    """Per-layer attention windows ``(L,)`` int32 (hymba: ``BIG_WINDOW`` on
    the full-attention layers); None without a sliding window."""
    if cfg.sliding_window is None:
        return None
    return torch.tensor([BIG_WINDOW if i in cfg.full_attn_layers
                         else cfg.sliding_window for i in range(cfg.n_layers)],
                        dtype=torch.int32, device=device)


def _xlstm_super_block(p, h, cfg, *, policy, cache=None, fresh=True):
    """7 mLSTM blocks + 1 sLSTM block.  With a cache the blocks start from
    its states (from none on a ``fresh`` prefill: the sLSTM's initial state
    is the cache's initial value) and their final states are written back
    into it in place."""
    m_cache = None if cache is None else cache["mlstm"]      # (7, B, H, hd, hd)
    for i, lp in enumerate(_unbind(p["mlstm"])):
        st = None if m_cache is None or fresh else m_cache[i]
        out, st = ssm.mlstm_block(lp["cell"], _norm(cfg, h, lp["ln"]), cfg,
                                  policy=policy, state=st)
        if m_cache is not None:
            m_cache[i].copy_(st)
        h = h + out
    s_cache = None if cache is None else cache["slstm"]
    out, st = ssm.slstm_block(p["slstm"]["cell"], _norm(cfg, h, p["slstm"]["ln"]),
                              cfg, policy=policy,
                              state=None if fresh else s_cache)
    if s_cache is not None:
        for k, v in st.items():
            s_cache[k].copy_(v)
    return h + out


def _hymba_block(p, h, cfg, *, pos, cache, window, policy, fresh=True):
    """Attention and the SSD mixer read the same normed input; their
    normed outputs are averaged (reference ``transformer.py:222-235``)."""
    hn = _norm(cfg, h, p["ln1"])
    a, _ = attention.gqa_attention(
        p["attn"], hn, cfg, pos_offset=pos,
        cache=None if cache is None else cache["attn"], window=window,
        policy=policy, q_chunk=cfg.q_chunk)
    state = None if cache is None or fresh else cache["ssm"]
    m, state = ssm.mamba_mixer(p["mamba"], hn, cfg, policy=policy, state=state)
    if cache is not None:
        cache["ssm"].copy_(state)
    h = h + 0.5 * (_norm(cfg, a, p["attn_out_norm"])
                   + _norm(cfg, m, p["mamba_out_norm"]))
    return h + layers.mlp_glu(p["mlp"], _norm(cfg, h, p["ln2"]), act=cfg.act,
                              policy=policy)


def _run_attn(cfg, p, h, *, pos, cache, policy, kv_group_sizes):
    """GQA or MLA attention (the cache, if any, is written in place)."""
    fn = attention.mla_attention if cfg.mla else attention.gqa_attention
    a, _ = fn(p, h, cfg, pos_offset=pos, cache=cache, policy=policy,
              q_chunk=cfg.q_chunk, kv_group_sizes=kv_group_sizes)
    return a


def _attn_block(p, h, cfg, *, pos, cache, policy, kv_group_sizes=None):
    h = h + _run_attn(cfg, p["attn"], _norm(cfg, h, p["ln1"]), pos=pos,
                      cache=cache, policy=policy, kv_group_sizes=kv_group_sizes)
    mlp = layers.mlp_glu if cfg.mlp == "glu" else layers.mlp_plain
    return h + mlp(p["mlp"], _norm(cfg, h, p["ln2"]), act=cfg.act, policy=policy)


def _moe_block(p, h, cfg, *, pos, cache, policy, kv_group_sizes=None):
    """Attention, then the MoE FFN; returns ``(h, metrics)`` with the
    metrics as a tuple in :data:`moe.METRICS` order."""
    h = h + _run_attn(cfg, p["attn"], _norm(cfg, h, p["ln1"]), pos=pos,
                      cache=cache, policy=policy, kv_group_sizes=kv_group_sizes)
    m, metrics = moe.moe_forward(p["moe"], _norm(cfg, h, p["ln2"]), cfg,
                                 policy=policy)
    return h + m, tuple(metrics[k] for k in moe.METRICS)


def _head(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """The LM head: the tied ``(V, d)`` embedding read in place ("nt"), or
    the ``(d, V)`` ``lm_head``."""
    if cfg.tie_embeddings:
        return engine.matmul(h, params["embed"], policy=cfg.policy, layout="nt")
    return engine.matmul(h, params["lm_head"], policy=cfg.policy)


def forward(params: Dict[str, Any], cfg, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, Any]] = None, pos=0,
            last_only: bool = False, head: bool = True, kv_group_sizes=None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Logits ``(B, S', V)`` (``S' = 1`` with ``last_only``; with ``head``
    False the final-normed hidden states), the cache (updated in place)
    and the MoE metrics summed over the MoE layers (empty for other
    kinds).  The input is ``batch["embeddings"]`` ``(B, S, d)`` where the
    batch carries it, else the embedded ``batch["inputs"]``.  ``pos`` is an
    int or a ``(B,)`` tensor of per-slot decode positions."""
    _check_kind(cfg)
    policy = cfg.policy
    kind = cfg.block_kind
    if "embeddings" in batch:
        h = batch["embeddings"].to(policy.compute_dtype)
    else:
        h = params["embed"][batch["inputs"]].to(policy.compute_dtype)
    aux: Dict[str, torch.Tensor] = {}
    # a fresh prefill: the recurrent sweeps start from no state (kernel 4)
    fresh = not isinstance(pos, torch.Tensor) and pos == 0
    kw = dict(pos=pos, policy=policy, kv_group_sizes=kv_group_sizes)
    caches = itertools.repeat(None) if cache is None else _unbind(cache["layers"])
    per_layer = [_unbind(params["layers"]), caches]
    if kind == "xlstm":
        layer = lambda lp, hh, lc: (_xlstm_super_block(
            lp, hh, cfg, policy=policy, cache=lc, fresh=fresh), ())
    elif kind == "hymba":
        per_layer.append(window_array(cfg, device=h.device).unbind(0))
        layer = lambda lp, hh, lc, win: (_hymba_block(
            lp, hh, cfg, pos=pos, cache=lc, window=win, policy=policy,
            fresh=fresh), ())
    elif kind == "moe":
        # the dense layer 0, outside the remat (as the reference's scan)
        h = _attn_block(params["layer0"], h, cfg,
                        cache=None if cache is None else cache["layer0"], **kw)
        layer = lambda lp, hh, lc: _moe_block(lp, hh, cfg, cache=lc, **kw)
    else:
        layer = lambda lp, hh, lc: (_attn_block(lp, hh, cfg, cache=lc, **kw), ())
    block = layer if cache is not None else _remat(cfg, layer)
    sums = None
    for lp, lc, *win in zip(*per_layer):
        h, m = block(lp, h, lc, *win)
        sums = m if sums is None else tuple(a + b for a, b in zip(sums, m))
    if kind == "moe":
        aux = dict(zip(moe.METRICS, sums))
    if last_only:
        h = h[:, -1:]   # serving: never materialise (B, S, V) prompt logits
    h = _norm(cfg, h, params["final_norm"])
    return (_head(params, cfg, h) if head else h), cache, aux


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
        h, _, aux = forward(params, cfg, batch, head=False)
        loss, metrics = _chunked_ce(params, cfg, h, batch["labels"])
    else:
        logits, _, aux = forward(params, cfg, batch)
        loss, metrics = layers.cross_entropy(logits, batch["labels"])
    if cfg.moe:
        # the reference's per-MoE-layer weighting (transformer.py:444-448)
        n = max(cfg.n_layers - 1, 1)
        loss = loss + cfg.moe.aux_weight * aux["moe_aux_loss"] / n
        loss = loss + cfg.moe.z_weight * aux["moe_z_loss"] / n
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


@torch.inference_mode()
def serve_step(params, cfg, tokens: torch.Tensor, cache, pos, *,
               kv_group_sizes=None):
    """One decode step: tokens ``(B, 1)`` + cache at ``pos`` -> (logits
    ``(B, V)``, cache).  ``pos`` is an int (uniform batch) or a ``(B,)``
    tensor (the scheduler's continuous batch, with ``kv_group_sizes`` the
    per-slot valid KV lengths after this step's append)."""
    logits, cache, _ = forward(params, cfg, {"inputs": tokens}, cache=cache,
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
    logits, cache, _ = forward(params, cfg, batch, cache=cache, pos=0,
                               last_only=True)
    return logits[:, -1], cache


def _stack(tree, n: int):
    """``n`` copies of every leaf, stacked along a new leading dim."""
    if isinstance(tree, torch.Tensor):
        return tree[None].repeat(n, *([1] * tree.ndim))
    return {k: _stack(v, n) for k, v in tree.items()}


def init_cache(cfg, batch: int, max_len: int, dtype=None, storage_dtype=None,
               *, device="cuda"):
    """The decode cache, leaf for leaf the reference's
    (``transformer.py:544-568``): ``{"layers": {"k", "v": (L, B, Hkv, T,
    hd)}}`` (MLA: ``{"ckv": (L, B, T, r), "kr": (L, B, T, dr)}``; the MoE
    kind also has the unstacked ``"layer0"``); hymba ``{"layers": {"attn":
    {"k", "v"}, "ssm": (L, B, H, N, P) fp32}}``; xLSTM ``{"layers":
    {"mlstm": (n_super, 7, B, H, hd, hd), "slstm": {"c", "n", "h", "m":
    (n_super, B, H, hd)}}}`` fp32, ``m`` at -1e30."""
    _check_kind(cfg)
    kind = cfg.block_kind
    if storage_dtype is not None and kind not in ("attn", "moe"):
        raise ValueError(
            f"FP8 cache storage supports attn/moe block kinds, not {kind!r}")
    dev = resolve_device(device)
    dtype = dtype or cfg.policy.compute_dtype
    f32 = dict(dtype=torch.float32, device=dev)
    if kind == "xlstm":
        n_super = cfg.n_layers // cfg.ssm.slstm_period
        H = cfg.n_heads
        hd_m = cfg.ssm.mlstm_proj_factor * cfg.d_model // H
        hd_s = cfg.d_model // H
        s_shape = (n_super, batch, H, hd_s)
        return {"layers": {
            "mlstm": torch.zeros((n_super, cfg.ssm.slstm_period - 1, batch, H,
                                  hd_m, hd_m), **f32),
            "slstm": {"c": torch.zeros(s_shape, **f32),
                      "n": torch.zeros(s_shape, **f32),
                      "h": torch.zeros(s_shape, **f32),
                      "m": torch.full(s_shape, -1e30, **f32)}}}
    if kind == "hymba":
        di = cfg.ssm.mamba_expand * cfg.d_model
        one = {"attn": attention.init_gqa_cache(cfg, batch, max_len, dtype,
                                                device=dev),
               "ssm": torch.zeros((batch, cfg.n_heads, cfg.ssm.state_dim,
                                   di // cfg.n_heads), **f32)}
        return {"layers": _stack(one, cfg.n_layers)}
    init = attention.init_mla_cache if cfg.mla else attention.init_gqa_cache
    one = init(cfg, batch, max_len, dtype, storage_dtype, device=dev)
    out = {"layers": _stack(one, cfg.n_layers - (kind == "moe"))}
    if kind == "moe":
        out["layer0"] = one
    return out
