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
layers).  With ``remat="full"`` (or ``"dots"``) each
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
rounding).  ``remat="dots"`` makes each block a region that keeps its
no-batch GEMM outputs (``engine.checkpoint``).

Every parameter carries the reference's logical axes, so
:func:`param_specs`, :func:`abstract_params` and :func:`cache_axes` give
its spec trees leaf for leaf.  Under rules and a mesh of ranks
(``runtime/sharding.py``: ``use_rules`` / ``use_mesh``) each rank runs
its part on its local blocks: the embedding looks up its vocab block and
the rows are summed over the model axis; attention (GQA and MLA) runs
head-parallel, or replicated where the heads do not divide the model
axis, or on the sequence-sharded serving cache; the MLPs and MoE experts
run tensor- / expert-parallel; the recurrent blocks run their cut GEMMs
on the rank's block and their core and states replicated; the head's
logits come out cut over the vocab, and the cross-entropy is
vocab-parallel.  Under FSDP each block gathers its layer's data-cut
weights inside its remat region (:func:`_gather_top`); under sequence
parallelism the residual stream holds the rank's positions between the
blocks (``ShardCtx.enter`` / ``leave``).  ``serve_step`` and ``prefill``
gather the logits whole.  The FP8 KV cache on a mesh raises, naming
ROADMAP.md.
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
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding

__all__ = ["schema", "init_params", "param_specs", "abstract_params",
           "count_params", "forward", "loss_fn", "serve_step", "prefill",
           "init_cache", "cache_axes", "window_array", "BIG_WINDOW"]

_ROADMAP = "not yet ported (see ROADMAP.md, Queue A)"

BIG_WINDOW = 1 << 30     # the window of hymba's full-attention layers


def _check_kind(cfg) -> None:
    if cfg.mlp not in ("glu", "plain"):
        raise NotImplementedError(f"mlp {cfg.mlp!r} (arch {cfg.name!r}) is "
                                  f"{_ROADMAP}")
    if cfg.block_kind == "moe" and cfg.moe_impl not in ("gspmd", "shard_map"):
        raise ValueError(f"moe_impl {cfg.moe_impl!r}: gspmd | shard_map")


def _norm_param(cfg) -> Param:
    return Param((cfg.d_model,), (None,), init="ones")


def _mlp_schema(cfg, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"w_in": Param((d, 2 * ff if cfg.mlp == "glu" else ff), ("embed", "ff")),
            "w_out": Param((ff, d), ("ff", "embed"))}


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
        "embed": Param((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                       init="embed"),
        "final_norm": _norm_param(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Param((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
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
                dtype: Optional[torch.dtype] = None, mesh=None,
                specs=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` on ``device``.

    ``dtype`` defaults to the policy's compute dtype: every engine dispatch
    casts its operands to that dtype anyway (the reference's
    ``engine._prep_operand``) and rmsnorm / the embedding cast to the
    activation dtype, so holding the weights in it on the card computes
    exactly what fp32 weights would.

    With ``mesh`` and ``specs`` (a sanitized spec tree, e.g.
    :func:`param_specs` through ``sanitize_spec``) each leaf is drawn
    whole, exactly as without them, and cut at once to this rank's block:
    a rank holds its shards and at most one whole leaf."""
    place = None
    if mesh is not None:
        def place(path, x):
            spec = specs
            for k in path:
                spec = spec[k]
            return sharding.shard_block(x, spec, mesh).clone()
    return layers.init_tree(schema(cfg), seed=seed, device=resolve_device(device),
                            dtype=dtype or cfg.policy.compute_dtype, place=place)


def param_specs(cfg, rules):
    """The logical spec of every parameter under ``rules``."""
    return layers.spec_tree(schema(cfg), rules)


def abstract_params(cfg):
    """Every parameter as a meta tensor of ``cfg.param_dtype``."""
    return layers.abstract_tree(schema(cfg), dtype=getattr(torch, cfg.param_dtype))


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
    reference's ``jax.checkpoint`` of the layer-scan body); ``"dots"``
    keeps the region's no-batch GEMM outputs and recomputes the rest (the
    reference's ``dots_with_no_batch_dims_saveable``,
    ``engine.checkpoint(policy="dots")``)."""
    if cfg.remat == "none":
        return fn
    return lambda *args: engine.checkpoint(fn, *args, policy=cfg.remat)


def window_array(cfg, device=None) -> Optional[torch.Tensor]:
    """Per-layer attention windows ``(L,)`` int32 (hymba: ``BIG_WINDOW`` on
    the full-attention layers); None without a sliding window."""
    if cfg.sliding_window is None:
        return None
    return torch.tensor([BIG_WINDOW if i in cfg.full_attn_layers
                         else cfg.sliding_window for i in range(cfg.n_layers)],
                        dtype=torch.int32, device=device)


def _xlstm_super_block(p, h, cfg, *, policy, cache=None, fresh=True, shard=None):
    """7 mLSTM blocks + 1 sLSTM block.  With a cache the blocks start from
    its states (from none on a ``fresh`` prefill: the sLSTM's initial state
    is the cache's initial value) and their final states are written back
    into it in place (on a mesh every rank holds them whole and computes
    them alike)."""
    m_cache = None if cache is None else cache["mlstm"]      # (7, B, H, hd, hd)
    for i, lp in enumerate(_unbind(p["mlstm"])):
        st = None if m_cache is None or fresh else m_cache[i]
        out, st = ssm.mlstm_block(lp["cell"], _norm(cfg, h, lp["ln"]), cfg,
                                  policy=policy, state=st, shard=shard)
        if m_cache is not None:
            m_cache[i].copy_(st)
        h = h + out
    s_cache = None if cache is None else cache["slstm"]
    out, st = ssm.slstm_block(p["slstm"]["cell"], _norm(cfg, h, p["slstm"]["ln"]),
                              cfg, policy=policy,
                              state=None if fresh else s_cache, shard=shard)
    if s_cache is not None:
        for k, v in st.items():
            s_cache[k].copy_(v)
    return h + out


def _hymba_block(p, h, cfg, *, pos, cache, window, policy, fresh=True, shard=None):
    """Attention and the SSD mixer read the same normed input; their
    normed outputs are averaged (reference ``transformer.py:222-235``).
    Under sequence parallelism the normed input is gathered once for
    both."""
    hn = _norm(cfg, h, p["ln1"])
    if shard is not None:
        hn = shard.enter(hn)
    a, _ = attention.gqa_attention(
        p["attn"], hn, cfg, pos_offset=pos,
        cache=None if cache is None else cache["attn"], window=window,
        policy=policy, q_chunk=cfg.q_chunk, shard=shard)
    state = None if cache is None or fresh else cache["ssm"]
    m, state = ssm.mamba_mixer(p["mamba"], hn, cfg, policy=policy, state=state,
                               shard=shard)
    if cache is not None:
        cache["ssm"].copy_(state)
    h = h + 0.5 * (_norm(cfg, a, p["attn_out_norm"])
                   + _norm(cfg, m, p["mamba_out_norm"]))
    return h + layers.mlp_glu(p["mlp"], _norm(cfg, h, p["ln2"]), act=cfg.act,
                              policy=policy, shard=shard, ff=cfg.d_ff)


def _run_attn(cfg, p, h, *, pos, cache, policy, kv_group_sizes, shard=None):
    """GQA or MLA attention (the cache, if any, is written in place)."""
    if cfg.mla:
        a, _ = attention.mla_attention(p, h, cfg, pos_offset=pos, cache=cache,
                                       policy=policy, q_chunk=cfg.q_chunk,
                                       kv_group_sizes=kv_group_sizes, shard=shard)
        return a
    a, _ = attention.gqa_attention(p, h, cfg, pos_offset=pos, cache=cache,
                                   policy=policy, q_chunk=cfg.q_chunk,
                                   kv_group_sizes=kv_group_sizes, shard=shard)
    return a


def _attn_block(p, h, cfg, *, pos, cache, policy, kv_group_sizes=None,
                shard=None, d_ff=None):
    h = h + _run_attn(cfg, p["attn"], _norm(cfg, h, p["ln1"]), pos=pos,
                      cache=cache, policy=policy, kv_group_sizes=kv_group_sizes,
                      shard=shard)
    mlp = layers.mlp_glu if cfg.mlp == "glu" else layers.mlp_plain
    return h + mlp(p["mlp"], _norm(cfg, h, p["ln2"]), act=cfg.act, policy=policy,
                   shard=shard, ff=d_ff or cfg.d_ff)


def _moe_block(p, h, cfg, *, pos, cache, policy, kv_group_sizes=None, shard=None):
    """Attention, then the MoE FFN (the route of ``cfg.moe_impl``); returns
    ``(h, metrics)`` with the metrics as a tuple in :data:`moe.METRICS`
    order."""
    h = h + _run_attn(cfg, p["attn"], _norm(cfg, h, p["ln1"]), pos=pos,
                      cache=cache, policy=policy, kv_group_sizes=kv_group_sizes,
                      shard=shard)
    fn = moe.moe_forward_shard_map if cfg.moe_impl == "shard_map" else moe.moe_forward
    m, metrics = fn(p["moe"], _norm(cfg, h, p["ln2"]), cfg, policy=policy,
                    shard=shard)
    return h + m, tuple(metrics[k] for k in moe.METRICS)


def _embed(params, cfg, ids: torch.Tensor, shard) -> torch.Tensor:
    """Token rows of the ``(V, d)`` table.  Cut over the vocab, each rank
    looks up the ids in its block (others give zero rows) and the rows are
    summed over the model axis (reduce-scattered over the positions under
    sequence parallelism)."""
    table = params["embed"]
    start = shard.block(cfg.vocab_size, table.shape[0]) if shard else None
    if start is None:
        rows = table[ids]
        return rows if shard is None else shard.leave(rows, partial=False)
    local = ids - start
    ok = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(ok, local, 0)] * ok[..., None].to(table.dtype)
    return shard.leave(rows, partial=True)


def _vocab_start(params, cfg, shard) -> Optional[int]:
    """This rank's first vocab entry when the head is cut over the vocab."""
    if shard is None:
        return None
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return shard.block(cfg.vocab_size, w.shape[0 if cfg.tie_embeddings else 1])


def _gather_vocab(logits: torch.Tensor, params, cfg, shard) -> torch.Tensor:
    """Vocab-cut logits made whole (serving's greedy argmax reads all)."""
    if _vocab_start(params, cfg, shard) is None:
        return logits
    return coll.all_gather(logits, shard.mesh, sharding.MODEL_AXIS, -1)


def _head(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """The LM head: the tied ``(V, d)`` embedding read in place ("nt"), or
    the ``(d, V)`` ``lm_head`` (on a mesh: this rank's vocab block)."""
    if cfg.tie_embeddings:
        return engine.matmul(h, params["embed"], policy=cfg.policy, layout="nt")
    return engine.matmul(h, params["lm_head"], policy=cfg.policy)


def _gather_top(params, cfg, sh):
    """FSDP (parameters cut over the data axes, ``Rules(fsdp=True)``): the
    parameters outside the layer stack gathered over the data axes, and
    the layer stack's sanitized specs, which each block reads to gather
    its own layer inside its remat region (ZeRO-3: a layer's gathered
    weights live for its forward, and the recompute gathers them again;
    the gather's backward sums the gradient over the data axes and keeps
    the rank's block).  ``(params, None)`` when nothing is cut over
    data."""
    if sh is None or sh.data == 1:
        return params, None
    specs = sharding.sanitize_tree(param_specs(cfg, sh.rules), abstract_params(cfg),
                                   sh.mesh)
    top = {k: v if k == "layers" else sharding.gather_over(
        v, specs[k], sh.mesh, sh.data_axes) for k, v in params.items()}
    return top, specs["layers"]


def forward(params: Dict[str, Any], cfg, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, Any]] = None, pos=0,
            last_only: bool = False, head: bool = True, kv_group_sizes=None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Logits ``(B, S', V)`` (``S' = 1`` with ``last_only``; with ``head``
    False the final-normed hidden states), the cache (updated in place)
    and the MoE metrics summed over the MoE layers (empty for other
    kinds).  The input is ``batch["embeddings"]`` ``(B, S, d)`` where the
    batch carries it, else the embedded ``batch["inputs"]``.  ``pos`` is an
    int or a ``(B,)`` tensor of per-slot decode positions.  On a mesh the
    batch is this rank's rows and the logits its vocab block."""
    _check_kind(cfg)
    sh = sharding.context()
    params, lspec = _gather_top(params, cfg, sh)
    return _forward(params, lspec, cfg, batch, sh, cache=cache, pos=pos,
                    last_only=last_only, head=head, kv_group_sizes=kv_group_sizes)


def _forward(params, lspec, cfg, batch, sh, *, cache=None, pos=0,
             last_only=False, head=True, kv_group_sizes=None):
    """:func:`forward` on parameters whose leaves outside the layer stack
    are whole over the data axes (:func:`_gather_top`); ``lspec`` the
    layer stack's specs when its leaves are cut over them."""
    policy = cfg.policy
    kind = cfg.block_kind
    x = batch["embeddings"] if "embeddings" in batch else batch["inputs"]
    sh = sharding.with_sequence(sh, x.shape[1])
    if "embeddings" in batch:
        h = x.to(policy.compute_dtype)
        h = h if sh is None else sh.leave(h, partial=False)
    else:
        h = _embed(params, cfg, x, sh).to(policy.compute_dtype)
    aux: Dict[str, torch.Tensor] = {}
    # a fresh prefill: the recurrent sweeps start from no state (kernel 4)
    fresh = not isinstance(pos, torch.Tensor) and pos == 0
    kw = dict(pos=pos, policy=policy, kv_group_sizes=kv_group_sizes, shard=sh)
    caches = itertools.repeat(None) if cache is None else _unbind(cache["layers"])
    per_layer = [_unbind(params["layers"]), caches]
    if kind == "xlstm":
        layer = lambda lp, hh, lc: (_xlstm_super_block(
            lp, hh, cfg, policy=policy, cache=lc, fresh=fresh, shard=sh), ())
    elif kind == "hymba":
        per_layer.append(window_array(cfg, device=h.device).unbind(0))
        layer = lambda lp, hh, lc, win: (_hymba_block(
            lp, hh, cfg, pos=pos, cache=lc, window=win, policy=policy,
            fresh=fresh, shard=sh), ())
    elif kind == "moe":
        # the dense layer 0, outside the remat (as the reference's scan)
        h = _attn_block(params["layer0"], h, cfg,
                        cache=None if cache is None else cache["layer0"],
                        d_ff=cfg.moe.dense_ff, **kw)
        layer = lambda lp, hh, lc: _moe_block(lp, hh, cfg, cache=lc, **kw)
    else:
        layer = lambda lp, hh, lc: (_attn_block(lp, hh, cfg, cache=lc, **kw), ())
    if lspec is not None:       # FSDP: gather the layer inside its region
        cut = layer
        layer = lambda lp, *rest: cut(sharding.gather_over(
            lp, lspec, sh.mesh, sh.data_axes, lead=1), *rest)
    block = layer if cache is not None else _remat(cfg, layer)
    sums = None
    for lp, lc, *win in zip(*per_layer):
        h, m = block(lp, h, lc, *win)
        sums = m if sums is None else tuple(a + b for a, b in zip(sums, m))
    if kind == "moe":
        aux = dict(zip(moe.METRICS, sums))
    if sh is not None:
        h = sh.enter(h)         # the head reads every position
    if last_only:
        h = h[:, -1:]   # serving: never materialise (B, S, V) prompt logits
    h = _norm(cfg, h, params["final_norm"])
    return (_head(params, cfg, h) if head else h), cache, aux


def _lse_gold(lf: torch.Tensor, labels: torch.Tensor, start: Optional[int],
              shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-sum-exp over the vocab and the target's logit, from fp32 logits
    ``lf (..., V)``.  Cut over the vocab (``start`` the rank's first entry)
    they are vocab-parallel: the row maximum and the sum of exponentials
    are combined over the model axis, and the target logit comes from the
    rank that holds it."""
    if start is None:
        gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
        return torch.logsumexp(lf, dim=-1), gold
    mesh, ax = shard.mesh, sharding.MODEL_AXIS
    mx = coll.pmax(lf.amax(dim=-1), mesh, ax)
    lse = mx + torch.log(coll.psum(torch.exp(lf - mx[..., None]).sum(dim=-1), mesh, ax))
    local = labels.clamp(min=0) - start
    ok = (local >= 0) & (local < lf.shape[-1])
    gold = torch.gather(lf, -1, torch.where(ok, local, 0)[..., None])[..., 0]
    return lse, coll.psum(gold * ok, mesh, ax)


def _cross_entropy(params, cfg, logits: torch.Tensor, labels: torch.Tensor,
                   shard, z_loss: float = 0.0):
    """``layers.cross_entropy``, vocab-parallel on a mesh."""
    start = _vocab_start(params, cfg, shard)
    if start is None:
        return layers.cross_entropy(logits, labels, z_loss)
    lse, gold = _lse_gold(logits.to(torch.float32), labels, start, shard)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    return loss, {"loss": loss, "ntokens": denom}


def _chunked_ce(params, cfg, h: torch.Tensor, labels: torch.Tensor, shard=None
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

    start = _vocab_start(params, cfg, shard)

    def chunk(h_c, y_c):
        lse, gold = _lse_gold(_head(params, cfg, h_c).to(torch.float32), y_c,
                              start, shard)
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
    _check_kind(cfg)
    sh = sharding.context()
    params, lspec = _gather_top(params, cfg, sh)
    if cfg.ce_chunk:
        h, _, aux = _forward(params, lspec, cfg, batch, sh, head=False)
        loss, metrics = _chunked_ce(params, cfg, h, batch["labels"], sh)
    else:
        logits, _, aux = _forward(params, lspec, cfg, batch, sh)
        loss, metrics = _cross_entropy(params, cfg, logits, batch["labels"], sh)
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
    return _gather_vocab(logits[:, -1], params, cfg, sharding.context()), cache


@torch.inference_mode()
def prefill(params, cfg, batch, max_len: int, storage_dtype=None):
    """Run the prompt ``batch["inputs"] (B, S)``, build a ``max_len``
    cache, return (last-token logits ``(B, V)``, cache); an embedding-input
    arch's prompt is ``batch["embeddings"] (B, S, d)``.  On a mesh the
    prompt is this rank's rows of the batch and the cache its block."""
    sh = sharding.context()
    some = batch["inputs"] if "inputs" in batch else batch["embeddings"]
    B = some.shape[0] * (sh.data if sh is not None else 1)
    cache = init_cache(cfg, B, max_len, dtype=cfg.policy.compute_dtype,
                       storage_dtype=storage_dtype,
                       device=params["embed"].device)
    logits, cache, _ = forward(params, cfg, batch, cache=cache, pos=0,
                               last_only=True)
    return _gather_vocab(logits[:, -1], params, cfg, sh), cache


def cache_axes(cfg, storage_dtype=None):
    """The logical axes of every leaf of :func:`init_cache`'s output, leaf
    for leaf the reference's (``transformer.py:483-512``); with
    ``storage_dtype`` the FP8 cache's per-head scale leaves too."""
    kind = cfg.block_kind
    gqa = {"k": ("batch", "kv_heads", "kv_seq", None),
           "v": ("batch", "kv_heads", "kv_seq", None)}
    mla = {"ckv": ("batch", "kv_seq", None), "kr": ("batch", "kv_seq", None)}
    if storage_dtype is not None:
        gqa = dict(gqa, k_scale=attention.scale_leaf_axes(("kv_heads",)),
                   v_scale=attention.scale_leaf_axes(("kv_heads",)))
        mla = dict(mla, ckv_scale=attention.scale_leaf_axes(()),
                   kr_scale=attention.scale_leaf_axes(()))
    attn = mla if cfg.mla else gqa

    def stackax(tree):
        if isinstance(tree, tuple):
            return ("layers", *tree)
        return {k: stackax(v) for k, v in tree.items()}

    if kind == "attn":
        return {"layers": stackax(attn)}
    if kind == "moe":
        return {"layer0": attn, "layers": stackax(attn)}
    if kind == "hymba":
        return {"layers": stackax({"attn": gqa, "ssm": ("batch", None, None, None)})}
    if kind == "xlstm":
        return {"layers": stackax({
            "mlstm": (None, "batch", None, None, None),
            "slstm": {k: ("batch", None, None) for k in ("c", "n", "h", "m")}})}
    raise ValueError(kind)


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
    (n_super, B, H, hd)}}}`` fp32, ``m`` at -1e30.

    On a mesh (``use_rules`` / ``use_mesh``) ``batch`` and ``max_len`` are
    the global sizes and the cache is this rank's block of
    :func:`cache_axes`' sanitized spec (:func:`_local_cache`): its data
    rows and, under the serving rules, its ``max_len / model`` positions
    of every KV head; under ``Rules()`` its KV heads where they divide the
    model axis; the recurrent states whole."""
    _check_kind(cfg)
    kind = cfg.block_kind
    if storage_dtype is not None and kind not in ("attn", "moe"):
        raise ValueError(
            f"FP8 cache storage supports attn/moe block kinds, not {kind!r}")
    dev = resolve_device(device)
    dtype = dtype or cfg.policy.compute_dtype
    sh = sharding.context()
    if sh is not None:
        return _local_cache(cfg, sh, batch, max_len, dtype, storage_dtype, dev)
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


def _local_cache(cfg, sh, batch: int, max_len: int, dtype, storage_dtype, dev):
    """This rank's blocks of the decode cache of ``batch`` x ``max_len``:
    every leaf at the local shape of its sanitized :func:`cache_axes` spec,
    at its initial value (the sLSTM stabiliser ``m`` at -1e30, the rest
    zero)."""
    if storage_dtype is not None:
        sharding.refuse("the FP8 KV cache")
    if sh.rules.serve_attention and cfg.block_kind != "xlstm" and max_len % sh.model:
        sharding.refuse(f"a serving cache of {max_len} positions on a "
                        f"{sh.model}-way model axis (max_len a multiple of it)")
    from repro_torch.roofline.memory import described

    with sharding.use_mesh(None), described():
        whole = init_cache(cfg, batch, max_len, dtype, device="meta")

    def local(axes, leaf, name):
        if isinstance(leaf, dict):
            return {k: local(axes[k], v, k) for k, v in leaf.items()}
        spec = sharding.sanitize_spec(sharding.logical_spec(axes, sh.rules),
                                      tuple(leaf.shape), sh.mesh)
        return torch.full(sharding.local_shape(tuple(leaf.shape), spec, sh.mesh),
                          -1e30 if name == "m" else 0.0, dtype=leaf.dtype, device=dev)

    return local(cache_axes(cfg), whole, None)
