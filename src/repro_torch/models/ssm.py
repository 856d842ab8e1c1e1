"""SSM blocks: xLSTM's mLSTM and sLSTM, and the Mamba2 / SSD mixer.

Counterpart of ``repro.models.ssm``.  The mLSTM and the SSD mixer (hymba's
SSM heads) run their matrix-memory recurrence through the engine's chunked
linear-attention op (the hand-written sweep kernel on the card, when no
state is carried in; a decode step with a state takes
:func:`linear_attention_step`); the sLSTM is a sequential scalar
recurrence: its input projection is hoisted into one GEMM and the
reference's ``lax.scan`` over time is a Python loop here, one fp32
recurrent GEMM per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.models import layers
from repro_torch.models.layers import Param

__all__ = [
    "chunked_linear_attention",
    "linear_attention_step",
    "mlstm_schema",
    "mlstm_block",
    "slstm_schema",
    "slstm_block",
    "mamba_schema",
    "mamba_mixer",
]

_F32 = prec.FP32


def chunked_linear_attention(q, k, v, log_g, *, chunk: int = 64,
                             state: Optional[torch.Tensor] = None,
                             backend: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, S, dv), final state (B, H, dk, dv)) of the chunked
    sweep; a thin wrapper over :func:`repro_torch.core.engine.linear_attention`."""
    return engine.linear_attention(q, k, v, log_g, chunk=chunk, state=state,
                                   backend=backend)


def linear_attention_step(state, q, k, v, log_g):
    """One decode step: S' = exp(g) S + k v^T; out = q @ S'."""
    state = (torch.exp(log_g.float())[..., None, None] * state
             + k.float()[..., :, None] * v.float()[..., None, :])
    out = engine.einsum2d("bhk,bhkv->bhv", q.float(), state, policy=_F32)
    return out, state


def _per_head_rmsnorm(x: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Group-norm over each head's channels; x (B, S, di), scale (di,)."""
    B, S, di = x.shape
    xh = x.reshape(B, S, H, di // H)
    xh = layers.rmsnorm(xh, torch.ones(di // H, dtype=x.dtype, device=x.device))
    return xh.reshape(B, S, di) * scale.to(x.dtype)


def _log_sigmoid_shifted(f: torch.Tensor) -> torch.Tensor:
    """log sigmoid(f + 3) <= 0, as the reference writes it."""
    return -F.softplus(-(f + 3.0))


# --------------------------------------------------------------------- #
# mLSTM block
# --------------------------------------------------------------------- #
def mlstm_schema(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    di = cfg.ssm.mlstm_proj_factor * d
    H = cfg.n_heads
    hd = di // H
    return {
        "w_up": Param((d, 2 * di), ("embed", "ff")),
        # block-diagonal per-head q/k/v: H independent hd -> 3hd projections
        "w_qkv": Param((H, hd, 3 * hd), (None, None, None)),
        "w_if": Param((di, 2 * H), (None, None)),
        "b_if": Param((2 * H,), (None,), init="zeros"),
        "norm": Param((di,), (None,), init="ones"),
        "w_down": Param((di, d), ("ff", "embed")),
    }


def mlstm_block(params, x, cfg, *, policy, state=None, shard=None):
    """x (B, S, d) -> (y (B, S, d), state (B, H, hd, hd)); ``state`` is
    carried across decode steps.  On a mesh (``shard``) ``w_up``'s fused
    ``[x | z]`` columns are cut (on two ranks: all of x on rank 0, all of
    z on rank 1): kernel 1 runs on the rank's block, the block is gathered
    whole, the per-head core and the state run replicated, and
    ``w_down`` is row-parallel."""
    if shard is not None:
        x = shard.enter(x)
    B, S, d = x.shape
    H = cfg.n_heads
    di = cfg.ssm.mlstm_proj_factor * d
    hd = di // H

    u = engine.matmul(x, params["w_up"], policy=policy)
    xin, z = layers.gather_cols(u, 2 * di, shard).chunk(2, dim=-1)
    xh = xin.reshape(B, S, H, hd).permute(2, 0, 1, 3).reshape(H, B * S, hd)
    qkv = engine.matmul(xh, params["w_qkv"], policy=policy)     # (H, B*S, 3hd)
    qkv = qkv.reshape(H, B, S, 3 * hd).permute(1, 0, 2, 3)
    q, k, v = qkv.chunk(3, dim=-1)                               # (B, H, S, hd)
    # the scale rounds to the activation dtype first, as JAX's weak-typed
    # scalar does
    q = q * torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)

    gates = (engine.matmul(xin, params["w_if"], policy=_F32)
             + params["b_if"].float())
    i_raw, f_raw = gates.chunk(2, dim=-1)                        # (B, S, H)
    log_f = _log_sigmoid_shifted(f_raw)
    i_gate = torch.sigmoid(i_raw)
    k = k * i_gate.permute(0, 2, 1)[..., None].to(k.dtype)
    log_g = log_f.permute(0, 2, 1)                               # (B, H, S)

    if S == 1 and state is not None:
        o, state = linear_attention_step(state, q[:, :, 0], k[:, :, 0],
                                         v[:, :, 0], log_g[:, :, 0])
        o = o[:, :, None]
    else:
        o, state = chunked_linear_attention(q, k, v, log_g,
                                            chunk=cfg.ssm.chunk, state=state)

    o = o.permute(0, 2, 1, 3).reshape(B, S, di).to(x.dtype)
    o = _per_head_rmsnorm(o, params["norm"], H)
    o = o * F.silu(z)
    return layers.row_parallel(o, params["w_down"], di, policy=policy,
                               shard=shard), state


# --------------------------------------------------------------------- #
# sLSTM block — sequential scalar recurrence
# --------------------------------------------------------------------- #
def slstm_schema(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    ff = cfg.ssm.slstm_ffn_dim(d)
    return {
        "w_gates": Param((d, 4 * d), ("embed", "ff")),
        "r_gates": Param((H, hd, 4 * hd), (None, None, None)),
        "b_gates": Param((4 * d,), (None,), init="zeros"),
        "norm": Param((d,), (None,), init="ones"),
        "ffn": {
            "w_in": Param((d, 2 * ff), ("embed", "ff")),
            "w_out": Param((ff, d), ("ff", "embed")),
        },
    }


def slstm_block(params, x, cfg, *, policy, state=None, shard=None):
    """x (B, S, d) -> (y, state); state is dict(c, n, h, m), each
    (B, H, hd) fp32.  On a mesh (``shard``) ``w_gates``' gate-major
    columns are cut (on two ranks: gates z, i on rank 0, f, o on rank 1):
    the input GEMM runs on the rank's block, the block is gathered whole,
    the time loop and the state run replicated, and the GLU is
    tensor-parallel."""
    if shard is not None:
        x = shard.enter(x)
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H

    wx = engine.matmul(x, params["w_gates"], policy=policy)     # one GEMM
    wx = layers.gather_cols(wx, 4 * d, shard).reshape(B, S, 4, H, hd).float()
    if state is None:
        zeros = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = {"c": zeros, "n": zeros, "h": zeros,
                 "m": torch.full((B, H, hd), -1e30, device=x.device)}
    b = params["b_gates"].float().reshape(4, H, hd)
    r = params["r_gates"].float()
    one = torch.ones((), device=x.device)

    st = state
    hs = []
    for t in range(S):      # the reference's lax.scan over time
        rec = engine.einsum2d("bhd,hde->bhe", st["h"], r,
                              policy=_F32).reshape(B, H, 4, hd)
        g = wx[:, t] + rec.transpose(1, 2) + b[None]
        z_t, i_t, f_t, o_t = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        log_f = _log_sigmoid_shifted(f_t)
        m_new = torch.maximum(log_f + st["m"], i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(log_f + st["m"] - m_new)
        c = f_p * st["c"] + i_p * torch.tanh(z_t)
        n = f_p * st["n"] + i_p
        h = torch.sigmoid(o_t) * c / torch.maximum(torch.abs(n), one)
        st = {"c": c, "n": n, "h": h, "m": m_new}
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    h = layers.rmsnorm(h, params["norm"])
    ffn = layers.mlp_glu(params["ffn"], h, act=cfg.act, policy=policy, shard=shard,
                         ff=cfg.ssm.slstm_ffn_dim(d))
    return (h if shard is None else shard.leave(h, partial=False)) + ffn, st


# --------------------------------------------------------------------- #
# Mamba2 / SSD mixer (hymba's SSM heads)
# --------------------------------------------------------------------- #
def mamba_schema(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    di = cfg.ssm.mamba_expand * d
    H, N = cfg.n_heads, cfg.ssm.state_dim
    return {
        "w_xz": Param((d, 2 * di), ("embed", "ff")),
        "w_bcdt": Param((d, 2 * N + H), ("embed", None)),
        "a_log": Param((H,), (None,), init="zeros"),
        "skip_d": Param((H,), (None,), init="ones"),
        "dt_bias": Param((H,), (None,), init="zeros"),
        "norm": Param((di,), (None,), init="ones"),
        "w_out": Param((di, d), ("ff", "embed")),
    }


def mamba_mixer(params, x, cfg, *, policy, state=None, shard=None):
    """SSD as linear attention: q = C, k = B (fp32, from the fp32 ``w_bcdt``
    GEMM, shared by the heads), v = dt·x (the compute dtype), decay
    ``exp(-exp(a_log)·dt)``.  x (B, S, d) -> (y (B, S, d), state (B, H, N,
    P) fp32).  On a mesh (``shard``) ``w_xz``'s fused ``[x | z]`` block
    is gathered whole after kernel 1, ``w_bcdt`` is whole, the SSD core
    and its state run replicated, and ``w_out`` is row-parallel."""
    if shard is not None:
        x = shard.enter(x)
    B_, S, d = x.shape
    H, N = cfg.n_heads, cfg.ssm.state_dim
    di = cfg.ssm.mamba_expand * d
    P = di // H

    xz = engine.matmul(x, params["w_xz"], policy=policy)
    xin, z = layers.gather_cols(xz, 2 * di, shard).chunk(2, dim=-1)
    bcdt = engine.matmul(x, params["w_bcdt"], policy=_F32)      # (B, S, 2N + H)
    bmat, cmat, dt = torch.split(bcdt, [N, N, H], dim=-1)
    dt = F.softplus(dt + params["dt_bias"].float())             # (B, S, H)
    a = -torch.exp(params["a_log"].float())
    log_g = (dt * a).permute(0, 2, 1)                           # (B, H, S) <= 0

    v = xin.reshape(B_, S, H, P).permute(0, 2, 1, 3)            # (B, H, S, P)
    v_in = v * dt.permute(0, 2, 1)[..., None].to(v.dtype)
    q = cmat[:, None].expand(B_, H, S, N)
    k = bmat[:, None].expand(B_, H, S, N)

    if S == 1 and state is not None:
        o, state = linear_attention_step(state, q[:, :, 0], k[:, :, 0],
                                         v_in[:, :, 0], log_g[:, :, 0])
        o = o[:, :, None]
    else:
        o, state = chunked_linear_attention(q, k, v_in, log_g,
                                            chunk=cfg.ssm.chunk, state=state)

    o = o + v.float() * params["skip_d"].float()[None, :, None, None]
    o = o.permute(0, 2, 1, 3).reshape(B_, S, di).to(x.dtype)
    o = _per_head_rmsnorm(o, params["norm"], H)
    o = o * F.silu(z)
    return layers.row_parallel(o, params["w_out"], di, policy=policy,
                               shard=shard), state
