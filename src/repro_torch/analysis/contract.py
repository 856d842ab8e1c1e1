"""The backend registry's contract as executable checks.

Counterpart of ``tests/test_backend_conformance.py``'s ``check_*`` and
``run_contract``: every registered backend is held to every contract its
capability flags declare.  The checks live in the package, not in the
tests, so ``chip_smoke.py`` runs them on CUDA tensors for ``"hopper"``
(the test file parametrises them on the CPU):

* **base** (every backend): ``fn(x, w, *, spec) -> (..., M, K)`` matches
  an fp32 oracle to the policy's tolerance, for weight and batched GEMMs;
* **fused_epilogue**: ``fn(..., bias=..., fuse_epilogue=True)`` adds the
  accumulator-dtype bias row and applies ``spec.epilogue`` before the
  store — bitwise the post-op path under ``paper_fp16`` for bias / relu;
* **layouts**: "nt" / "tn" dispatches on forward-storage operands equal
  the pre-transposed "nn" dispatch;
* **fused_bwd_epilogue**: ``fn(a, b, *, spec, deriv=..., bias_grad=True)``
  returns ``(grad, db)`` with the documented shapes and dtypes, ``act'``
  applied to dZ on load and ``db`` its row sum;
* **operand_dtypes**: FP8-stored operands (widened on load) give what the
  pre-widened compute-dtype operands give;
* **attention** (every backend: capable ones run their sweep kernels, the
  rest the engine's composition): ``engine.attention`` over {dense,
  causal, GQA with a ragged ``t_valid``} and ``engine.linear_attention``
  over {fresh, state carried in} match fp32 oracles.

The GEMM shapes are the reference's, off every tile multiple (M, N, K =
24, 33, 17; batch 3).  The attention shapes fit the card's kernels: head
size 64 (the flash kernel takes 64 and 128; the reference's check uses 8)
and chunk 16 with dk 16 (kernel 4's chunks are 16-128; the reference's
check uses 8 and 6).  Each check raises ``AssertionError`` naming the
backend and the violated clause.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec

__all__ = ["CONTRACT_CHECKS", "CONTRACTS", "run_contract", "check_base",
           "check_fused_epilogue", "check_layouts", "check_fused_bwd_epilogue",
           "check_operand_dtypes", "check_attention"]

# shapes deliberately off tile multiples so edge masking is part of the contract
M, N, K = 24, 33, 17
BATCH = 3
_TOL = {"float32": 1e-5, "float16": 2e-2, "bfloat16": 1e-1}


class _Draw:
    """Seeded normal draws (numpy), cast on ``device``."""

    def __init__(self, seed: int, device):
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def __call__(self, shape, dtype, scale: float = 0.3) -> torch.Tensor:
        a = torch.as_tensor(self.rng.normal(size=shape) * scale, dtype=torch.float32)
        return a.to(self.device).to(prec.as_dtype(dtype))


def _spec(policy, *, op="matmul", m=M, n=N, k=K, batch=1, layout="nn",
          epilogue=None, **kw) -> engine.GemmSpec:
    return engine.GemmSpec(op=op, tag="conformance", m=m, n=n, k=k, batch=batch,
                           policy=policy, epilogue=epilogue, layout=layout,
                           w_shared=(batch == 1), **kw)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, policy, *, what: str, backend: str) -> None:
    tol = _TOL[prec.dtype_name(policy.compute_dtype)]
    g, w = _f32(got), _f32(want)
    if g.shape != w.shape or not np.allclose(g, w, rtol=tol, atol=tol):
        err = (float(np.max(np.abs(g - w))) if g.shape == w.shape
               else f"shape {g.shape} vs {w.shape}")
        raise AssertionError(
            f"backend {backend!r} violates the {what} contract under policy "
            f"{policy.name!r}: max abs error {err} exceeds the documented "
            f"tolerance {tol} (see repro_torch.core.engine.BackendSpec)")


def check_base(backend: str, device="cpu") -> None:
    """fn(x, w, *, spec) matches the fp32 oracle (weight and batched GEMM)."""
    fn = engine.get_backend(backend).fn
    rand = _Draw(5, device)
    for policy in (prec.FP32, prec.PAPER_FP16, prec.TPU_FP16):
        x = rand((M, N), policy.compute_dtype)
        w = rand((N, K), policy.compute_dtype)
        z = fn(x, w, spec=_spec(policy))
        if tuple(z.shape) != (M, K):
            raise AssertionError(
                f"backend {backend!r} violates the base contract: output shape "
                f"{tuple(z.shape)} != {(M, K)} for x{tuple(x.shape)} @ "
                f"w{tuple(w.shape)}")
        _close(z, _f32(x) @ _f32(w), policy,
               what="base (weight GEMM vs FP32 oracle)", backend=backend)
        xb = rand((BATCH, M, N), policy.compute_dtype)
        wb = rand((BATCH, N, K), policy.compute_dtype)
        zb = fn(xb, wb, spec=_spec(policy, batch=BATCH))
        _close(zb, np.einsum("bmn,bnk->bmk", _f32(xb), _f32(wb)), policy,
               what="base (batched GEMM vs FP32 oracle)", backend=backend)


def check_fused_epilogue(backend: str, device="cpu") -> None:
    """Bias and activation applied to the accumulator before the store;
    bitwise the post-op path under paper_fp16 for bias / relu."""
    fn = engine.get_backend(backend).fn
    rand = _Draw(6, device)
    policy = prec.PAPER_FP16
    x = rand((M, N), policy.compute_dtype)
    w = rand((N, K), policy.compute_dtype)
    b = rand((K,), policy.accum_dtype, 0.1)
    for act in (None, "relu"):
        fused = fn(x, w, spec=_spec(policy, op="linear", epilogue=act), bias=b,
                   fuse_epilogue=True)
        plain = fn(x, w, spec=_spec(policy))
        post = plain.to(policy.accum_dtype) + b
        post = epi.apply_epilogue(act, post).to(policy.out_dtype)
        if not torch.equal(fused.to(policy.out_dtype), post):
            raise AssertionError(
                f"backend {backend!r} violates the fused_epilogue contract: "
                f"fuse_epilogue=True with epilogue={act!r} is not bitwise-equal "
                f"to the post-op path under paper_fp16 (the bias row is added "
                f"in the accum dtype before the single store)")


def check_layouts(backend: str, device="cpu") -> None:
    """"nt" / "tn" dispatches on forward-storage operands equal the
    pre-transposed "nn" dispatch."""
    fn = engine.get_backend(backend).fn
    rand = _Draw(7, device)
    for policy in (prec.FP32, prec.PAPER_FP16):
        x = rand((M, N), policy.compute_dtype)
        w = rand((N, K), policy.compute_dtype)
        want = fn(x, w, spec=_spec(policy))
        znt = fn(x, w.t().contiguous(), spec=_spec(policy, layout="nt"))
        _close(znt, want, policy, what='layouts ("nt" vs pre-transposed "nn")',
               backend=backend)
        ztn = fn(x.t().contiguous(), w, spec=_spec(policy, layout="tn"))
        _close(ztn, want, policy, what='layouts ("tn" vs pre-transposed "nn")',
               backend=backend)


def check_fused_bwd_epilogue(backend: str, device="cpu") -> None:
    """(grad, db) shapes and dtypes and values: act' applied to dZ on load,
    db the accumulator-dtype row sum of the scaled dZ."""
    fn = engine.get_backend(backend).fn
    rand = _Draw(8, device)
    policy = prec.FP32
    # the dW ("tn") dispatch: a = X stored (rows, n_features), b = dZ
    # (rows, k), deriv stored like dZ
    xs = rand((M, N), policy.compute_dtype)
    dz = rand((M, K), policy.compute_dtype)
    d = rand((M, K), policy.compute_dtype)
    spec = _spec(policy, op="matmul_dw", m=N, n=M, k=K, layout="tn",
                 grad_epilogue="tanh", grad_mode="output", fused_bwd=True,
                 fused_bias_grad=True)
    out = fn(xs, dz, spec=spec, deriv=d, bias_grad=True)
    if not (isinstance(out, tuple) and len(out) == 2):
        raise AssertionError(
            f"backend {backend!r} violates the fused_bwd_epilogue contract: "
            f"bias_grad=True must return (grad, db), got {type(out).__name__}")
    dw, db = out
    ds = _f32(dz) * _f32(epi.epilogue_grad("tanh").deriv_from_output(d))
    if tuple(dw.shape) != (N, K) or tuple(db.shape) != (K,):
        raise AssertionError(
            f"backend {backend!r} violates the fused_bwd_epilogue contract: "
            f"shapes (grad, db) = ({tuple(dw.shape)}, {tuple(db.shape)}), want "
            f"(({N}, {K}), ({K},))")
    if db.dtype != policy.accum_dtype:
        raise AssertionError(
            f"backend {backend!r} violates the fused_bwd_epilogue contract: db "
            f"dtype {db.dtype} is not the accum dtype {policy.accum_dtype}")
    _close(dw, _f32(xs).T @ ds, policy, what="fused_bwd_epilogue (act' on dZ load)",
           backend=backend)
    _close(db, ds.sum(axis=0), policy, what="fused_bwd_epilogue (fused db row sum)",
           backend=backend)


def check_operand_dtypes(backend: str, device="cpu") -> None:
    """FP8-stored operands (widened on load) == the pre-widened dispatch."""
    fn = engine.get_backend(backend).fn
    rand = _Draw(9, device)
    policy = prec.MIXED_FP8_E4M3
    xq = rand((M, N), torch.float8_e4m3fn)
    wq = rand((N, K), torch.float8_e4m3fn)
    narrow = fn(xq, wq, spec=_spec(policy, x_dtype="float8_e4m3fn",
                                   w_dtype="float8_e4m3fn", scaled=True))
    wide = fn(xq.to(policy.compute_dtype), wq.to(policy.compute_dtype),
              spec=_spec(policy))
    if not np.allclose(_f32(narrow), _f32(wide), rtol=1e-3, atol=1e-3):
        err = float(np.max(np.abs(_f32(narrow) - _f32(wide))))
        raise AssertionError(
            f"backend {backend!r} violates the operand_dtypes contract: FP8 "
            f"storage dispatched directly differs from widening before the "
            f"dispatch by {err:.4g} — the kernel must widen tiles to the "
            f"compute dtype on load, changing bytes, not values")


def _attention_oracle(q, k, v, *, group, causal, scale, t_valid):
    """fp32 numpy oracle: K / V per q head, dense softmax, fully masked
    rows exact zeros (the engine's contract)."""
    qf, kf, vf = _f32(q), _f32(k), _f32(v)
    S, T = qf.shape[2], kf.shape[2]
    kr, vr = np.repeat(kf, group, axis=1), np.repeat(vf, group, axis=1)
    s = np.einsum("bhsd,bhtd->bhst", qf, kr) * scale
    mask = np.arange(T)[None, :] < t_valid
    if causal:
        mask = mask & (np.arange(T)[None, :] <= np.arange(S)[:, None])
    else:
        mask = np.broadcast_to(mask, (S, T))
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    p = np.where(mask.any(axis=-1)[..., None], p, 0.0)
    return np.einsum("bhst,bhtd->bhsd", p, vr)


def _linear_attention_oracle(q, k, v, log_g, state=None):
    """fp32 numpy oracle: S_t = exp(g_t) S_{t-1} + k_t v_t^T,
    out_t = q_t S_t, token by token."""
    qf, kf, vf, gf = _f32(q), _f32(k), _f32(v), _f32(log_g)
    B, H, S, dk = qf.shape
    dv = vf.shape[-1]
    st = np.zeros((B, H, dk, dv), np.float32) if state is None else _f32(state)
    outs = []
    for t in range(S):
        st = (np.exp(gf[:, :, t])[..., None, None] * st
              + np.einsum("bhk,bhv->bhkv", kf[:, :, t], vf[:, :, t]))
        outs.append(np.einsum("bhk,bhkv->bhv", qf[:, :, t], st))
    return np.stack(outs, axis=2), st


def check_attention(backend: str, device="cpu") -> None:
    """engine.attention / engine.linear_attention on this backend match the
    fp32 oracles for {dense, causal, GQA, chunked state}."""
    policy = prec.FP32
    rand = _Draw(11, device)
    B, Hkv, S, T, D = 2, 2, 19, 26, 64
    k = rand((B, Hkv, T, D), torch.float32)
    v = rand((B, Hkv, T, D), torch.float32)
    for what, group, causal, t_valid in (
            ("attention (dense)", 1, False, T),
            ("attention (causal)", 1, True, T),
            ("attention (GQA, causal, ragged t_valid)", 3, True, T - 5)):
        q = rand((B, Hkv * group, S, D), torch.float32)
        got = engine.attention(q, k, v, causal=causal, t_valid=t_valid,
                               policy=policy, backend=backend)
        want = _attention_oracle(q, k, v, group=group, causal=causal,
                                 scale=D ** -0.5, t_valid=t_valid)
        _close(got, want, policy, what=what, backend=backend)

    H, dk, dv, Sl, chunk = 2, 16, 10, 23, 16
    q2, k2 = rand((B, H, Sl, dk), torch.float32), rand((B, H, Sl, dk), torch.float32)
    v2 = rand((B, H, Sl, dv), torch.float32)
    g2 = -rand((B, H, Sl), torch.float32).abs() * 0.3
    for label, state0 in (("", None), (" carry-in", rand((B, H, dk, dv), torch.float32))):
        want_o, want_s = _linear_attention_oracle(q2, k2, v2, g2, state=state0)
        got_o, got_s = engine.linear_attention(q2, k2, v2, g2, chunk=chunk,
                                               state=state0, backend=backend)
        _close(got_o, want_o, policy, what=f"attention (linear, chunked sweep{label})",
               backend=backend)
        _close(got_s, want_s, policy, what=f"attention (linear, final state{label})",
               backend=backend)


CONTRACT_CHECKS = {
    "base": check_base,
    "fused_epilogue": check_fused_epilogue,
    "layouts": check_layouts,
    "fused_bwd_epilogue": check_fused_bwd_epilogue,
    "operand_dtypes": check_operand_dtypes,
    "attention": check_attention,
}
# "tiled" has no value contract of its own: it promises that spec.tile is
# the launch geometry, which the base check exercises with real tiles
CONTRACTS = tuple(CONTRACT_CHECKS)


def run_contract(backend: str, contract: str, device: Optional[str] = None) -> None:
    """Run one contract check against one backend on ``device`` (default
    the CPU); raises ``AssertionError`` naming the violated clause."""
    CONTRACT_CHECKS[contract](backend, device or "cpu")
