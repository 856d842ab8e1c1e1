"""The port's FP8 storage path (``mixed_fp8_e4m3`` / ``mixed_fp8_e5m2``)
against the JAX package.

The same numpy inputs go through both packages; FP8 arrays cross as
``uint8`` views.  Kernel-level tests hold the port's plain versions of
kernels 1 and 2 against the reference's Pallas kernels in interpret mode;
engine-level tests hold the port's ``matmul`` / ``linear`` (forward, grads,
events) against the reference engine on its ``interpret`` backend, which
declares ``operand_dtypes`` as the port's ``hopper`` does.  The
AutoEncoder and the serving tests run the reference on its ``xla``
backend, which also declares ``operand_dtypes``; at these sizes every
reduction fits one rounding block, where it computes what its Pallas
kernel computes.

Tolerances, each relative to the largest reference magnitude: a faithful
fp16 accumulator one fp16 ulp (2^-10) per rounding block, an fp16 store
after fp32 accumulation 2^-9, an fp32 store 1e-5 (summation order only);
the engine's FP8 ops 2e-2 (the reference's own
``test_fp8_linear_grads_interpret_vs_xla``); the AutoEncoder's gradients
twice the reference's own spread over renumbered hidden units, as in
``tests/test_torch_ae.py``; serving logits 2^-3, one E4M3 step at the top
of the range (an fp16 rounding flip upstream of a quantization moves that
element by one E4M3 step).
"""

import collections
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import engine as je
from repro.core import precision as jprec
from repro.core import tiling as jtiling
from repro.data import SyntheticAE as JSyntheticAE
from repro.kernels import ops as jops
from repro.models import autoencoder as jae
from repro.models import transformer as jt
from repro.optim import AdamW as JAdamW
from repro.optim import clip_by_global_norm as jclip
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.convert import ae_params_from_jax
from repro_torch.core import engine as te
from repro_torch.core import precision as tprec
from repro_torch.core import tiling as ttiling
from repro_torch.data import SyntheticAE
from repro_torch.kernels import ops as tops
from repro_torch.kernels import redmule_matmul as trm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import autoencoder as tae
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamW, OptState, tree_leaves

BASELINES = Path(__file__).resolve().parent.parent / "benchmarks" / "baselines"
FMTS = ("float8_e4m3fn", "float8_e5m2")
FP8_POLICIES = ("mixed_fp8_e4m3", "mixed_fp8_e5m2")
ULP = 2.0 ** -10


def _close(got: torch.Tensor, want, tol_rel: float) -> float:
    g = got.float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= tol_rel * max(np.abs(w).max(), 1e-6), (err, np.abs(w).max())
    return err


def _fp8(a: np.ndarray, fmt: str):
    """``a`` quantized per tensor by the reference, in both packages."""
    q, _ = jprec.quantize_fp8(jnp.asarray(a, jnp.float32), getattr(jnp, fmt))
    t = torch.from_numpy(np.asarray(q).view(np.uint8).copy()).view(getattr(torch, fmt))
    return q, t


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _grad_pol(name: str):
    jp, tp = jprec.resolve(name), tprec.resolve(name)
    return (dataclasses.replace(jp, name=jp.name + "+grad", output_dtype=jp.accum_dtype),
            dataclasses.replace(tp, name=tp.name + "+grad", output_dtype=tp.accum_dtype))


# --------------------------------------------------------------------- #
# precision: quantize / dequantize / fp8_max
# --------------------------------------------------------------------- #
def _grid(fmt: str) -> np.ndarray:
    """Every finite value of the format in [-1, 1]."""
    v = np.arange(256, dtype=np.uint8).view(getattr(jnp, fmt)).astype(np.float32)
    return np.unique(v[np.isfinite(v) & (np.abs(v) <= 1)])


def _quant_cases(fmt: str):
    rng = np.random.default_rng(FMTS.index(fmt))
    g = _grid(fmt)
    tiny = float(g[g > 0].min())                      # the smallest subnormal
    return {
        "normal": (rng.standard_normal((33, 17)) * 3).astype(np.float32),
        # exact midpoints between neighbours: round half to even
        "ties": np.concatenate([[1.0], (g[1:] + g[:-1]) / 2]).astype(np.float32),
        "subnormals": np.concatenate(
            [[1.0], np.arange(-40, 41) * tiny / 4]).astype(np.float32),
        "zeros": np.zeros((4, 5), np.float32),
        "inf": np.array([1.0, np.inf, -2.0, -np.inf], np.float32),
        "nan": np.array([1.0, np.nan, -2.0, -np.nan, 0.5], np.float32),
    }


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_fp8_bitwise_matches_reference(fmt):
    """Bit for bit, FP8 values and scales: RNE ties, subnormals, an all-zero
    tensor (scale 1), non-finite inputs (scale 1; E4M3 has no infinity,
    so XLA stores NaN where PyTorch would saturate), and an explicit
    scale that pushes values past the format's range."""
    cases = _quant_cases(fmt)
    cases["explicit scale"] = cases["normal"]
    for name, a in cases.items():
        scale = 0.004 if name == "explicit scale" else None
        jq, js = jprec.quantize_fp8(jnp.asarray(a), getattr(jnp, fmt),
                                    None if scale is None else jnp.float32(scale))
        tq, ts = tprec.quantize_fp8(torch.from_numpy(a), getattr(torch, fmt),
                                    None if scale is None else torch.tensor(scale))
        assert tq.dtype == getattr(torch, fmt) and ts.dtype == torch.float32
        assert np.array_equal(_bits(tq), _bits(jq)), name
        assert np.float32(ts) == np.float32(js), name
        # dequantized: equal values (NaN payloads of the fp16 store may differ)
        np.testing.assert_array_equal(
            tprec.dequantize_fp8(tq, ts, torch.float16).numpy(),
            np.asarray(jprec.dequantize_fp8(jq, js, jnp.float16)), err_msg=name)


def test_fp8_max_matches_reference():
    assert tprec.fp8_max(torch.float8_e4m3fn) == jprec.fp8_max(jnp.float8_e4m3fn) == 448
    assert tprec.fp8_max("float8_e5m2") == jprec.fp8_max(jnp.float8_e5m2) == 57344


# --------------------------------------------------------------------- #
# tiling: the rounding block at the operands' storage widths
# --------------------------------------------------------------------- #
def test_accum_block_follows_reference_tiles_per_storage():
    shapes = ((512, 4096, 512), (16, 640, 128), (640, 4096, 128), (128, 6144, 2048),
              (4, 2048, 151936), (144, 128, 2), (2048, 4096, 4096), (8, 8, 8))
    stores = ((None, None), ("float8_e4m3fn", "float8_e4m3fn"),
              ("float8_e5m2", "float8_e4m3fn"), ("float8_e4m3fn", "float8_e5m2"))
    for (M, N, K) in shapes:
        for xs, ws in stores:
            for fused in (False, True):
                for acc in ("float16", "float32"):
                    want = jtiling.choose_tiles(
                        M, N, K, compute_dtype=jnp.float16, accum_dtype=getattr(jnp, acc),
                        fused_bwd=fused, x_dtype=xs, w_dtype=ws)
                    got = ttiling.reference_tiles(
                        M, N, K, compute_dtype=torch.float16,
                        accum_dtype=getattr(torch, acc), fused_bwd=fused,
                        x_dtype=xs, w_dtype=ws)
                    assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk)
    kw = dict(compute_dtype=torch.float16, accum_dtype=torch.float16)
    assert ttiling.accum_block(512, 4096, 512, **kw) == 1024
    assert ttiling.accum_block(512, 4096, 512, x_dtype=torch.float8_e4m3fn,
                               w_dtype=torch.float8_e4m3fn, **kw) == 2048
    assert ttiling.accum_block(512, 4096, 512, x_dtype="float8_e5m2",
                               w_dtype="float8_e4m3fn", **kw) == 2048


def test_engine_stamps_the_fp8_rounding_block():
    """A qkv prefill projection of 512 prompt rows into K = 4096 under
    mixed_fp8_e4m3 rounds every 2048 rows, as the reference's E4M3 tile
    does, not every 1024 as fp16 operands would."""
    x, w = torch.zeros(512, 512), torch.zeros(512, 4096)
    with te.instrument() as ev:
        te.matmul(x, w, policy="mixed_fp8_e4m3")
    with te.instrument() as ev16:
        te.matmul(x, w, policy="paper_fp16")
    (e,), (e16,) = ev, ev16
    assert (e.spec.m, e.spec.n, e.spec.k) == (512, 512, 4096)
    want = jtiling.choose_tiles(512, 512, 4096, compute_dtype=jnp.float16,
                                accum_dtype=jnp.float16, x_dtype="float8_e4m3fn",
                                w_dtype="float8_e4m3fn")
    assert e.spec.accum_block == want.bn
    x, w = torch.zeros(512, 4096), torch.zeros(4096, 512)
    with te.instrument() as ev:
        te.matmul(x, w, policy="mixed_fp8_e4m3")
    with te.instrument() as ev16:
        te.matmul(x, w, policy="paper_fp16")
    assert (ev[0].spec.accum_block, ev16[0].spec.accum_block) == (2048, 1024)


# --------------------------------------------------------------------- #
# kernels 1 and 2: the plain versions on FP8 operands
# --------------------------------------------------------------------- #
# (policy, layout, x storage, w storage, "+grad"): the dispatches the two
# policies make — forward "nn" E4M3 x E4M3, dX "nt" E5M2 dZ x E4M3 W, dW
# "tn" E4M3 X x E5M2 dZ; E5M2 everywhere under mixed_fp8_e5m2
_PAIRS = (("mixed_fp8_e4m3", "nn", FMTS[0], FMTS[0], False),
          ("mixed_fp8_e4m3", "nt", FMTS[1], FMTS[0], True),
          ("mixed_fp8_e4m3", "tn", FMTS[0], FMTS[1], True),
          ("mixed_fp8_e5m2", "nn", FMTS[1], FMTS[1], False),
          ("mixed_fp8_e5m2", "nt", FMTS[1], FMTS[1], True),
          ("mixed_fp8_e5m2", "tn", FMTS[1], FMTS[1], True))


def _tol(tp: tprec.Policy, n_blocks: int = 1) -> float:
    if tp.blockwise_accum:
        return (n_blocks + 1) * ULP
    return 1e-5 if tp.out_dtype == torch.float32 else 2.0 ** -9


@pytest.mark.parametrize("case", _PAIRS, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("shape", ((24, 33, 17), (8, 2304, 16)),
                         ids=("ragged", "two-blocks"))
def test_plain_fp8_gemm_matches_interpret_kernel(case, shape):
    """Ragged (24, 33, 17) as the reference's pipeline-depth test, and a
    reduction over two of the reference's 2048-row blocks."""
    policy, layout, xs, ws, grad = case
    M, N, K = shape
    rng = np.random.default_rng([M, _PAIRS.index(case)])
    x = rng.standard_normal((N, M) if layout == "tn" else (M, N))
    w = rng.standard_normal((K, N) if layout == "nt" else (N, K))
    (jx, tx), (jw, tw) = _fp8(x, xs), _fp8(w, ws)
    jp, tp = _grad_pol(policy) if grad else (jprec.resolve(policy), tprec.resolve(policy))
    want = jops.redmule_matmul(jx, jw, policy=jp, layout=layout, interpret=True)
    got = tops.redmule_matmul(tx, tw, policy=tp, layout=layout)
    assert got.dtype == tp.out_dtype
    _close(got, want, _tol(tp, -(-N // 2048)))
    # the operand_dtypes contract: narrow storage == widened before dispatch
    wide = tops.redmule_matmul(tx.half(), tw.half(), policy=tp, layout=layout,
                               accum_block=(ttiling.accum_block(
                                   M, N, K, compute_dtype=torch.float16,
                                   accum_dtype=tp.accum_dtype, x_dtype=tx.dtype,
                                   w_dtype=tw.dtype) if tp.blockwise_accum else None))
    torch.testing.assert_close(got, wide, rtol=1e-3, atol=1e-3)


def test_plain_fp8_batched_broadcast_and_scores():
    """Kernel 2 as decode runs it under mixed_fp8_e4m3: the scores through
    the ``*_scores`` policy (fp16 accumulator, fp32 store) and PV with V
    broadcast over the query heads of its KV head."""
    rng = np.random.default_rng(5)
    B, Hkv, G, T, hd = 2, 2, 3, 20, 16
    jsp = dataclasses.replace(jprec.MIXED_FP8_E4M3, name="mixed_fp8_e4m3_scores",
                              output_dtype=jnp.float32, faithful_accum=False)
    tsp = dataclasses.replace(tprec.MIXED_FP8_E4M3, name="mixed_fp8_e4m3_scores",
                              output_dtype=torch.float32, faithful_accum=False)
    (jk, tk), (jq, tq) = (_fp8(rng.standard_normal((B * Hkv, T, hd)), FMTS[0]),
                          _fp8(rng.standard_normal((B * Hkv, hd, G)), FMTS[0]))
    want = jops.redmule_matmul_batched(jk, jq, policy=jsp, interpret=True)
    got = tops.redmule_matmul_batched(tk, tq, policy=tsp)
    assert got.dtype == torch.float32
    _close(got, want, 2 * ULP)
    # every score is an fp16 value: the accumulator is fp16, the store fp32
    assert torch.equal(got, got.half().float())
    (jp_, tp_), (jv, tv) = (_fp8(rng.random((B, Hkv, G, 1, T)), FMTS[0]),
                            _fp8(rng.standard_normal((B, Hkv, 1, T, hd)), FMTS[0]))
    got = tops.redmule_matmul_batched(tp_, tv, policy=tprec.MIXED_FP8_E4M3)
    want = jops.redmule_matmul_batched(
        jp_.reshape(B * Hkv * G, 1, T),
        jnp.broadcast_to(jv, (B, Hkv, G, T, hd)).reshape(B * Hkv * G, T, hd),
        policy=jprec.MIXED_FP8_E4M3, interpret=True).reshape(B, Hkv, G, 1, hd)
    _close(got, want, 2 * ULP)


@pytest.mark.parametrize("layout,act,from_output",
                         (("nt", "relu", True), ("tn", "relu", False),
                          ("nt", "gelu", False), ("tn", "tanh", True)))
def test_plain_fp8_dz_fused_bwd_matches_interpret_kernel(layout, act, from_output):
    """An E5M2 dZ stream widened, scaled by act'(deriv) on load (the
    reference kernel's composition of upcast and fused backward), and on
    "tn" the bias gradient in the same pass."""
    rng = np.random.default_rng([6, layout == "tn", act == "gelu"])
    M, N, K = (13, 300, 21) if layout == "tn" else (13, 21, 300)
    x = rng.standard_normal((N, M) if layout == "tn" else (M, N))
    w = rng.standard_normal((K, N) if layout == "nt" else (N, K))
    if layout == "nt":
        (jx, tx), (jw, tw) = _fp8(x, FMTS[1]), _fp8(w, FMTS[0])
    else:
        (jx, tx), (jw, tw) = _fp8(x, FMTS[0]), _fp8(w, FMTS[1])
    d = rng.standard_normal(x.shape if layout == "nt" else w.shape)
    if from_output:
        d = np.tanh(d) if act == "tanh" else np.maximum(d, 0)
    jd, td = jnp.asarray(d, jnp.float16), torch.from_numpy(d).half()
    jp, tp = _grad_pol("mixed_fp8_e4m3")
    kw = dict(layout=layout, grad_epilogue=act, grad_from_output=from_output,
              bias_grad=layout == "tn")
    want = jops.redmule_matmul(jx, jw, policy=jp, deriv=jd, interpret=True, **kw)
    got = tops.redmule_matmul(tx, tw, policy=tp, deriv=td, **kw)
    want, got = (want, got) if layout == "tn" else ((want,), (got,))
    tol = 2e-2 if act == "gelu" else 3 * ULP
    for g, w_ in zip(got, want):
        _close(g, w_, tol)


def test_fp8_operand_rules():
    x = torch.ones(4, 8).to(torch.float8_e4m3fn)
    # FP8 widens to an fp16 compute dtype only
    with pytest.raises(NotImplementedError, match="fp16 compute"):
        tops.redmule_matmul(x, x.t(), policy=tprec.FP32)
    with pytest.raises(NotImplementedError, match="fp16 compute"):
        tops.redmule_matmul_batched(x[None], x.t()[None], policy=tprec.TPU_BF16)
    # the compiled pairs are exactly the two policies' dispatches
    E4, E5 = torch.float8_e4m3fn, torch.float8_e5m2
    assert (E4, E4, torch.float16, True) in trm.FP8_KERNELS
    assert (E4, E4, torch.float32, True) in trm.FP8_KERNELS       # decode scores
    assert (E5, E5, torch.float32, False) in trm.FP8_KERNELS
    assert (E5, E5, torch.float16, True) not in trm.FP8_KERNELS
    assert (E4, E4, torch.float16, False) not in trm.FP8_KERNELS
    # the 16-byte load rule counts 16 FP8 elements per run
    t = torch.zeros(64, 128, dtype=E4)
    assert trm._vec_ok(t, (0, 0), 128, 1, 64, 128) == 1
    assert trm._vec_ok(t, (0, 0), 128, 1, 64, 120) == 0
    assert trm._vec_ok(t, (0, 8), 128, 1, 64, 128) == 0
    assert trm._vec_ok(t, (0, 0), 1, 2048, 2048, 64) == 1
    assert trm._vec_ok(t, (0, 0), 1, 40, 40, 64) == 0


# --------------------------------------------------------------------- #
# the engine under the FP8 policies, against the reference's interpret
# --------------------------------------------------------------------- #
ACTS = (None, "tanh", "gelu", "relu")


def _ref_linear(policy, act, x, w, b, r, backend="interpret"):
    def f(x_, w_, b_):
        if b_ is None:
            y = je.matmul(x_, w_, policy=policy, backend=backend)
        else:
            y = je.linear(x_, w_, b_, activation=act, policy=policy, backend=backend)
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, y), g = jax.value_and_grad(f, argnums=(0, 1, 2) if b is not None else (0, 1),
                                   has_aux=True)(x, w, b)
    return y, g


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("policy", FP8_POLICIES)
def test_fp8_linear_and_grads_match_reference(policy, act):
    rng = np.random.default_rng([FP8_POLICIES.index(policy), ACTS.index(act)])
    x = rng.standard_normal((2, 12, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    r = rng.standard_normal((2, 12, 24)).astype(np.float32)
    jy, jg = _ref_linear(policy, act, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         jnp.asarray(r))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    ty = te.linear(tx, tw, tb, activation=act, policy=policy)
    (ty.float() * torch.from_numpy(r)).sum().backward()
    assert ty.dtype == torch.float16
    _close(ty.detach(), jy, 2e-2)
    for got, want in zip((tx.grad, tw.grad, tb.grad), jg):
        _close(got, want, 2e-2)


@pytest.mark.parametrize("policy", FP8_POLICIES)
def test_fp8_matmul_grads_match_reference(policy):
    rng = np.random.default_rng(FP8_POLICIES.index(policy) + 10)
    x = rng.standard_normal((3, 10, 48)).astype(np.float32)
    w = rng.standard_normal((48, 20)).astype(np.float32)
    r = rng.standard_normal((3, 10, 20)).astype(np.float32)
    jy, jg = _ref_linear(policy, None, jnp.asarray(x), jnp.asarray(w), None,
                         jnp.asarray(r))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    ty = te.matmul(tx, tw, policy=policy)
    (ty.float() * torch.from_numpy(r)).sum().backward()
    _close(ty.detach(), jy, 2e-2)
    _close(tx.grad, jg[0], 2e-2)
    _close(tw.grad, jg[1], 2e-2)


def _key(e, scoped=False):
    s = e.spec
    op = s.op if scoped else s.op.split("/")[-1]
    return (op, s.layout, s.m, s.n, s.k, s.batch, s.x_dtype, s.w_dtype, s.scaled,
            s.bytes, s.flops)


def test_fp8_linear_events_match_reference():
    """Per-slot storage on every event (the forward's, E5M2 for dZ in the
    x slot of dX and the w slot of dW), the post-op pass beside its GEMM,
    the bias gradient's pass, and under a remat region the post-op pass
    classified like its GEMM."""
    x, w, b = np.ones((16, 40), np.float32), np.ones((40, 24), np.float32), np.ones(24, np.float32)
    r = np.ones((16, 24), np.float32)
    with je.instrument() as jev:
        _ref_linear("mixed_fp8_e4m3", "gelu", jnp.asarray(x), jnp.asarray(w),
                    jnp.asarray(b), jnp.asarray(r))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    with te.instrument() as tev:
        y = te.linear(tx, tw, tb, activation="gelu", policy="mixed_fp8_e4m3")
        (y.float() * torch.from_numpy(r)).sum().backward()
    assert collections.Counter(map(_key, tev)) == collections.Counter(map(_key, jev))
    ops = {e.spec.op: e.spec for e in tev}
    assert set(ops) == {"linear", "linear_postep", "linear_dact", "linear_dbias",
                        "matmul_dx", "matmul_dw"}
    assert (ops["matmul_dx"].x_dtype, ops["matmul_dx"].w_dtype) == ("float8_e5m2",
                                                                   "float8_e4m3fn")
    assert (ops["matmul_dw"].x_dtype, ops["matmul_dw"].w_dtype) == ("float8_e4m3fn",
                                                                   "float8_e5m2")
    assert te.is_pass_op("linear_postep") and not te.is_backward_op("linear_postep")
    assert ops["linear_postep"].flops == 0
    # under a remat region the recomputed forward's post-op pass is tagged
    # like its GEMM event
    tx.grad = tw.grad = tb.grad = None
    with te.instrument() as rev:
        y = te.checkpoint(lambda a: te.linear(a, tw, tb, activation="relu",
                                              policy="mixed_fp8_e4m3"), tx)
        y.float().sum().backward()
    fwd = [(e.spec.op, e.recompute) for e in rev if e.spec.op.startswith("linear")
           and not e.spec.op.endswith(("_dact", "_dbias"))]
    assert fwd == [("linear", False), ("linear_postep", False),
                   ("linear", True), ("linear_postep", True)]


def test_scale_multiply_runs_in_fp32():
    """The reference undoes the scales as ``dw.astype(accum) * s`` with a
    strongly typed fp32 scale, which JAX computes in fp32 even for an fp16
    accumulator; PyTorch would keep a 0-d fp32 tensor's product in fp16.
    Scales fp16 cannot hold (amax 3.0001, -2.7183) and fp32 primal weights
    show it in dW: bit-equal to the reference, and not all fp16 values."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    x[0, 0] = 3.0001
    w = rng.standard_normal((4, 5)).astype(np.float32)
    w[0, 0] = -2.7183
    r = rng.standard_normal((6, 5)).astype(np.float32)
    jy, (jdx, jdw) = _ref_linear("mixed_fp8_e4m3", None, jnp.asarray(x),
                                 jnp.asarray(w), None, jnp.asarray(r))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    ty = te.matmul(tx, tw, policy="mixed_fp8_e4m3")
    (ty.float() * torch.from_numpy(r)).sum().backward()
    # few products of FP8 values sum exactly: every result is bit-equal
    assert np.array_equal(ty.detach().view(torch.int16).numpy(),
                          np.asarray(jy).view(np.int16))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
        # an fp16 multiply would leave only fp16 values
        assert not torch.equal(got, got.half().float())


# --------------------------------------------------------------------- #
# the AutoEncoder under the FP8 policies
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ae_ref_params():
    return jae.init_ae(jax.random.PRNGKey(0))


def _port_params(tree):
    p = ae_params_from_jax(jax.device_get(tree), device="cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    return p


def test_ae_fp8_train_events_reproduce_the_pins(ae_ref_params):
    """One AE train step at batch 16 under mixed_fp8_e4m3: the reference's
    events one for one (per-slot storage dtypes included) and the
    ``ae_train_fp8`` byte and flop pins, exactly."""
    pin = json.loads((BASELINES / "train_bytes.json").read_text())["ae_train_fp8"]
    x = JSyntheticAE(batch=16).sample(0)
    with je.instrument() as jev:
        jax.eval_shape(lambda p: jax.value_and_grad(lambda q: jae.ae_loss(
            q, jnp.asarray(x), policy=jprec.MIXED_FP8_E4M3, backend="interpret")[0])(p),
            ae_ref_params)

    def port_trace(policy):
        params = _port_params(ae_ref_params)
        with te.instrument() as ev:
            loss, _ = tae.ae_loss(params, torch.from_numpy(x), policy=policy)
            torch.autograd.grad(loss, tree_leaves(params))
        return ev

    tev = port_trace(tprec.MIXED_FP8_E4M3)
    assert collections.Counter(map(_key, tev)) == collections.Counter(map(_key, jev))
    split = {"fwd": 0, "bwd": 0}
    for e in tev:
        split["bwd" if te.is_backward_op(e.spec.op) else "fwd"] += e.total_bytes
    got = {"fwd": split["fwd"], "bwd": split["bwd"], "total": sum(split.values()),
           "fp16_total": te.total_bytes(port_trace(tprec.PAPER_FP16)),
           "engine_flops": te.total_flops(tev)}
    assert got == pin == {"fwd": 454_800, "bwd": 983_184, "total": 1_437_984,
                          "fp16_total": 1_909_520, "engine_flops": 25_362_432}
    gemms = [e for e in tev if not te.is_pass_op(e.spec.op)]
    assert len(gemms) == 30 and all(e.spec.scaled for e in gemms)
    # every dispatch the path makes is one the CUDA kernel is compiled for
    for pol in FP8_POLICIES:
        for e in port_trace(tprec.resolve(pol)):
            if not te.is_pass_op(e.spec.op):
                s = e.spec
                ext = s.accum_block is not None or s.fused_bwd or s.fused_bias_grad
                assert (getattr(torch, s.x_dtype), getattr(torch, s.w_dtype),
                        s.policy.out_dtype, bool(ext)) in trm.FP8_KERNELS, s


def _relabeled(params, seed: int):
    """The same AutoEncoder with its hidden units renumbered (and layer 0's
    input features): the same function, other summation orders.  Returns
    the tree, the input-column order and the map of gradients back."""
    rng = np.random.default_rng(seed)
    dims = tae.AE_DIMS
    perms = ([rng.permutation(640)] + [rng.permutation(d) for d in dims[1:-1]]
             + [np.arange(640)])

    def apply(tree, inverse=False):
        out = {}
        for i in range(len(dims) - 1):
            pi, po = perms[i], perms[i + 1]
            if inverse:
                pi, po = np.argsort(pi), np.argsort(po)
            out[f"fc{i}"] = {k: (np.asarray(v)[pi][:, po] if k == "w" else np.asarray(v)[po])
                             for k, v in tree[f"fc{i}"].items()}
        return out

    return jax.tree.map(jnp.asarray, apply(params)), perms[0], \
        lambda g: apply(g, inverse=True)


@pytest.mark.parametrize("policy", FP8_POLICIES)
def test_ae_fp8_grads_and_adamw_step_match_reference(ae_ref_params, policy):
    """At shared parameters (the reference's, then after 3 of its steps):
    the loss within 1e-3, the gradients within twice the reference's own
    spread over four renumberings of the hidden units (at least 2e-2 of
    max |g|, at most 0.2), and the port's AdamW step equal to the
    reference optimizer fed the port's gradients (1e-6)."""
    jpol, tpol = jprec.resolve(policy), tprec.resolve(policy)
    ds = SyntheticAE(batch=16)
    jopt = JAdamW(lr=3e-3, warmup_steps=0)
    # under mixed_fp8_e5m2 (fp32 accumulator, fp16 store) the reference's
    # xla backend keeps its dot's fp32 result where its Pallas kernel
    # stores fp16 before the scales are undone (a 1.4e-2 loss gap at step
    # 0, ROADMAP Queue C); the port is the kernel: hold it to interpret
    backend = "interpret" if policy == "mixed_fp8_e5m2" else "xla"

    def jloss(q, x, cols=None):
        h = x if cols is None else x[:, cols]
        rec = jae.ae_forward(q, h, policy=jpol, backend=backend)
        err = rec.astype(jnp.float32) - x
        return jnp.mean(err * err)

    jvg = jax.jit(jax.value_and_grad(jloss))

    @jax.jit
    def japply(p_, s_, g):
        g, gnorm = jclip(g, 1.0)
        u, s_ = jopt.update(g, s_, p_)
        return jopt.apply(p_, u), s_, gnorm

    def gap(a, b, scale):
        return max(float(np.abs(np.asarray(a[l][k], np.float32)
                                - np.asarray(b[l][k], np.float32)).max())
                   for l in b for k in b[l]) / scale

    jp, js = ae_ref_params, jopt.init(ae_ref_params)
    opt = AdamW(lr=3e-3, warmup_steps=0)
    step = ttrain.build_ae_step(opt, tpol)
    for i in range(4):
        x = ds.sample(i)
        jl, g_ref = jvg(jp, jnp.asarray(x))
        if i in (0, 3):
            g_ref = jax.device_get(g_ref)
            gmax = max(np.abs(np.asarray(v)).max() for d in g_ref.values() for v in d.values())
            spread = 0.0
            for r in range(4):
                rp, cols, back = _relabeled(jp, seed=100 * r + i)
                g_alt = back(jax.device_get(jvg(rp, jnp.asarray(x), jnp.asarray(cols))[1]))
                spread = max(spread, gap(g_alt, g_ref, gmax))
            tol = min(0.2, max(2e-2, 2 * spread))
            tl, tg = ttrain.ae_grads(_port_params(jp), torch.from_numpy(x), tpol)
            tg = {l: {k: v.detach().float().numpy() for k, v in d.items()}
                  for l, d in tg.items()}
            assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl)), i
            assert gap(tg, g_ref, gmax) <= tol, (i, gap(tg, g_ref, gmax), tol)
            want_p, want_s, _ = japply(jp, js, jax.tree.map(jnp.asarray, tg))
            params = _port_params(jp)
            ostate = OptState(step=i, mu=ae_params_from_jax(jax.device_get(js.mu), device="cpu"),
                              nu=ae_params_from_jax(jax.device_get(js.nu), device="cpu"))
            ostate, _, _ = step(params, ostate, torch.from_numpy(x))
            for got, want in ((params, want_p), (ostate.mu, want_s.mu),
                              (ostate.nu, want_s.nu)):
                want = jax.device_get(want)
                got = {l: {k: v.detach().numpy() for k, v in d.items()}
                       for l, d in got.items()}
                scale = max(np.abs(np.asarray(v)).max() for d in want.values()
                            for v in d.values())
                assert gap(got, want, scale) <= 1e-6, i
        jp, js, _ = japply(jp, js, g_ref)


def test_ae_float64_batchnorm_makes_the_fp8_step_order_independent():
    """The witness behind chip_smoke.py's ae8 step parity.  At batch 1024
    under mixed_fp8_e4m3 another order of the rows (one dW rounding block,
    so the same function) moves the gradients by a sixth of their max when
    BatchNorm reduces in fp32, and by nothing when it reduces in float64;
    a step on a batch one row short still moves them far past 2^-9 of max,
    the bound the card is held to with float64 BatchNorm.  float64 changes
    the loss only by BatchNorm's rounding."""
    batch = 1024
    # seed 0: the parameters this witness has always run on (until the seed
    # reached the CPU generator's low 32 bits, every seed drew seed 0's);
    # the size of the move is a property of the draw
    params = tae.init_ae(seed=0, device="cpu")
    x = torch.from_numpy(SyntheticAE(batch=batch, seed=0).sample(1))
    rows = torch.randperm(batch, generator=torch.Generator().manual_seed(6))

    def step(xx, stats):
        p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
             for k, v in params.items()}
        loss, _ = tae.ae_loss(p, xx, policy=tprec.MIXED_FP8_E4M3, stats_dtype=stats)
        g = torch.autograd.grad(loss, tree_leaves(p))
        return float(loss.detach()), torch.cat([t.flatten() for t in g])

    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    l32, g32 = step(x, torch.float32)
    l64, g64 = step(x, torch.float64)
    assert abs(l64 - l32) <= 1e-5 * l32
    assert rel(step(x[rows], torch.float32)[1], g32) > 2.0 ** -6
    assert rel(step(x[rows], torch.float64)[1], g64) <= 2.0 ** -12
    assert rel(step(x[:-1], torch.float64)[1], g64) > 2.0 ** -9


def test_ae_fp8_train_cli_on_cpu():
    for pol in FP8_POLICIES:
        out = ttrain.main(["--device", "cpu", "--arch", "ae", "--policy", pol,
                           "--batch", "16", "--steps", "3"])
        assert out["policy"] == pol and len(out["history"]) == 3
        assert all(np.isfinite(h["loss"]) for h in out["history"])


# --------------------------------------------------------------------- #
# serving reduced qwen3-1.7b under mixed_fp8_e4m3 (dense fp16 KV cache)
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fp8_pair():
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-1.7b"),
                               policy_name="mixed_fp8_e4m3")
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3-1.7b"),
                               policy_name="mixed_fp8_e4m3")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_fp8_decode_events_carry_e4m3_in_both_slots(fp8_pair):
    """The reference's ``test_decode_gemms_under_mixed_fp8_policy``
    without the FP8 KV cache: every decode GEMM carries E4M3 in both
    slots, event for event with the reference's decode step (the layout
    aside: the port's tied head reads the embedding "nt" in place)."""
    jcfg, tcfg, jparams, tparams = fp8_pair
    n, max_len, lengths = 3, 16, [9, 0, 5]
    jev = jsched.instrumented_decode_events(
        jparams, jcfg, jsched.SchedulerConfig(n_slots=n, max_len=max_len), lengths)
    cache = tt.init_cache(tcfg, n, max_len, device="cpu")
    with te.instrument() as tev, te.op_scope("serve_decode"):
        tt.serve_step(tparams, tcfg, torch.zeros(n, 1, dtype=torch.long), cache,
                      torch.tensor([8, max_len - 1, 4]),
                      kv_group_sizes=np.asarray(lengths, np.int32))
    assert tev and all(e.spec.op.startswith("serve_decode/") for e in tev)
    assert all(e.spec.x_dtype == e.spec.w_dtype == "float8_e4m3fn" and e.spec.scaled
               for e in tev)
    # every decode dispatch is a pair the kernel is compiled for
    for e in tev:
        s = e.spec
        assert (torch.float8_e4m3fn, torch.float8_e4m3fn, s.policy.out_dtype,
                s.accum_block is not None) in trm.FP8_KERNELS, s
    key = lambda e: (_key(e, scoped=True)[:1] + _key(e)[2:]
                     + (e.spec.valid_rows, e.spec.policy.name))
    assert collections.Counter(key(e) for e in tev) == \
        collections.Counter(key(e) for e in jev for _ in range(e.count))


def test_fp8_prefill_events_per_op(fp8_pair):
    """Prefill op by op: the projections and the tied head carry E4M3 and
    match the reference's; attention runs flash at fp16, billed as the
    reference's ``engine.attention`` bills it (the reference's own prefill
    takes its q-chunked route under jax 0.9, see tests/test_torch_engine.py)."""
    jcfg, tcfg, jparams, tparams = fp8_pair
    S, T = 8, 12
    prompt = np.arange(3, 3 + S, dtype=np.int32)[None]
    with je.instrument() as jev:
        jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, T)
    with te.instrument() as tev:
        tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()}, T)
    weight = lambda e: e.spec.w_shared and not e.spec.op.startswith("attention")
    want = collections.Counter(_key(e)[2:] for e in jev if weight(e) for _ in range(e.count))
    got = collections.Counter(_key(e)[2:] for e in tev if weight(e))
    assert got == want and sum(got.values()) == 4 * tcfg.n_layers + 1
    attn = [e for e in tev if e.spec.op.startswith("attention")]
    assert len(attn) == 2 * tcfg.n_layers
    assert all(e.spec.x_dtype is None and e.spec.policy.name == "mixed_fp8_e4m3"
               for e in attn)


def test_fp8_decode_step_from_shared_cache_matches_reference(fp8_pair):
    """One continuous-batching decode step from the same cache (the
    reference's prefill cache, converted), slots of different lengths and
    one parked: the logits and the new cache rows within 2^-3 of max.

    The gap reads up to 7.8e-2 of max: an fp16 rounding flip upstream of a
    quantization moves an element by an E4M3 step.  The control, the same
    step with E5M2 operands in place of E4M3, reads 0.17 to 0.31 of max and
    must fail the bound in every slot's logits."""
    jcfg, tcfg, jparams, tparams = fp8_pair
    n, max_len = 3, 16
    rng = np.random.default_rng(11)
    jpool = jt.init_cache(jcfg, n, max_len)
    lens = {0: 7, 2: 4}
    for slot, plen in lens.items():
        prompt = rng.integers(0, 512, (1, plen)).astype(np.int32)
        _, jc = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, max_len)
        jpool = jkv.insert_slot(jpool, jc, jnp.int32(slot), jnp.float16)
    tpool = {"layers": {k: torch.from_numpy(np.asarray(v).astype(np.float32)).half()
                        for k, v in jpool["layers"].items()}}
    toks = rng.integers(0, 512, (n, 1)).astype(np.int32)
    pos = np.array([lens[0], max_len - 1, lens[2]], np.int32)
    sizes = np.array([lens[0] + 1, 0, lens[2] + 1], np.int32)
    jl, jpool = jt.serve_step(jparams, jcfg, jnp.asarray(toks), jpool,
                              jnp.asarray(pos), kv_group_sizes=jnp.asarray(sizes))
    jl = np.asarray(jl).astype(np.float32)
    jrows = {k: np.asarray(v).astype(np.float32) for k, v in jpool["layers"].items()}

    def gaps(cfg):
        """Relative gaps to the reference: (logits, k, v) per live slot."""
        tl, tp = tt.serve_step(tparams, cfg, torch.from_numpy(toks).long(),
                               {"layers": dict(tpool["layers"])},
                               torch.from_numpy(pos).long(), kv_group_sizes=sizes)
        assert tl.dtype == torch.float16 and torch.isfinite(tl.float()).all()
        rel = lambda g, w: float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
        return {slot: (rel(tl[slot], jl[slot]),
                       *(rel(tp["layers"][k][:, slot], jrows[k][:, slot])
                         for k in ("k", "v")))
                for slot in lens}

    tol = 2.0 ** -3
    for slot, g in gaps(tcfg).items():
        assert max(g) <= tol, (slot, g)
    wrong = dataclasses.replace(tprec.MIXED_FP8_E4M3, x_dtype=torch.float8_e5m2,
                                w_dtype=torch.float8_e5m2)
    for slot, g in gaps(dataclasses.replace(tcfg, policy_name=wrong)).items():
        assert g[0] > tol, (slot, g)


def test_fp8_generate_on_cpu(fp8_pair):
    _, tcfg, _, tparams = fp8_pair
    prompts = np.random.default_rng(2).integers(0, 512, (2, 6)).astype(np.int32)
    seqs, _, final = tserve.generate(tparams, tcfg, prompts, 4, return_state=True)
    assert seqs.shape == (2, 10) and np.array_equal(seqs[:, :6], prompts)
    assert ((seqs >= 0) & (seqs < tcfg.vocab_size)).all()
    assert np.isfinite(final).all()
