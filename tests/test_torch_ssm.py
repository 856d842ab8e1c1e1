"""The port's xLSTM path against the JAX package: engine ops and blocks.

The same numpy inputs go through ``repro`` and ``repro_torch`` (on the CPU,
where the port's kernel wrappers take their plain versions).  Covered:

* ``engine.linear_attention`` on its kernel path against the reference's
  ``"interpret"`` backend (the Pallas sweep kernel): outputs, final state,
  and events by op (flops and bytes equal);
* its gradients against ``jax.grad`` of the reference composition
  (``"xla"``) — the kernel path's backward recomputes through that
  composition on both sides;
* ``matmul`` / ``einsum2d`` gradients and their ``matmul_dx`` /
  ``matmul_dw`` events against ``jax.grad`` of the reference ops;
* the FP32-policy GEMMs; ``mlstm_block`` and ``slstm_block`` forward on
  converted parameters; the remat recompute tag and ``paused``.

Tolerances are relative to the largest reference magnitude: fp32 1e-5 for
one op (summation order), 1e-4 through a block or a gradient chain (a few
dozen fp32 ops); bf16 2^-6 through a block (several bf16 roundings of
2^-8 each that may flip between two summation orders).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import engine as je
from repro.models import ssm as jssm
from repro.models import transformer as jt

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _by_op(events, keep=lambda e: True):
    """Events expanded by count, keyed by op (scope stripped), flops and
    bytes: the reference emits a scanned body once with a multiplicity,
    the port once per executed iteration."""
    out = collections.Counter()
    for e in events:
        if keep(e):
            out[(e.spec.op.split("/")[-1], e.spec.flops, e.spec.bytes)] += e.count
    return out


def _linattn_inputs(seed, B=2, H=3, S=40, dk=16, dv=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, dk)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, H, S, dk))).astype(np.float32)
    v = rng.standard_normal((B, H, S, dv)).astype(np.float32)
    lg = -rng.random((B, H, S)).astype(np.float32)
    return q, k, v, lg


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("S,chunk", ((40, 16), (32, 32)))
def test_linear_attention_kernel_path_matches_reference(dtype, S, chunk):
    q, k, v, lg = _linattn_inputs(S, S=S)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with je.instrument() as jev:
        jo, js = je.linear_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                                     jnp.asarray(lg), chunk=chunk,
                                     backend="interpret")
    with te.instrument() as tev:
        to, ts = te.linear_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                     torch.from_numpy(lg), chunk=chunk)
    assert to.dtype == torch.float32 and ts.dtype == torch.float32
    assert _rel(ts, js) <= 1e-5
    # the kernel stores out in the input dtype on both sides
    assert _rel(to, jo) <= (1e-5 if dtype == "float32" else 2.0 ** -7)
    assert _by_op(tev) == _by_op(jev)
    assert {e.spec.op for e in tev} == {
        "linear_attention_score", "linear_attention_pv",
        "linear_attention_inter", "linear_attention_state"}


def test_linear_attention_grads_match_reference_composition():
    q, k, v, lg = _linattn_inputs(1)
    rng = np.random.default_rng(9)
    co = rng.standard_normal(q.shape[:3] + (v.shape[-1],)).astype(np.float32)
    cs = rng.standard_normal(q.shape[:2] + (q.shape[-1], v.shape[-1])).astype(np.float32)

    def jloss(q_, k_, v_, g_):
        o, s = je.linear_attention(q_, k_, v_, g_, chunk=16, backend="xla")
        return jnp.sum(o * co) + jnp.sum(s * cs)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, lg)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, lg)]
    with te.instrument() as tev:
        o, s = te.linear_attention(*ins, chunk=16)
        loss = (o * torch.from_numpy(co)).sum() + (s * torch.from_numpy(cs)).sum()
        got = torch.autograd.grad(loss, ins)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4
    # the backward recomputes through the fp32 reference composition
    bwd = [e for e in tev if te.is_backward_op(e.spec.op)]
    assert bwd and all(e.spec.policy.compute_dtype == torch.float32 for e in bwd)


def test_linear_attention_state_carry_matches_reference():
    q, k, v, lg = _linattn_inputs(2, S=24)
    s0 = np.random.default_rng(3).standard_normal((2, 3, 16, 8)).astype(np.float32)
    with je.instrument() as jev:
        jo, js = je.linear_attention(*map(jnp.asarray, (q, k, v, lg)), chunk=8,
                                     state=jnp.asarray(s0), backend="interpret")
    with te.instrument() as tev:
        to, ts = te.linear_attention(*map(torch.from_numpy, (q, k, v, lg)), chunk=8,
                                     state=torch.from_numpy(s0))
    assert _rel(to, jo) <= 1e-5 and _rel(ts, js) <= 1e-5
    assert _by_op(tev) == _by_op(jev)          # the composition's dispatches


_GEMM_CASES = {
    # name: (equation or None for matmul, x shape, w shape)
    "matmul_weight": (None, (2, 5, 12), (12, 7)),
    "matmul_batched": (None, (3, 5, 12), (3, 12, 7)),
    "matmul_broadcast": (None, (2, 3, 1, 12), (2, 1, 12, 7)),
    "einsum_slstm": ("bhd,hde->bhe", (4, 3, 8), (3, 8, 20)),
    "einsum_scores": ("bhik,bhjk->bhij", (2, 3, 6, 8), (2, 3, 6, 8)),
    "einsum_sum_out": ("bsk,bsl->bk", (2, 5, 6), (2, 5, 3)),
}


@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
@pytest.mark.parametrize("name", sorted(_GEMM_CASES))
def test_gemm_grads_and_events_match_reference(name, policy):
    eq, xs, ws = _GEMM_CASES[name]
    rng = np.random.default_rng(sorted(_GEMM_CASES).index(name))
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)

    def jop(a, b):
        if eq is None:
            return je.matmul(a, b, policy=policy, backend="xla")
        return je.einsum2d(eq, a, b, policy=policy, backend="xla")

    def top(a, b):
        if eq is None:
            return te.matmul(a, b, policy=policy)
        return te.einsum2d(eq, a, b, policy=policy)

    zshape = jax.eval_shape(jop, jnp.asarray(x), jnp.asarray(w)).shape
    c = rng.standard_normal(zshape).astype(np.float32)
    jloss = lambda a, b: jnp.sum(jop(a, b).astype(jnp.float32) * c)
    with je.instrument() as jev:
        jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    with te.instrument() as tev:
        z = top(tx, tw)
        tval = (z.float() * torch.from_numpy(c)).sum()
        tgrads = torch.autograd.grad(tval, (tx, tw))
    tol = 1e-5 if policy == "fp32" else 2.0 ** -7
    assert _rel(tval, jval) <= tol
    for g, want in zip(tgrads, jgrads):
        assert g.dtype == torch.float32        # the primal operands' dtype
        assert _rel(g, want) <= tol
    assert _by_op(tev) == _by_op(jev)
    assert {e.spec.op for e in tev} >= {"matmul_dx", "matmul_dw"}


def test_fp32_policy_gemm_matches_reference():
    """The mLSTM gate projection: bf16 activations x an fp32 weight under
    the FP32 policy (full fp32 products, fp32 out)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    want = je.matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                     policy="fp32", backend="interpret")
    got = te.matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                    policy="fp32")
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.fixture(scope="module")
def xlstm_pair():
    """Reduced xlstm-1.3b under the fp32 and bf16 policies, the reference's
    initial parameters converted to the port."""
    out = {}
    for policy in ("fp32", "tpu_bf16"):
        jcfg = dataclasses.replace(jconfigs.get_reduced("xlstm-1.3b"),
                                   policy_name=policy)
        tcfg = dataclasses.replace(tconfigs.get_reduced("xlstm-1.3b"),
                                   policy_name=policy)
        jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                          device="cpu", dtype=torch.float32)
        out[policy] = (jcfg, tcfg, jparams, tparams)
    return out


def _block_input(cfg, seed, B=2, S=24):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    return x.astype(np.float32)


@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
@pytest.mark.parametrize("block", ("mlstm", "slstm"))
def test_block_forward_matches_reference(xlstm_pair, block, policy):
    jcfg, tcfg, jparams, tparams = xlstm_pair[policy]
    if block == "mlstm":
        jp = jax.tree.map(lambda a: a[0, 0], jparams["layers"]["mlstm"]["cell"])
        tp = {k: v[0, 0] for k, v in tparams["layers"]["mlstm"]["cell"].items()}
        jfn, tfn = jssm.mlstm_block, tssm.mlstm_block
    else:
        jp = jax.tree.map(lambda a: a[0], jparams["layers"]["slstm"]["cell"])
        tp = {"ffn": {k: v[0] for k, v in tparams["layers"]["slstm"]["cell"]["ffn"].items()},
              **{k: v[0] for k, v in tparams["layers"]["slstm"]["cell"].items()
                 if k != "ffn"}}
        jfn, tfn = jssm.slstm_block, tssm.slstm_block
    x = _block_input(jcfg, 5)
    comp = jcfg.policy.compute_dtype
    with je.use_backend("xla"):     # the reference composition; the port
        jy, _ = jfn(jp, jnp.asarray(x).astype(comp), jcfg, policy=jcfg.policy)
    ty, _ = tfn(tp, torch.from_numpy(x).to(tcfg.policy.compute_dtype), tcfg,
                policy=tcfg.policy)          # runs the sweep kernel's plain version
    assert ty.dtype == tcfg.policy.compute_dtype
    assert _rel(ty, jy) <= (1e-4 if policy == "fp32" else 2.0 ** -6)


def test_mlstm_decode_step_with_state_matches_reference(xlstm_pair):
    """S = 1 with a carried state takes ``linear_attention_step``."""
    jcfg, tcfg, jparams, tparams = xlstm_pair["fp32"]
    jp = jax.tree.map(lambda a: a[1, 0], jparams["layers"]["mlstm"]["cell"])
    tp = {k: v[1, 0] for k, v in tparams["layers"]["mlstm"]["cell"].items()}
    H, hd = jcfg.n_heads, jcfg.ssm.mlstm_proj_factor * jcfg.d_model // jcfg.n_heads
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, H, hd, hd)).astype(np.float32)
    jy, js = jssm.mlstm_block(jp, jnp.asarray(x), jcfg, policy=jcfg.policy,
                              state=jnp.asarray(s0))
    with te.instrument() as tev:
        ty, ts = tssm.mlstm_block(tp, torch.from_numpy(x), tcfg, policy=tcfg.policy,
                                  state=torch.from_numpy(s0))
    assert _rel(ty, jy) <= 1e-4 and _rel(ts, js) <= 1e-5
    assert "einsum2d" in {e.spec.op for e in tev}       # the state readout


def test_checkpoint_tags_recompute_events_and_paused_suppresses():
    w = torch.randn(6, 6, requires_grad=True)
    x = torch.randn(3, 6, requires_grad=True)
    with te.instrument() as ev:
        y = te.checkpoint(lambda a: te.matmul(te.matmul(a, w, policy="fp32"), w,
                                              policy="fp32"), x)
        y.sum().backward()
    ops = [(e.spec.op, e.recompute) for e in ev]
    assert ops.count(("matmul", False)) == 2          # the forward
    assert ops.count(("matmul", True)) == 2           # the remat recompute
    assert sum(op in ("matmul_dx", "matmul_dw") for op, _ in ops) == 4
    assert not any(r for op, r in ops if op != "matmul")
    with te.instrument() as ev2, te.paused():
        te.matmul(x, w, policy="fp32")
    assert ev2 == []


def test_backwards_of_later_slices_raise():
    x = torch.randn(2, 4, 8, requires_grad=True)
    w = torch.randn(8, 8)
    # linear with an epilogue differentiates now (the fused backward)
    z = te.linear(x, w, torch.zeros(8), activation="gelu", policy="fp32")
    (gx,) = torch.autograd.grad(z.sum(), x)
    xr = x.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(
        torch.nn.functional.gelu(xr @ w, approximate="tanh").sum(), xr)
    torch.testing.assert_close(gx, want, rtol=1e-5, atol=1e-5)
    # grouped_matmul differentiates now: its gradient is the plain one
    wg = w[None].expand(2, 8, 8).detach().requires_grad_(True)
    (gx, gw) = torch.autograd.grad(
        te.grouped_matmul(x[None], wg, policy="fp32").sum(), (x, wg))
    xr = x.detach().requires_grad_(True)
    wr = wg.detach().requires_grad_(True)
    want = torch.autograd.grad((xr[None] @ wr).sum(), (xr, wr))
    torch.testing.assert_close(gx, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gw, want[1], rtol=1e-5, atol=1e-5)
    # attention differentiates now (tests/test_torch_lm_train.py); remat
    # "dots" runs: its region's output and gradient equal "full"'s
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    (gq,) = torch.autograd.grad(te.attention(q, q, q, policy="fp32").sum(), q)
    assert torch.isfinite(gq).all()
    qcfg = tconfigs.get_reduced("qwen3-1.7b")
    wq = torch.randn(16, 16)
    region = lambda h: te.linear(te.attention(h, h, h, policy="fp32"), wq,
                                 activation="silu", policy="fp32")
    outs = {}
    for remat in ("dots", "full"):
        hq = q.detach().requires_grad_(True)
        out = tt._remat(dataclasses.replace(qcfg, remat=remat), region)(hq)
        outs[remat] = (out, torch.autograd.grad(out.sum(), hq)[0])
    assert torch.equal(outs["dots"][0], outs["full"][0])
    assert torch.equal(outs["dots"][1], outs["full"][1])
    with torch.no_grad():                       # inference stays available
        te.linear(x, w, torch.zeros(8), activation="gelu", policy="fp32")
