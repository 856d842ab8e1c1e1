"""The port's MoE layer (``repro_torch.models.moe``) and the grouped GEMM's
backward against the JAX package.

Both sides see the same numpy inputs and the reference's own parameters
(``repro.models.moe.moe_schema`` initialised by ``repro.models.layers``).
The reference runs its kernels on the "interpret" backend, as its own
tests do on the CPU.

Tolerances: under ``fp32`` the MoE output agrees to 1e-4 of the largest
reference magnitude (summation order), with identical routing (the same
expert ids in the same slot order) and an identical drop fraction; the
aux and z losses to 1e-5 relative (fp32 reductions of the same values in
another order); the grouped GEMM's gradients to 1e-5 of max (one fp32
product, summed in another order).  Events are compared exactly.
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
from repro.core import precision as jprec
from repro.models import layers as jlayers
from repro.models import moe as jmoe

from repro_torch import configs as tconfigs
from repro_torch.core import engine as te
from repro_torch.core import precision as tprec
from repro_torch.models import moe as tmoe

TOL = 1e-4
ARCH = "deepseek-v2-lite-16b"


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _cfgs(**moe_over):
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    if moe_over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_over))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_over))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jlayers.init_tree(jax.random.PRNGKey(seed), jmoe.moe_schema(jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jp, tp


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _ref_forward(jp, x, jcfg):
    with je.use_backend("interpret"):
        return jax.jit(lambda p, xx: jmoe.moe_forward(
            p, xx, jcfg, policy=jprec.FP32))(jp, jnp.asarray(x))


def _ref_ids(jp, x, k):
    logits = je.matmul(jnp.asarray(x), jp["router"], backend="interpret",
                       policy=jprec.Policy("router", jnp.float32, jnp.float32,
                                           jnp.float32))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)[1])


@pytest.mark.parametrize("cf", (64.0, 0.1))
@pytest.mark.parametrize("shape", ((2, 40), (3, 48), (1, 64)))
def test_moe_forward_matches_reference_fp32(cf, shape):
    """The output, the routing and the drop fraction, with nothing dropped
    (cf 64) and most slots dropped (cf 0.1)."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp, tp = _params(jcfg)
    B, S = shape
    x = _x(B, S, jcfg.d_model)
    jy, jm = _ref_forward(jp, x, jcfg)
    ty, tm = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg,
                              policy=tprec.FP32)
    assert _rel(ty, jy) <= TOL
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])
    if cf == 64.0:
        assert float(tm["moe_drop_frac"]) == 0.0
    else:
        assert float(tm["moe_drop_frac"]) > 0.1
    logits = te.matmul(torch.from_numpy(x), tp["router"],
                       policy=tmoe._router_policy(tprec.FP32))
    _, ids = tmoe.top_k(torch.softmax(logits, -1), tcfg.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(), _ref_ids(jp, x, jcfg.moe.top_k))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_aux_and_z_loss_match_reference(seed):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed)
    x = _x(2, 16, jcfg.d_model, seed + 5)
    _, jm = _ref_forward(jp, x, jcfg)
    _, tm = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg,
                             policy=tprec.FP32)
    for k in ("moe_aux_loss", "moe_z_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k


@pytest.mark.parametrize("cf", (64.0, 1.25, 0.1))
def test_batched_dispatch_equals_the_per_row_vmap(cf):
    """The port's one-pass dispatch over (B, S k) builds the same expert
    buffers and slot destinations as the reference's ``_dispatch_row``
    vmapped over rows, spill row and capacity rounding included."""
    E, k, S, B, d = 8, 2, 20, 3, 6
    rng = np.random.default_rng(7)
    ids = rng.integers(0, E, (B, S, k)).astype(np.int32)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    C = tmoe.capacity(S, k, E, cf)
    assert C % 8 == 0
    jb, jdest, jinv, _ = jax.vmap(lambda xs, i, g: jmoe._dispatch_row(
        xs, i, g, E=E, k=k, C=C, dtype=jnp.float32))(
            jnp.asarray(x), jnp.asarray(ids), jnp.ones((B, S, k), jnp.float32))
    tb, tdest = tmoe._dispatch(torch.from_numpy(x), torch.from_numpy(ids).long(),
                               E=E, k=k, C=C, dtype=torch.float32)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        tdest.numpy(), np.take_along_axis(np.asarray(jdest), np.asarray(jinv), 1))


@pytest.mark.parametrize("row", (
    [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
    [0.1, 0.3, 0.1, 0.3, 0.1, 0.1],
    [0.0, 0.0, 0.5, 0.0, 0.5, 0.0],
    [1 / 6] * 6,
))
@pytest.mark.parametrize("k", (1, 2, 3))
def test_top_k_breaks_ties_like_lax_top_k(row, k):
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    p = np.asarray([row, row[::-1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), k)
    tv, ti = tmoe.top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("lead", ((), (2,), (2, 3)))
@pytest.mark.parametrize("sizes", (None, (5, 0, 8, 3)))
def test_grouped_matmul_grads_match_reference(lead, sizes):
    """dX and dW of the grouped GEMM against ``jax.grad`` of the
    reference, with and without ``group_sizes`` (masked rows: zero
    cotangent) and lead dims over which W is broadcast (dW summed)."""
    G, M, N, K = 4, 8, 16, 12
    rng = np.random.default_rng(3)
    x = rng.standard_normal((*lead, G, M, N)).astype(np.float32)
    w = rng.standard_normal((G, N, K)).astype(np.float32)
    dz = rng.standard_normal((*lead, G, M, K)).astype(np.float32)
    gs = None if sizes is None else np.asarray(sizes, np.int32)

    def jloss(xx, ww):
        z = je.grouped_matmul(xx, ww, group_sizes=gs, policy="fp32",
                              backend="interpret")
        return jnp.sum(z * dz)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tz = te.grouped_matmul(tx, tw, group_sizes=gs, policy="fp32")
    tgx, tgw = torch.autograd.grad((tz * torch.from_numpy(dz)).sum(), (tx, tw))
    assert _rel(tgx, jgx) <= 1e-5 and _rel(tgw, jgw) <= 1e-5
    if gs is not None:
        for g, n in enumerate(gs):
            assert not tgx[..., g, n:, :].any()


def test_grouped_matmul_grads_under_bf16_match_the_plain_product():
    """The bf16 datapath: gradients are the fp32 products of the bf16
    operands, cast once to bf16 (2^-7 of max: one bf16 rounding, order)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((4, 16, 12)).astype(np.float32)).bfloat16()
    dz = torch.from_numpy(rng.standard_normal((2, 4, 8, 12)).astype(np.float32)).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    z = te.grouped_matmul(x, w, policy="tpu_bf16")
    gx, gw = torch.autograd.grad(z, (x, w), dz)
    assert gx.dtype == gw.dtype == torch.bfloat16
    want_x = dz.float() @ w.detach().float().transpose(-1, -2)
    want_w = (x.detach().float().transpose(-1, -2) @ dz.float()).sum(0)
    assert _rel(gx, want_x.numpy()) <= 2.0 ** -7
    assert _rel(gw, want_w.numpy()) <= 2.0 ** -7


def _bill(events):
    out = collections.Counter()
    for e in events:
        s = e.spec
        out[(s.op, s.tag, s.m, s.n, s.k, s.batch, s.groups, s.valid_rows,
             s.ragged_dim if s.valid_rows is not None else "m", s.flops,
             s.bytes)] += e.count
    return out


@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
def test_moe_forward_backward_events_match_reference(policy):
    """Every GEMM event of one MoE layer's forward and backward — router,
    the two grouped expert GEMMs, the combine, the shared experts, and
    each one's ``matmul_dx`` / ``matmul_dw`` — with the reference's specs,
    flops and bytes."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, policy_name=policy)
    tcfg = dataclasses.replace(tcfg, policy_name=policy)
    jp, tp = _params(jcfg)
    x = _x(2, 12, jcfg.d_model)

    def jf(p, xx):
        y, m = jmoe.moe_forward(p, xx, jcfg, policy=jcfg.policy)
        return jnp.sum(y.astype(jnp.float32)) + m["moe_aux_loss"] + m["moe_z_loss"]

    # the events are the backend's to choose no field of: "xla" traces
    # faster than "interpret" and bills the same specs
    with je.use_backend("xla"), je.instrument() as jev:
        jax.eval_shape(jax.grad(jf, argnums=(0, 1)), jp, jnp.asarray(x))
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with te.instrument() as tev:
        y, m = tmoe.moe_forward(tp, xt, tcfg, policy=tcfg.policy)
        loss = y.float().sum() + m["moe_aux_loss"] + m["moe_z_loss"]
        torch.autograd.grad(loss, [xt, *jax.tree.leaves(tp)])
    assert _bill(tev) == _bill(jev)
    ops = collections.Counter(e.spec.op for e in tev)
    # router, 2 grouped, combine, 2 shared: each forward, dX and dW
    assert ops == {"matmul": 3, "grouped_matmul": 2, "einsum2d": 1,
                   "matmul_dx": 6, "matmul_dw": 6}


def test_grouped_backward_events_carry_ragged_rows():
    """With ``group_sizes`` the dX event is ragged in M and the dW event
    in its contraction rows, billed as the reference bills them."""
    G, M, N, K = 3, 8, 16, 12
    sizes = np.asarray([5, 0, 8], np.int32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, G, M, N)).astype(np.float32)
    w = rng.standard_normal((G, N, K)).astype(np.float32)
    with je.instrument() as jev:
        jax.grad(lambda a, b: jnp.sum(je.grouped_matmul(
            a, b, group_sizes=sizes, policy="fp32", backend="interpret")),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    with te.instrument() as tev:
        torch.autograd.grad(te.grouped_matmul(tx, tw, group_sizes=sizes,
                                              policy="fp32").sum(), (tx, tw))
    assert _bill(tev) == _bill(jev)
    by_op = {e.spec.op: e.spec for e in tev}
    assert by_op["matmul_dx"].valid_rows == 13 and by_op["matmul_dx"].ragged_dim == "m"
    assert by_op["matmul_dw"].valid_rows == 13 and by_op["matmul_dw"].ragged_dim == "n"
