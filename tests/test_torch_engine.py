"""The port's engine against ``repro.core.engine``.

Ops: the same numpy inputs through both engines (JAX on its CPU default
backend, "xla"; for attention, "interpret", whose flash kernel has the
attention capability the port's "hopper" backend has).  Events: for one
prefill and one decode step of reduced qwen3-1.7b, the port's event stream
equals the reference's in op, m/n/k, batch, groups, valid_rows and flops
(each event expanded by its count: the reference emits a scanned layer
body once with count = n_layers, the port once per layer).

Tolerances are relative to the largest reference magnitude: fp32 1e-5
(summation order), bf16 2^-7 (one output-rounding flip of 2^-8, doubled).
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
from repro.models import transformer as jt
from repro.serving import scheduler as jsched

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.models import transformer as tt

TOL = {"fp32": 1e-5, "tpu_bf16": 2.0 ** -7}


def _close(got, want, tol_rel):
    g = got.float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.abs(g - w).max() <= tol_rel * max(np.abs(w).max(), 1e-6)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
@pytest.mark.parametrize("kind", ("weight", "batched", "broadcast", "tied_nt"))
def test_matmul_matches_reference(kind, policy):
    rng = np.random.default_rng(0)
    if kind == "weight":
        x, w = rng.standard_normal((2, 5, 24)), rng.standard_normal((24, 9))
    elif kind == "batched":
        x, w = rng.standard_normal((3, 5, 24)), rng.standard_normal((3, 24, 9))
    elif kind == "broadcast":
        x, w = rng.standard_normal((2, 3, 1, 24)), rng.standard_normal((2, 1, 24, 9))
    else:   # the tied head: the (V, d) embedding read through layout "nt"
        x, w = rng.standard_normal((2, 1, 24)), rng.standard_normal((9, 24))
    (jx, tx), (jw, tw) = _both(x.astype(np.float32)), _both(w.astype(np.float32))
    if kind == "tied_nt":
        want = je.matmul(jx, jw.T, policy=policy, backend="xla")
        got = te.matmul(tx, tw, policy=policy, layout="nt")
    else:
        want = je.matmul(jx, jw, policy=policy, backend="xla")
        got = te.matmul(tx, tw, policy=policy)
    assert got.dtype == tprec.resolve(policy).out_dtype
    _close(got, want, TOL[policy])


@pytest.mark.parametrize("activation", (None, "relu", "gelu", "silu", "tanh"))
def test_linear_fused_epilogue_matches_reference(activation):
    rng = np.random.default_rng(1)
    (jx, tx) = _both(rng.standard_normal((6, 16)).astype(np.float32))
    (jw, tw) = _both(rng.standard_normal((16, 10)).astype(np.float32))
    (jb, tb) = _both(rng.standard_normal(10).astype(np.float32))
    with je.instrument() as jev:
        want = je.linear(jx, jw, jb, activation=activation, policy="tpu_bf16",
                         backend="xla")
    with te.instrument() as tev:
        got = te.linear(tx, tw, tb, activation=activation, policy="tpu_bf16")
    # fused (port) vs post-op (reference's xla) epilogue: ~2 ulp of bf16,
    # the reference's own fused-vs-unfused contract
    _close(got, want, 2.0 ** -6)
    assert [(e.spec.op, e.spec.epilogue, e.flops) for e in tev] == \
           [(e.spec.op, e.spec.epilogue, e.flops) for e in jev]


@pytest.mark.parametrize("sizes", ([5, 0, 3], [7, 7, 7], [2, 9, 1]))
def test_grouped_matmul_ragged_matches_reference(sizes):
    rng = np.random.default_rng(2)
    G, M, N, K = 3, 7, 12, 4
    (jx, tx) = _both(rng.standard_normal((2, G, M, N)).astype(np.float32))
    (jw, tw) = _both(rng.standard_normal((G, N, K)).astype(np.float32))
    gs = np.asarray(sizes, np.int32)
    with je.instrument() as jev:
        want = je.grouped_matmul(jx, jw, group_sizes=gs, policy="fp32",
                                 backend="xla")
    with te.instrument() as tev:
        got = te.grouped_matmul(tx, tw, group_sizes=gs, policy="fp32")
    _close(got, want, TOL["fp32"])
    for i, s in enumerate(sizes):   # rows past a group's size are exact zeros
        assert torch.count_nonzero(got[:, i, min(s, M):]) == 0
    (je_,), (te_,) = jev, tev
    assert (te_.spec.valid_rows, te_.flops, te_.bytes) == \
           (je_.spec.valid_rows, je_.flops, je_.bytes)


_ATTN_CASES = {
    # name: (B, Hq, Hkv, S, T, t_valid, q_offset)
    "prefill_in_cache": (1, 4, 2, 8, 12, 8, 0),
    "batched_gqa": (2, 4, 1, 8, 8, 8, 0),
    "continuation": (1, 4, 2, 4, 12, 12, 8),
}


@pytest.mark.parametrize("name", sorted(_ATTN_CASES))
@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
def test_attention_matches_reference_with_pinned_tiles(name, policy):
    B, Hq, Hkv, S, T, t_valid, q_offset = _ATTN_CASES[name]
    rng = np.random.default_rng(4)
    D = 16
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]
    kw = dict(q_offset=q_offset, t_valid=t_valid, bq=4, bkv=4, policy=policy)
    with je.instrument() as jev:
        want = je.attention(*(jnp.asarray(a) for a in arrs), backend="interpret", **kw)
    with te.instrument() as tev:
        got = te.attention(*(torch.from_numpy(a) for a in arrs), **kw)
    _close(got, want, TOL[policy])
    assert [(e.spec.op, e.spec.groups, e.flops, e.bytes) for e in tev] == \
           [(e.spec.op, e.spec.groups, e.flops, e.bytes) for e in jev]


def test_attention_defaults_bill_the_kernel_tiles():
    q, kv = torch.zeros(1, 2, 100, 16), torch.zeros(1, 1, 150, 16)
    with te.instrument() as ev:
        te.attention(q, kv, kv, t_valid=100)
    assert {e.spec.tile.bm for e in ev} == {tiling.FLASH_BQ}
    assert {e.spec.tile.bn for e in ev} == {tiling.FLASH_BKV}


def test_instrument_repeat_and_scope():
    x, w = torch.ones(2, 3), torch.ones(3, 4)
    with te.instrument() as outer:
        with te.repeat(3), te.op_scope("serve_decode"), te.instrument() as inner:
            te.matmul(x, w, policy="fp32")
    assert outer == inner and len(outer) == 1
    (ev,) = outer
    assert (ev.spec.op, ev.count, ev.total_flops) == ("serve_decode/matmul", 3, 3 * 2 * 2 * 3 * 4)
    assert te.summarize(outer)["total"]["calls"] == 3


def test_registry_contract():
    assert te.default_backend() == "hopper"
    for cap in ("fused_epilogue", "tiled", "layouts", "fused_bwd_epilogue",
                "operand_dtypes", "attention"):
        assert te.backend_supports("hopper", cap)
    with pytest.raises(ValueError, match="unknown backend capabilities"):
        te.register_backend("bad", lambda *a, **k: None, capabilities=("warp",))
    with pytest.raises(ValueError, match="attention_fn"):
        te.register_backend("bad", lambda *a, **k: None, capabilities=("attention",))
    with pytest.raises(ValueError, match="unknown backend"):
        te.matmul(torch.ones(2, 2), torch.ones(2, 2), backend="nope")
    # the FP8 policies dispatch: E4M3 operands, per-tensor scales undone
    with te.instrument() as ev:
        z = te.matmul(torch.ones(2, 2), torch.ones(2, 2), policy="mixed_fp8_e4m3")
    assert z.dtype == torch.float16 and torch.equal(z, torch.full((2, 2), 2.0).half())
    assert (ev[0].spec.x_dtype, ev[0].spec.w_dtype, ev[0].spec.scaled) == \
        ("float8_e4m3fn", "float8_e4m3fn", True)


def test_post_op_backend_without_capabilities():
    """A backend with no capabilities gets pre-transposed "nn" operands and
    the engine's post-op epilogue — the reference's fallback contract."""
    seen = []

    def plain(x, w, *, spec):
        seen.append(spec.layout)
        return torch.matmul(x.float(), w.float())

    te.register_backend("plain_test", plain)
    try:
        x, w, b = torch.randn(3, 5), torch.randn(4, 5), torch.randn(4)
        z = te.matmul(x, w, policy="fp32", backend="plain_test", layout="nt")
        torch.testing.assert_close(z, x @ w.t())
        y = te.linear(x, w.t(), b, activation="relu", policy="fp32",
                      backend="plain_test")
        torch.testing.assert_close(y, torch.relu(x @ w.t() + b))
    finally:
        te.unregister_backend("plain_test")
    assert seen == ["nn", "nn"]


def _expanded(events, keep=lambda e: True):
    out = collections.Counter()
    for e in events:
        if keep(e):
            s = e.spec
            out[(s.op.split("/")[-1], s.m, s.n, s.k, s.batch, s.groups,
                 s.valid_rows, s.flops)] += e.count
    return out


@pytest.fixture(scope="module")
def reduced_pair():
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-1.7b"), policy_name="fp32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3-1.7b"), policy_name="fp32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_prefill_event_parity(reduced_pair):
    """Projection and head GEMMs match event for event.  The reference's
    prefill reaches its attention through the q-chunked batched matmuls —
    its layer scan makes ``kv_valid`` a tracer, so the static-offset flash
    route (``attention.py:240-256``) is not taken — while the port takes
    that route; its attention events are held against the reference's
    ``engine.attention`` at the same shapes and pinned tiles instead."""
    jcfg, tcfg, jparams, tparams = reduced_pair
    S, T = 8, 12
    prompt = np.arange(3, 3 + S, dtype=np.int32)[None]
    with je.instrument() as jev:
        jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, T)
    with te.instrument() as tev:
        tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()}, T)
    weight = lambda e: e.spec.tag == "mn,nk->mk"
    assert _expanded(tev, weight) == _expanded(jev, weight)

    hd, hq, hkv = tcfg.head_dim, tcfg.n_heads, tcfg.n_kv_heads
    with je.instrument() as jattn:
        je.attention(jnp.zeros((1, hq, S, hd)), jnp.zeros((1, hkv, T, hd)),
                     jnp.zeros((1, hkv, T, hd)), t_valid=S,
                     bq=tiling.FLASH_BQ, bkv=tiling.FLASH_BKV, policy="fp32",
                     backend="interpret")
    attn = lambda e: e.spec.op.startswith("attention")
    want = collections.Counter({k: v * tcfg.n_layers
                                for k, v in _expanded(jattn).items()})
    assert _expanded(tev, attn) == want
    assert len(tev) == sum(_expanded(tev).values()) == 9 + 4   # 2 layers


def test_decode_event_parity(reduced_pair):
    """One continuous-batching decode step with mixed per-slot lengths."""
    jcfg, tcfg, jparams, tparams = reduced_pair
    n, max_len = 3, 16
    lengths = [9, 0, 5]      # a parked slot bills nothing
    jev = jsched.instrumented_decode_events(
        jparams, jcfg, jsched.SchedulerConfig(n_slots=n, max_len=max_len), lengths)
    cache = tt.init_cache(tcfg, n, max_len, device="cpu")
    pos = torch.tensor([8, max_len - 1, 4])
    with te.instrument() as tev, te.op_scope("serve_decode"):
        tt.serve_step(tparams, tcfg, torch.zeros(n, 1, dtype=torch.long), cache,
                      pos, kv_group_sizes=np.asarray(lengths, np.int32))
    assert _expanded(tev) == _expanded(jev)
    assert all(e.spec.op.startswith("serve_decode/") for e in tev)
    ragged = [e for e in tev if e.spec.op.endswith("grouped_matmul")]
    assert {e.spec.valid_rows for e in ragged} == {(9 + 5) * tcfg.n_kv_heads}


# --------------------------------------------------------------------- #
# linear's backward: one pass (fused_bwd_epilogue) and two-pass fallback
# --------------------------------------------------------------------- #
@pytest.fixture
def two_pass_backend():
    """The hopper kernels behind a backend without ``fused_bwd_epilogue``:
    the engine's two-pass fallback."""
    te.register_backend("hopper_two_pass", te.get_backend("hopper").fn,
                        capabilities=("fused_epilogue", "tiled", "layouts"))
    yield "hopper_two_pass"
    te.unregister_backend("hopper_two_pass")


def _event_key(e):
    s = e.spec
    return (s.op.split("/")[-1], s.layout, s.m, s.n, s.k, s.batch,
            s.grad_epilogue, s.grad_mode, s.fused_bwd, s.fused_bias_grad,
            s.flops, s.bytes)


LIN_TOL = {"fp32": 1e-5, "paper_fp16": 2e-2}


@pytest.mark.parametrize("path", ("one_pass", "two_pass"))
@pytest.mark.parametrize("policy", ("fp32", "paper_fp16"))
@pytest.mark.parametrize("activation", (None, "relu", "tanh", "gelu"))
def test_linear_backward_matches_reference(activation, policy, path,
                                           two_pass_backend):
    """Grads of x, w and b against ``repro.core.engine.linear`` under
    ``jax.grad``; the events against the reference's capable backend
    ("interpret", one pass) or its xla fallback (two-pass)."""
    rng = np.random.default_rng([3, ("fp32", "paper_fp16").index(policy),
                                 path == "one_pass"])
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 12)) * 24 ** -0.5).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    r = rng.standard_normal((2, 5, 12)).astype(np.float32)
    jbk = "interpret" if path == "one_pass" else "xla"
    tbk = "hopper" if path == "one_pass" else two_pass_backend

    def jloss(p):
        z = je.linear(p["x"], p["w"], p["b"], activation=activation,
                      policy=policy, backend=jbk)
        return jnp.sum(z.astype(jnp.float32) * r)

    jp = {k: jnp.asarray(v) for k, v in (("x", x), ("w", w), ("b", b))}
    with je.instrument() as jev:
        jax.eval_shape(jax.grad(jloss), jp)
    want = jax.grad(lambda p: je.linear(
        p["x"], p["w"], p["b"], activation=activation, policy=policy,
        backend="xla").astype(jnp.float32).__mul__(r).sum())(jp)
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in (("x", x), ("w", w), ("b", b))}
    with te.instrument() as tev:
        z = te.linear(tp["x"], tp["w"], tp["b"], activation=activation,
                      policy=policy, backend=tbk)
        (z.float() * torch.from_numpy(r)).sum().backward()
    for k in ("x", "w", "b"):
        assert tp[k].grad.dtype == torch.float32
        _close(tp[k].grad, want[k], LIN_TOL[policy])
    assert [_event_key(e) for e in tev] == [_event_key(e) for e in jev]
    ops = [e.spec.op for e in tev]
    if path == "one_pass":
        assert not any(te.is_pass_op(o) for o in ops)
        assert tev[-1].spec.fused_bias_grad
    else:
        assert "linear_dbias" in ops
        assert ("linear_dact" in ops) == (activation is not None)


def test_faithful_dispatches_carry_the_reference_block():
    """Under paper_fp16 each dispatch rounds at the reference's tile.bn:
    at 4096 rows the dW reduction spans 4 blocks of 1024 (the fused
    backward shrinks the reference's VMEM budget)."""
    x = np.random.default_rng(4).standard_normal((4096, 640)).astype(np.float32)
    w = np.zeros((640, 128), np.float32)
    b = np.zeros(128, np.float32)
    jp = {"x": jnp.asarray(x), "w": jnp.asarray(w), "b": jnp.asarray(b)}
    with je.instrument() as jev:
        jax.eval_shape(jax.grad(lambda p: je.linear(
            p["x"], p["w"], p["b"], policy="paper_fp16",
            backend="interpret").astype(jnp.float32).sum()), jp)
    tw = torch.zeros(640, 128, requires_grad=True)
    tb = torch.zeros(128, requires_grad=True)
    with te.instrument() as tev:
        te.linear(torch.from_numpy(x), tw, tb, policy="paper_fp16").float().sum().backward()
    assert [e.spec.accum_block for e in tev] == [e.spec.tile.bn for e in jev] \
        == [640, 128, 1024]
    with te.instrument() as ev32:
        te.linear(torch.zeros(4, 8), torch.zeros(8, 2), torch.zeros(2),
                  policy="fp32")
    assert ev32[0].spec.accum_block is None     # fp32 accumulation


def test_fused_bwd_capability_requires_layouts():
    assert te.backend_supports("hopper", "fused_bwd_epilogue")
    with pytest.raises(ValueError, match="requires 'layouts'"):
        te.register_backend("bad", lambda *a, **k: None,
                            capabilities=("fused_bwd_epilogue",))
    assert te.is_pass_op("linear_dact") and te.is_pass_op("x/linear_dbias")
    assert te.is_backward_op("linear_dact") and not te.is_pass_op("matmul_dw")
