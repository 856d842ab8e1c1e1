"""The port's LM training path against the JAX package (reduced qwen3-1.7b).

* the model's loss and every gradient against
  ``jax.value_and_grad(transformer.loss_fn)`` under the ``"interpret"``
  backend, and its engine events: the projection and head GEMMs op for
  op; the attention — which the reference's layer scan routes through
  q-chunked batched matmuls (its ``kv_valid`` is a tracer) while the port
  runs flash and recomputes through the composition — against
  ``engine.attention`` under ``jax.value_and_grad`` of a remat region at
  the same shapes with the flash tiles pinned;
* ``engine.attention``'s gradients (causal and dense, GQA and MHA,
  ``t_valid < T``, ``q_offset > 0``, a fully masked row, ``Dv != D``
  through the composition) and the ``"nt"`` / ``"tn"`` ``matmul``
  backward against ``jax.vjp``;
* the ``attn_*`` rows of ``benchmarks/baselines/engine_flops.json``;
* the chunked cross-entropy, the loss-scaled ``tpu_fp16`` step (and an
  overflowed one), a ``tpu_bf16`` bound, and the CLI.

Inputs come from numpy seeds; the reference's initial parameters are
carried across with ``repro_torch.convert``.  Tolerances are relative to
the largest reference magnitude: fp32 1e-4 through the whole model (the
two sides sum in different orders over a few hundred fp32 ops per value),
1e-5 for one attention or one GEMM.
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
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro.optim import optimizer as jopt
from repro.optim import scale as jscale

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import tiling
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizer as topt
from repro_torch.optim import scale as tscale

TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k in tree for item in _paths(tree[k], prefix + (k,))]


def _by_op(events, keep=lambda e: True):
    out = collections.Counter()
    for e in events:
        if keep(e):
            out[(e.spec.op, e.spec.tag, e.spec.flops, e.spec.bytes, e.recompute)] += e.count
    return out


def _batched(e) -> bool:
    """The attention's events: the sweep, its composition and their
    batched backward GEMMs (every other GEMM of the model is 2D)."""
    return e.spec.tag.startswith("b")


def _setup(policy: str, arch: str = "qwen3-1.7b", **over):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name=policy, **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), policy_name=policy, **over)
    return jcfg, tcfg, jt.init_params(jax.random.PRNGKey(0), jcfg)


def _tparams(jparams, tcfg):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                     device="cpu", dtype=torch.float32)
    for p in topt.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(seed, B=2, S=24, vocab=512):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(-1, vocab, (B, S)).astype(np.int32)}


def _ref_loss_grads(jcfg, jparams, b, backend="interpret"):
    f = jax.jit(jax.value_and_grad(lambda p, x: jt.loss_fn(p, jcfg, x), has_aux=True))
    with je.use_backend(backend), je.instrument() as jev:
        (jloss, _), jgrads = f(jparams, {k: jnp.asarray(v) for k, v in b.items()})
    return float(jloss), dict(_paths(jax.tree.map(np.asarray, jgrads))), jev


def _port_loss_grads(tcfg, tparams, b):
    leaves = topt.tree_leaves(tparams)
    with te.instrument() as tev:
        tloss, _ = tt.loss_fn(tparams, tcfg, ttrain._to_device(b, torch.device("cpu")))
        tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    got = {p: (torch.zeros_like(t) if g is None else g)
           for (p, t), g in zip(_paths(tparams), tgrads)}
    return float(tloss.detach()), got, tev


@pytest.fixture(scope="module")
def fp32_qwen3():
    jcfg, tcfg, jparams = _setup("fp32")
    b = _batch(0)
    return jcfg, tcfg, jparams, b, _ref_loss_grads(jcfg, jparams, b)


def test_reduced_qwen3_loss_and_every_grad_match_reference(fp32_qwen3):
    jcfg, tcfg, jparams, b, (jloss, want, _) = fp32_qwen3
    tloss, got, _ = _port_loss_grads(tcfg, _tparams(jparams, tcfg), b)
    assert abs(tloss - jloss) <= TOL * abs(jloss)
    assert set(got) == set(want)
    for path, g in got.items():
        assert _rel(g, want[path]) <= TOL, path


def test_reduced_qwen3_events_match_reference(fp32_qwen3):
    """The projection and head GEMMs (forward, remat recompute, dX / dW)
    event for event.  The attention's against ``engine.attention`` under
    ``jax.value_and_grad`` of a checkpointed layer scan on "interpret" at
    the model's shapes (``t_valid = S``, the flash tiles pinned): the
    forward sweep, its remat recompute, the backward's composition forward
    once (the reference bills it once here, unlike the chunked sweep's in
    ``tests/test_torch_train.py``: there is no copy to subtract) and its
    four batched backward GEMMs a layer."""
    jcfg, tcfg, jparams, b, (_, _, jev) = fp32_qwen3
    _, _, tev = _port_loss_grads(tcfg, _tparams(jparams, tcfg), b)
    flat = lambda e: not _batched(e)
    assert _by_op(tev, flat) == _by_op(jev, flat)
    # 4 projections a layer: forward, remat recompute, dX, dW; the head's 3
    assert sum(_by_op(tev, flat).values()) == tcfg.n_layers * 4 * 4 + 3

    B, S = b["inputs"].shape
    hq, hkv, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim

    def attn(q, k, v):
        return je.attention(q, k, v, t_valid=S, bq=tiling.FLASH_BQ,
                            bkv=tiling.FLASH_BKV, policy="fp32",
                            backend="interpret").sum()

    def layers(q, k, v):
        def body(c, _):
            return c + attn(q * c, k, v), 0
        with je.repeat(tcfg.n_layers):
            c, _ = jax.lax.scan(jax.checkpoint(body), jnp.float32(1), None,
                                length=tcfg.n_layers)
        return c

    rng = np.random.default_rng(1)
    z = lambda h: jnp.asarray(rng.standard_normal((B, h, S, hd)), jnp.float32)
    with je.instrument() as jattn:
        jax.jit(jax.value_and_grad(layers, argnums=(0, 1, 2)))(z(hq), z(hkv), z(hkv))
    got = _by_op(tev, _batched)
    assert got == _by_op(jattn)
    assert {op for op, *_ in got} == {"attention_score", "attention_pv", "einsum2d",
                                      "matmul_dx", "matmul_dw"}


def _attn_inputs(seed, B, Hq, Hkv, S, T, D, Dv=None):
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv or D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


ATTN_CASES = {
    "causal GQA": dict(shape=(2, 4, 2, 12, 12, 16), kw=dict(causal=True)),
    "dense MHA": dict(shape=(1, 3, 3, 10, 14, 16), kw=dict(causal=False)),
    "t_valid < T": dict(shape=(2, 4, 2, 9, 16, 16), kw=dict(causal=False, t_valid=11)),
    "q_offset > 0": dict(shape=(1, 4, 1, 5, 12, 16), kw=dict(causal=True, q_offset=7,
                                                            t_valid=12)),
    "fully masked rows": dict(shape=(1, 2, 1, 6, 8, 16), kw=dict(causal=True,
                                                                q_offset=-3)),
    "Dv != D (composition)": dict(shape=(2, 4, 2, 8, 8, 16), dv=24,
                                  kw=dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_grads_match_reference(case):
    """Output and dq / dk / dv of ``te.attention`` against ``jax.vjp`` of
    ``je.attention`` on "interpret" (the flash kernel with the reference's
    composition VJP; ``Dv != D`` takes the composition on both sides)."""
    c = ATTN_CASES[case]
    B, Hq, Hkv, S, T, D = c["shape"]
    q, k, v = _attn_inputs(sorted(ATTN_CASES).index(case), B, Hq, Hkv, S, T, D,
                           c.get("dv"))
    do = np.random.default_rng(5).standard_normal(
        (B, Hq, S, v.shape[-1])).astype(np.float32)
    with je.use_backend("interpret"):
        jout, vjp = jax.vjp(lambda a, b_, c_: je.attention(a, b_, c_, policy="fp32",
                                                           **c["kw"]),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        jgrads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with te.instrument() as tev:
        tout = te.attention(*ts, policy="fp32", **c["kw"])
        tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(do))
    assert _rel(tout, jout) <= 1e-5
    for g, w in zip(tgrads, jgrads):
        assert _rel(g, w) <= 1e-5
    flash = any(e.spec.op == "attention_score" for e in tev)
    assert flash == (c.get("dv") is None)
    if case == "fully masked rows":        # rows -3..-1 see no column
        assert torch.count_nonzero(tout[:, :, :3]) == 0
        assert torch.count_nonzero(tgrads[0][:, :, :3]) == 0


@pytest.mark.parametrize("layout", ("nt", "tn"))
@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
@pytest.mark.parametrize("batched", (False, True))
def test_transposed_matmul_backward_matches_reference(layout, policy, batched):
    """``te.matmul(..., layout=...)`` against ``jax.vjp`` of ``je.matmul``
    on the transposed operand (the reference has no layout argument): the
    product, dX, dW — each in its primal's storage — and the events by op,
    flops and bytes (the backward bills the reference's specs)."""
    rng = np.random.default_rng(7)
    lead = (3,) if batched else ()
    M, N, K = 6, 20, 9
    if layout == "nt":
        x = rng.standard_normal((2, M, N) if not batched else (3, M, N))
        w = rng.standard_normal((*lead, K, N))
    else:
        x = rng.standard_normal((*lead, N, M))
        w = rng.standard_normal((*lead, N, K))
    x, w = x.astype(np.float32), w.astype(np.float32)
    dz_shape = ((*x.shape[:-2], M, K) if layout == "nt" else (*lead, M, K))
    dz = rng.standard_normal(dz_shape).astype(np.float32)
    sw = lambda a: jnp.swapaxes(a, -1, -2)
    fn = ((lambda a, b_: je.matmul(a, sw(b_), policy=policy)) if layout == "nt"
          else (lambda a, b_: je.matmul(sw(a), b_, policy=policy)))
    with je.use_backend("interpret"), je.instrument() as jev:
        jz, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(dz).astype(jz.dtype))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    with te.instrument() as tev:
        tz = te.matmul(tx, tw, policy=policy, layout=layout)
        tdx, tdw = torch.autograd.grad(tz, (tx, tw), torch.from_numpy(dz).to(tz.dtype))
    tol = 1e-5 if policy == "fp32" else 2.0 ** -7       # bf16: two ulps
    for got, want in ((tz, jz), (tdx, jdx), (tdw, jdw)):
        assert _rel(got, np.asarray(want, np.float32)) <= tol
    key = lambda evs: collections.Counter((e.spec.op, e.flops, e.bytes) for e in evs)
    assert key(tev) == key(jev)
    assert [e.spec.op for e in tev] == ["matmul", "matmul_dx", "matmul_dw"]


def test_attention_flop_rows_match_the_baseline():
    """The ``attn_flash_fwd_*`` rows of engine_flops.json, with the
    reference's tiles (bq = bkv = 128) pinned: causal strictly below
    dense at one geometry."""
    base = json.loads((ROOT / "benchmarks/baselines/engine_flops.json").read_text())
    z = torch.zeros(2, 4, 256, 64)
    got = {}
    for causal in (True, False):
        with te.instrument() as ev:
            te.attention(z, z, z, causal=causal, bq=128, bkv=128, policy="fp32")
        got[causal] = te.total_flops(ev)
    assert got[True] == base["attn_flash_fwd_B2_H4_S256_D64_causal"] == 100_663_296
    assert got[False] == base["attn_flash_fwd_B2_H4_S256_D64_dense"] == 134_217_728


@pytest.mark.parametrize("ce_chunk", (1, 3))
def test_chunked_ce_matches_reference_and_the_unchunked_loss(ce_chunk):
    """``ce_chunk`` 1 (four one-row chunks) and 3 (two chunks, the second
    padded with a row labelled -1): loss, every gradient and the events
    against the reference, and the loss and head gradient against the
    port's unchunked loss."""
    jcfg, tcfg, jparams = _setup("fp32", ce_chunk=ce_chunk)
    b = _batch(2, B=4, S=8)
    jloss, want, jev = _ref_loss_grads(jcfg, jparams, b, backend="xla")
    tloss, got, tev = _port_loss_grads(tcfg, _tparams(jparams, tcfg), b)
    assert abs(tloss - jloss) <= TOL * abs(jloss)
    for path, g in got.items():
        assert _rel(g, want[path]) <= TOL, path
    flat = lambda e: not _batched(e)
    assert _by_op(tev, flat) == _by_op(jev, flat)
    heads = [e for e in tev if e.spec.op == "matmul" and e.spec.layout == "nt"]
    n = -(-4 // ce_chunk)                 # chunks: forward, then remat
    assert [e.recompute for e in heads] == [False] * n + [True] * n
    plain_cfg = dataclasses.replace(tcfg, ce_chunk=0)
    ploss, pgot, _ = _port_loss_grads(plain_cfg, _tparams(jparams, plain_cfg), b)
    assert abs(tloss - ploss) <= 1e-6 * abs(ploss)
    assert _rel(got[("embed",)], pgot[("embed",)].numpy()) <= 1e-5


def _scaled_states(jcfg, tcfg, jparams, scale0):
    jo, to = jopt.AdamW(lr=3e-3, warmup_steps=10), topt.AdamW(lr=3e-3, warmup_steps=10)
    jstate = jtrain.TrainState(params=jparams, opt=jo.init(jparams),
                               scale=jscale.init_scale(scale0))
    tparams = _tparams(jparams, tcfg)
    tstate = ttrain.TrainState(tparams, to.init(tparams),
                               tscale.init_scale(scale0))
    return (jo, jstate), (to, tstate)


def test_loss_scaled_fp16_step_matches_reference():
    """One ``use_scale`` step under ``tpu_fp16`` (scale 2^15): loss,
    gradient norm, the scale state, both AdamW moments and the updated
    parameters against the reference.  fp16 compute rounds every GEMM
    output, norm and residual to 11 bits, at different places in the two
    frameworks: the loss and the gradient norm (fp32 reductions over fp16
    logits and grads) agree to one fp16 ulp (2^-10), the moments to 2^-6
    of max; a first AdamW step moves each parameter by ~lr * sign(g), so
    parameters are compared absolutely — to 1 % of one step where |g| is
    above 1 % of the tensor's largest, within one step (2 lr) elsewhere."""
    jcfg, tcfg, jparams = _setup("tpu_fp16")
    b = _batch(3)
    (jo, jstate), (to, tstate) = _scaled_states(jcfg, tcfg, jparams, 2.0 ** 15)
    with je.use_backend("xla"):
        jnew, jm = jax.jit(jtrain.build_train_step(jcfg, jo, None, use_scale=True))(
            jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tm = ttrain.build_train_step(tcfg, to, use_scale=True)(tstate, b)
    assert float(tm["finite"]) == float(jm["finite"]) == 1.0
    assert _rel(tm["loss"], jm["loss"]) <= 2.0 ** -10
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 2.0 ** -10
    for f in ("scale", "good_steps", "growth_interval", "overflow_count"):
        assert int(getattr(tnew.scale, f)) == int(getattr(jnew.scale, f)), f
    assert float(tm["loss_scale"]) == float(jm["loss_scale"]) == 2.0 ** 15
    for tree_t, tree_j in ((tnew.opt.mu, jnew.opt.mu), (tnew.opt.nu, jnew.opt.nu)):
        want = dict(_paths(jax.tree.map(np.asarray, tree_j)))
        for path, t in _paths(tree_t):
            assert _rel(t, want[path]) <= 2.0 ** -6, path
    lr1 = 3e-3 * 2 / 10
    mu = dict(_paths(jax.tree.map(np.asarray, jnew.opt.mu)))
    want = dict(_paths(jax.tree.map(np.asarray, jnew.params)))
    for path, t in _paths(tnew.params):
        err = np.abs(t.detach().numpy() - want[path])
        g = np.abs(mu[path])
        settled = g > 1e-2 * max(g.max(), 1e-30)
        assert err[settled].max(initial=0.0) <= 1e-2 * lr1, path
        assert err.max() <= 2.1 * lr1, path


def test_overflowed_fp16_step_skips_params_and_moments():
    """A scale of 2^40 overflows the fp16 backward: the step leaves the
    parameters and both moments bit for bit and the optimizer's step count
    as they were, halves the scale and counts the overflow — as the
    reference does."""
    jcfg, tcfg, jparams = _setup("tpu_fp16")
    b = _batch(4)
    (jo, jstate), (to, tstate) = _scaled_states(jcfg, tcfg, jparams, 2.0 ** 40)
    leaves = lambda st: [t for tree in (st.params, st.opt.mu, st.opt.nu)
                         for t in topt.tree_leaves(tree)]
    before = [t.detach().clone() for t in leaves(tstate)]
    with je.use_backend("xla"):
        jnew, jm = jax.jit(jtrain.build_train_step(jcfg, jo, None, use_scale=True))(
            jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tm = ttrain.build_train_step(tcfg, to, use_scale=True)(tstate, b)
    assert float(tm["finite"]) == float(jm["finite"]) == 0.0
    assert all(torch.equal(a, c) for a, c in zip(before, leaves(tnew)))
    assert tnew.opt.step == 0 and int(jnew.opt.step) == 0
    for f in ("scale", "good_steps", "overflow_count"):
        assert float(getattr(tnew.scale, f)) == float(getattr(jnew.scale, f)), f
    assert float(tnew.scale.scale) == 2.0 ** 39 and int(tnew.scale.overflow_count) == 1


def test_train_step_raises_on_a_parameter_the_loss_does_not_reach():
    """Only the untied token table of an embedding-input arch may miss the
    graph (it gets jax.grad's zero gradient); any other parameter the loss
    does not reach raises instead of training on a silent zero gradient."""
    from repro_torch.optim import AdamW

    tcfg = tconfigs.get_reduced("qwen3-1.7b")
    opt = AdamW(lr=1e-3)
    state = ttrain.init_state(tcfg, opt, seed=0, device="cpu")
    state.params["stray"] = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="not have been used"):
        ttrain.build_train_step(tcfg, opt)(state, _batch(6))


def test_remat_recompute_in_another_thread_keeps_the_forwards_backend():
    """A backend pinned with ``use_backend`` around a remat region's forward
    also runs its recompute when autograd runs the backward in another
    thread (as it does for CUDA tensors): forward, recompute, dX and dW."""
    import threading

    hop = te.get_backend("hopper")
    calls = []

    def counted(x, w, **kw):
        calls.append(kw["spec"].op)
        return hop.fn(x, w, **kw)

    te.register_backend("counted", counted, capabilities=hop.capabilities,
                        attention_fn=hop.attention_fn)
    try:
        x = torch.randn(4, 8, requires_grad=True)
        w = torch.randn(8, 8, requires_grad=True)
        with te.use_backend("counted"):
            y = te.checkpoint(lambda a: te.matmul(a, w), x)
        worker = threading.Thread(target=lambda: y.sum().backward())
        worker.start()
        worker.join()
    finally:
        te.unregister_backend("counted")
    assert len(calls) == 4, calls
    assert x.grad is not None and w.grad is not None


def test_reduced_qwen3_bf16_loss_and_grads_bound():
    """Under ``tpu_bf16`` every GEMM output, norm and residual is rounded
    to 8 bits, at different places in the two frameworks (the port's flash
    keeps fp32 softmax weights into PV, the reference's q-chunked path
    casts them to bf16 first): the loss agrees to two bf16 ulps (2^-7) of
    itself and each gradient to 2^-4 of its largest value over two layers,
    the bound of the two-layer bf16 prefill logits
    (``tests/test_torch_serve.py``)."""
    jcfg, tcfg, jparams = _setup("tpu_bf16")
    b = _batch(5)
    jloss, want, _ = _ref_loss_grads(jcfg, jparams, b, backend="xla")
    tloss, got, _ = _port_loss_grads(tcfg, _tparams(jparams, tcfg), b)
    assert abs(tloss - jloss) <= 2.0 ** -7 * abs(jloss)
    for path, g in got.items():
        assert _rel(g, want[path]) <= 2.0 ** -4, path


@pytest.mark.parametrize("scaled", (False, True))
def test_lm_train_cli_on_cpu(capsys, scaled):
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]
    out = ttrain.main(argv + (["--fp16-scale"] if scaled else ["--instrument"]))
    assert out["arch"] == "qwen3-1.7b" and out["device"] == "cpu"
    assert out["policy"] == ("tpu_fp16" if scaled else "tpu_bf16")
    assert len(out["history"]) == 2
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["step_ms"] > 0
        if scaled:
            assert h["finite"] and h["loss_scale"] == 2.0 ** 15
    text = capsys.readouterr().out
    assert "final loss" in text
    if not scaled:
        for op in ("attention_score", "einsum2d", "matmul_dx", "matmul_dw"):
            assert f"[engine] {op}" in text
