"""The port's AutoEncoder training slice against the JAX package.

The TinyMLPerf AutoEncoder (640 -> [128 x4] -> 8 -> [128 x4] -> 640) under
``paper_fp16`` and ``fp32``: the same numpy inputs and the reference's own
initial parameters (``repro.models.autoencoder.init_ae(PRNGKey(0))``,
carried across by ``repro_torch.convert.ae_params_from_jax``) go through
both packages.  The reference runs on its "xla" backend, which at batch 16
gives the loss and gradients of its Pallas kernel in interpret mode (every
reduction fits one rounding block); one test holds the port to
"interpret" itself.  Also: ``SyntheticAE`` bit for bit, ``LossScaleState``
step for step, the loss-scaled example's overflow skip, the CLI, and the
train step's 30 engine events against the reference's and the
``ae_train_B16`` pins in ``benchmarks/baselines``.

Tolerances: ``paper_fp16`` loss 1e-3 relative, gradients 2e-2 of the
largest |g| in the tree; ``fp32`` 1e-5 and 1e-5.  Gradients are measured
against the tree's largest magnitude because the hidden layers' bias
gradients are zero up to rounding (BatchNorm removes each column's mean),
so they have no scale of their own.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import engine as je
from repro.core import precision as jprec
from repro.data import SyntheticAE as JSyntheticAE
from repro.models import autoencoder as jae
from repro.optim import AdamW as JAdamW
from repro.optim import adjust as jadjust
from repro.optim import clip_by_global_norm as jclip
from repro.optim import init_scale as jinit_scale

from repro_torch.convert import ae_params_from_jax
from repro_torch.core import engine as te
from repro_torch.core import precision as tprec
from repro_torch.data import SyntheticAE
from repro_torch.examples import train_autoencoder as tex
from repro_torch.launch import train as ttrain
from repro_torch.models import autoencoder as tae
from repro_torch.optim import AdamW, OptState, adjust, init_scale, tree_leaves

BASELINES = Path(__file__).resolve().parent.parent / "benchmarks" / "baselines"
LOSS_TOL = {"paper_fp16": 1e-3, "fp32": 1e-5}
GRAD_TOL = {"paper_fp16": 2e-2, "fp32": 1e-5}
# the most a measured summation-order spread may widen GRAD_TOL to
SPREAD_CAP = {"paper_fp16": 0.2, "fp32": 1e-4}


@pytest.fixture(scope="module")
def ref_params():
    return jae.init_ae(jax.random.PRNGKey(0))


def _port_params(ref_params):
    p = ae_params_from_jax(jax.device_get(ref_params), device="cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    return p


def _grads_close(tgrads, jgrads, tol):
    """Every leaf within ``tol`` of the tree's largest reference |g|."""
    jg = jax.device_get(jgrads)
    gmax = max(np.abs(np.asarray(v)).max() for d in jg.values() for v in d.values())
    worst = 0.0
    for layer, d in tgrads.items():
        for k, g in d.items():
            want = np.asarray(jg[layer][k], np.float32)
            assert g.shape == want.shape, (layer, k)
            worst = max(worst, float(np.abs(g.float().numpy() - want).max()))
    assert worst <= tol * gmax, (worst, gmax)


@pytest.mark.parametrize("step", (0, 1, 7))
def test_synthetic_ae_batches_are_identical(step):
    for kw in (dict(batch=16), dict(batch=5, dim=64, seed=3)):
        want, got = JSyntheticAE(**kw).sample(step), SyntheticAE(**kw).sample(step)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def test_ae_schema_matches_reference(ref_params):
    tree = tae.init_ae(seed=0, device="cpu")
    assert tae.AE_DIMS == (640, 128, 128, 128, 128, 8, 128, 128, 128, 128, 640)
    assert set(tree) == set(ref_params)
    for layer, d in tree.items():
        assert set(d) == set(ref_params[layer]), layer
        for k, t in d.items():
            assert tuple(t.shape) == ref_params[layer][k].shape
    # He init: the first layer's weights have std sqrt(2 / 640)
    assert abs(float(tree["fc0"]["w"].std()) - (2 / 640) ** 0.5) < 2e-3
    assert float(tree["fc0"]["gamma"].min()) == 1.0 and float(tree["fc0"]["b"].abs().max()) == 0.0


@pytest.mark.parametrize("policy,backend", (("paper_fp16", "interpret"),
                                            ("fp32", "xla")))
def test_ae_loss_and_grads_match_reference(ref_params, policy, backend):
    x = SyntheticAE(batch=16).sample(0)
    (jloss, _), jg = jax.value_and_grad(
        lambda q: jae.ae_loss(q, jnp.asarray(x), policy=jprec.resolve(policy),
                              backend=backend), has_aux=True)(ref_params)
    params = _port_params(ref_params)
    loss, grads = ttrain.ae_grads(params, torch.from_numpy(x),
                                  tprec.resolve(policy))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL[policy] * abs(float(jloss))
    _grads_close(grads, jg, GRAD_TOL[policy])


def _relabeled(params, seed: int):
    """The same AutoEncoder with its hidden units renumbered (and layer 0's
    input features, which ``x`` is permuted to match): the same function,
    but every GEMM sums in another order.  Returns the relabeled tree and
    a function mapping its gradients back to the original labels."""
    rng = np.random.default_rng(seed)
    dims = tae.AE_DIMS
    perms = ([rng.permutation(640)] + [rng.permutation(d) for d in dims[1:-1]]
             + [np.arange(640)])
    out = {}
    for i in range(len(dims) - 1):
        pi, po = perms[i], perms[i + 1]
        out[f"fc{i}"] = {k: (np.asarray(v)[pi][:, po] if k == "w" else np.asarray(v)[po])
                         for k, v in params[f"fc{i}"].items()}

    def back(g):
        res = {}
        for i in range(len(dims) - 1):
            ipi, ipo = np.argsort(perms[i]), np.argsort(perms[i + 1])
            res[f"fc{i}"] = {k: (np.asarray(v)[ipi][:, ipo] if k == "w"
                                 else np.asarray(v)[ipo])
                             for k, v in g[f"fc{i}"].items()}
        return res

    return jax.tree.map(jnp.asarray, out), perms[0], back


@pytest.mark.parametrize("policy", ("paper_fp16", "fp32"))
def test_ae_ten_adamw_steps_match_reference(ref_params, policy):
    """The ``--arch ae`` step (AdamW without warmup, clip 1.0) along 10
    steps of the reference's trajectory.  At each step the port starts from
    the reference's parameters and AdamW moments, and:

    * its loss agrees within the loss tolerance;
    * its gradients and gradient norm agree within the gradient tolerance,
      or twice the reference's own spread at that state, capped at
      ``SPREAD_CAP``;
    * its updated parameters and moments equal the reference optimizer's
      (``jopt.update`` / ``jopt.apply``) fed the port's own gradients, to
      fp32 rounding (1e-6).

    The spread: the largest gap, over four renumberings of the hidden units,
    between the reference on the renumbered network (the same function,
    other summation orders) and on the original, measured in this run.
    Along the trajectory BatchNorm over near-constant columns makes the
    gradients ill-conditioned: a one-ulp flip in an fp16 activation moves
    them by percents (the spread reaches 0.16 of max |g| under paper_fp16
    and 2.7e-5 under fp32 on these batches).  The parameters are held
    through the optimizer and not against the reference's own update:
    Adam turns a gradient element near 1e-9 (the hidden biases, which
    BatchNorm cancels) into an update near ±lr, so two correct summation
    orders move such parameters apart by up to 6e-3 even in fp32."""
    jpol, tpol, ds = jprec.resolve(policy), tprec.resolve(policy), SyntheticAE(batch=16)
    jopt = JAdamW(lr=3e-3, warmup_steps=0)

    def jloss(q, x, cols=None):
        h = x if cols is None else x[:, cols]
        rec = jae.ae_forward(q, h, policy=jpol, backend="xla")
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

    opt = AdamW(lr=3e-3, warmup_steps=0)
    step = ttrain.build_ae_step(opt, tpol)
    jp, js = ref_params, jopt.init(ref_params)
    for i in range(10):
        x = ds.sample(i)
        jl, g_ref = jvg(jp, jnp.asarray(x))
        g_ref = jax.device_get(g_ref)
        gmax = max(np.abs(np.asarray(v)).max() for d in g_ref.values() for v in d.values())
        spread = 0.0
        for r in range(4):
            rp, cols, back = _relabeled(jp, seed=100 * r + i)
            g_alt = back(jax.device_get(jvg(rp, jnp.asarray(x), jnp.asarray(cols))[1]))
            spread = max(spread, gap(g_alt, g_ref, gmax))
        tol = min(SPREAD_CAP[policy], max(GRAD_TOL[policy], 2 * spread))
        _, tg = ttrain.ae_grads(_port_params(jp), torch.from_numpy(x), tpol)
        tg = {l: {k: v.detach().float().numpy() for k, v in d.items()}
              for l, d in tg.items()}
        print(f"[ae parity] {policy} step {i}: spread {spread:.3e}, port vs "
              f"reference {gap(tg, g_ref, gmax):.3e} of max |g|, held to {tol:.3e}")
        assert gap(tg, g_ref, gmax) <= tol, (i, gap(tg, g_ref, gmax), tol)
        next_p, next_s, jgnorm = japply(jp, js, g_ref)   # the reference's step
        want_p, want_s, want_gnorm = japply(jp, js, jax.tree.map(jnp.asarray, tg))
        params = _port_params(jp)
        opt_state = OptState(step=i, mu=ae_params_from_jax(jax.device_get(js.mu), device="cpu"),
                             nu=ae_params_from_jax(jax.device_get(js.nu), device="cpu"))
        opt_state, loss, gnorm = step(params, opt_state, torch.from_numpy(x))
        assert abs(float(loss) - float(jl)) <= LOSS_TOL[policy] * abs(float(jl)), i
        assert abs(float(gnorm) - float(jgnorm)) <= tol * float(jgnorm), (i, tol)
        assert abs(float(gnorm) - float(want_gnorm)) <= 1e-6 * float(want_gnorm), i
        assert opt_state.step == int(want_s.step) == i + 1
        for got, want in ((params, want_p), (opt_state.mu, want_s.mu),
                          (opt_state.nu, want_s.nu)):
            want = jax.device_get(want)
            got = {l: {k: v.detach().numpy() for k, v in d.items()}
                   for l, d in got.items()}
            scale = max(np.abs(np.asarray(v)).max() for d in want.values()
                        for v in d.values())
            assert gap(got, want, scale) <= 1e-6, i
        jp, js = next_p, next_s


def test_loss_scale_follows_reference_adjust():
    seq = [True] * 3 + [False, True, True, False, False] + [True] * 5
    js, ts = jinit_scale(initial=2.0 ** 4, growth_interval=2), init_scale(
        initial=2.0 ** 4, growth_interval=2)
    for finite in seq:
        js, ts = jadjust(js, jnp.bool_(finite)), adjust(ts, torch.tensor(finite))
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
        assert int(ts.overflow_count) == int(js.overflow_count)
    # the scale never drops below 1
    s = init_scale(initial=2.0, growth_interval=10)
    for _ in range(4):
        s = adjust(s, torch.tensor(False))
    assert float(s.scale) == 1.0 and int(s.overflow_count) == 4


def test_loss_scaled_step_skips_params_and_moments_on_overflow():
    params = tae.init_ae(seed=1, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(params)
    x = torch.from_numpy(SyntheticAE(batch=16).sample(0))
    # one finite step, so the moments are not zero
    opt_state, scale, _, finite = tex.loss_scaled_step(
        params, opt_state, init_scale(initial=2.0 ** 4), x, opt)
    assert bool(finite) and opt_state.step == 1
    before = [t.detach().clone() for t in
              tree_leaves(params) + tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu)]
    # 2^40 overflows the fp16 cotangent of the reconstruction
    scale = init_scale(initial=2.0 ** 40)
    opt_state, scale, loss, finite = tex.loss_scaled_step(params, opt_state,
                                                          scale, x, opt)
    assert not bool(finite) and np.isfinite(float(loss))
    after = tree_leaves(params) + tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu)
    assert all(torch.equal(a.detach(), b) for a, b in zip(after, before))
    assert opt_state.step == 1
    assert float(scale.scale) == 2.0 ** 39 and int(scale.overflow_count) == 1


def test_loss_scaled_example_trains_on_cpu():
    out = tex.main(["--device", "cpu", "--steps", "20", "--batch", "16"])
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert out["overflows"] == 0 and out["loss_scale"] == 2.0 ** 12


def test_ae_train_cli_on_cpu(capsys):
    out = ttrain.main(["--device", "cpu", "--arch", "ae", "--batch", "16",
                       "--steps", "5", "--instrument"])
    assert out["arch"] == "ae" and out["policy"] == "paper_fp16"
    assert out["params"] == sum(int(np.prod(v.shape)) for d in jae.init_ae(
        jax.random.PRNGKey(0)).values() for v in d.values())
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 5 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    text = capsys.readouterr().out
    assert "[engine] matmul_dw: calls=10" in text and "final mse" in text
    for pol in ("tpu_fp16", "tpu_bf16", "fp32"):
        out = ttrain.main(["--device", "cpu", "--arch", "ae", "--batch", "8",
                           "--steps", "1", "--policy", pol])
        assert out["policy"] == pol and np.isfinite(out["history"][0]["loss"])
    with pytest.raises(ValueError, match="--arch ae only"):
        ttrain.main(["--device", "cpu", "--policy", "fp32", "--steps", "1"])


def _ref_events(ref_params, backend):
    x = jnp.asarray(JSyntheticAE(batch=16).sample(0))
    with je.instrument() as events:
        jax.eval_shape(lambda p: jax.value_and_grad(lambda q: jae.ae_loss(
            q, x, policy=jprec.PAPER_FP16, backend=backend)[0])(p), ref_params)
    return events


def _port_events(ref_params, backend):
    params = _port_params(ref_params)
    x = torch.from_numpy(SyntheticAE(batch=16).sample(0))
    with te.instrument() as events:
        loss, _ = tae.ae_loss(params, x, policy=tprec.PAPER_FP16, backend=backend)
        torch.autograd.grad(loss, tree_leaves(params))
    return events


def _split(events, what):
    out = {"fwd": 0, "bwd": 0}
    for e in events:
        out["bwd" if te.is_backward_op(e.spec.op) else "fwd"] += getattr(e, what)
    return out


def test_ae_train_events_reproduce_the_pins(ref_params):
    """30 kernel-1 dispatches one for one with the reference's, and the
    ae_train_B16 flop and byte pins, fused (hopper) and two-pass."""
    flops_pin = json.loads((BASELINES / "train_flops.json").read_text())["ae_train_B16"]
    bytes_pin = json.loads((BASELINES / "train_bytes.json").read_text())["ae_train_B16"]
    key = lambda e: (e.spec.op, e.spec.layout, e.spec.m, e.spec.n, e.spec.k,
                     e.spec.fused_bias_grad)
    fused = _port_events(ref_params, "hopper")
    want = _ref_events(ref_params, "interpret")
    assert len(fused) == 30
    assert [key(e) for e in fused] == [key(e) for e in want]
    assert sum(e.spec.fused_bias_grad for e in fused) == 10
    flops = _split(fused, "total_flops")
    assert flops == {"fwd": flops_pin["fwd"], "bwd": flops_pin["bwd"]}
    assert sum(flops.values()) == flops_pin["total"] == 25_362_432
    assert _split(fused, "total_bytes") == bytes_pin["fused"]
    te.register_backend("hopper_two_pass", te.get_backend("hopper").fn,
                        capabilities=("fused_epilogue", "tiled", "layouts"))
    try:
        two_pass = _port_events(ref_params, "hopper_two_pass")
    finally:
        te.unregister_backend("hopper_two_pass")
    assert _split(two_pass, "total_bytes") == bytes_pin["two_pass"]
    assert [key(e) for e in two_pass] == [key(e) for e in _ref_events(ref_params, "xla")]
