"""The port's training path against the JAX package (reduced xlstm-1.3b).

* the model's loss and every gradient against
  ``jax.value_and_grad(transformer.loss_fn)`` under the ``"interpret"``
  backend, so both sides run the chunked-linear-attention sweep kernel
  (the port's plain version of it here), and the engine events by op;
* one ``build_train_step`` step — updated parameters, AdamW moments,
  loss and gradient norm — against the reference's;
* the optimizer pieces, the ``SyntheticLM`` stream, and the CLI.

Inputs come from numpy seeds; the reference's initial parameters are
carried across with ``repro_torch.convert``.  Tolerances are relative to
the largest reference magnitude: fp32 1e-4 through the whole model (the
two sides sum in different orders over a few hundred fp32 ops per value).
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
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro.optim import optimizer as jopt

from repro_torch import configs as tconfigs
from repro_torch import convert, resolve_device
from repro_torch.core import engine as te
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizer as topt

TOL = 1e-4


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k in tree for item in _paths(tree[k], prefix + (k,))]


@pytest.fixture(scope="module")
def fp32_xlstm():
    jcfg = dataclasses.replace(jconfigs.get_reduced("xlstm-1.3b"), policy_name="fp32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("xlstm-1.3b"), policy_name="fp32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams


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


def _by_op(events):
    out = collections.Counter()
    for e in events:
        out[(e.spec.op, e.spec.flops, e.spec.bytes, e.recompute)] += e.count
    return out


def test_reduced_xlstm_loss_grads_and_events_match_reference(fp32_xlstm):
    """Both sides run remat="full" and the sweep kernel (S = 24, chunk 16:
    one padded chunk).  Events match by op, flops, bytes and the
    recompute tag, except one documented difference: the reference bills
    the forward of the sweep backward's recompute composition a second
    time, recompute-tagged (its custom-VJP primal and fwd rule both trace
    inside the remat region's backward); the port runs and bills it once."""
    jcfg, tcfg, jparams = fp32_xlstm
    b = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    f = jax.jit(jax.value_and_grad(lambda p, x: jt.loss_fn(p, jcfg, x), has_aux=True))
    with je.use_backend("interpret"), je.instrument() as jev:
        (jloss, _), jgrads = f(jparams, jb)
    tparams = _tparams(jparams, tcfg)
    leaves = topt.tree_leaves(tparams)
    with te.instrument() as tev:
        tloss, _ = tt.loss_fn(tparams, tcfg, {k: torch.from_numpy(v).long()
                                              for k, v in b.items()})
        tgrads = torch.autograd.grad(tloss, leaves)
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(zip((p for p, _ in _paths(tparams)), tgrads))
    assert set(got) == set(want)
    for path, g in got.items():
        assert _rel(g, want[path]) <= TOL, path

    # the reference's second, recompute-tagged bill of the composition
    # forward: one per mLSTM layer, at this layer's sweep shape
    B, S = b["inputs"].shape
    H, hd = jcfg.n_heads, jcfg.ssm.mlstm_proj_factor * jcfg.d_model // jcfg.n_heads
    z = jnp.zeros((B, H, S, hd), jnp.float32)
    with je.instrument() as comp:
        je._linear_attention_reference(z, z, z, z[..., 0], chunk=jcfg.ssm.chunk,
                                       state=None, backend="interpret")
    n_mlstm = jcfg.n_layers // jcfg.ssm.slstm_period * (jcfg.ssm.slstm_period - 1)
    extra = collections.Counter({(op, fl, by, True): n * n_mlstm
                                 for (op, fl, by, _), n in _by_op(comp).items()})
    assert all(_by_op(jev)[k] >= n for k, n in extra.items())
    assert _by_op(tev) == _by_op(jev) - extra
    sweeps = [e for e in tev if e.spec.op == "linear_attention_state"]
    assert [e.recompute for e in sweeps] == [False] * n_mlstm + [True] * n_mlstm


def test_train_step_matches_reference(fp32_xlstm):
    """One AdamW step (warmup, global-norm clipping at 1.0): parameters,
    both moments, loss and gradient norm.  A first AdamW step moves each
    parameter by lr * g / (|g| + eps): ~lr * sign(g), but for a gradient
    within the fp32 summation noise of zero the direction follows that
    noise.  Parameters are therefore compared absolutely: to 1 % of one
    step's lr where |g| is above 1e-3 of the tensor's largest gradient, and
    to within one step (2 lr) elsewhere."""
    jcfg, tcfg, jparams = fp32_xlstm
    b = _batch(1)
    opt_kw = dict(lr=3e-3, warmup_steps=10, weight_decay=0.01)
    jo = jopt.AdamW(**opt_kw)
    jstate = jtrain.TrainState(params=jparams, opt=jo.init(jparams), scale=())
    jstep = jax.jit(jtrain.build_train_step(jcfg, jo, None))
    with je.use_backend("xla"):
        jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    to = topt.AdamW(**opt_kw)
    tparams = _tparams(jparams, tcfg)
    tstate = ttrain.TrainState(tparams, to.init(tparams), ())
    tnew, tm = ttrain.build_train_step(tcfg, to)(tstate, b)
    assert tnew.opt.step == 1
    assert _rel(tm["loss"], jm["loss"]) <= TOL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= TOL
    for tree_t, tree_j in ((tnew.opt.mu, jnew.opt.mu), (tnew.opt.nu, jnew.opt.nu)):
        want = dict(_paths(jax.tree.map(np.asarray, tree_j)))
        for path, t in _paths(tree_t):
            assert _rel(t, want[path]) <= 2 * TOL, path      # nu ~ g^2
    lr1 = 3e-3 * 2 / 10                            # the schedule at step 1
    mu = dict(_paths(jax.tree.map(np.asarray, jnew.opt.mu)))
    want = dict(_paths(jax.tree.map(np.asarray, jnew.params)))
    for path, t in _paths(tnew.params):
        err = np.abs(t.detach().numpy() - want[path])
        g = np.abs(mu[path])                        # (1 - b1) |g|
        settled = g > 1e-3 * max(g.max(), 1e-30)
        assert err[settled].max(initial=0.0) <= 1e-2 * lr1, path
        assert err.max() <= 2.1 * lr1, path         # at most one step apart


@pytest.mark.parametrize("accum", (1, 2))
def test_grad_accum_averages_microbatch_grads(fp32_xlstm, accum):
    jcfg, tcfg, jparams = fp32_xlstm
    b = _batch(2, B=4, S=16)
    opt = topt.SGD(lr=0.1, momentum=0.0)
    tparams = _tparams(jparams, tcfg)
    state = ttrain.TrainState(tparams, opt.init(tparams), ())
    step = ttrain.build_train_step(tcfg, opt, clip_norm=1e9, grad_accum=accum)
    new, m = step(state, b)
    jo = jopt.SGD(lr=0.1, momentum=0.0)
    jstate = jtrain.TrainState(jparams, jo.init(jparams), ())
    with je.use_backend("xla"):
        jnew, jm = jax.jit(jtrain.build_train_step(jcfg, jo, None, clip_norm=1e9,
                                                   grad_accum=accum))(
            jstate, {k: jnp.asarray(v) for k, v in b.items()})
    assert _rel(m["loss"], jm["loss"]) <= TOL
    want = dict(_paths(jax.tree.map(np.asarray, jnew.opt.mu)))  # mu = grad
    for path, t in _paths(new.opt.mu):
        assert _rel(t, want[path]) <= TOL, path


def test_cast_params_casts_at_entry_and_rewidens_grads():
    """``cast_params`` (the reference's: compute-dtype copies of the fp32
    masters at step entry, grads re-widened at the cast boundary).  Every
    op casts its weights to bf16 anyway, so on masters that are already
    bf16 values the step computes the same loss, and each gradient is the
    bf16 rounding of the uncast step's fp32 gradient — exactly, except the
    embedding's, whose repeated-token rows are summed in bf16."""
    cfg = tconfigs.get_reduced("xlstm-1.3b")
    opt = topt.SGD(lr=0.1, momentum=0.0)
    masters = ttrain.init_state(cfg, opt, seed=1, device="cpu").params
    masters = topt.tree_map(lambda p: p.detach().to(torch.bfloat16).float(), masters)
    fresh = lambda: topt.tree_map(lambda p: p.clone().requires_grad_(True), masters)
    b = _batch(4, S=16)
    runs = []
    for cast in (True, False):
        params = fresh()
        step = ttrain.build_train_step(cfg, opt, clip_norm=1e9, cast_params=cast)
        runs.append(step(ttrain.TrainState(params, opt.init(params), ()), b))
    (cast_state, cast_m), (plain_state, plain_m) = runs
    assert torch.equal(cast_m["loss"], plain_m["loss"])
    plain = dict(_paths(plain_state.opt.mu))
    for path, g in _paths(cast_state.opt.mu):
        assert g.dtype == torch.float32
        want = plain[path].to(torch.bfloat16).float()
        if path == ("embed",):
            torch.testing.assert_close(g, want, rtol=2.0 ** -7, atol=0)
        else:
            assert torch.equal(g, want), path


def test_optimizer_pieces_match_reference():
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}

    def tree(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params, grads = tree(1.0), tree(3.0)
    to_torch = lambda t: jax.tree.map(torch.from_numpy, t)
    tp, tg = to_torch(params), to_torch(grads)
    assert _rel(topt.global_norm(tg), jopt.global_norm(grads)) <= 1e-6
    jclipped, jn = jopt.clip_by_global_norm(grads, 2.0)
    tclipped, tn = topt.clip_by_global_norm(topt.tree_map(torch.clone, tg), 2.0)
    assert _rel(tn, jn) <= 1e-6
    for (_, t), (_, j) in zip(_paths(tclipped), _paths(jax.tree.map(np.asarray, jclipped))):
        assert _rel(t, j) <= 1e-6
    for opt_kw in (dict(lr=1e-2, warmup_steps=3, weight_decay=0.1),
                   dict(lr=1e-3, warmup_steps=0)):
        jo, to = jopt.AdamW(**opt_kw), topt.AdamW(**opt_kw)
        js, ts = jo.init(params), to.init(tp)
        jparams, tparams = params, topt.tree_map(torch.clone, tp)
        for _ in range(4):                       # through the warmup
            ju, js = jo.update(grads, js, jparams)
            jparams = jo.apply(jparams, ju)
            tu, ts = to.update(topt.tree_map(torch.clone, tg), ts, tparams)
            tparams = to.apply(tparams, tu)
        for (_, t), (_, j) in zip(_paths(tparams), _paths(jax.tree.map(np.asarray, jparams))):
            assert _rel(t, j) <= 1e-6
    jo, to = jopt.SGD(lr=0.1), topt.SGD(lr=0.1)
    js, ts = jo.init(params), to.init(tp)
    for _ in range(2):
        ju, js = jo.update(grads, js, params)
        tu, ts = to.update(tg, ts, tp)
    for (_, t), (_, j) in zip(_paths(tu), _paths(jax.tree.map(np.asarray, ju))):
        assert _rel(t, j) <= 1e-6


@pytest.mark.parametrize("step", (0, 7))
def test_synthetic_lm_batches_are_identical(step):
    kw = dict(vocab_size=50304, seq_len=64, global_batch=4, seed=3, doc_len=32)
    jb, tb = JSyntheticLM(**kw).batch(step), TSyntheticLM(**kw).batch(step)
    assert set(jb) == set(tb) == {"inputs", "labels"}
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k])


def test_train_cli_on_cpu(capsys):
    out = ttrain.main(["--device", "cpu", "--arch", "xlstm-1.3b", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--instrument"])
    assert out["arch"] == "xlstm-1.3b" and out["device"] == "cpu"
    assert len(out["history"]) == 2
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["step_ms"] > 0
    text = capsys.readouterr().out
    assert "[engine] linear_attention_state" in text
    assert "[engine] matmul_dw" in text and "final loss" in text


def test_full_width_config_matches_reference():
    jcfg, tcfg = jconfigs.get("xlstm-1.3b"), tconfigs.get("xlstm-1.3b")
    assert tt.count_params(tcfg) == jt.count_params(jcfg) == 2_020_481_360
    for f in dataclasses.fields(tcfg):
        if f.name != "ssm":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(jcfg.ssm)


def test_train_unported_paths_raise():
    # the AutoEncoder under an FP8 policy trains (tests/test_torch_fp8.py)
    out = ttrain.main(["--device", "cpu", "--arch", "ae", "--policy",
                       "mixed_fp8_e4m3", "--batch", "8", "--steps", "1"])
    assert out["policy"] == "mixed_fp8_e4m3" and np.isfinite(out["history"][0]["loss"])
    # --fp16-scale trains (tests/test_torch_lm_train.py), and so do
    # --ckpt-dir, --compress / --dp-procs, --fail-step and --result
    # (tests/test_torch_checkpoint_ft.py, test_torch_ft_gates.py); since the
    # sharding slice so do sharding rules (outside a mesh the reference's
    # no-op; on two ranks tests/test_torch_shard_exec.py), and MLA and the
    # recurrent kinds run under a mesh too (tests/test_torch_shard_layouts.py):
    # on a mesh description the step now gets past every refusal to its
    # first collective
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import sharding as ts
    qcfg = tconfigs.get_reduced("qwen3-1.7b")
    toks = torch.zeros((2, 8), dtype=torch.long)
    states = []
    for rules in (None, ts.Rules()):
        st = ttrain.init_state(qcfg, topt.AdamW(), seed=0, device="cpu")
        st, m = ttrain.build_train_step(qcfg, topt.AdamW(), rules=rules)(
            st, {"inputs": toks, "labels": toks})
        states.append((st, float(m["loss"])))
    assert states[0][1] == states[1][1]
    mcfg = tconfigs.get_reduced("deepseek-v2-lite-16b")
    st = ttrain.init_state(mcfg, topt.AdamW(), seed=0, device="cpu")
    step, _ = ttrain.make_sharded_train_step(
        mcfg, tmesh.Mesh((1, 2), ("data", "model"), device="cpu"), ts.Rules(),
        topt.AdamW())
    with pytest.raises(RuntimeError, match="not bound to a process group"):
        step(st, {"inputs": toks, "labels": toks})
    # hymba-1.5b trains and xlstm serves from its decode state now
    # (tests/test_torch_recurrent.py); remat "dots" runs: xLSTM's loss is
    # finite and equals "full"'s
    cfg = dataclasses.replace(tconfigs.get_reduced("xlstm-1.3b"), remat="dots")
    params = tt.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    loss_dots = tt.loss_fn(params, cfg, {"inputs": toks, "labels": toks})[0]
    loss_full = tt.loss_fn(params, dataclasses.replace(cfg, remat="full"),
                           {"inputs": toks, "labels": toks})[0]
    assert torch.isfinite(loss_dots) and torch.equal(loss_dots, loss_full)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main(["--steps", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
