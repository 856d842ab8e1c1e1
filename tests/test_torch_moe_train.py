"""Training the two DeepSeek architectures (MoE + MLA, MoE + MHA)
against the JAX package, and the parameter init they need at full width.

* reduced, fp32: one training batch's loss (cross-entropy plus the
  weighted aux and z losses), every gradient, the summed router metrics
  and the step's GEMM events (forward, remat recompute of the MoE layers,
  dX / dW), with the reference's parameters (``repro_torch.convert``) and
  its kernels on "interpret";
* three AdamW steps (clip, warmup) of the train step: losses, router
  metrics and the parameters after them;
* the train CLI on the CPU with ``--arch`` for each, printing the router
  metrics every step;
* ``init_tree`` draws a large stacked leaf slice by slice (the full
  deepseek-v2-lite-16b expert stack would otherwise need two 38 GB fp32
  transients on the card).

Tolerances: fp32 1e-4 of the largest reference magnitude (summation
order); the router metrics 1e-5 relative; events exactly.  After AdamW
steps a parameter moves by ~lr * sign(m): where the first moment is below
1 % of its tensor's largest the sign is rounding, so parameters are held
to 1 % of one step where it is above, and within the steps taken
elsewhere.
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
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizer as topt

ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
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


def _setup(arch):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name="fp32")
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), policy_name="fp32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def fp32(request):
    return _setup(request.param)


def _batch(jcfg, seed=1):
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2, seed=seed)
    jb, tb = JSyntheticLM(**kw).batch(0), TSyntheticLM(**kw).batch(0)
    assert all(np.array_equal(jb[k], tb[k]) for k in jb)
    return jb, tb


def _by_op(events):
    out = collections.Counter()
    for e in events:
        s = e.spec
        out[(s.op, s.tag, s.flops, s.bytes, e.recompute)] += e.count
    return out


def test_loss_grads_and_events_match_reference(fp32):
    """One training batch: the loss (cross-entropy plus the weighted aux and
    z losses), every gradient, the summed router metrics, and — where both
    sides run the q-chunked attention (MLA) — every GEMM event of the step
    (forward, remat recompute of the MoE layers, dX / dW); the MHA arch
    runs kernel 3 where the reference runs the q-chunked matmuls, so its
    attention events (batched tags) are left out there."""
    jcfg, tcfg, jparams, tparams = fp32
    jb, tb = _batch(jcfg)
    f = jax.jit(jax.value_and_grad(lambda p, x: jt.loss_fn(p, jcfg, x), has_aux=True))
    with je.use_backend("interpret"), je.instrument() as jev:
        (jloss, jm), jgrads = f(jparams, {k: jnp.asarray(v) for k, v in jb.items()})
    for p in topt.tree_leaves(tparams):
        p.requires_grad_(True)
    with te.instrument() as tev:
        tloss, tm = tt.loss_fn(tparams, tcfg, ttrain._to_device(tb, torch.device("cpu")))
        tgrads = torch.autograd.grad(tloss, topt.tree_leaves(tparams))
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_frac"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1), k
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    for (path, _), g in zip(_paths(tparams), tgrads):
        assert _rel(g, want[path]) <= TOL, path
    if tcfg.mla:
        assert _by_op(tev) == _by_op(jev)
    else:
        # every event but the attention's and the batched backward's
        mine = lambda e: e.spec.tag in ("mn,nk->mk", "mk,nk->mn", "mn,mk->nk",
                                        "gmn,gnk->gmk", "bskd,bsk->bsd")
        assert _by_op(filter(mine, tev)) == _by_op(filter(mine, jev))


def test_three_adamw_steps_match_reference():
    """The MLA + MoE arch, the one the card trains at full width."""
    jcfg, tcfg, jparams, tparams = _setup(ARCHS[0])
    jo, to = jopt.AdamW(lr=3e-3, warmup_steps=10), topt.AdamW(lr=3e-3, warmup_steps=10)
    jstate = jtrain.TrainState(params=jparams, opt=jo.init(jparams), scale=())
    for p in topt.tree_leaves(tparams):
        p.requires_grad_(True)
    tstate = ttrain.TrainState(tparams, to.init(tparams), ())
    jstep = jax.jit(jtrain.build_train_step(jcfg, jo, None))
    tstep = ttrain.build_train_step(tcfg, to)
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2, seed=4)
    jds, tds = JSyntheticLM(**kw), TSyntheticLM(**kw)
    for i in range(3):
        with je.use_backend("interpret"):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        tstate, tm = tstep(tstate, tds.batch(i))
        for k in ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss", "moe_drop_frac"):
            assert abs(float(tm[k]) - float(jm[k])) <= TOL * max(abs(float(jm[k])), 1e-3), (i, k)
    lr_sum = 3e-3 * (1 + 2 + 3) / 10
    mu = dict(_paths(jax.tree.map(np.asarray, jstate.opt.mu)))
    want = dict(_paths(jax.tree.map(np.asarray, jstate.params)))
    for path, t in _paths(tstate.params):
        err = np.abs(t.detach().numpy() - want[path])
        g = np.abs(mu[path])
        settled = g > 1e-2 * max(g.max(), 1e-30)
        assert err[settled].max(initial=0.0) <= 1e-2 * 3e-3 * 3 / 10, path
        assert err.max() <= 2 * lr_sum, path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu_prints_the_router_metrics(arch, capsys):
    out = ttrain.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--seq", "24", "--steps", "3", "--layers", "2"])
    assert out["arch"] == arch and len(out["history"]) == 3
    for h in out["history"]:
        for k in ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss", "moe_drop_frac"):
            assert np.isfinite(h[k]), k
    printed = capsys.readouterr().out
    assert printed.count("moe_aux_loss=") == 3 and "moe_drop_frac=" in printed


def test_large_stacked_leaves_are_drawn_slice_by_slice(monkeypatch):
    """A stacked leaf above ``SLICE_DRAW_ELEMS`` is drawn one leading slice
    at a time, each from its own seed: deterministic from the seed, each
    slice the draw of its own path; leaves at or under the limit keep the
    whole-leaf draw (so their values do not change)."""
    schema = {"big": tlayers.Param((3, 4, 5)), "mat": tlayers.Param((6, 7)),
              "small": tlayers.Param((2, 3, 4))}

    def init(seed):
        return tlayers.init_tree(schema, seed=seed, device=torch.device("cpu"),
                                 dtype=torch.float32)

    whole = init(0)
    monkeypatch.setattr(tlayers, "SLICE_DRAW_ELEMS", 40)
    a, b = init(0), init(0)
    for name in schema:
        assert torch.equal(a[name], b[name])
    for name in ("mat", "small"):
        assert torch.equal(a[name], whole[name])
    assert not torch.equal(a["big"], whole["big"])
    assert not torch.equal(a["big"][0], a["big"][1])
    gen = torch.Generator()
    for i in range(3):
        gen.manual_seed(tlayers._path_seed(0, ("big", str(i))))
        assert torch.equal(a["big"][i], torch.randn((4, 5), generator=gen) * 4 ** -0.5)
