"""Sharded execution on two gloo ranks against the unsharded runs.

One spawn of two rank processes (``repro_torch.launch.mesh``) runs every
cell of a plan on reduced configs under the ``fp32`` policy; the tests
hold what rank 0 gathered against the port's unsharded run on the same
weights and against the JAX package's unsharded functions.  The weights
are the reference's own initial parameters (``repro.models.transformer.
init_params``, carried across by ``repro_torch.convert``), saved as a host
tree that each rank cuts to its blocks (``runtime.fault_tolerance.
reshard``).

Tolerances (fp32): sharded against unsharded 1e-5 relative to the largest
magnitude (the summation order of the cross-rank sums and of the
vocab-parallel log-sum-exp; the sequence-sharded serving path takes the
q-chunked attention where the unsharded one takes flash); against the
reference 1e-4, the bound of ``tests/test_torch_serve.py``.  Greedy tokens
and MoE routing are identical.  Finite differences of the collectives
(fp64, step 1e-6) agree to 1e-6.

FP8 on the mesh (the ``*_fp8`` and ``sched_*`` cells): every per-tensor
amax is reduced over the ranks holding the rest of the logical tensor.
Each such check runs beside a control cell (``*_local``) whose amaxes are
every rank's own block's (``launch/mesh.py::_local_amax``), which must miss it.
Under ``mixed_fp8_e4m3`` a dispatch scale equals the unsharded run's bit
for bit wherever the rank's block holds the unsharded operand's values:
every one on ``[2, 1]`` (forward and backward), and on ``[1, 2]`` every
weight's and every operand's before the first cross-rank partial sum
(after it the layouts differ by the sum's rounding, amplified by E4M3:
those are held to ``FP8_REST_TOL``, which the control exceeds).
The FP8 caches (fp32 policy) hold their scale leaves to 1e-5 relative
(``tests/test_torch_serve_fp8.py``'s bound across packages: fp32 rounding
of the new rows moves an amax by ulps) and their logits to the bounds
above.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as jt

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamW
from repro_torch.runtime import procs
from repro_torch.runtime import sharding as ts
from repro_torch.serving import kv_cache

QWEN, MOE, MLA = "qwen3-1.7b", "deepseek-moe-16b", "deepseek-v2-lite-16b"
FP8 = "float8_e4m3fn"
SERVE = dict(batch=2, prompt=8, gen=4)
TRAIN = dict(batch=4, seq=8, steps=2)
FWD = dict(batch=2, seq=8)
SCHED = dict(n_slots=2, requests=4, prompt=8, gen=4, audit_every=1)
FP8_STEP = dict(policy_name="mixed_fp8_e4m3", record_scales=True, batch=4, seq=8, steps=1)
# on [1, 2], a dispatch scale after the first cross-rank partial sum
# against the unsharded run's, relative: twice the sound run's largest gap
# rounded up to a power of two (read on the CPU: forward operands 1.54e-2,
# cotangents 1.03e-1; the local-amax control 3.68e-1 and 7.35e-1)
FP8_REST_TOL = {":x": 2.0 ** -5, ":w": 2.0 ** -5, ":dz": 2.0 ** -2}


def _rel(got, want) -> float:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _setup(arch, **repl):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name="fp32", **repl)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), policy_name="fp32", **repl)
    jparams = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = convert.params_from_jax(jparams, tcfg, device="cpu",
                                      dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


PLAN = [
    dict(name="collectives", kind="collectives", mesh=[1, 2]),
    dict(name="reshard", kind="reshard", arch=QWEN, mesh=[1, 2]),
    dict(name="serve", kind="serve", arch=QWEN, mesh=[1, 2], generate=True, **SERVE),
    dict(name="fwd", kind="forward", arch=QWEN, mesh=[1, 2], **FWD),
    dict(name="train_1x2", kind="train", arch=QWEN, mesh=[1, 2], **TRAIN),
    dict(name="train_2x1", kind="train", arch=QWEN, mesh=[2, 1], **TRAIN),
    dict(name="moe_gspmd", kind="forward", arch=MOE, mesh=[1, 2], **FWD),
    dict(name="moe_shard_map", kind="forward", arch=MOE, moe_impl="shard_map",
         mesh=[1, 2], **FWD),
    dict(name="moe_train_shard_map", kind="train", arch=MOE, moe_impl="shard_map",
         mesh=[1, 2], **TRAIN),
    dict(name="moe_serve_shard_map", kind="serve", arch=MOE, moe_impl="shard_map",
         mesh=[1, 2], **SERVE),
    # the layouts once refused on a mesh, weights drawn from the seed on each rank
    dict(name="sp_fwd", kind="forward", arch=QWEN, mesh=[1, 2],
         sequence_parallel=True, **FWD),
    dict(name="mla_fwd", kind="forward", arch="deepseek-v2-lite-16b", mesh=[1, 2],
         **FWD),
    dict(name="hymba_fwd", kind="forward", arch="hymba-1.5b", mesh=[1, 2], **FWD),
    dict(name="xlstm_fwd", kind="forward", arch="xlstm-1.3b", mesh=[1, 2], **FWD),
    dict(name="fsdp_fwd", kind="forward", arch=QWEN, mesh=[2, 1], fsdp=True, **FWD),
]
FORMERLY_REFUSED = ("sp_fwd", "mla_fwd", "hymba_fwd", "xlstm_fwd", "fsdp_fwd")
# FP8 on the mesh and the scheduler over ranks, each beside its control
FP8_PLAN = [
    dict(name="fwd_fp8_1x2", kind="train", arch=QWEN, mesh=[1, 2], **FP8_STEP),
    dict(name="fwd_fp8_2x1", kind="train", arch=QWEN, mesh=[2, 1], **FP8_STEP),
    dict(name="serve_fp8", kind="serve", arch=QWEN, mesh=[1, 2], storage_dtype=FP8,
         generate=True, **SERVE),
    dict(name="serve_fp8_heads", kind="serve", arch=QWEN, mesh=[1, 2], serve_rules=False,
         storage_dtype=FP8, generate=True, **SERVE),
    dict(name="mla_fp8", kind="serve", arch=MLA, mesh=[1, 2], storage_dtype=FP8,
         generate=True, **SERVE),
    dict(name="sched_dp", kind="sched", arch=QWEN, mesh=[2, 1], storage_dtype=FP8,
         inject="kv_corrupt@2", **SCHED),
]
PLAN += FP8_PLAN + [dict(c, name=c["name"] + "_local", local_amax=True) for c in FP8_PLAN] + [
    dict(name="sched_tp", kind="sched", arch=QWEN, mesh=[1, 2], inject="nan_logits@2",
         **SCHED),
    # a serving cache of 13 positions on a 2-way model axis: whole, as the
    # reference's sanitize_spec leaves it; and the scheduler's FP8 pool of
    # 17 positions so, with the audit and a KV corruption
    dict(name="serve_odd", kind="serve", arch=QWEN, mesh=[1, 2], generate=True,
         batch=2, prompt=8, gen=5, max_len=13),
    dict(name="sched_odd", kind="sched", arch=QWEN, mesh=[1, 2], storage_dtype=FP8,
         inject="kv_corrupt@2", max_len=17, **SCHED),
]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    setups = {QWEN: _setup(QWEN), MOE: _setup(MOE), MLA: _setup(MLA)}
    for arch, (_, _, _, tparams) in setups.items():
        torch.save(tparams, d / f"{arch}.pt")
    plan = [dict(c, policy_name=c.get("policy_name", "fp32"),
                 params=str(d / f"{c['arch']}.pt"))
            if c.get("arch") in setups else dict(c, policy_name="fp32")
            for c in PLAN]
    (d / "plan.json").write_text(json.dumps(plan))
    rc = procs.spawn(2, ["-m", "repro_torch.launch.mesh", "--device", "cpu",
                         "--plan", str(d / "plan.json"), "--out", str(d)],
                     run_dir=str(d), timeout=480)
    assert rc == 0, f"a rank failed with exit code {rc}"

    def load(name):
        infos = [json.loads((d / f"{name}.rank{r}.json").read_text()) for r in (0, 1)]
        return torch.load(d / f"{name}.pt", weights_only=False), infos

    return setups, load


def _teacher_forced(tparams, tcfg, prompts, fed, gen):
    """The unsharded port's prefill and decode steps on the tokens the
    sharded run fed."""
    S = prompts.shape[1]
    lg, cache = tt.prefill(tparams, tcfg, {"inputs": prompts}, S + gen)
    rows = [lg]
    for i in range(gen):
        lg, cache = tt.serve_step(tparams, tcfg, fed[:, i:i + 1], cache, S + i)
        rows.append(lg)
    return torch.stack(rows)


@pytest.mark.parametrize("cell,arch", [("serve", QWEN), ("moe_serve_shard_map", MOE)])
def test_serve_prefill_decode_matches_unsharded(run, cell, arch):
    setups, load = run
    jcfg, tcfg, jparams, tparams = setups[arch]
    if cell.startswith("moe"):
        tcfg = dataclasses.replace(tcfg, moe_impl="shard_map")
    out, infos = load(cell)
    prompts, fed, logits = out["prompts"], out["fed"], out["logits"]
    want = _teacher_forced(tparams, tcfg, prompts, fed, SERVE["gen"])
    assert _rel(logits, want) <= 1e-5
    # greedy: the fed tokens are the unsharded run's argmax too
    assert torch.equal(want[:-1].argmax(-1).T, fed)
    S = prompts.shape[1]
    if arch == QWEN:         # the reference, unsharded (MoE: the forward test)
        _reference_serve(jcfg, jparams, prompts, fed, logits)
    # the cache is cut over its sequence: each rank holds half the bytes
    whole = sum(t.numel() * t.element_size() for sub in tt.init_cache(
        tcfg, SERVE["batch"], S + SERVE["gen"], device="cpu").values()
        for t in sub.values())
    assert [i["kv_bytes"] for i in infos] == [whole // 2] * 2
    assert all(i["collectives_decode"]["psum"]["count"] > 0 for i in infos)


def _reference_serve(jcfg, jparams, prompts, fed, logits):
    S = prompts.shape[1]
    jl, jc = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompts.numpy())},
                        S + SERVE["gen"])
    rows = [np.asarray(jl)]
    for i in range(SERVE["gen"]):
        jl, jc = jt.serve_step(jparams, jcfg, jnp.asarray(fed[:, i:i + 1].numpy()),
                               jc, S + i)
        rows.append(np.asarray(jl))
    assert _rel(logits, np.stack(rows)) <= 1e-4


def test_serve_generate_matches_unsharded(run):
    setups, load = run
    _, tcfg, _, tparams = setups[QWEN]
    out, _ = load("serve")
    seqs, _, final = tserve.generate(tparams, tcfg, out["prompts"], SERVE["gen"],
                                     return_state=True)
    assert np.array_equal(out["gen_seqs"].numpy(), seqs)
    assert _rel(out["gen_final"], final) <= 1e-5


def _trainable(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone().requires_grad_(True)
    return {k: _trainable(v) for k, v in tree.items()}


def _unsharded_step(tcfg, tparams, steps_batches):
    opt = AdamW()
    params = _trainable(tparams)
    state = ttrain.TrainState(params, opt.init(params), ())
    step = ttrain.build_train_step(tcfg, opt, return_grads=True)
    losses, grads0 = [], None
    for i, b in enumerate(steps_batches):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            grads0 = m["grads"]
    return losses, grads0


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)))
    return out


@pytest.mark.parametrize("cell,arch", [("train_1x2", QWEN), ("train_2x1", QWEN),
                                       ("moe_train_shard_map", MOE)])
def test_train_step_matches_unsharded(run, cell, arch):
    setups, load = run
    jcfg, tcfg, jparams, tparams = setups[arch]
    if cell.startswith("moe"):
        tcfg = dataclasses.replace(tcfg, moe_impl="shard_map")
    out, infos = load(cell)
    from repro_torch.data import SyntheticLM
    ds = SyntheticLM(tcfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
               for i in range(TRAIN["steps"])]
    assert all(torch.equal(out["batch0"][k], batches[0][k]) for k in batches[0])
    losses, grads0 = _unsharded_step(tcfg, tparams, batches)
    for info in infos:
        np.testing.assert_allclose(info["losses"], losses, rtol=1e-5)
    got, want = _leaves(out["grads0"]), _leaves(grads0)
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    # the reference's loss and gradients at step 0, unsharded
    jb = {k: jnp.asarray(v.numpy()) for k, v in batches[0].items()}
    (jloss, _), jg = jax.value_and_grad(lambda p: jt.loss_fn(p, jcfg, jb),
                                        has_aux=True)(jparams)
    assert abs(infos[0]["losses"][0] - float(jloss)) <= 1e-4 * abs(float(jloss))
    for k, v in _leaves(jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), jg)
                        ).items():
        assert _rel(got[k], v) <= 1e-4, k


@pytest.mark.parametrize("cell", ["moe_gspmd", "moe_shard_map"])
def test_moe_forward_routes_match_unsharded(run, cell):
    setups, load = run
    jcfg, tcfg, jparams, tparams = setups[MOE]
    out, infos = load(cell)
    impl = cell.split("_", 1)[1]
    assert all(i["route"] == {impl: 2} for i in infos)   # two MoE layers
    tl, _, aux = tt.forward(tparams, dataclasses.replace(tcfg, moe_impl=impl),
                            {"inputs": out["tokens"]})
    assert _rel(out["logits"], tl.detach()) <= 1e-5
    jl, _, jaux = jt.forward(jparams, jcfg, {"inputs": jnp.asarray(out["tokens"].numpy())})
    assert _rel(out["logits"], np.asarray(jl)) <= 1e-4
    for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_frac"):
        assert abs(float(out[k]) - float(aux[k])) <= 1e-5 * max(abs(float(aux[k])), 1)
        assert abs(float(out[k]) - float(jaux[k])) <= 1e-4 * max(abs(float(jaux[k])), 1)


@pytest.mark.parametrize("fn", ["psum", "all_gather", "all_to_all", "redistribute"])
def test_collective_gradients_match_finite_differences(run, fn):
    _, load = run
    _, infos = load("collectives")
    for info in infos:
        assert info["fd_err"][fn] <= 1e-6


def test_reshard_then_gather_is_identity(run):
    _, load = run
    _, infos = load("reshard")
    assert all(i["params_identity"] and i["cache_identity"] for i in infos)


def _bill(events):
    out = {}
    for ev in events:
        b = out.setdefault(f"{ev.spec.op}/{ev.spec.policy.name}", [0, 0])
        b[0] += ev.total_flops
        b[1] += ev.total_bytes
    return out


# work the layout repeats on every rank: the gspmd route routes and
# combines every token on both ranks (flops and bytes twice)
REPEATED = {"fwd": (), "moe_shard_map": (),
            "moe_gspmd": ("matmul/router", "einsum2d/moe_combine")}


@pytest.mark.parametrize("cell", tuple(REPEATED))
def test_rank_summed_bill_equals_unsharded(run, cell):
    setups, load = run
    arch = QWEN if cell == "fwd" else MOE
    _, tcfg, _, tparams = setups[arch]
    if cell == "moe_shard_map":
        tcfg = dataclasses.replace(tcfg, moe_impl="shard_map")
    out, infos = load(cell)
    with engine.instrument() as events, torch.no_grad():
        tt.forward(tparams, tcfg, {"inputs": out["tokens"]})
    want = _bill(events)
    got: dict = {}
    for info in infos:
        for key, b in info["bill"].items():
            g = got.setdefault(key, [0, 0])
            g[0] += b["flops"]
            g[1] += b["bytes"]
    assert got.keys() == want.keys()
    for key in want:
        n = 2 if key in REPEATED[cell] else 1
        assert got[key][0] == n * want[key][0], key
        # bytes: every rank also reads a column-parallel GEMM's whole
        # activation and writes a row-parallel GEMM's whole (partial) output
        assert n * want[key][1] <= got[key][1] <= 2 * want[key][1], key


def test_formerly_refused_layouts_run_on_a_mesh(run):
    """Sequence parallelism, MLA, hymba, xLSTM and FSDP run a forward on
    the mesh (against the unsharded forward from the same seed); the FP8
    KV cache and the scheduler over a data axis with fault injection, once
    refused, build on a mesh description (their runs: the FP8 and
    scheduler cells below)."""
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serving import scheduler as tsched

    setups, load = run
    for name in FORMERLY_REFUSED:
        cell = next(c for c in PLAN if c["name"] == name)
        cfg = dataclasses.replace(tconfigs.get_reduced(cell["arch"]), policy_name="fp32")
        if cell["arch"] in setups:
            params = setups[cell["arch"]][3]
        else:
            params = tt.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        out, _ = load(name)
        want, _, _ = tt.forward(params, cfg, {"inputs": out["tokens"]})
        assert _rel(out["logits"], want.detach()) <= 1e-5, name
    mesh = tmesh.Mesh((1, 2), ("data", "model"), device="cpu")
    cfg = tconfigs.get_reduced(QWEN)
    params = tt.init_params(cfg, seed=0, device="cpu")
    with ts.use_rules(tserve.serve_rules()), ts.use_mesh(mesh):
        cache = tt.init_cache(cfg, 2, 8, storage_dtype=FP8, device="cpu")
    sub = cache["layers"]
    assert sub["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 4, cfg.head_dim)
    assert sub["k"].dtype == torch.float8_e4m3fn
    assert torch.equal(sub["k_scale"]["scale"], torch.ones(cfg.n_layers, cfg.n_kv_heads))
    scfg = tsched.SchedulerConfig(n_slots=2, max_len=8, storage_dtype=FP8, audit_every=1)
    for shape, mine in (((2, 1), [1]), ((1, 2), [0, 1])):
        dmesh = tmesh.Mesh(shape, ("data", "model"), rank=1, device="cpu")
        sched = tsched.Scheduler(params, cfg, scfg, FailureInjector(1, "kv_corrupt"),
                                 rules=tserve.serve_rules(), mesh=dmesh)
        assert sched._mine == mine
        assert sched.cache["layers"]["k"].shape[1] == len(mine)
    # FSDP where it cuts nothing (one data rank) runs as plain rules do
    with ts.use_rules(ts.Rules(fsdp=True)), ts.use_mesh(tmesh.make_host_mesh()):
        logits, _, _ = tt.forward(params, cfg, {"inputs": torch.zeros((2, 4), dtype=torch.long)})
    assert logits.shape == (2, 4, cfg.vocab_size)


# --------------------------------------------------------------------- #
# FP8 on the mesh and the serving scheduler over ranks
# --------------------------------------------------------------------- #
def _unsharded_scales(tcfg, tparams):
    """Every dispatch scale of the unsharded train step 0 under the
    ``mixed_fp8_e4m3`` policy on the cells' batch, in dispatch order."""
    from repro_torch.data import SyntheticLM

    cfg = dataclasses.replace(tcfg, policy_name="mixed_fp8_e4m3")
    ds = SyntheticLM(cfg.vocab_size, FP8_STEP["seq"], FP8_STEP["batch"], seed=0)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(0).items()}
    opt = AdamW()
    params = _trainable(tparams)
    state = ttrain.TrainState(params, opt.init(params), ())
    with engine.record_scales() as scales:
        ttrain.build_train_step(cfg, opt)(state, batch)
    return [[label, float(s)] for label, s in scales]


@pytest.mark.parametrize("cell", ["fwd_fp8_1x2", "fwd_fp8_2x1"])
def test_fp8_dispatch_scales_are_the_logical_tensors(run, cell):
    """Under mixed_fp8_e4m3 every FP8 dispatch of a train step (forward,
    remat recompute and the backward's cotangents) takes the logical
    tensor's amax: equal on both ranks, and the unsharded run's bit for bit
    wherever the rank's block holds the unsharded operand's values (every
    dispatch on [2, 1]; on [1, 2] every weight and every operand before the
    first cross-rank partial sum, layer 0's wqkv and wo).  On [1, 2] the
    rest differ from the unsharded run by that sum's rounding, which E4M3
    codes amplify: each is held to a relative bound of twice the sound
    run's largest gap, rounded up to a power of two (``FP8_REST_TOL``).
    The control, each rank's own amax, differs across the ranks and from
    the unsharded run where the scales are exact, and exceeds each bound
    of the rest."""
    setups, load = run
    _, tcfg, _, tparams = setups[QWEN]
    want = _unsharded_scales(tcfg, tparams)
    _, infos = load(cell)
    _, controls = load(cell + "_local")
    got = [i["scales0"] for i in infos]
    assert len(got[0]) == len(want) > 40
    assert got[0] == got[1]
    assert [g[0] for g in got[0]] == [w[0] for w in want]
    if cell.endswith("2x1"):
        exact = range(len(want))
    else:
        # the weights (every matmul's w here: attention's forward is flash,
        # its backward's einsum2d operands are activations) and layer 0's
        # wqkv and wo operands
        exact = [i for i, w in enumerate(want) if w[0] == "matmul:w" or i < 4]
    assert all(got[0][i] == want[i] for i in exact)
    ctl = [i["scales0"] for i in controls]
    assert ctl[0] != ctl[1]
    assert any(c[i] != want[i] for c in ctl for i in exact)
    rest = [i for i in range(len(want)) if i not in set(exact)]
    assert bool(rest) == cell.endswith("1x2")
    for kind, tol in FP8_REST_TOL.items():
        idx = [i for i in rest if want[i][0].endswith(kind)]
        if not idx:
            continue
        gap = lambda run: max(abs(run[i][1] - want[i][1]) / want[i][1] for i in idx)
        assert gap(got[0]) <= tol
        assert max(gap(c) for c in ctl) > tol


def _scale_rel(got: dict, want: dict) -> float:
    assert got.keys() == want.keys() and want
    return max(_rel(got[k], want[k]) for k in want)


def _cache_scales(cache) -> dict:
    return {f"{key}/{name}/{f}": t for key, sub in cache.items()
            for name, leaf in sub.items() if name.endswith("_scale")
            for f, t in leaf.items()}


@pytest.mark.parametrize("cell,arch", [("serve_fp8", QWEN), ("serve_fp8_heads", QWEN),
                                       ("mla_fp8", MLA)])
def test_fp8_cache_on_a_mesh_matches_unsharded(run, cell, arch):
    """The FP8 KV cache on the mesh: teacher-forced prefill and decode
    logits and the cache's scale leaves against the unsharded port on the
    same weights, and ``generate`` (the scheduler: prefill, admission into
    the pool, decode) against the unsharded port's and, for GQA, the
    reference's ``generate(..., storage_dtype=)``.  The control (local
    amaxes) misses the scale leaves where a rank holds part of a scale's
    rows (the sequence-cut caches); on the head-cut cache each rank holds
    its heads' scales whole, so there the control equals."""
    setups, load = run
    jcfg, tcfg, jparams, tparams = setups[arch]
    out, infos = load(cell)
    ctl, _ = load(cell + "_local")
    prompts, fed, G = out["prompts"], out["fed"], SERVE["gen"]
    S = prompts.shape[1]
    lg, cache = tt.prefill(tparams, tcfg, {"inputs": prompts}, S + G, storage_dtype=FP8)
    rows = [lg]
    for i in range(G):
        lg, cache = tt.serve_step(tparams, tcfg, fed[:, i:i + 1], cache, S + i)
        rows.append(lg)
    assert _rel(out["logits"], torch.stack(rows)) <= 1e-5
    assert _scale_rel(out["scales"], _cache_scales(cache)) <= 1e-5
    seqs, gcache, final = tserve.generate(tparams, tcfg, prompts, G, storage_dtype=FP8,
                                          return_state=True)
    assert np.array_equal(out["gen_seqs"].numpy(), seqs)
    assert _rel(out["gen_final"], final) <= 1e-5
    want = _cache_scales(gcache)
    assert _scale_rel(out["gen_scales"], want) <= 1e-5
    if cell == "serve_fp8_heads":
        assert _scale_rel(ctl["gen_scales"], want) <= 1e-5
    else:
        assert _scale_rel(ctl["gen_scales"], want) > 1e-3
    if arch == QWEN:        # the reference's generate on the FP8 cache
        jseqs, jcache, jfinal = jserve.generate(
            jparams, jcfg, jnp.asarray(prompts.numpy()), G, storage_dtype=FP8,
            return_state=True)
        assert np.array_equal(out["gen_seqs"].numpy(), np.asarray(jseqs))
        assert _rel(out["gen_final"], jfinal) <= 1e-4
        jscales = {k: torch.from_numpy(np.asarray(v)) for k, v in
                   _cache_scales(jax.tree.map(np.asarray, jcache)).items()}
        assert _scale_rel(out["gen_scales"], jscales) <= 1e-5
    if cell == "serve_fp8":     # the cache's positions cut: each rank half
        whole = sum(t.numel() * t.element_size()
                    for t in tt.init_cache(tcfg, 2, S + G, storage_dtype=FP8,
                                           device="cpu")["layers"].values()
                    if isinstance(t, torch.Tensor))
        assert [i["kv_bytes"] for i in infos] == [
            whole // 2 + sum(t.numel() * t.element_size()
                             for t in _cache_scales(cache).values())] * 2


def _reference_sched(jcfg, jparams, cell):
    from repro.runtime.fault_tolerance import FailureInjector as JInjector
    from repro.serving import loadgen as jloadgen
    from repro.serving import scheduler as jsched

    mode, _, at = cell["inject"].partition("@")
    s = jsched.Scheduler(jparams, jcfg, jsched.SchedulerConfig(
        n_slots=cell["n_slots"], max_len=cell.get("max_len", cell["prompt"] + cell["gen"] + 4),
        storage_dtype=cell.get("storage_dtype"), audit_every=cell["audit_every"]),
        injector=JInjector(fail_at_step=int(at), mode=mode))
    s.submit(jloadgen.poisson_requests(jcfg, jloadgen.LoadConfig(
        rate=1.0, n_requests=cell["requests"], prompt_len=cell["prompt"],
        gen_len=cell["gen"], seed=0)))
    return s, {r.rid: r for r in s.run()}


def _port_sched(tcfg, tparams, cell):
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serving import loadgen as tloadgen
    from repro_torch.serving import scheduler as tsched

    mode, _, at = cell["inject"].partition("@")
    s = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(
        n_slots=cell["n_slots"], max_len=cell.get("max_len", cell["prompt"] + cell["gen"] + 4),
        storage_dtype=cell.get("storage_dtype"), audit_every=cell["audit_every"]),
        FailureInjector(fail_at_step=int(at), mode=mode))
    s.submit(tloadgen.poisson_requests(tcfg, tloadgen.LoadConfig(
        rate=1.0, n_requests=cell["requests"], prompt_len=cell["prompt"],
        gen_len=cell["gen"], seed=0)))
    return s, {r.rid: r for r in s.run()}


@pytest.mark.parametrize("cell,detect", [("sched_dp", "kv_quarantine"),
                                         ("sched_tp", "nan_detect"),
                                         ("sched_odd", "kv_quarantine")])
def test_sharded_scheduler_matches_the_reference(run, cell, detect):
    """The scheduler on the mesh: over the data axis with the FP8 cache
    and a KV corruption at decode step 2 (audited every step), over the
    model axis with NaN logits at step 2, and over the model axis on an
    FP8 pool of 17 positions (whole on every rank: the reference's
    sanitize_spec) with the corruption.  Every rank writes the same trace
    and tokens (digests), and holds the same bytes in every pool leaf its
    spec leaves whole; the trace (injection, detection and recovery
    included) is the unsharded port's and the reference ``Scheduler``'s;
    tokens are equal (fp32), final logits within 1e-5 / 1e-4, the FP8
    pool's scale leaves within 1e-5 of the unsharded run's.  The data-axis
    FP8 cell's control (local amaxes) misses its logits; on the whole pool
    every rank writes every row, so no amax is partial there."""
    setups, load = run
    jcfg, tcfg, jparams, tparams = setups[QWEN]
    spec = next(c for c in PLAN if c["name"] == cell)
    out, infos = load(cell)
    assert len({i["trace_digest"] for i in infos}) == 1
    assert len({i["tokens_digest"] for i in infos}) == 1
    assert len({i["whole_leaves_digest"] for i in infos}) == 1
    ts_, tr = _port_sched(tcfg, tparams, spec)
    js_, jr = _reference_sched(jcfg, jparams, spec)
    want = [list(e) for e in ts_.trace]
    assert out["trace"] == want == [list(e) for e in js_.trace]
    assert [e[0] for e in want].count(detect) == 1 and "recover" in [e[0] for e in want]
    for rid, r in tr.items():
        assert out["tokens"][rid] == r.tokens == jr[rid].tokens
        assert _rel(out["final_logits"][rid], r.final_logits) <= 1e-5
        assert _rel(out["final_logits"][rid], jr[rid].final_logits) <= 1e-4
    if spec.get("storage_dtype"):
        assert _scale_rel(out["scales"], _cache_scales(ts_.cache)) <= 1e-5
        health = kv_cache.scale_health(ts_.cache)
        assert infos[0]["scale_health"] == infos[1]["scale_health"]
        assert {k: v["overflow_total"] for k, v in infos[0]["scale_health"].items()} == \
            {k: v["overflow_total"] for k, v in health.items()}
        assert all(abs(infos[0]["scale_health"][k]["max_scale"] - v["max_scale"])
                   <= 1e-5 * v["max_scale"] for k, v in health.items())
    if cell == "sched_dp":
        ctl, _ = load(cell + "_local")
        assert max(_rel(ctl["final_logits"][rid], r.final_logits)
                   for rid, r in tr.items()) > 1e-3
    assert all(i["collectives"]["all_gather"]["count"] > 0 for i in infos)


def test_serving_cache_of_indivisible_length_stays_whole(run):
    """A serving cache of 13 positions on a 2-way model axis: every rank
    holds it whole (the reference's sanitize_spec) and attention runs
    head-parallel on its KV heads; prefill, decode and generate match the
    unsharded run."""
    setups, load = run
    _, tcfg, _, tparams = setups[QWEN]
    out, infos = load("serve_odd")
    S, G, T = 8, 5, 13
    assert S + G == T
    want = _teacher_forced(tparams, tcfg, out["prompts"], out["fed"], G)
    assert _rel(out["logits"], want) <= 1e-5
    whole = sum(t.numel() * t.element_size() for sub in tt.init_cache(
        tcfg, 2, T, device="cpu").values() for t in sub.values())
    assert [i["kv_bytes"] for i in infos] == [whole] * 2
    seqs, _, final = tserve.generate(tparams, tcfg, out["prompts"], G, return_state=True)
    assert np.array_equal(out["gen_seqs"].numpy(), seqs)
    assert _rel(out["gen_final"], final) <= 1e-5
