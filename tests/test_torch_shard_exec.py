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
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
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

QWEN, MOE = "qwen3-1.7b", "deepseek-moe-16b"
SERVE = dict(batch=2, prompt=8, gen=4)
TRAIN = dict(batch=4, seq=8, steps=2)
FWD = dict(batch=2, seq=8)


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    setups = {QWEN: _setup(QWEN), MOE: _setup(MOE)}
    for arch, (_, _, _, tparams) in setups.items():
        torch.save(tparams, d / f"{arch}.pt")
    plan = [dict(c, policy_name="fp32", params=str(d / f"{c['arch']}.pt"))
            if c.get("arch") in setups else dict(c, policy_name="fp32")
            for c in PLAN]
    (d / "plan.json").write_text(json.dumps(plan))
    rc = procs.spawn(2, ["-m", "repro_torch.launch.mesh", "--device", "cpu",
                         "--plan", str(d / "plan.json"), "--out", str(d)],
                     run_dir=str(d), timeout=240)
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


def test_unported_layouts_refuse_on_a_mesh(run):
    """Sequence parallelism, MLA, hymba, xLSTM and FSDP run a forward on
    the mesh (against the unsharded forward from the same seed); the FP8
    KV cache and the scheduler over a data axis or with fault injection
    still refuse, naming ROADMAP (on a mesh description: the refusals come
    before any collective)."""
    from repro_torch.models import attention as tattn
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
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt.init_cache(cfg, 2, 8, storage_dtype="float8_e4m3fn", device="cpu")
    fp8 = tattn.init_gqa_cache(cfg, 2, 8, cfg.policy.compute_dtype, "float8_e4m3fn",
                               device="cpu")
    layer0 = {k: v[0] for k, v in params["layers"]["attn"].items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.gqa_attention(layer0, torch.zeros((2, 4, cfg.d_model)), cfg, pos_offset=0,
                            cache=fp8, policy=cfg.policy,
                            shard=ts.ShardCtx(tserve.serve_rules(), mesh))
    scfg = tsched.SchedulerConfig(n_slots=2, max_len=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsched.Scheduler(params, cfg, scfg, rules=tserve.serve_rules(),
                         mesh=tmesh.Mesh((2, 1), ("data", "model"), device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsched.Scheduler(params, cfg, scfg, FailureInjector(1, "nan_logits"),
                         rules=tserve.serve_rules(), mesh=mesh)
    # FSDP where it cuts nothing (one data rank) runs as plain rules do
    with ts.use_rules(ts.Rules(fsdp=True)), ts.use_mesh(tmesh.make_host_mesh()):
        logits, _, _ = tt.forward(params, cfg, {"inputs": torch.zeros((2, 4), dtype=torch.long)})
    assert logits.shape == (2, 4, cfg.vocab_size)
