"""Every architecture under the reference's dry-run layouts on gloo ranks.

The reference's dry run (``repro.launch.dryrun``) runs three layouts:
training under ``Rules(fsdp=True, sequence_parallel=sp)`` with
``grad_accum``, prefill under ``serve_rules(Rules(sequence_parallel=sp))``
and decode under ``serve_rules(Rules())``.  One spawn of two rank
processes (``repro_torch.launch.mesh``) and one of four (FSDP x TP on a
``(2, 2)`` mesh) run those layouts on reduced configs under the ``fp32``
policy: FSDP, sequence parallelism, ``grad_accum``, MLA
(deepseek-v2-lite-16b), hymba-1.5b and xlstm-1.3b, and a decode cache
under ``Rules()``.  The weights are the reference's own initial
parameters (``repro_torch.convert``), saved as a host tree that each rank
cuts to its blocks.

Every cell is held against the port's unsharded run on the same weights
(1e-5 of the largest magnitude: the summation order of the cross-rank
sums; a gradient whose fp32 floor lies higher within 3x that floor,
measured as the gap of the unsharded gradients to the reference's and to
those of the same network with its MLP hidden units renumbered)
and against the JAX package's unsharded functions (1e-4); greedy
tokens and MoE drop fractions are identical.  Each rank's resident
parameter, moment and cache bytes equal the local blocks of the sanitized
spec trees exactly, the replicated recurrent states are bitwise equal
across ranks, and every cell has a control that must fail its bound: the
unsharded run with one rank's block of a cut weight negated.

hymba-1.5b's 25 query / 5 KV heads do not divide a model axis of 2 and its
fused ``wqkv`` is cut inside a query head; the reduced config (4 / 2
heads) would hide that, so the hymba cells also run ``n_heads=5,
n_kv_heads=1, vocab_size=511`` with ``d_model=80``: the reference's Mamba
mixer splits ``d_model`` over ``n_heads`` SSD heads, which 64 does not
allow for 5, and 80 is the nearest width that does (``wqkv``'s 112
columns are cut at 56, inside q head 3; ``wo``'s 80 rows at 40, inside
head 2).
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
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamW
from repro_torch.runtime import procs
from repro_torch.runtime import sharding as ts

QWEN, MLA, HYMBA, XLSTM = ("qwen3-1.7b", "deepseek-v2-lite-16b", "hymba-1.5b",
                           "xlstm-1.3b")
HYMBA5 = "hymba5"       # hymba with heads that do not divide (module docstring)
OVERRIDES = {HYMBA5: dict(n_heads=5, n_kv_heads=1, d_model=80, vocab_size=511)}
ARCH = {QWEN: QWEN, MLA: MLA, HYMBA: HYMBA, XLSTM: XLSTM, HYMBA5: HYMBA}
SERVE = dict(batch=2, prompt=8, gen=4)
TRAIN = dict(batch=4, seq=8, steps=2)
TOL, REF_TOL = 1e-5, 1e-4
TOL16 = 2 ** -8     # a 16-bit cell's loss against the unsharded 16-bit run
FLOOR_X = 3     # a gradient's bound: at least 3x its measured fp32 floor


def _rel(got, want) -> float:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _setup(key):
    repl = dict(policy_name="fp32", **OVERRIDES.get(key, {}))
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH[key]), **repl)
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH[key]), **repl)
    init = jax.jit(lambda key: jt.init_params(key, jcfg))
    jparams = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    tparams = convert.params_from_jax(jparams, tcfg, device="cpu",
                                      dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


def _cell(name, kind, key, mesh, **kw):
    base = dict(SERVE if kind == "serve" else TRAIN, **kw)
    return dict(name=name, kind=kind, key=key, arch=ARCH[key], mesh=mesh,
                overrides=OVERRIDES.get(key, {}), **base)


FSDP = dict(fsdp=True)
PLAN2 = [
    _cell("fsdp_2x1", "train", QWEN, [2, 1], **FSDP),
    _cell("fsdp_accum", "train", QWEN, [2, 1], grad_accum=2, **FSDP),
    _cell("sp_train", "train", QWEN, [1, 2], sequence_parallel=True),
    _cell("sp_prefill", "serve", QWEN, [1, 2], sequence_parallel=True),
    _cell("rules_serve", "serve", QWEN, [1, 2], serve_rules=False, generate=True),
    _cell("mla_train", "train", MLA, [1, 2]),
    _cell("mla_serve", "serve", MLA, [1, 2]),
    _cell("hymba_train", "train", HYMBA, [1, 2]),
    # 40 + 4 positions cut at 22: the last rows' window of 32 reaches
    # back across both ranks
    _cell("hymba_serve", "serve", HYMBA, [1, 2], prompt=40),
    _cell("hymba5_train", "train", HYMBA5, [1, 2]),
    _cell("hymba5_serve", "serve", HYMBA5, [1, 2]),
    _cell("hymba5_rules_serve", "serve", HYMBA5, [1, 2], serve_rules=False),
    _cell("xlstm_train", "train", XLSTM, [1, 2]),
    _cell("xlstm_serve", "serve", XLSTM, [1, 2]),
    # sequence parallelism through MoE, the SSD mixer and the sLSTM
    _cell("mla_sp_train", "train", MLA, [1, 2], sequence_parallel=True),
    _cell("hymba5_sp_train", "train", HYMBA5, [1, 2], sequence_parallel=True),
    _cell("xlstm_sp_train", "train", XLSTM, [1, 2], sequence_parallel=True),
    # the master weights cast to bf16 before FSDP's gathers
    _cell("fsdp_cast", "train", QWEN, [2, 1], cast_params=True,
          policy_name="tpu_bf16", **FSDP),
]
PLAN4 = [
    _cell("fsdp_2x2", "train", QWEN, [2, 2], **FSDP),
    _cell("mla_fsdp_2x2", "train", MLA, [2, 2], **FSDP),
]
CELLS = {c["name"]: c for c in PLAN2 + PLAN4}
# the weight whose rank block the control negates, per arch
CONTROL = {QWEN: ("layers", "attn", "wo"), MLA: ("layers", "attn", "wo"),
           HYMBA: ("layers", "mamba", "w_out"), HYMBA5: ("layers", "attn", "wqkv"),
           XLSTM: ("layers", "mlstm", "cell", "w_down")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("layouts")
    setups = {k: _setup(k) for k in ARCH}
    for key, (_, _, _, tparams) in setups.items():
        torch.save(tparams, d / f"{key}.pt")
    for plan, n in ((PLAN2, 2), (PLAN4, 4)):
        cells = [dict({"policy_name": "fp32"}, **c, params=str(d / f"{c['key']}.pt"))
                 for c in plan]
        (d / f"plan{n}.json").write_text(json.dumps(cells))
        rc = procs.spawn(n, ["-m", "repro_torch.launch.mesh", "--device", "cpu",
                             "--plan", str(d / f"plan{n}.json"), "--out", str(d)],
                         run_dir=str(d), timeout=300)
        assert rc == 0, f"a rank of the {n}-rank spawn failed with exit code {rc}"

    def load(name):
        ranks = int(np.prod(CELLS[name]["mesh"]))
        infos = [json.loads((d / f"{name}.rank{r}.json").read_text())
                 for r in range(ranks)]
        return torch.load(d / f"{name}.pt", weights_only=False), infos

    return setups, load


def _rules(cell):
    base = ts.Rules(fsdp=cell.get("fsdp", False),
                    sequence_parallel=cell.get("sequence_parallel", False))
    serve = cell.get("serve_rules", cell["kind"] == "serve")
    return tserve.serve_rules(base) if serve else base


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local_bytes(specs, shapes, mesh) -> int:
    """The bytes of every leaf's local block of a sanitized spec tree."""
    if isinstance(specs, ts.PartitionSpec):
        return (int(np.prod(ts.local_shape(tuple(shapes.shape), specs, mesh)))
                * shapes.element_size())
    return sum(_local_bytes(specs[k], shapes[k], mesh) for k in specs)


def _param_specs(tcfg, rules, mesh):
    return ts.sanitize_tree(tt.param_specs(tcfg, rules), tt.abstract_params(tcfg), mesh)


def _control_params(tparams, tcfg, cell):
    """The weights with the last rank's block of the control leaf (layer 0
    of a stack) negated."""
    shape = tuple(cell["mesh"])
    mesh = tmesh.Mesh(shape, ("data", "model"), rank=int(np.prod(shape)) - 1)
    path = CONTROL[cell["key"]]
    spec = _get(_param_specs(tcfg, _rules(cell), mesh), path)
    params = jax.tree.map(lambda x: x, tparams)     # new dicts, same leaves
    leaf = _get(tparams, path).clone()
    ts.shard_block(leaf, spec, mesh)[0].neg_()      # a view: negated in place
    _get(params, path[:-1])[path[-1]] = leaf
    assert ts.shard_block(leaf, spec, mesh).shape != leaf.shape   # a cut leaf
    return params


# --------------------------------------------------------------------- #
# training layouts
# --------------------------------------------------------------------- #
def _trainable(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone().requires_grad_(True)
    return {k: _trainable(v) for k, v in tree.items()}


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)))
    return out


def _batches(tcfg):
    ds = SyntheticLM(tcfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=0)
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
            for i in range(TRAIN["steps"])]


def _unsharded_train(tcfg, tparams, batches, grad_accum=1):
    opt = AdamW()
    params = _trainable(tparams)
    state = ttrain.TrainState(params, opt.init(params), ())
    step = ttrain.build_train_step(tcfg, opt, return_grads=True, grad_accum=grad_accum)
    hist = []
    for b in batches:
        state, m = step(state, b)
        hist.append(m)
    return hist


def _renumbered(tree, inverse=False):
    """Every gated MLP's (and MoE expert's) hidden units permuted alike in
    ``w_in``'s gate and up columns and ``w_out``'s rows: the same function
    (``inverse`` undoes it, e.g. on the gradients)."""
    out = {k: _renumbered(v, inverse) if isinstance(v, dict) else v
           for k, v in tree.items()}
    w_in, w_out = tree.get("w_in"), tree.get("w_out")
    if isinstance(w_in, torch.Tensor) and w_in.shape[-1] == 2 * w_out.shape[-2]:
        ff = w_out.shape[-2]
        p = torch.randperm(ff, generator=torch.Generator().manual_seed(0))
        p = torch.argsort(p) if inverse else p
        out["w_in"] = torch.cat([w_in[..., :ff][..., p], w_in[..., ff:][..., p]], -1)
        out["w_out"] = w_out[..., p, :]
    return out


_REFERENCE = {}


def _reference_grads(key, jcfg, jparams, batch, grad_accum):
    """The reference's step-0 loss and gradients (``repro.launch.train``'s
    microbatch split), computed once per arch and split."""
    if (key, grad_accum) not in _REFERENCE:
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        mbs = [jax.tree.map(lambda x, i=i: x.reshape(grad_accum, -1, *x.shape[1:])[i], jb)
               for i in range(grad_accum)]
        vg_fn = jax.jit(jax.value_and_grad(lambda p, b: jt.loss_fn(p, jcfg, b),
                                           has_aux=True))
        vg = [vg_fn(jparams, b) for b in mbs]
        loss = np.mean([float(v[0][0]) for v in vg])
        grads = jax.tree.map(lambda *g: np.mean(np.stack([np.asarray(x) for x in g]), 0),
                             *[v[1] for v in vg])
        _REFERENCE[(key, grad_accum)] = (loss, _leaves(jax.tree.map(torch.from_numpy,
                                                                    grads)))
    return _REFERENCE[(key, grad_accum)]


# the fp32 training cells (the 16-bit cast cell has its own test)
TRAIN_CELLS = [c["name"] for c in PLAN2 + PLAN4
               if c["kind"] == "train" and "policy_name" not in c]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_layout_matches_unsharded(run, name):
    setups, load = run
    cell = CELLS[name]
    jcfg, tcfg, jparams, tparams = setups[cell["key"]]
    out, infos = load(name)
    batches = _batches(tcfg)
    assert all(torch.equal(out["batch0"][k], batches[0][k]) for k in batches[0])
    ga = cell.get("grad_accum", 1)
    hist = _unsharded_train(tcfg, tparams, batches, ga)
    losses = [float(m["loss"]) for m in hist]
    norms = [float(m["grad_norm"]) for m in hist]
    for info in infos:
        np.testing.assert_allclose(info["losses"], losses, rtol=TOL)
        # the global norm: each leaf's squares over the axes it is cut over
        # (step 0: a later step's norm follows AdamW's sign-like update of
        # near-zero gradients, which rounding flips)
        assert abs(info["grad_norms"][0] - norms[0]) <= TOL * norms[0]
        for k in ("moe_aux_loss", "moe_z_loss"):
            if k in hist[0]:
                assert abs(info[k] - float(hist[0][k])) <= TOL * max(abs(info[k]), 1)
        if "moe_drop_frac" in hist[0]:      # routing: the same slots dropped
            assert info["moe_drop_frac"] == float(hist[0]["moe_drop_frac"])
    got, want = _leaves(out["grads0"]), _leaves(hist[0]["grads"])
    assert got.keys() == want.keys()
    # the reference, unsharded, on the same weights and microbatches
    jloss, jgrads = _reference_grads(cell["key"], jcfg, jparams, batches[0], ga)
    assert abs(infos[0]["losses"][0] - jloss) <= REF_TOL * abs(jloss)
    assert jgrads.keys() == got.keys()
    # a gradient summed over many terms of both signs has an fp32 floor
    # above 1e-5 of its max (hymba's SSD skip_d / dt_bias, ln2): measured
    # here as the larger gap of the unsharded step to the reference's and
    # to the same network with its MLP hidden units renumbered (the same
    # function, its sums in another order)
    ren = _unsharded_train(tcfg, _renumbered(tparams), batches[:1], ga)[0]["grads"]
    ren = _leaves(_renumbered(ren, inverse=True))
    bound = {}
    for k, v in jgrads.items():
        assert _rel(got[k], v) <= REF_TOL, k
        floor = max(_rel(want[k], v), _rel(ren[k], want[k]))
        bound[k] = max(TOL, FLOOR_X * floor)
        assert _rel(got[k], want[k]) <= bound[k], k
    # the control: one rank's block of a cut weight negated
    chist = _unsharded_train(tcfg, _control_params(tparams, tcfg, cell), batches[:1], ga)
    cgot = _leaves(chist[0]["grads"])
    assert any(_rel(got[k], cgot[k]) > bound[k] for k in want)
    # placement: parameters and both AdamW moments are the spec's blocks
    for r, info in enumerate(infos):
        mesh = tmesh.Mesh(tuple(cell["mesh"]), ("data", "model"), rank=r)
        want_b = _local_bytes(_param_specs(tcfg, _rules(cell), mesh),
                              tt.abstract_params(tcfg), mesh)
        assert info["param_bytes"] == want_b
        assert info["moment_bytes"] == 2 * want_b


def test_fsdp_holds_half_the_state(run):
    """Under FSDP on two data ranks every leaf with an "embed" axis is cut:
    a rank holds less than half of the whole state plus the norms."""
    setups, load = run
    _, tcfg, _, _ = setups[QWEN]
    whole = sum(t.numel() * 4 for t in _leaves(tt.abstract_params(tcfg)).values())
    norms = sum(t.numel() * 4 for k, t in _leaves(tt.abstract_params(tcfg)).items()
                if "norm" in k[-1] or k[-1].startswith("ln"))
    for name in ("fsdp_2x1", "fsdp_accum"):
        _, infos = load(name)
        for info in infos:
            assert info["param_bytes"] == (whole - norms) // 2 + norms
    _, infos = load("fsdp_2x2")
    assert all(i["param_bytes"] < whole // 2 for i in infos)


def test_fsdp_collectives_gather_per_layer(run):
    """ZeRO-3: the data-cut weights are all-gathered in the forward and
    again in the remat recompute; the step reduces once, not per
    microbatch."""
    _, load = run
    _, one = load("fsdp_2x1")
    _, acc = load("fsdp_accum")
    g1 = one[0]["collectives"][0]["all_gather"]["count"]
    g2 = acc[0]["collectives"][0]["all_gather"]["count"]
    assert g2 == 2 * g1 > 0
    # the gradients' psums: the gathers' backward runs per microbatch, the
    # step's reductions (the whole leaves' mean, the metrics, the norm) once
    p1 = one[0]["collectives"][0]["psum"]["count"]
    p2 = acc[0]["collectives"][0]["psum"]["count"]
    assert p1 < p2 < 2 * p1


# --------------------------------------------------------------------- #
# serving layouts
# --------------------------------------------------------------------- #
def _teacher_forced(tparams, tcfg, prompts, fed, gen, T):
    """The unsharded port's prefill and decode steps on the tokens the
    sharded run fed; the logits and the final cache."""
    S = prompts.shape[1]
    lg, cache = tt.prefill(tparams, tcfg, {"inputs": prompts}, T)
    rows = [lg]
    for i in range(gen):
        lg, cache = tt.serve_step(tparams, tcfg, fed[:, i:i + 1], cache, S + i)
        rows.append(lg)
    return torch.stack(rows), cache


def _reference_serve(jcfg, jparams, prompts, fed, gen, T):
    S = prompts.shape[1]
    pre = jax.jit(lambda p, b: jt.prefill(p, jcfg, b, T))
    step = jax.jit(lambda p, t, c, pos: jt.serve_step(p, jcfg, t, c, pos))
    jl, jc = pre(jparams, {"inputs": jnp.asarray(prompts.numpy())})
    rows = [np.asarray(jl)]
    for i in range(gen):
        jl, jc = step(jparams, jnp.asarray(fed[:, i:i + 1].numpy()), jc,
                      jnp.int32(S + i))
        rows.append(np.asarray(jl))
    return np.stack(rows)


SERVE_CELLS = [c["name"] for c in PLAN2 if c["kind"] == "serve"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_layout_matches_unsharded(run, name):
    setups, load = run
    cell = CELLS[name]
    jcfg, tcfg, jparams, tparams = setups[cell["key"]]
    out, infos = load(name)
    prompts, fed, logits = out["prompts"], out["fed"], out["logits"]
    gen = SERVE["gen"]
    T = prompts.shape[1] + gen
    want, cache = _teacher_forced(tparams, tcfg, prompts, fed, gen, T)
    assert _rel(logits, want) <= TOL
    assert torch.equal(want[:-1].argmax(-1).T, fed)     # greedy, unsharded
    control, _ = _teacher_forced(_control_params(tparams, tcfg, cell), tcfg, prompts,
                                 fed, gen, T)
    assert _rel(logits, control) > TOL
    assert _rel(logits, _reference_serve(jcfg, jparams, prompts, fed, gen, T)) <= REF_TOL
    # placement: parameters and cache are the spec trees' local blocks
    rules = _rules(cell)
    for r, info in enumerate(infos):
        mesh = tmesh.Mesh(tuple(cell["mesh"]), ("data", "model"), rank=r)
        assert info["param_bytes"] == _local_bytes(
            _param_specs(tcfg, rules, mesh), tt.abstract_params(tcfg), mesh)
        cspec = tserve.cache_spec_tree(tcfg, rules, mesh, SERVE["batch"], T)
        with ts.use_mesh(None):
            whole = tt.init_cache(tcfg, SERVE["batch"], T, device="meta")
        assert info["kv_bytes"] == _local_bytes(cspec, whole, mesh)
    # the recurrent states: whole on every rank, bitwise alike, and the
    # unsharded run's
    states = out.get("states", {})
    assert (len(states) > 0) == (tcfg.block_kind in ("xlstm", "hymba"))
    if states:
        assert len({i["state_digest"] for i in infos}) == 1
        whole = tmesh.recurrent_states(cache)
        assert states.keys() == whole.keys()
        for k in states:
            assert _rel(states[k], whole[k]) <= TOL, k


def test_serve_layout_cuts_the_cache_as_declared(run):
    """The decode cache under the serving rules holds the rank's positions
    (MLA's latent cache too), under ``Rules()`` the rank's KV heads where
    they divide the model axis and the whole cache where they do not
    (one KV head)."""
    setups, load = run
    T = SERVE["prompt"] + SERVE["gen"]
    for name, frac in (("sp_prefill", 2), ("rules_serve", 2), ("hymba5_rules_serve", 1),
                       ("mla_serve", 2)):
        tcfg = setups[CELLS[name]["key"]][1]
        with ts.use_mesh(None):
            whole = tt.init_cache(tcfg, SERVE["batch"], T, device="meta")
        n = sum(t.numel() * t.element_size() for t in _leaves(whole).values())
        _, infos = load(name)
        assert [i["kv_bytes"] for i in infos] == [n // frac] * 2, name


def test_generate_under_rules_matches_unsharded(run):
    setups, load = run
    _, tcfg, _, tparams = setups[QWEN]
    out, _ = load("rules_serve")
    seqs, _, final = tserve.generate(tparams, tcfg, out["prompts"], SERVE["gen"],
                                     return_state=True)
    assert np.array_equal(out["gen_seqs"].numpy(), seqs)
    assert _rel(out["gen_final"], final) <= TOL


def test_sequence_parallel_collectives(run):
    """Under sequence parallelism the row-parallel outputs and the
    embedding are reduce-scattered over the positions, and the stream is
    gathered before the column-parallel GEMMs; a decode step (S = 1) runs
    as without it."""
    _, load = run
    _, infos = load("sp_train")
    st = infos[0]["collectives"][0]
    assert st["psum_scatter"]["count"] > 0 and st["all_gather"]["count"] > 0
    _, infos = load("sp_prefill")
    assert infos[0]["collectives_prefill"]["psum_scatter"]["count"] > 0
    assert "psum_scatter" not in infos[0]["collectives_decode"]


# --------------------------------------------------------------------- #
# cast_params on a mesh
# --------------------------------------------------------------------- #
def test_cast_params_gathers_16_bit_words(run):
    """FSDP under ``cast_params`` with the tpu_bf16 policy: the master
    weights are cast before the per-layer gathers, so every all-gather
    carries half the bytes of the fp32 cell's (the same gathers), and the
    loss is the unsharded cast run's."""
    setups, load = run
    _, one = load("fsdp_2x1")
    _, cast = load("fsdp_cast")
    for a, b in zip(one, cast):
        fp32, bf16 = a["collectives"][0]["all_gather"], b["collectives"][0]["all_gather"]
        assert bf16["count"] == fp32["count"] > 0
        assert 2 * bf16["bytes"] == fp32["bytes"]
    _, tcfg, _, tparams = setups[QWEN]
    cfg = dataclasses.replace(tcfg, policy_name="tpu_bf16")
    opt = AdamW()
    params = _trainable(tparams)
    state = ttrain.TrainState(params, opt.init(params), ())
    step = ttrain.build_train_step(cfg, opt, cast_params=True)
    want = [float(step(state, b)[1]["loss"]) for b in _batches(cfg)[:1]]
    for info in cast:
        assert abs(info["losses"][0] - want[0]) <= TOL16 * abs(want[0])


# --------------------------------------------------------------------- #
# the dry run against the ranks
# --------------------------------------------------------------------- #
def _stats(st):
    """``collectives.STATS`` without the host seconds."""
    return {k: {"count": v["count"], "bytes": v["bytes"]} for k, v in st.items()}


def _sum_stats(parts):
    out = {}
    for st in parts:
        for k, v in st.items():
            s = out.setdefault(k, {"count": 0, "bytes": 0})
            s["count"] += v["count"]
            s["bytes"] += v["bytes"]
    return out


def _sum_bills(bills):
    return {q: {d: sum(b[q][d] for b in bills) for d in ("fwd", "bwd")}
            for q in ("flops", "bytes")}


@pytest.mark.parametrize("name", list(CELLS))
def test_dry_run_predicts_every_rank(run, name):
    """Rank 0's program traced on meta tensors (``launch/dryrun.py``,
    predicting a CPU run) equals what every rank of the cell ran: the
    collectives per kind (count and payload bytes), the resident
    parameter / moment / KV bytes and the engine bill of each step."""
    from repro_torch.launch import dryrun

    setups, load = run
    cell = CELLS[name]
    cfg = dataclasses.replace(setups[cell["key"]][1],
                              policy_name=cell.get("policy_name", "fp32"))
    _, infos = load(name)
    mesh = tmesh.Mesh(tuple(cell["mesh"]), ("data", "model"))
    rules = _rules(cell)
    if cell["kind"] == "train":
        got = dryrun.trace_train(cfg, mesh, rules, batch=cell["batch"], seq=cell["seq"],
                                 grad_accum=cell.get("grad_accum", 1),
                                 cast_params=cell.get("cast_params", False),
                                 contract="cpu")
        for info in infos:
            assert _stats(info["collectives"][0]) == got.collective_stats()
            assert info["bill"][0] == got.bill()
            assert info["param_bytes"] == got.resident["param_bytes"]
            assert info["moment_bytes"] == got.resident["moment_bytes"]
        return
    S, G, m = cell["prompt"], cell["gen"], cell["mesh"][1]
    T = -(-(S + G) // m) * m
    pre = dryrun.trace_prefill(cfg, mesh, rules, batch=cell["batch"], seq=S,
                               max_len=T, contract="cpu")
    steps = [dryrun.trace_decode(cfg, mesh, rules, batch=cell["batch"], max_len=T,
                                 pos=S + i, contract="cpu") for i in range(G)]
    for info in infos:
        assert _stats(info["collectives_prefill"]) == pre.collective_stats()
        assert _stats(info["collectives_decode"]) == _sum_stats(
            s.collective_stats() for s in steps)
        assert info["bill_prefill"] == pre.bill()
        assert info["bill_decode"] == _sum_bills([s.bill() for s in steps])
        assert info["param_bytes"] == pre.resident["param_bytes"]
        assert info["kv_bytes"] == pre.resident["kv_bytes"] == steps[0].resident["kv_bytes"]
