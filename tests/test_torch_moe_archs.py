"""The two DeepSeek architectures end to end against the JAX package:
deepseek-v2-lite-16b (MLA attention, MoE) and deepseek-moe-16b (MHA,
MoE).

* ``full()`` matches the reference and counts its parameters: total and
  active (``top_k`` of ``n_routed`` routed experts);
* reduced, fp32: prefill and decode steps (logits and caches), greedy
  generation and the continuous-batching scheduler's trace; tpu_bf16:
  the logits of a two-layer cut to a bound, off routing ties;
* prefill then decode equals a longer prefill (the port on its own);
* one continuous-batching decode step's engine flops equal the
  reference's, and for deepseek-moe-16b ``serve_bytes.json``'s pin;
* the serve CLI on the CPU (training: ``tests/test_torch_moe_train.py``).

The reference's parameters are carried across with ``repro_torch.convert``
and its kernels run on "interpret".  Tolerances: fp32 1e-4 of the largest
reference magnitude (summation order); tpu_bf16 logits 2^-4 of max, as
``tests/test_torch_serve.py`` holds the dense archs (every GEMM output,
norm and residual add rounds to bf16, 2^-8, at different places in the
two frameworks), on the tokens whose router is off a tie (see
``test_logits_bf16_bound_off_routing_ties``).
"""

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
from repro.launch import serve as jserve
from repro.models import transformer as jt
from repro.serving import scheduler as jsched

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched

ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
TOL = 1e-4
# (total, active) parameters of the full configs
COUNTS = {"deepseek-v2-lite-16b": (15_706_484_224, 2_661_150_208),
          "deepseek-moe-16b": (16_375_728_128, 2_828_650_496)}
SERVE_BYTES = Path(__file__).resolve().parent.parent / "benchmarks" / \
    "baselines" / "serve_bytes.json"


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k in tree for item in _paths(tree[k], prefix + (k,))]


def _setup(arch, policy="fp32"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name=policy)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), policy_name=policy)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def fp32(request):
    return _setup(request.param)


def _prompt(B, n, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference_and_counts(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                        if k in dataclasses.asdict(tcfg)}
    assert {f.name for f in dataclasses.fields(tcfg)} <= \
        {f.name for f in dataclasses.fields(jcfg)}
    red_j, red_t = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    assert dataclasses.asdict(red_t) == {k: v for k, v in dataclasses.asdict(red_j).items()
                                         if k in dataclasses.asdict(red_t)}
    total, active = COUNTS[arch]
    assert tt.count_params(tcfg) == jt.count_params(jcfg) == total
    assert tt.count_params(tcfg, active_only=True) == \
        jt.count_params(jcfg, active_only=True) == active


def test_prefill_and_decode_match_reference(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    prompt = _prompt(2, 7, 0)
    jl, jc = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, 12)
    tl, tc = tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()}, 12)
    assert _rel(tl, jl) <= TOL
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    for step in range(3):
        jl, jc = jt.serve_step(jparams, jcfg, jnp.asarray(tok), jc, 7 + step)
        tl, tc = tt.serve_step(tparams, tcfg, torch.from_numpy(tok).long(), tc, 7 + step)
        assert _rel(tl, jl) <= TOL, step
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    assert set(tc) == set(jc) == {"layer0", "layers"}
    for key in ("layer0", "layers"):
        for name, leaf in tc[key].items():
            assert _rel(leaf, jc[key][name]) <= TOL, (key, name)


def test_prefill_then_decode_equals_a_longer_prefill(fp32):
    """The cache path against no cache: three decode steps after a 5-token
    prefill give the logits a prefill of all 8 tokens gives at each of its
    last three positions."""
    _, tcfg, _, tparams = fp32
    toks = torch.from_numpy(_prompt(2, 8, 3)).long()
    full, _, _ = tt.forward(tparams, tcfg, {"inputs": toks})
    _, cache = tt.prefill(tparams, tcfg, {"inputs": toks[:, :5]}, 8)
    for i in range(5, 8):
        logits, cache = tt.serve_step(tparams, tcfg, toks[:, i:i + 1], cache, i)
        assert _rel(logits, full[:, i].detach().numpy()) <= TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_reference(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    prompts = _prompt(3, 5, 1)
    want = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts), 4))
    got = tserve.generate(tparams, tcfg, prompts, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_trace_equals_reference(arch):
    """Five requests of mixed prompt lengths through two slots: per-slot
    decode positions (the MLA cache's per-slot writes and mask, the MHA
    ragged scores) and slot insertion into the MoE kind's cache tree."""
    jcfg, tcfg, jparams, tparams = _setup(arch)

    def reqs(module):
        r = np.random.default_rng(2)
        return [module.Request(rid=i, arrival=float(i), prompt=r.integers(
            0, 512, int(r.choice([3, 6]))).astype(np.int32),
            max_new_tokens=int(r.integers(1, 5))) for i in range(5)]

    js = jsched.Scheduler(jparams, jcfg, jsched.SchedulerConfig(n_slots=2, max_len=12))
    js.submit(reqs(jsched))
    jres = js.run()
    ts = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(n_slots=2, max_len=12))
    ts.submit(reqs(tsched))
    tres = ts.run()
    assert ts.trace == js.trace
    assert [r.tokens for r in tres] == [r.tokens for r in jres]


def _router_logits(run):
    """``(run(), logits)``: ``logits`` the router GEMM outputs of the
    port's forward in ``run`` (through the engine's public registry: the
    "hopper" backend wrapped, nothing patched)."""
    hop = te.get_backend("hopper")
    got = []

    def fn(x, w, **kw):
        z = hop.fn(x, w, **kw)
        if kw["spec"].policy.name == "router":
            got.append(z.float())
        return z

    te.register_backend("hopper+router", fn, capabilities=hop.capabilities,
                        attention_fn=hop.attention_fn)
    try:
        with te.use_backend("hopper+router"):
            out = run()
    finally:
        te.unregister_backend("hopper+router")
    return out, got


@pytest.mark.parametrize("seed", (4, 5, 6))
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_bf16_bound_off_routing_ties(arch, seed):
    """tpu_bf16, a two-layer cut (layer 0 dense, one MoE layer) with no
    capacity drops (cf 64: a slot's fate is its own): every token's logits
    within 2^-4 of max of the reference's unless its router sits on a tie.
    bf16 rounds the router's input at other places in the two frameworks,
    so a token whose k-th and (k+1)-th router logits lie within the
    rounding of each other may pick another expert and move by O(1).  The
    rounding is measured: delta, the port's largest router-logit change
    from fp32 to bf16 on the same parameters; a flip needs the two sides'
    orders to differ, so a tie is a gap of at most 2 delta.  At least half
    the tokens must be off a tie."""
    over = dict(n_layers=2)
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jcfg = dataclasses.replace(jcfg, policy_name="tpu_bf16", **over,
                               moe=dataclasses.replace(jcfg.moe, capacity_factor=64.0))
    tcfg = dataclasses.replace(tcfg, policy_name="tpu_bf16", **over,
                               moe=dataclasses.replace(tcfg.moe, capacity_factor=64.0))
    t32 = dataclasses.replace(tcfg, policy_name="fp32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    prompt = _prompt(2, 12, seed)
    toks = {"inputs": torch.from_numpy(prompt).long()}
    jl, _, _ = jt.forward(jparams, jcfg, {"inputs": jnp.asarray(prompt)})
    (tl, _, _), (r16,) = _router_logits(lambda: tt.forward(
        convert.params_from_jax(tree, tcfg, device="cpu"), tcfg, toks))
    _, (r32,) = _router_logits(lambda: tt.forward(
        convert.params_from_jax(tree, t32, device="cpu"), t32, toks))
    assert tl.dtype == torch.bfloat16
    jl = np.asarray(jl, np.float32)
    err = np.abs(tl.float().numpy() - jl).max(-1) / np.abs(jl).max()
    delta = (r16 - r32).abs().max().item()
    top = torch.sort(r16, dim=-1, descending=True).values
    k = tcfg.moe.top_k
    off_tie = (top[..., k - 1] - top[..., k]).numpy() > 2 * delta
    assert off_tie.mean() >= 0.5
    assert err[off_tie].max() <= 2.0 ** -4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_engine_flops_match_reference(arch):
    """One continuous-batching decode step, per-slot lengths [4, 9, 17] in
    a 4-slot pool (one parked) of max_len 32: the port's executed events
    sum to the reference's instrumented flops — for deepseek-moe-16b the
    7,410,944 that ``serve_bytes.json`` pins."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    lengths = [4, 9, 17]
    sizes = np.asarray(lengths + [0], np.int32)
    jev = jsched.instrumented_decode_events(
        jt.abstract_params(jcfg), jcfg,
        jsched.SchedulerConfig(n_slots=4, max_len=32), sizes)
    params = tt.init_params(tcfg, seed=0, device="cpu")
    cache = tt.init_cache(tcfg, 4, 32, device="cpu")
    pos = torch.as_tensor(np.where(sizes > 0, sizes - 1, 31)).long()
    toks = torch.zeros((4, 1), dtype=torch.long)
    with te.instrument() as tev, te.op_scope("serve_decode"):
        tt.serve_step(params, tcfg, toks, cache, pos, kv_group_sizes=sizes)
    assert te.total_flops(tev) == je.total_flops(jev)
    assert {e.spec.op for e in tev} == {e.spec.op for e in jev}
    if arch == "deepseek-moe-16b":
        pin = json.loads(SERVE_BYTES.read_text())
        assert pin["lengths"] == lengths
        assert te.total_flops(tev) == pin[arch]["engine_flops"] == 7_410_944


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    seqs = tserve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                        "--prompt-len", "8", "--gen", "4"])
    assert seqs.shape == (2, 12)
    assert ((seqs >= 0) & (seqs < 512)).all()
    assert f"arch={arch}" in capsys.readouterr().out


def test_shard_map_moe_is_refused():
    # moe_impl="shard_map" runs now (the sharding runtime): outside a mesh it
    # is the gspmd dispatch, as the reference's falls back to moe_forward;
    # on two ranks tests/test_torch_shard_exec.py holds it to the unsharded
    # run.  An unknown route is still refused.
    gcfg = tconfigs.get_reduced(ARCHS[0])
    scfg = dataclasses.replace(gcfg, moe_impl="shard_map")
    params = tt.init_params(scfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 8)))
    gl, _, gaux = tt.forward(params, gcfg, {"inputs": toks})
    sl, _, saux = tt.forward(params, scfg, {"inputs": toks})
    assert torch.equal(gl, sl)
    assert all(torch.equal(gaux[k], saux[k]) for k in gaux)
    with pytest.raises(ValueError, match="moe_impl"):
        tt.init_params(dataclasses.replace(gcfg, moe_impl="manual"), device="cpu")
