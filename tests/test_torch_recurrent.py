"""The port's recurrent paths against the JAX package: serving xlstm-1.3b
from its decode state, and serving and training hymba-1.5b (Mamba2 / SSD
beside sliding-window attention).

The same numpy inputs, and the reference's initial parameters carried
across with ``repro_torch.convert``, go through ``repro`` (its "xla"
backend: the reference's serving hands every sweep the zero state of its
cache and so runs its composition, Queue C of ROADMAP.md) and
``repro_torch`` on the CPU (the kernels' plain versions).  Covered:

* the full hymba config and its parameter count;
* the mixed-dtype sweep (fp32 q / k, bf16 or fp16 v) against the Pallas
  kernel in interpret mode;
* ``mamba_mixer`` with and without a state, and ``_hymba_block``;
* prefill logits and the whole cache tree, leaf for leaf, then 3
  teacher-forced ``serve_step``s, for reduced hymba (window 32, a 40- and a
  72-token prompt: the window masks, and 72 crosses ``q_chunk`` 64) and
  reduced xlstm;
* the prefill's engine events: the port's fresh prefill runs the sweep
  kernel (four ``linear_attention_*`` events a sweep) where the reference
  runs the composition; with that one substitution the bills are equal;
* hymba's loss and gradients of one step, and the train CLI;
* the scheduler's refusal of recurrent kinds, a window tensor on the
  q-chunked and the ragged decode paths, and the seed of ``init_params``.

Tolerances, relative to the largest reference magnitude: fp32 1e-4
(summation order through a few dozen fp32 ops); tpu_bf16 2^-4 for logits
and caches (every GEMM output, norm and residual add rounds to bf16, 2^-8,
at different places in the two frameworks; the dense archs are held so in
``tests/test_torch_serve.py``) and 2^-5 for a single block.
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
from repro.kernels.chunked_linear_attention import chunked_linear_attention_pallas
from repro.models import ssm as jssm
from repro.models import transformer as jt

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.kernels import chunked_linear_attention as tcla
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched

ARCHS = ("hymba-1.5b", "xlstm-1.3b")
TOL = {"fp32": 1e-4, "tpu_bf16": 2.0 ** -4}
SWEEP_OPS = {"linear_attention_score", "linear_attention_pv",
             "linear_attention_inter", "linear_attention_state"}


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _leaves(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in tree:
        out.update(_leaves(tree[k], prefix + (k,)))
    return out


def _by_op(events):
    """Events expanded by count, keyed by op (scope stripped), flops and
    bytes (the reference emits a scanned body once with a multiplicity,
    the port once per executed iteration)."""
    out = collections.Counter()
    for e in events:
        out[(e.spec.op.split("/")[-1], e.spec.flops, e.spec.bytes)] += e.count
    return out


_PAIRS = {}


def _setup(arch, policy="fp32"):
    key = (arch, policy)
    if key not in _PAIRS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name=policy)
        tcfg = dataclasses.replace(tconfigs.get_reduced(arch), policy_name=policy)
        jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                          device="cpu", dtype=torch.float32)
        _PAIRS[key] = (jcfg, tcfg, jparams, tparams)
    return _PAIRS[key]


def _prompt(B, n, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


def _mamba_params(jparams, tparams, layer):
    jp = jax.tree.map(lambda a: a[layer], jparams["layers"]["mamba"])
    tp = {k: v[layer] for k, v in tparams["layers"]["mamba"].items()}
    return jp, tp


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
def test_full_hymba_config_matches_reference_and_counts():
    jcfg, tcfg = jconfigs.get("hymba-1.5b"), tconfigs.get("hymba-1.5b")
    tdict = dataclasses.asdict(tcfg)
    assert tdict == {k: v for k, v in dataclasses.asdict(jcfg).items() if k in tdict}
    red_j, red_t = jconfigs.get_reduced("hymba-1.5b"), tconfigs.get_reduced("hymba-1.5b")
    rdict = dataclasses.asdict(red_t)
    assert rdict == {k: v for k, v in dataclasses.asdict(red_j).items() if k in rdict}
    assert tt.count_params(tcfg) == jt.count_params(jcfg) == 1_393_364_000
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    w = tt.window_array(tcfg)
    assert w.dtype == torch.int32 and w.tolist() == np.asarray(jt.window_array(jcfg)).tolist()
    assert [i for i, x in enumerate(w.tolist()) if x == tt.BIG_WINDOW] == [0, 15, 31]


# --------------------------------------------------------------------- #
# the sweep with mixed operand dtypes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("vdtype", ("bfloat16", "float16"))
def test_mixed_dtype_sweep_plain_matches_interpret_kernel(vdtype):
    """hymba's operands: fp32 q / k (C, B), a 16-bit v (dt·x), dk < dv; the
    output in q's dtype (fp32), the state fp32; summation order only."""
    rng = np.random.default_rng(len(vdtype))
    BH, S, dk, dv, chunk = 6, 48, 8, 16, 16
    q = rng.standard_normal((BH, S, dk)).astype(np.float32)
    k = (0.5 * rng.standard_normal((BH, S, dk))).astype(np.float32)
    v = rng.standard_normal((BH, S, dv)).astype(np.float32)
    lg = -rng.random((BH, S)).astype(np.float32)
    jv, tv = getattr(jnp, vdtype), getattr(torch, vdtype)
    want_o, want_s = chunked_linear_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v).astype(jv), jnp.asarray(lg),
        chunk=chunk, interpret=True)
    got_o, got_s = tcla.chunked_linear_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v).to(tv),
        torch.from_numpy(lg), chunk=chunk)
    assert got_o.dtype == torch.float32 and want_o.dtype == jnp.float32
    assert _rel(got_o, want_o) <= 1e-5 and _rel(got_s, want_s) <= 1e-5
    with pytest.raises(TypeError, match="dtypes"):
        tcla.chunked_linear_attention(
            torch.from_numpy(q).to(tv), torch.from_numpy(k).to(tv),
            torch.from_numpy(v), torch.from_numpy(lg), chunk=chunk)


def test_sweep_gradient_is_finite_where_the_decays_overflow_the_reference():
    """Decays whose chunk sums fall below about -88 (Mamba2's dt·exp(a_log)
    at full width): the reference composition exponentiates the masked
    entries of its decay matrix too, so they overflow and its gradient is
    NaN; the port's is finite and equals autograd through the plain
    recurrence S_t = exp(g_t) S_{t-1} + k_t v_t^T in float64."""
    rng = np.random.default_rng(14)
    B, H, S, dk, dv, chunk = 1, 2, 32, 4, 8, 16
    q, k, v, co = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((B, H, S, dk), (B, H, S, dk), (B, H, S, dv), (B, H, S, dv)))
    lg = -(6.0 + 2.0 * rng.random((B, H, S))).astype(np.float32)   # ~ -112 a chunk

    def jloss(*a):
        return jnp.sum(je.linear_attention(*a, chunk=chunk, backend="xla")[0] * co)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, lg)))
    assert np.isnan(np.asarray(jgrads[3])).any()        # the reference's fault
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, lg)]
    o, _ = te.linear_attention(*ins, chunk=chunk)
    got = torch.autograd.grad((o * torch.from_numpy(co)).sum(), ins)
    ref = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v, lg)]
    state = torch.zeros((B, H, dk, dv), dtype=torch.float64)
    outs = []
    for t in range(S):
        state = (torch.exp(ref[3][..., t])[..., None, None] * state
                 + ref[1][..., t, :, None] * ref[2][..., t, None, :])
        outs.append(torch.einsum("bhk,bhkv->bhv", ref[0][..., t, :], state))
    want = torch.autograd.grad((torch.stack(outs, 2) * torch.from_numpy(co)).sum(), ref)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel(g, w.numpy()) <= 1e-4


# --------------------------------------------------------------------- #
# the Mamba2 / SSD mixer and the hybrid block
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
@pytest.mark.parametrize("with_state", (False, True))
def test_mamba_mixer_matches_reference(policy, with_state):
    jcfg, tcfg, jparams, tparams = _setup("hymba-1.5b", policy)
    jp, tp = _mamba_params(jparams, tparams, 1)
    H, N, P = jcfg.n_heads, jcfg.ssm.state_dim, jcfg.d_model // jcfg.n_heads
    rng = np.random.default_rng(11 + with_state)
    S = 1 if with_state else 40
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, H, N, P)).astype(np.float32) if with_state else None
    comp = jcfg.policy.compute_dtype
    jy, js = jssm.mamba_mixer(jp, jnp.asarray(x).astype(comp), jcfg, policy=jcfg.policy,
                              state=None if s0 is None else jnp.asarray(s0))
    with te.instrument() as tev:
        ty, ts = tssm.mamba_mixer(tp, torch.from_numpy(x).to(tcfg.policy.compute_dtype),
                                  tcfg, policy=tcfg.policy,
                                  state=None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == tcfg.policy.compute_dtype and ts.dtype == torch.float32
    tol = 1e-4 if policy == "fp32" else 2.0 ** -5
    assert _rel(ty, jy) <= tol and _rel(ts, js) <= tol
    ops = {e.spec.op for e in tev}
    # a decode step reads the state out with einsum2d; no state: the sweep
    assert ("einsum2d" in ops) == with_state and (SWEEP_OPS <= ops) != with_state


@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
def test_hymba_block_matches_reference(policy):
    jcfg, tcfg, jparams, tparams = _setup("hymba-1.5b", policy)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"])
    tp = tt._unbind(tparams["layers"])[1]
    x = np.random.default_rng(12).standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    comp = jcfg.policy.compute_dtype
    jy, _, _ = jt._hymba_block(jp, jnp.asarray(x).astype(comp), jcfg, pos=0, cache=None,
                               window=jnp.int32(jcfg.sliding_window), policy=jcfg.policy)
    ty = tt._hymba_block(tp, torch.from_numpy(x).to(tcfg.policy.compute_dtype), tcfg,
                         pos=0, cache=None, window=torch.tensor(tcfg.sliding_window),
                         policy=tcfg.policy)
    assert _rel(ty, jy) <= (1e-4 if policy == "fp32" else 2.0 ** -5)


# --------------------------------------------------------------------- #
# serving: prefill, the cache tree, teacher-forced decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
@pytest.mark.parametrize("arch,plen", (("hymba-1.5b", 40), ("hymba-1.5b", 72),
                                       ("xlstm-1.3b", 40)))
def test_prefill_cache_and_decode_match_reference(arch, plen, policy):
    """Prefill logits and every cache leaf, then 3 teacher-forced
    ``serve_step``s (logits and the cache after each), against the
    reference's ``prefill`` / ``serve_step``."""
    jcfg, tcfg, jparams, tparams = _setup(arch, policy)
    tol = TOL[policy]
    prompt = _prompt(2, plen, plen)
    nxt = _prompt(2, 3, plen + 1)
    T = plen + 4
    jl, jc = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, T)
    tl, tc = tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()}, T)
    assert _rel(tl, jl) <= tol
    for step in range(4):
        jleaves, tleaves = _leaves(jc), _leaves(tc)
        assert set(jleaves) == set(tleaves)
        for path, leaf in tleaves.items():
            assert leaf.dtype == getattr(torch, str(jleaves[path].dtype)), path
            assert _rel(leaf, jleaves[path]) <= tol, (step, path)
        if step == 3:
            break
        jl, jc = jt.serve_step(jparams, jcfg, jnp.asarray(nxt[:, step:step + 1]), jc,
                               plen + step)
        tl, tc = tt.serve_step(tparams, tcfg, torch.from_numpy(nxt[:, step:step + 1]).long(),
                               tc, plen + step)
        assert _rel(tl, jl) <= tol, step


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_events_match_reference_with_the_sweep_kernel(arch):
    """The fresh prefill's bills: the port runs the sweep kernel (its four
    ``linear_attention_*`` events a sweep) where the reference runs its
    composition over the zero state of its cache.  Replace each sweep's
    four events by the reference composition's events of the same shape
    (measured from ``repro.core.engine.linear_attention`` with a zero
    state): the bills are then equal, op for op."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    B, plen = 2, 40
    prompt = _prompt(B, plen, 5)
    with je.instrument() as jev:
        jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, plen + 4)
    with te.instrument() as tev:
        tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()}, plen + 4)
    if arch == "hymba-1.5b":
        H = jcfg.n_heads
        dk, dv = jcfg.ssm.state_dim, jcfg.d_model // H
        n_sweeps, qk_dtype = jcfg.n_layers, jnp.float32
    else:
        H = jcfg.n_heads
        dk = dv = jcfg.ssm.mlstm_proj_factor * jcfg.d_model // H
        n_sweeps = jcfg.n_layers // jcfg.ssm.slstm_period * (jcfg.ssm.slstm_period - 1)
        qk_dtype = jcfg.policy.compute_dtype
    qk = jnp.zeros((B, H, plen, dk), qk_dtype)
    v = jnp.zeros((B, H, plen, dv), jcfg.policy.compute_dtype)
    g = jnp.zeros((B, H, plen), jnp.float32)
    with je.instrument() as comp:
        je.linear_attention(qk, qk, v, g, chunk=jcfg.ssm.chunk,
                            state=jnp.zeros((B, H, dk, dv), jnp.float32), backend="xla")
    with te.instrument() as kern:
        te.linear_attention(torch.zeros(qk.shape, dtype=tcfg.policy.compute_dtype
                                        if arch == "xlstm-1.3b" else torch.float32),
                            torch.zeros(qk.shape, dtype=tcfg.policy.compute_dtype
                                        if arch == "xlstm-1.3b" else torch.float32),
                            torch.zeros(v.shape, dtype=tcfg.policy.compute_dtype),
                            torch.zeros(g.shape), chunk=tcfg.ssm.chunk)
    assert {e.spec.op for e in kern} == SWEEP_OPS
    got = _by_op(tev)
    for key, n in _by_op(kern).items():
        assert got[key] == n * n_sweeps, key
        del got[key]
    for key, n in _by_op(comp).items():
        got[key] += n * n_sweeps
    assert got == _by_op(jev)


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ("fp32", "tpu_bf16"))
def test_hymba_loss_and_grads_match_reference(policy):
    """One step's loss and every gradient; the port's training runs the
    sweep kernel's plain version forward and the composition backward, the
    reference ("xla") the composition both ways."""
    jcfg, tcfg, jparams, tparams = _setup("hymba-1.5b", policy)
    toks = _prompt(2, 40, 21)
    labels = _prompt(2, 40, 22)
    jb = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, jb), has_aux=True)(jparams)
    leaves = _leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        tloss, _ = tt.loss_fn(tparams, tcfg, {"inputs": torch.from_numpy(toks).long(),
                                              "labels": torch.from_numpy(labels).long()})
        grads = torch.autograd.grad(tloss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    tol = 1e-4 if policy == "fp32" else 2.0 ** -4
    assert abs(float(tloss.detach()) - float(jloss)) <= tol * abs(float(jloss))
    jleaves = _leaves(jgrads)
    for (path, _), grad in zip(leaves.items(), grads):
        assert _rel(grad, jleaves[path]) <= tol, path


def test_hymba_train_cli_on_cpu(capsys):
    out = ttrain.main(["--device", "cpu", "--arch", "hymba-1.5b", "--batch", "2",
                       "--seq", "24", "--steps", "2", "--instrument"])
    assert out["arch"] == "hymba-1.5b" and len(out["history"]) == 2
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
    text = capsys.readouterr().out
    assert "[engine] linear_attention_state" in text and "final loss" in text


# --------------------------------------------------------------------- #
# refusals, windows, seeds
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_refuses_recurrent_kinds(arch):
    _, tcfg, _, tparams = _setup(arch)
    with pytest.raises(ValueError, match="attn/moe decode caches"):
        tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(n_slots=1, max_len=8))
    with pytest.raises(ValueError, match="FP8 cache storage"):
        tt.init_cache(tcfg, 1, 8, storage_dtype="float8_e4m3fn", device="cpu")


def test_window_tensor_reaches_q_chunked_and_ragged_decode_paths():
    """A per-layer window handed as a 0-d tensor masks like the int."""
    rng = np.random.default_rng(13)
    B, Hkv, G, S, T, hd = 2, 2, 2, 20, 24, 8
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, S, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, T, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, T, hd)).astype(np.float32))
    kw = dict(q_offset=4, kv_valid=S + 4, q_chunk=8, policy=te.prec.FP32)
    full = tattn.chunked_attention(q, k, v, **kw)
    for w in (5, tt.BIG_WINDOW):
        got = tattn.chunked_attention(q, k, v, window=torch.tensor(w, dtype=torch.int32),
                                      **kw)
        want = tattn.chunked_attention(q, k, v, window=w, **kw)
        assert torch.equal(got, want)
        assert torch.equal(got, full) == (w == tt.BIG_WINDOW)
    # one decode row per slot at per-slot positions (the ragged route)
    pos = torch.tensor([9, 15])
    kw1 = dict(q_offset=pos, kv_valid=pos + 1, policy=te.prec.FP32,
               kv_group_sizes=(pos + 1).numpy())
    got = tattn.chunked_attention(q[:, :, :, :1], k, v, window=torch.tensor(5), **kw1)
    want = tattn.chunked_attention(q[:, :, :, :1], k, v, window=5, **kw1)
    wide = tattn.chunked_attention(q[:, :, :, :1], k, v, **kw1)
    assert torch.equal(got, want) and not torch.equal(got, wide)


def test_init_params_seed_reaches_the_cpu_generator():
    """Seeds differ on the CPU (the seed enters the low 32 bits the CPU
    generator reads), and seed 0 keeps the values it always had (pinned
    from the draw before the seed reached the low bits)."""
    cfg = tconfigs.get_reduced("xlstm-1.3b")
    p0, p1, p0b = (_leaves(tt.init_params(cfg, seed=s, device="cpu",
                                          dtype=torch.float32)) for s in (0, 1, 0))
    for path, leaf in p0.items():
        assert torch.equal(leaf, p0b[path])
        if leaf.std() > 0:          # drawn, not zeros / ones
            assert not torch.equal(leaf, p1[path]), path
    assert tlayers._path_seed(0, ("embed",)) == 1203373331
    assert p0[("embed",)][0, :4].tolist() == [
        0.017288533970713615, -0.027822120115160942, 0.011217998340725899,
        0.006230622995644808]
    assert p0[("layers", "mlstm", "cell", "w_up")][0, 0, 0, :3].tolist() == [
        -0.08633793890476227, 0.04303696006536484, 0.05360058695077896]
