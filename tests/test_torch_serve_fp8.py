"""The port's FP8 KV cache against the JAX package, on the CPU.

Reduced yi-9b (GQA, per-head delayed scales), deepseek-moe-16b (MHA +
MoE, the ``layer0`` subtree) and deepseek-v2-lite-16b (MLA, per-tensor
scales on ``ckv`` / ``kr``, the absorbed decode reading the dequantized
cache).  Tolerances, each the reference's own contract:

* the delayed-scaling state, slot admission and the byte accounting are
  exact arithmetic: equal to the reference bit for bit, and to
  ``benchmarks/baselines/serve_bytes.json``;
* a dequantized FP8 row sits within one E4M3 step of its 16-bit value:
  ``2^-3 |x| + scale 2^-9`` (relative precision, and the subnormal grid
  below ``scale 2^-6``; ``tests/test_serving.py:47-69``);
* FP8 decode logits follow the 16-bit cache's within the reference's band,
  max < 0.5 and mean < 0.3 over six greedy steps
  (``tests/test_serving.py:71-97``); prefill logits agree to 1e-2;
* across the packages under fp32 (the same weights, the same prompt) the
  caches' codes are the same but for rounding flips at an E4M3 boundary,
  so the dequantized rows agree within one E4M3 step and the scales to
  1e-5 relative.
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
from repro.models import transformer as jt
from repro.optim import scale as jscale
from repro.serving import kv_cache as jkv
from repro.serving import loadgen as jloadgen
from repro.serving import scheduler as jsched

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import precision as tprec
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.optim import scale as tscale
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving import scheduler as tsched

ROOT = Path(__file__).resolve().parents[1]
FP8 = "float8_e4m3fn"
E4M3_EPS = 2.0 ** -3
SERVE_BYTES = json.loads((ROOT / "benchmarks" / "baselines" / "serve_bytes.json").read_text())


def _setup(arch, policy=None):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    if policy:
        jcfg = dataclasses.replace(jcfg, policy_name=policy)
        tcfg = dataclasses.replace(tcfg, policy_name=policy)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def yi():
    return _setup("yi-9b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prompts(n, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (n, S)).astype(np.int32)


# --------------------------------------------------------------------- #
# delayed scaling
# --------------------------------------------------------------------- #
def test_fp8_scale_state_updates_equal_reference():
    """A stream of amax observations per head (finite, zero, inf, NaN,
    negative) through both: every state bit for bit the reference's
    (which vmaps the scalar update over the heads)."""
    obs = np.array([[0.5, 0.0, 2.0], [0.25, 0.0, np.inf], [3.0, 0.0, np.nan],
                    [1.0, 0.0, -1.0], [0.125, 0.0, 4.0]], np.float32)
    t = tscale.init_fp8_scale(4, lead=(3,))
    j = jax.vmap(lambda _: jscale.init_fp8_scale(4))(jnp.arange(3))
    upd = jax.vmap(jscale.update_fp8_scale)
    for row in obs:
        t = tscale.update_fp8_scale(t, torch.from_numpy(row))
        j = upd(j, jnp.asarray(row))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tscale.fp8_scale_of(t, margin=2.0).numpy(),
                                  np.asarray(jax.vmap(lambda s: jscale.fp8_scale_of(
                                      s, margin=2.0))(j)))
    x = torch.tensor([[-3.0, 1.0], [0.5, 2.0]])
    o = tscale.observe_amax(tscale.init_fp8_scale(), x)
    assert o.scale.item() == 3.0 and o.amax_history[0].item() == 3.0


# --------------------------------------------------------------------- #
# the cache: prefill, decode, MLA
# --------------------------------------------------------------------- #
def _bcast(sc, name):
    """A scale leaf ``(layers..., [Hkv])`` shaped against its data leaf."""
    if name in ("k", "v"):
        return sc.reshape(*sc.shape[:-1], 1, sc.shape[-1], 1, 1)
    return sc.reshape(*sc.shape, 1, 1, 1)


def _dequant(sub, name):
    return sub[name].float() * _bcast(sub[f"{name}_scale"]["scale"], name)


def _within_e4m3(sub8, sub16, names, rows):
    for name in names:
        sc = _bcast(sub8[f"{name}_scale"]["scale"], name)
        got = _dequant(sub8, name)[..., :rows, :]
        want = sub16[name].float()[..., :rows, :]
        bound = E4M3_EPS * want.abs() + sc * 2.0 ** -9
        assert ((got - want).abs() <= bound).all(), name


@pytest.mark.parametrize("arch", ("yi-9b", "deepseek-moe-16b", "deepseek-v2-lite-16b"))
def test_fp8_prefill_rows_and_decode_logits_within_reference_bounds(arch):
    """The FP8 cache's prefill rows within one E4M3 step of the 16-bit
    cache's, and six greedy decode steps from it within the reference's
    logit band of the 16-bit cache's.  The band is the reference's for the
    GQA / MHA caches; its own MLA run (the absorbed decode over the
    per-tensor-scaled latent) reaches 0.69 there, so deepseek-v2-lite-16b's
    decode is held to the reference instead
    (:func:`test_fp8_cache_against_reference_fp32`)."""
    _, tcfg, _, tparams = _setup(arch)
    prompts = torch.from_numpy(_prompts(2, 6)).long()
    lg16, c16 = tt.prefill(tparams, tcfg, {"inputs": prompts}, 14)
    lg8, c8 = tt.prefill(tparams, tcfg, {"inputs": prompts}, 14, storage_dtype=FP8)
    assert tkv.is_fp8_cache(c8) and not tkv.is_fp8_cache(c16)
    assert (lg16.float() - lg8.float()).abs().max().item() <= 1e-2
    names = ("ckv", "kr") if tcfg.mla else ("k", "v")
    for key in c8:
        _within_e4m3(c8[key], c16[key], names, 6)
    tok = lg16.argmax(-1)[:, None]
    diffs = []
    for i in range(6):
        lg16, c16 = tt.serve_step(tparams, tcfg, tok, c16, 6 + i)
        lg8, c8 = tt.serve_step(tparams, tcfg, tok, c8, 6 + i)
        diffs.append((lg16.float() - lg8.float()).abs().max().item())
        tok = lg16.argmax(-1)[:, None]
    if not tcfg.mla:
        assert max(diffs) < 0.5 and sum(diffs) / len(diffs) < 0.3, diffs


@pytest.mark.parametrize("arch", ("yi-9b", "deepseek-v2-lite-16b"))
def test_fp8_cache_against_reference_fp32(arch):
    """The same weights and prompt through both packages under fp32: the
    scales agree to 1e-5, the dequantized rows within one E4M3 step (codes
    differ only where an fp32 rounding crosses an E4M3 boundary), after
    the prefill and after two decode steps."""
    jcfg, tcfg, jparams, tparams = _setup(arch, "fp32")
    prompt = _prompts(1, 7, seed=4)
    _, jc = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, 12,
                       storage_dtype=FP8)
    _, tc = tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()}, 12,
                       storage_dtype=FP8)
    tok = np.zeros((1, 1), np.int32)
    for i in range(2):
        jl, jc = jt.serve_step(jparams, jcfg, jnp.asarray(tok), jc, jnp.int32(7 + i))
        tl, tc = tt.serve_step(tparams, tcfg, torch.from_numpy(tok).long(), tc, 7 + i)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jl = torch.from_numpy(np.array(jl))
    assert ((tl - jl).abs().max() / jl.abs().max()).item() <= 1e-3
    want = convert.cache_from_jax(_np(jc), device="cpu")
    names = ("ckv", "kr") if tcfg.mla else ("k", "v")
    for key in tc:
        for name in names:
            a, b = tc[key][f"{name}_scale"], want[key][f"{name}_scale"]
            torch.testing.assert_close(a["scale"], b["scale"], rtol=1e-5, atol=0)
            assert torch.equal(a["overflow_count"], b["overflow_count"])
            wide = {name: _dequant(want[key], name)}
            _within_e4m3(tc[key], wide, (name,), 9)
            same = (tc[key][name].view(torch.uint8) == want[key][name].view(torch.uint8))
            assert same.float().mean().item() >= 0.99


# --------------------------------------------------------------------- #
# slot admission
# --------------------------------------------------------------------- #
def _scaled(single, factor):
    """A copy of an FP8 cache tree with every stored scale times
    ``factor`` (its dequantized values scaled, its codes unchanged)."""
    return {key: {name: (dict(leaf, scale=leaf["scale"] * factor)
                         if name.endswith("_scale") else leaf)
                  for name, leaf in sub.items()} for key, sub in single.items()}


def _assert_same_tree(got, want):
    for key, sub in got.items():
        for name, leaf in sub.items():
            if isinstance(leaf, dict):
                for f in leaf:
                    assert torch.equal(leaf[f], want[key][name][f]), (key, name, f)
            else:
                assert torch.equal(leaf.view(torch.uint8),
                                   want[key][name].view(torch.uint8)), (key, name)


@pytest.mark.parametrize("arch", ("yi-9b", "deepseek-v2-lite-16b"))
def test_fp8_insert_slot_equals_reference_bitwise(arch):
    """Admissions into an FP8 pool from the same caches in both packages:
    codes and every scale leaf equal bit for bit.  A second admission with
    the same amax leaves the ratchet where it was and the first slot's
    codes bitwise unchanged; a third with its values doubled moves the
    ratchet, and the co-resident slots' rows stay within one E4M3 step."""
    jcfg, tcfg, jparams, _ = _setup(arch)
    dt = tcfg.policy.compute_dtype
    names = ("ckv", "kr") if tcfg.mla else ("k", "v")
    jpool = jt.init_cache(jcfg, 3, 8, dtype=jcfg.policy.compute_dtype, storage_dtype=FP8)
    tpool = convert.cache_from_jax(_np(jpool), device="cpu")
    _, single = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(_prompts(1, 5, 2))}, 8,
                           storage_dtype=FP8)
    for slot in (1, 0):
        jpool = jkv.insert_slot(jpool, single, jnp.int32(slot), jcfg.policy.compute_dtype)
        tkv.insert_slot(tpool, convert.cache_from_jax(_np(single), device="cpu"), slot, dt)
        _assert_same_tree(tpool, convert.cache_from_jax(_np(jpool), device="cpu"))
        if slot == 1:
            first = {(k, n): leaf.select(b, 1).clone() for k, n, leaf, b in
                     tkv.iter_kv_leaves(tpool)}
            scales = {(k, n): tpool[k][f"{n}_scale"]["scale"].clone()
                      for k in tpool for n in names}
    for (k, n), sc in scales.items():
        assert torch.equal(tpool[k][f"{n}_scale"]["scale"], sc)
    for k, n, leaf, b in tkv.iter_kv_leaves(tpool):
        assert torch.equal(leaf.select(b, 1).view(torch.uint8),
                           first[(k, n)].view(torch.uint8)), (k, n)

    before = {(k, n): _dequant(tpool[k], n) for k in tpool for n in names}
    hot = _scaled(_np(single), 2.0)
    jpool = jkv.insert_slot(jpool, hot, jnp.int32(2), jcfg.policy.compute_dtype)
    tkv.insert_slot(tpool, convert.cache_from_jax(hot, device="cpu"), 2, dt)
    _assert_same_tree(tpool, convert.cache_from_jax(_np(jpool), device="cpu"))
    for (k, n), wide in before.items():
        sc = tpool[k][f"{n}_scale"]["scale"]
        assert (sc > scales[(k, n)]).all()
        bax = wide.ndim - (4 if n in ("k", "v") else 3)
        keep = torch.tensor([0, 1])
        got = _dequant(tpool[k], n).index_select(bax, keep)
        want = wide.index_select(bax, keep)
        assert ((got - want).abs() <= E4M3_EPS * want.abs()
                + _bcast(sc, n) * 2.0 ** -9).all(), (k, n)


# --------------------------------------------------------------------- #
# byte accounting and the decode step's bills
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ("yi-9b", "deepseek-moe-16b"))
def test_serve_bytes_pinned_fp8_below_fp16_same_flops(arch):
    """``serve_bytes.json`` exactly: the KV bytes of one decode step at
    per-slot lengths [4, 9, 17] (a 4-slot pool, one parked), FP8 and the
    compute dtype, and the instrumented decode flops, equal across the two
    storage dtypes."""
    base = SERVE_BYTES
    lengths = base["lengths"]
    cfg = tconfigs.get_reduced(arch)
    assert tkv.decode_step_kv_bytes(cfg, lengths) == base[arch]["fp16_bytes"]
    assert tkv.decode_step_kv_bytes(cfg, lengths, FP8) == base[arch]["fp8_bytes"]
    params = tt.init_params(cfg, seed=0, device="cpu")
    sizes = list(lengths) + [0]
    flops = set()
    for sd in (None, FP8):
        ev = tsched.instrumented_decode_events(
            params, cfg, tsched.SchedulerConfig(n_slots=4, max_len=32, storage_dtype=sd),
            sizes)
        assert all(e.spec.op.startswith("serve_decode/") for e in ev)
        flops.add(te.total_flops(ev))
    assert flops == {base[arch]["engine_flops"]}
    jcfg = jconfigs.get_reduced(arch)
    for sd in (None, FP8):
        assert tkv.cache_size_bytes(cfg, 4, 32, sd) == jkv.cache_size_bytes(jcfg, 4, 32, sd)
    assert tkv.cache_size_bytes(cfg, 4, 32, FP8) < tkv.cache_size_bytes(cfg, 4, 32)
    assert (tkv.token_elems(cfg), tkv.n_scale_elems(cfg), tkv.n_cache_layers(cfg)) == \
        (jkv.token_elems(jcfg), jkv.n_scale_elems(jcfg), jkv.n_cache_layers(jcfg))


def test_full_width_token_elems():
    """yi-9b at full width: 48 layers x (k, v) x 4 KV heads x 128 = 49,152
    cache elements a token."""
    cfg = tconfigs.get("yi-9b")
    assert tkv.token_elems(cfg) == 48 * 2 * 4 * 128 == 49_152


# --------------------------------------------------------------------- #
# the scheduler and generate on the FP8 cache
# --------------------------------------------------------------------- #
def test_scheduler_fp8_runs_and_tracks_the_reference(yi):
    jcfg, tcfg, jparams, tparams = yi
    lc = dict(rate=1.0, n_requests=3, prompt_len=4, gen_len=3, seed=1)
    scfg = dict(n_slots=2, max_len=12, storage_dtype=FP8)
    js = jsched.Scheduler(jparams, jcfg, jsched.SchedulerConfig(**scfg))
    js.submit(jloadgen.poisson_requests(jcfg, jloadgen.LoadConfig(**lc)))
    js.run()
    ts = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(**scfg))
    ts.submit(tloadgen.poisson_requests(tcfg, tloadgen.LoadConfig(**lc)))
    res = ts.run()
    assert ts.trace == js.trace
    assert all(len(r.tokens) == 3 and all(0 <= t < 512 for t in r.tokens) for r in res)
    health = tkv.scale_health(ts.cache)
    assert set(health) == set(jkv.scale_health(js.cache))
    assert all(d["overflow_total"] == 0 and d["max_scale"] > 0 for d in health.values())


def test_scheduler_moe_fp8_smoke():
    cfg = tconfigs.get_reduced("deepseek-moe-16b")
    params = tt.init_params(cfg, seed=0, device="cpu")
    sched = tsched.Scheduler(params, cfg, tsched.SchedulerConfig(
        n_slots=2, max_len=12, storage_dtype=FP8))
    sched.submit(tloadgen.poisson_requests(cfg, tloadgen.LoadConfig(
        rate=1.0, n_requests=3, prompt_len=4, gen_len=3, seed=1)))
    assert all(len(r.tokens) == 3 for r in sched.run())


def test_generate_fp8_storage(yi):
    _, tcfg, _, tparams = yi
    prompts = _prompts(2, 6, seed=3)
    seqs = tserve.generate(tparams, tcfg, prompts, 4, storage_dtype=FP8)
    assert seqs.shape == (2, 10) and np.array_equal(seqs[:, :6], prompts)
    with pytest.raises(ValueError, match="FP8"):
        tt.init_cache(tconfigs.get_reduced("xlstm-1.3b"), 1, 8, storage_dtype=FP8,
                      device="cpu")
    with pytest.raises(ValueError, match="storage_dtype"):
        tt.init_cache(tcfg, 1, 8, storage_dtype="float16", device="cpu")


def test_frozen_weight_quantization_is_the_fresh_one():
    """Serving under an FP8 policy quantizes a weight once and reuses it
    while the weight is unchanged: the same values as a fresh
    quantization, redone after an in-place write, never for a tensor made
    inside inference mode or outside it."""
    w = torch.randn(64, 32)
    view = w[8:40]
    with torch.inference_mode():
        a = te._frozen_fp8(view, FP8)
        assert a is te._frozen_fp8(w[8:40], FP8)            # a new view, the same key
        fresh = tprec.quantize_fp8(view, FP8)
        assert torch.equal(a[0].view(torch.uint8), fresh[0].view(torch.uint8))
        assert torch.equal(a[1], fresh[1])
        assert te._frozen_fp8(torch.randn(4, 4), FP8) is None   # an inference tensor
    w.mul_(2.0)                                              # bumps the version
    with torch.inference_mode():
        b = te._frozen_fp8(w[8:40], FP8)
        assert b is not a and torch.equal(b[1], a[1] * 2)
    assert te._frozen_fp8(w, FP8) is None                    # outside inference mode
    del w, view, a, b
    import gc
    gc.collect()
    assert not [k for k in te._FP8_FROZEN if k[1:3] == (256, (32, 32))]


def test_fp8_serving_with_frozen_weights_equals_fresh(yi):
    """A mixed_fp8_e4m3 decode run with the weights' quantization kept is
    bitwise the run that quantizes every dispatch."""
    _, tcfg, _, tparams = yi
    cfg = dataclasses.replace(tcfg, policy_name="mixed_fp8_e4m3")
    params = {k: v for k, v in tparams.items()}
    prompts = _prompts(2, 6, seed=5)
    kept = tserve.generate(params, cfg, prompts, 3, storage_dtype=FP8, return_state=True)
    te._FP8_FROZEN.clear()
    orig = te._frozen_fp8
    te._frozen_fp8 = lambda v, d: None
    try:
        fresh = tserve.generate(params, cfg, prompts, 3, storage_dtype=FP8,
                                return_state=True)
    finally:
        te._frozen_fp8 = orig
    np.testing.assert_array_equal(kept[0], fresh[0])
    np.testing.assert_array_equal(kept[2], fresh[2])
