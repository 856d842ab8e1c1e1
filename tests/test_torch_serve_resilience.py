"""The port's serving resilience layer against the JAX package, on the CPU.

Reduced yi-9b; both packages start from the reference's initial parameters
(``repro_torch.convert.params_from_jax``) and see the same requests, so the
virtual-clock event logs, statuses and goodput counters must be equal, not
close: they are host-side arithmetic.  Tokens are not compared across the
packages (under tpu_bf16 the two round at different places and the tiny
random model has near-ties); the recovery contract compares the port's
injected run with its own uninjected run, as the reference's tests do.

The recovery contract: the reference's rebuild re-prefills ``prompt +
absorbed tokens`` and is bit-identical to the decode-built cache because
its prefill (the q-chunked route, the one it takes under jax 0.9) equals
its decode step row for row.  The port reproduces that bitwise on the same
route (a backend without the ``attention`` capability), and on its own
flash route too: it re-prefills the prompt at the admission's shape and
replays the absorbed tokens through decode steps at the pool's batch.
Its FP8 cache keeps the reference's batch-1 re-prefill, within one E4M3
step.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.runtime.fault_tolerance import FailureInjector as JInjector
from repro.serving import loadgen as jloadgen
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.models import transformer as tt
from repro_torch.runtime.fault_tolerance import FailureInjector, InjectedFault
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving import resilience as tres
from repro_torch.serving import scheduler as tsched

ROOT = Path(__file__).resolve().parents[1]
FP8 = "float8_e4m3fn"
SLO = json.loads((ROOT / "benchmarks" / "baselines" / "serve_slo.json").read_text())
# the reference's measured goodputs of the SLO scenario (serve_slo.json's
# comment; prefill_crash bills one prefill of waste, as kv_corrupt does)
SLO_GOODPUT = {None: 1.0, "nan_logits": 12 / 13, "kv_corrupt": 0.96,
               "prefill_crash": 0.96}


@pytest.fixture(scope="module")
def yi():
    jcfg = jconfigs.get_reduced("yi-9b")
    tcfg = tconfigs.get_reduced("yi-9b")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def reference_route():
    """The hopper backend without the ``attention`` capability: prefill
    takes the q-chunked route, as the reference's does under jax 0.9."""
    te.register_backend("hopper_q_chunked", te.get_backend("hopper").fn,
                        capabilities=("fused_epilogue", "tiled", "layouts"))
    return "hopper_q_chunked"


def _requests(module, cfg, n=2, plen=5, gen=5, arrival=0.0, **kw):
    rng = np.random.default_rng(11)
    return [module.Request(rid=i, arrival=arrival,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               size=plen + i).astype(np.int32),
                           max_new_tokens=gen, **kw)
            for i in range(n)]


def _both(yi, scfg_kw, requests, injector=None):
    """Drain the same requests through both schedulers; returns (ref, port)
    schedulers and their results by rid."""
    jcfg, tcfg, jparams, tparams = yi
    out = []
    for m, cfg, params, inj in ((jsched, jcfg, jparams, JInjector),
                                (tsched, tcfg, tparams, FailureInjector)):
        s = m.Scheduler(params, cfg, m.SchedulerConfig(**scfg_kw),
                        injector=None if injector is None else inj(**injector))
        s.submit(requests(m))
        out.append((s, {r.rid: r for r in s.run()}))
    return out


def _same_story(ref, port):
    (js, jr), (ts, tr) = ref, port
    assert ts.trace == js.trace
    assert ts.health == js.health
    assert ts.rejections == [tres.Rejection(**dataclasses.asdict(r))
                             for r in js.rejections]
    assert ts.goodput.report() == js.goodput.report()
    assert {k: (r.status, r.first_token_tick, r.finish_tick) for k, r in tr.items()} \
        == {k: (r.status, r.first_token_tick, r.finish_tick) for k, r in jr.items()}


def test_undrained_result_metrics_are_nan(yi):
    _, tcfg, _, tparams = yi
    sched = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(n_slots=1, max_len=16))
    sched.submit(_requests(tsched, tcfg))
    assert math.isnan(sched.results[0].ttft)
    sched.step()
    assert math.isnan(sched.results[0].tokens_per_tick)
    assert math.isnan(sched.results[1].ttft) and sched.results[1].status == "pending"


def test_deadline_eviction_matches_reference(yi):
    """One slot: a request expires queued, one is evicted mid-decode, the
    freed slot serves later work — the reference's story event for event."""
    def reqs(m):
        rng = np.random.default_rng(3)
        mk = lambda rid, arr, gen, dl: m.Request(
            rid=rid, arrival=arr, prompt=rng.integers(0, 512, size=4).astype(np.int32),
            max_new_tokens=gen, deadline_ticks=dl)
        return [mk(0, 0.0, 8, None), mk(1, 0.0, 2, 3.0), mk(2, 20.0, 8, 3.0),
                mk(3, 40.0, 2, None)]
    ref, port = _both(yi, dict(n_slots=1, max_len=24), reqs)
    _same_story(ref, port)
    ts, tr = port
    assert [tr[i].status for i in range(4)] == ["finished", "expired", "expired", "finished"]
    assert ("evict", 2) in [(e[0], e[2]) for e in ts.trace]
    assert ts.goodput.wasted_tokens == len(tr[2].tokens) > 0


def test_bounded_queue_and_shedding_match_reference(yi):
    """A bounded queue rejects with retry_after; a shed policy drops the
    infeasible and the lowest-priority queued work, in the reference's
    order."""
    ref, port = _both(yi, dict(n_slots=1, max_len=16, max_queue=1),
                      lambda m: _requests(m, yi[1], n=4, plen=4, gen=2))
    _same_story(ref, port)
    assert {r.rid for r in port[0].rejections} == {2, 3}
    assert all(r.reason == "queue_full" and r.retry_after >= 1.0
               for r in port[0].rejections)

    def shed_reqs(m):
        rng = np.random.default_rng(5)
        mk = lambda rid, gen, dl, pr: m.Request(
            rid=rid, arrival=0.0, prompt=rng.integers(0, 512, size=4).astype(np.int32),
            max_new_tokens=gen, deadline_ticks=dl, priority=pr)
        return [mk(0, 4, None, 0), mk(1, 8, 5.0, 1), mk(2, 4, None, 1), mk(3, 4, None, 0)]
    jcfg, tcfg, jparams, tparams = yi
    js = jsched.Scheduler(jparams, jcfg, jsched.SchedulerConfig(
        n_slots=1, max_len=24, shed=jsched.resilience.ShedPolicy(queue_high_water=1)))
    js.submit(shed_reqs(jsched))
    jr = {r.rid: r for r in js.run()}
    ts = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(
        n_slots=1, max_len=24, shed=tres.ShedPolicy(queue_high_water=1)))
    ts.submit(shed_reqs(tsched))
    tr = {r.rid: r for r in ts.run()}
    _same_story((js, jr), (ts, tr))
    assert [e[2] for e in ts.trace if e[0] == "shed"] == [1, 3]


def test_shed_policy_ordering_is_the_reference():
    from repro.serving.resilience import ShedPolicy as JShed
    mk = lambda m: [m.Request(rid=i, arrival=float(i % 3), prompt=np.zeros(4, np.int32),
                              max_new_tokens=4, priority=i % 2,
                              deadline_ticks=None if i % 4 else 9.0) for i in range(6)]
    for kw in (dict(queue_high_water=2, shed_infeasible=False),
               dict(queue_high_water=1, shed_infeasible=True)):
        got = tres.ShedPolicy(**kw).select_shed(mk(tsched), clock=4.0, prefill_ticks=1.0)
        want = JShed(**kw).select_shed(mk(jsched), clock=4.0, prefill_ticks=1.0)
        assert [r.rid for r in got] == [r.rid for r in want]
    assert tres.retry_after_hint(3, 1.0) == 3.0


def test_loadgen_retries_match_reference(yi):
    """Client retries with backoff and seeded jitter: every metric that is
    not a wall-clock reading equals the reference's."""
    jcfg, tcfg, jparams, tparams = yi
    lc = dict(rate=4.0, n_requests=5, prompt_len=4, gen_len=2, seed=0, max_retries=4)
    want = jloadgen.run_load(jparams, jcfg, jsched.SchedulerConfig(
        n_slots=1, max_len=16, max_queue=1), jloadgen.LoadConfig(**lc))
    got = tloadgen.run_load(tparams, tcfg, tsched.SchedulerConfig(
        n_slots=1, max_len=16, max_queue=1), tloadgen.LoadConfig(**lc))
    assert got["retries"] > 0
    wall = {"wall_s", "s_per_tick", "p50_tokens_per_s", "p99_tokens_per_s"}
    assert {k: v for k, v in got.items() if k not in wall} == \
        {k: v for k, v in want.items() if k not in wall}
    reqs = tloadgen.poisson_requests(tcfg, tloadgen.LoadConfig(rate=0.7, n_requests=5))
    jreqs = jloadgen.poisson_requests(jcfg, jloadgen.LoadConfig(rate=0.7, n_requests=5))
    assert [(r.rid, r.arrival, r.prompt.tolist()) for r in reqs] == \
        [(r.rid, r.arrival, r.prompt.tolist()) for r in jreqs]


def test_prefill_crash_retries_like_reference(yi):
    ref, port = _both(yi, dict(n_slots=2, max_len=16),
                      lambda m: _requests(m, yi[1]),
                      injector=dict(fail_at_step=1, mode="prefill_crash"))
    _same_story(ref, port)
    base = tsched.Scheduler(yi[3], yi[1], tsched.SchedulerConfig(n_slots=2, max_len=16))
    base.submit(_requests(tsched, yi[1]))
    rb = {r.rid: r for r in base.run()}
    ts, tr = port
    assert any(e[0] == "prefill_retry" for e in ts.trace)
    for rid in rb:
        assert rb[rid].tokens == tr[rid].tokens
        np.testing.assert_array_equal(rb[rid].final_logits, tr[rid].final_logits)
    assert ts.goodput.recoveries == 1 and ts.goodput.goodput < base.goodput.goodput


@pytest.mark.parametrize("storage", [None, FP8])
def test_slot_checksum_equals_reference_and_flags_the_slot(yi, storage):
    """The same pool in both packages (the reference's, carried across bit
    for bit): equal CRC32 digests per slot, before and after the same
    corruption, which flags exactly slot 1."""
    jcfg, tcfg, jparams, _ = yi
    pool = jt.init_cache(jcfg, 3, 8, dtype=jcfg.policy.compute_dtype,
                         storage_dtype=storage)
    seq = np.random.default_rng(7).integers(0, 512, size=(1, 5)).astype(np.int32)
    _, single = jt.prefill(jparams, jcfg, {"inputs": seq}, 8, storage_dtype=storage)
    pool = jkv.insert_slot(pool, single, 1, jcfg.policy.compute_dtype)
    tpool = convert.cache_from_jax(jax.tree.map(np.asarray, pool), device="cpu")
    for i in range(3):
        assert tkv.slot_checksum(tpool, i, 5) == jkv.slot_checksum(pool, i, 5)
    jbad = jkv.corrupt_slot_rows(pool, 1, [0, 4])
    tbad = tkv.corrupt_slot_rows(tpool, 1, [0, 4])
    assert [tkv.slot_checksum(tbad, i, 5) for i in range(3)] == \
        [jkv.slot_checksum(jbad, i, 5) for i in range(3)]
    assert tkv.slot_checksum(tbad, 1, 5) != tkv.slot_checksum(tpool, 1, 5)
    assert tkv.slot_checksum(tbad, 0, 5) == tkv.slot_checksum(tpool, 0, 5)
    twice = tkv.corrupt_slot_rows(tbad, 1, [0, 4])
    assert tkv.slot_checksum(twice, 1, 5) == tkv.slot_checksum(tpool, 1, 5)


@pytest.mark.parametrize("mode,detect", [("nan_logits", "nan_detect"),
                                         ("kv_corrupt", "kv_quarantine")])
def test_recovery_bit_identical_on_the_reference_route(yi, reference_route, mode, detect):
    """nan_logits / kv_corrupt at decode step 2 on the 16-bit cache: the
    victim's tokens and final logits bit-identical to the uninjected run,
    the co-resident slot untouched, the event log the uninjected one plus
    the quarantine / recovery pair — and the reference's log."""
    jcfg, tcfg, jparams, tparams = yi
    scfg = dict(n_slots=2, max_len=16, audit_every=1)
    reqs = lambda m: _requests(m, tcfg, n=2, plen=4, gen=6)
    with te.use_backend(reference_route):
        ref, port = _both(yi, scfg, reqs, injector=dict(fail_at_step=2, mode=mode, target=0))
        base = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(**scfg))
        base.submit(reqs(tsched))
        rb = {r.rid: r for r in base.run()}
    (js, jr), (ts, tr) = ref, port
    assert ts.trace == js.trace and ts.goodput.report() == js.goodput.report()
    assert [e for e in ts.trace if e[0] == detect][0][2] == 0
    for rid in (0, 1):
        assert tr[rid].tokens == rb[rid].tokens
        np.testing.assert_array_equal(tr[rid].final_logits, rb[rid].final_logits)
        assert tr[rid].finish_tick == rb[rid].finish_tick
    assert [e for e in ts.trace if e[0] not in (detect, "recover")] == base.trace
    assert ts.goodput.recoveries == 1 and ts.goodput.goodput < base.goodput.goodput


@pytest.mark.parametrize("mode,detect", [("nan_logits", "nan_detect"),
                                         ("kv_corrupt", "kv_quarantine")])
def test_recovery_bit_identical_on_the_port_route(yi, mode, detect):
    """The port's own route (flash prefill): the rebuild re-prefills the
    prompt at the admission's shape and replays the absorbed tokens at the
    decode steps' batch, so the victim's tokens and final logits are
    bit-identical to the uninjected run's, and so are the rebuilt rows."""
    _, tcfg, _, tparams = yi
    scfg = tsched.SchedulerConfig(n_slots=2, max_len=16, audit_every=1)
    reqs = _requests(tsched, tcfg, n=2, plen=4, gen=6)
    runs = []
    for inj in (None, FailureInjector(fail_at_step=2, mode=mode, target=0)):
        sched = tsched.Scheduler(tparams, tcfg, scfg, injector=inj)
        sched.submit(reqs)
        for _ in range(4):
            sched.step()
        rows = {n: leaf.select(b, 0).clone() for _, n, leaf, b in
                tkv.iter_kv_leaves(sched.cache)}
        runs.append((sched, rows, {r.rid: r for r in sched.run()}))
    (base, rows0, rb), (ts, rows1, tr) = runs
    assert [e[2] for e in ts.trace if e[0] == detect] == [0]
    for n in rows0:
        assert torch.equal(rows1[n].view(torch.int16), rows0[n].view(torch.int16)), n
    for rid in (0, 1):
        assert tr[rid].tokens == rb[rid].tokens
        np.testing.assert_array_equal(tr[rid].final_logits, rb[rid].final_logits)
    assert [e for e in ts.trace if e[0] not in (detect, "recover")] == base.trace


def test_rebuild_restores_the_row_the_replay_parks_on(yi):
    """The 16-bit rebuild replays in the pool itself, parking the other
    slots on the last row: a co-resident slot's bytes there (its newest
    row once it reaches ``max_len``) come back unmoved, with the rest of
    the slot, and the victim's rows are the decode-built ones."""
    _, tcfg, _, tparams = yi
    scfg = tsched.SchedulerConfig(n_slots=2, max_len=16, audit_every=1)
    sched = tsched.Scheduler(tparams, tcfg, scfg)
    sched.submit(_requests(tsched, tcfg, n=2, plen=4, gen=6))
    for _ in range(4):
        sched.step()
    s0 = sched.slots[0]
    for _, _, leaf, b in tkv.iter_kv_leaves(sched.cache):
        leaf.select(b, 1)[..., -1, :] = 7.0   # a sentinel on the parked row
    before = {(k, n): leaf.clone() for k, n, leaf, b in tkv.iter_kv_leaves(sched.cache)}
    sched._rebuild_slot(0, s0, rerun_decode=False)
    assert sched.recovery_decode_steps == s0.fed
    for k, n, leaf, b in tkv.iter_kv_leaves(sched.cache):
        assert torch.equal(leaf.select(b, 1).view(torch.int16),
                           before[(k, n)].select(b, 1).view(torch.int16)), n
        assert torch.equal(leaf.select(b, 0)[..., :s0.pos, :].view(torch.int16),
                           before[(k, n)].select(b, 0)[..., :s0.pos, :]
                           .view(torch.int16)), n


def test_fp8_rebuild_within_e4m3_bound_and_co_resident_untouched(yi, reference_route):
    """The reference's FP8 recovery pin on its route: a corrupted FP8 slot
    is rebuilt within the E4M3 bound of a 16-bit full prefill of its
    absorbed tokens, and the co-resident slot's codes are bitwise
    untouched (the rebuilt rows carry the same values, so the ratchet does
    not move)."""
    _, tcfg, _, tparams = yi
    scfg = tsched.SchedulerConfig(n_slots=2, max_len=16, storage_dtype=FP8, audit_every=1)
    with te.use_backend(reference_route):
        sched = tsched.Scheduler(tparams, tcfg, scfg)
        sched.submit(_requests(tsched, tcfg, n=2, plen=4, gen=6))
        for _ in range(4):
            sched.step()
        s0 = sched.slots[0]
        before = {(k, n): leaf.select(b, 1).clone() for k, n, leaf, b in
                  tkv.iter_kv_leaves(sched.cache)}
        scale_before = sched.cache["layers"]["k_scale"]["scale"].clone()
        sched.cache = tkv.corrupt_slot_rows(sched.cache, 0, [0, s0.pos - 1])
        sched._audit_slots()
        absorbed = np.concatenate([s0.prompt, np.asarray(
            sched.results[s0.rid].tokens[:s0.fed], np.int32)])
        _, oracle = tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(
            absorbed).long()[None]}, scfg.max_len)
    assert any(e[0] == "kv_quarantine" and e[2] == s0.rid for e in sched.trace)
    assert torch.equal(sched.cache["layers"]["k_scale"]["scale"], scale_before)
    for k, n, leaf, b in tkv.iter_kv_leaves(sched.cache):
        assert torch.equal(leaf.select(b, 1).view(torch.uint8),
                           before[(k, n)].view(torch.uint8)), n
    _assert_e4m3_bound(sched.cache["layers"], oracle["layers"], slot=0,
                       rows=absorbed.shape[0])


E4M3_EPS = 2.0 ** -3   # tests/test_precision_fp8.py's relative step


def _assert_e4m3_bound(sub8, sub16, *, slot, rows):
    for name in ("k", "v"):
        sc = sub8[f"{name}_scale"]["scale"]                     # (L, Hkv)
        got = (sub8[name].float() * sc[:, None, :, None, None])[:, slot, :, :rows]
        want = sub16[name].float()[:, 0, :, :rows]
        bound = E4M3_EPS * want.abs() + sc[:, :, None, None] * 2.0 ** -9
        assert ((got - want).abs() <= bound).all(), name


@pytest.mark.parametrize("mode", [None, "nan_logits", "kv_corrupt", "prefill_crash"])
def test_slo_scenario_reproduces_the_reference(yi, monkeypatch, mode):
    """``serve_slo.json``'s scenario (FP8 cache, bounded queue, deadlines,
    audits every step, the fault at step 2 / prefill 1): the reference's
    goodput, deadline hit rate and recoveries, above the floors, and its
    full event log."""
    jcfg, tcfg, jparams, tparams = yi
    sc = SLO["scenario"]
    scfg = dict(n_slots=sc["n_slots"], max_len=sc["max_len"],
                storage_dtype=sc["storage_dtype"], max_queue=sc["max_queue"],
                audit_every=sc["audit_every"])
    lc = dict(rate=sc["rate"], n_requests=sc["n_requests"], prompt_len=sc["prompt_len"],
              gen_len=sc["gen_len"], seed=sc["seed"],
              deadline_ticks=sc["deadline_ticks"], max_retries=sc["max_retries"])
    at = 1 if mode == "prefill_crash" else sc["inject_step"]
    jruns = []

    class Traced(jsched.Scheduler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            jruns.append(self)

    monkeypatch.setattr(jloadgen, "Scheduler", Traced)
    want = jloadgen.run_load(jparams, jcfg, jsched.SchedulerConfig(**scfg),
                             jloadgen.LoadConfig(**lc),
                             injector=mode and JInjector(fail_at_step=at, mode=mode))
    truns = []
    inj = mode and FailureInjector(fail_at_step=at, mode=mode)
    rows, got = tloadgen.slo_rows(tparams, tcfg, tsched.SchedulerConfig(**scfg),
                                  "yi-9b", tloadgen.LoadConfig(**lc), injector=inj,
                                  scheduler=truns)
    assert truns[0].trace == jruns[0].trace
    assert truns[0].health == jruns[0].health
    for k in ("slo_goodput", "deadline_hit_rate", "slo_recoveries", "n_finished",
              "retries", "abandons", "slo_expired", "slo_shed", "slo_rejected"):
        assert got[k] == want[k], k
    assert got["slo_goodput"] == pytest.approx(SLO_GOODPUT[mode], abs=1e-12)
    assert got["deadline_hit_rate"] == 1.0 == want["deadline_hit_rate"]
    floor = SLO["goodput_floor_uninjected"] if mode is None else SLO["goodput_floor_injected"]
    assert got["slo_goodput"] >= floor
    assert got["deadline_hit_rate"] >= SLO["deadline_hit_rate_floor"]
    if mode is not None:
        assert got["slo_recoveries"] >= SLO["recoveries_min"] and inj.fired
    (name, _, derived), = rows
    assert name.startswith("serve/yi-9b/slo") and "goodput=" in derived


def test_recovery_trace_deterministic_two_runs(yi):
    _, tcfg, _, tparams = yi
    runs = []
    for _ in range(2):
        s = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(
            n_slots=2, max_len=16, audit_every=1),
            injector=FailureInjector(fail_at_step=3, mode="kv_corrupt"))
        s.submit(tloadgen.poisson_requests(tcfg, tloadgen.LoadConfig(
            rate=1.0, n_requests=5, prompt_len=4, gen_len=5, seed=13,
            deadline_ticks=9.0)))
        s.run()
        runs.append((s.trace, s.health, {k: r.tokens for k, r in s.results.items()}))
    assert runs[0] == runs[1]
    ev = [e[0] for e in runs[0][0]]
    assert "kv_quarantine" in ev and ("evict" in ev or "expire" in ev)


def test_guardrails(yi):
    _, tcfg, _, tparams = yi
    with pytest.raises(ValueError, match="audit_every"):
        tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(n_slots=1, max_len=8),
                         injector=FailureInjector(fail_at_step=1, mode="kv_corrupt"))
    inj = FailureInjector(fail_at_step=1, mode="nan_logits")
    inj.maybe_fail(1)
    assert not inj.fired
    assert inj.fires(1, "kv_corrupt") is False
    assert inj.fires(1, "nan_logits") is True
    assert inj.fires(2, "nan_logits") is False
    with pytest.raises(InjectedFault):
        FailureInjector(fail_at_step=2, mode="raise").maybe_fail(2)
    # the checkpoint modes are ported (tests/test_torch_checkpoint_ft.py):
    # before their step, and in the other hook, they do nothing
    for mode in ("die", "sigterm", "ckpt_crash"):
        inj = FailureInjector(fail_at_step=3, mode=mode)
        inj.maybe_fail(2)
        inj.maybe_fail_save(2, None)
        assert not inj.fired and inj.fires(3, "nan_logits") is False
    FailureInjector(fail_at_step=1, mode="die").maybe_fail_save(1, None)
    # placing a restored tree over a mesh is ported (the sharding slice):
    # each rank keeps the block of its coordinates, on the mesh's device
    # (two ranks, reshard then gather: tests/test_torch_shard_exec.py)
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import sharding as ts
    from repro_torch.runtime.fault_tolerance import reshard
    tree = {"w": torch.arange(8.0).reshape(4, 2), "b": torch.arange(3.0)}
    specs = {"w": ts.P("model"), "b": ts.P()}
    one = reshard(tree, tmesh.make_host_mesh(), specs)
    assert torch.equal(one["w"], tree["w"]) and one["w"] is not tree["w"]
    rank1 = tmesh.Mesh((1, 2), ("data", "model"), device="cpu", rank=1)
    got = reshard(tree, rank1, specs)
    assert torch.equal(got["w"], tree["w"][2:]) and torch.equal(got["b"], tree["b"])
