"""The port's autotuner (``repro_torch.core.autotune``) on the CPU.

The reference's ``tests/test_autotune.py`` cases on the port's candidates
(each compiled tile times each split S the kernel takes; one chunk per
compiled size of kernel 4; the flash kernel's one block pair) with the
cost model (``mode="model"``): precedence explicit > cache > heuristic at
every dispatch site, the cold miss -> pick -> warm hit -> fresh LRU from
disk round trip, key separation, LRU eviction, the corrupt file.  Then the
port's own rules: the key's fields and ``bucket_dim`` equal the
reference's; one cache file shared with the reference (each package hits
its own entries, foreign ones survive a write); an entry the kernels
cannot run raises naming the file; the split is keyed on the launch's
batch; under the faithful fp16 accumulator a cached tile changes no
result (the plan is the heuristic's, bitwise on the plain version here —
``chip_smoke.py`` holds the kernel to it on the card).  The kernels
themselves run only on the card, so the measured mode is not timed here:
it raises without one.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import precision as jprec

from repro_torch.core import autotune, engine, tiling
from repro_torch.core import precision as prec
from repro_torch.kernels import chunked_linear_attention as cla
from repro_torch.kernels import redmule_matmul as rm

T16, T64 = tiling.GEMM_TILES[1], tiling.GEMM_TILES[0]


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch, tmp_path):
    """Every test gets empty LRUs (both packages') and its own JSON file."""
    monkeypatch.setenv(autotune.ENV_VAR, str(tmp_path / "autotune.json"))
    autotune.clear_cache()
    jautotune.clear_cache()
    yield
    autotune.clear_cache()
    jautotune.clear_cache()


def _key(m, n, k, policy=prec.TPU_BF16, **kw):
    return autotune.canonical_key(m, n, k, policy=policy, backend="hopper", **kw)


# ------------------------------------------------------------------ #
# Candidates and the cost model
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mnk, batch", [((4, 2048, 4096), 1), ((4, 6144, 2048), 1),
                                        ((128, 2048, 12288), 1), ((4, 512, 2048), 4),
                                        ((300, 700, 300), 1), ((7, 40, 9), 1)])
def test_candidates_are_runnable_and_include_the_heuristic(mnk, batch):
    M, N, K = mnk
    cands = autotune.candidate_tiles(M, N, K, policy=prec.TPU_BF16, batch=batch)
    assert len({(t.bm, t.bn, t.bk, t.splits) for t in cands}) == len(cands)
    for t in cands:
        tiling.tile_index(t)                     # a compiled tile
        plan = tiling.launch_plan(M, N, K, tile=t, batch=batch)
        rm.check_split(plan, N, route="tensor")  # a split the kernel takes
    h = tiling.choose_tiles(M, N, K)
    hs = tiling.split_plan(M, N, K, tile=h, batch=batch).splits
    assert dataclasses.replace(h, splits=hs) in cands
    # a pick by the model is among the candidates, cheapest first
    costs = [autotune.predicted_cost_us(M, N, K, t, policy=prec.TPU_BF16,
                                        batch=batch) for t in cands]
    assert costs[0] == min(costs)


def test_candidates_keep_the_heuristic_when_truncated():
    h = tiling.choose_tiles(4, 2048, 4096)
    h = dataclasses.replace(h, splits=tiling.split_plan(4, 2048, 4096, tile=h).splits)
    assert h in autotune.candidate_tiles(4, 2048, 4096, policy=prec.TPU_BF16,
                                         max_candidates=1)


def test_faithful_and_fused_candidates_keep_the_numerics():
    """Under an fp16 accumulator only the tile varies (the split is the
    heuristic's, splits 0); the fused backward is never split."""
    faithful = autotune.candidate_tiles(16, 640, 128, policy=prec.PAPER_FP16)
    assert {t.splits for t in faithful} == {0}
    assert {(t.bm, t.bk) for t in faithful} == {(t.bm, t.bk) for t in tiling.GEMM_TILES}
    fused = autotune.candidate_tiles(640, 16, 128, policy=prec.TPU_BF16,
                                     fused_bwd=True)
    assert {t.splits for t in fused} == {1}


def test_cost_model_penalises_idle_sms_and_needless_blocks():
    """A decode GEMM unsplit leaves the card idle and must cost more than
    the heuristic's split; a large GEMM split 32 ways pays for its blocks
    and partials and must cost more than unsplit."""
    pol = prec.TPU_BF16
    cost = lambda M, N, K, t: autotune.predicted_cost_us(M, N, K, t, policy=pol)
    assert cost(4, 2048, 4096, dataclasses.replace(T16, splits=1)) > \
        cost(4, 2048, 4096, dataclasses.replace(T16, splits=8))
    assert cost(4096, 4096, 4096, dataclasses.replace(T64, splits=32)) > \
        cost(4096, 4096, 4096, dataclasses.replace(T64, splits=1))
    # the fused backward's derivative stream is never free
    assert autotune.predicted_cost_us(640, 4096, 128, T64, policy=pol, layout="tn",
                                      fused_bwd=True, bias_grad=True) >= \
        autotune.predicted_cost_us(640, 4096, 128, T64, policy=pol, layout="tn")


def test_plan_for_splits_gives_plans_the_kernel_takes():
    for N in (1, 31, 96, 288, 1000, 2048, 6144, 32001):
        for S in range(0, 40):
            for route in ("tensor", "simt"):
                plan = tiling.plan_for_splits(N, S, route=route)
                rm.check_split(plan, N, route=route)
                assert 1 <= plan.splits <= max(S, 1)


def test_faithful_plan_ignores_the_tile():
    """The faithful accumulator's plan is the heuristic tile's whatever tile
    runs (it fixes the fp32 summation order inside a rounding block)."""
    for M, N, K in ((16, 640, 128), (640, 4096, 128), (16, 1536, 256)):
        blk = tiling.accum_block(M, N, K, compute_dtype=torch.float16,
                                 accum_dtype=torch.float16)
        plans = {tiling.launch_plan(M, N, K, tile=t, accum_block=blk)
                 for t in tiling.GEMM_TILES}
        assert plans == {tiling.split_plan(M, N, K, tile=tiling.choose_tiles(M, N, K),
                                           accum_block=blk)}
    with pytest.raises(ValueError, match="faithful"):
        tiling.launch_plan(16, 640, 128, tile=dataclasses.replace(T16, splits=2),
                           accum_block=1024)


def test_split_counters_grow_with_the_tiles():
    dev = torch.device("cpu")
    small = rm._tile_counters(dev, 8)
    big = rm._tile_counters(dev, 4 * small.numel() + 1)
    assert big.numel() >= 4 * small.numel() + 1 and not big.any()
    rm._COUNTERS.pop(dev)


def test_measured_mode_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        autotune.measured_cost_us(4, 64, 64, T16, policy=prec.TPU_BF16)
    assert autotune.autotune_gemm(4, 64, 64, policy=prec.TPU_BF16,
                                  record=False).source == "model"


# ------------------------------------------------------------------ #
# Canonical keys
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("v", [0, 1, 2, 3, 5, 8, 100, 255, 256, 257, 511, 512,
                               513, 1023, 1500, 2048, 32001, 151936])
def test_bucket_dim_equals_reference(v):
    assert autotune.bucket_dim(v) == jautotune.bucket_dim(v)


_KEY_CASES = [
    dict(),
    dict(policy="paper_fp16", epilogue="relu"),
    dict(policy="tpu_fp16", layout="nt"),
    dict(policy="fp32", layout="tn", fused_bwd=True),
    dict(policy="mixed_fp8_e4m3", x_dtype="float8_e4m3fn", w_dtype="float8_e4m3fn"),
    dict(policy="mixed_fp8_e4m3", x_dtype="float8_e5m2", w_dtype="float8_e4m3fn",
         layout="nt"),
    dict(policy="fp32", sweep="lattn"),
    dict(policy="tpu_bf16", sweep="attnc"),
]


@pytest.mark.parametrize("mnk", [(4, 2048, 4096), (100, 200, 50), (1, 1, 1),
                                 (600, 5000, 513)])
@pytest.mark.parametrize("case", range(len(_KEY_CASES)))
def test_key_fields_equal_reference(mnk, case):
    kw = dict(_KEY_CASES[case])
    pol = kw.pop("policy", "tpu_bf16")
    t = autotune.canonical_key(*mnk, policy=prec.resolve(pol), backend="hopper", **kw)
    j = jautotune.canonical_key(*mnk, policy=jprec.resolve(pol), backend="hopper", **kw)
    jd = dataclasses.asdict(j)
    td = dataclasses.asdict(t)
    assert {f: td[f] for f in jd} == jd
    assert td["batch"] == 1 and t.to_str() == j.to_str()
    assert autotune._parse_key(t.to_str()) == t


def test_key_separates_dtype_epilogue_backend_layout_batch():
    base = _key(256, 512, 256)
    assert _key(256, 512, 256) == base
    assert _key(256, 512, 256, policy=prec.PAPER_FP16) != base
    assert _key(256, 512, 256, epilogue="gelu") != base
    assert autotune.canonical_key(256, 512, 256, policy=prec.TPU_BF16,
                                  backend="other") != base
    assert _key(256, 512, 256, layout="tn") != base
    assert _key(256, 512, 256, layout="tn", fused_bwd=True) != _key(
        256, 512, 256, layout="tn")
    assert _key(256, 512, 256, batch=4) != base
    assert "-B4" in _key(256, 512, 256, batch=4).to_str()
    assert _key(250, 500, 250) == base and _key(4096, 512, 256) != base
    for k in (base, _key(256, 512, 256, batch=8, layout="nt", epilogue="relu")):
        assert autotune._parse_key(k.to_str()) == k


# ------------------------------------------------------------------ #
# The round trip: cold miss -> tuned pick -> warm hits
# ------------------------------------------------------------------ #
def test_cache_roundtrip_cold_miss_pick_warm_hit():
    pol = prec.TPU_BF16
    look = lambda: autotune.cached_tile(4, 2048, 4096, policy=pol, backend="hopper")
    assert look() is None                                   # cold miss
    res = autotune.autotune_gemm(4, 2048, 4096, policy=pol, mode="model")
    assert res.source == "model" and res.n_candidates > 2
    assert res.us == min(us for _, us in res.scores)
    assert res.heuristic in autotune.candidate_tiles(4, 2048, 4096, policy=pol)
    assert look() == res.tile                               # LRU warm hit

    data = json.load(open(os.environ[autotune.ENV_VAR]))    # persisted
    (entry,) = data.values()
    assert (entry["bm"], entry["bn"], entry["bk"], entry["splits"]) == (
        res.tile.bm, res.tile.bn, res.tile.bk, res.tile.splits)
    assert entry["source"] == "model"
    stats = autotune.cache_stats()
    assert stats["misses"] >= 1 and stats["hits"] >= 1 and stats["evictions"] == 0
    assert set(stats) == {"entries", "hits", "misses", "evictions"}

    autotune.clear_cache()                                  # "a new process"
    assert look() == res.tile                               # disk warm hit
    assert autotune.cache_stats()["hits"] == 1


def test_lru_eviction_counter():
    cap = autotune._LRU_CAPACITY
    for i in range(cap + 5):
        key = autotune.AutotuneKey(m=8 * (i + 1), n=128, k=128, compute="bfloat16",
                                   accum="float32", out="bfloat16", epilogue="",
                                   backend="hopper")
        autotune.record_tile(key, T16)
    stats = autotune.cache_stats()
    assert stats["entries"] == cap and stats["evictions"] == 5


def test_corrupt_cache_file_is_ignored(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv(autotune.ENV_VAR, str(bad))
    autotune.clear_cache()
    assert autotune.cached_tile(64, 64, 64, policy=prec.TPU_BF16,
                                backend="hopper") is None


# ------------------------------------------------------------------ #
# One file, two packages
# ------------------------------------------------------------------ #
def test_shared_file_each_package_hits_its_own():
    path = os.environ[autotune.ENV_VAR]
    jt = jautotune.autotune_gemm(256, 512, 256, policy=jprec.TPU_BF16,
                                 backend="interpret", mode="model")
    foreign = json.load(open(path))
    res = autotune.autotune_gemm(256, 512, 256, policy=prec.TPU_BF16, mode="model")
    data = json.load(open(path))
    assert len(data) == 2
    for k, v in foreign.items():                 # written back untouched
        assert data[k] == v
    autotune.clear_cache()
    jautotune.clear_cache()
    assert autotune.cached_tile(256, 512, 256, policy=prec.TPU_BF16,
                                backend="hopper") == res.tile
    assert autotune.cached_tile(256, 512, 256, policy=prec.TPU_BF16,
                                backend="interpret") is None
    assert autotune.cache_stats()["entries"] == 1   # the foreign entry skipped
    assert jautotune.cached_tile(256, 512, 256, policy=jprec.TPU_BF16,
                                 backend="interpret") == jt.tile


@pytest.mark.parametrize("entry, key_kw, why", [
    ({"bm": 32, "bn": 32, "bk": 64}, {}, "compiled"),
    ({"bm": 16, "bn": 32, "bk": 128, "splits": 4}, {"policy": prec.PAPER_FP16},
     "faithful"),
    ({"bm": 64, "bn": 32, "bk": 64, "splits": 2}, {"layout": "tn", "fused_bwd": True},
     "fused"),
    ({"bm": 48, "bn": 48, "bk": 48}, {"policy": prec.FP32, "sweep": "lattn"}, "chunks"),
    ({"bm": 64, "bn": 64, "bk": 64}, {"sweep": "attnc"}, "flash"),
])
def test_an_entry_the_kernels_cannot_run_raises_naming_the_file(entry, key_kw, why):
    path = os.environ[autotune.ENV_VAR]
    key = _key(4, 2048, 4096, **key_kw)
    with open(path, "w") as fh:
        json.dump({key.to_str(): {**entry, "source": "manual"}}, fh)
    with pytest.raises(ValueError, match=why) as e:
        autotune.cached_tile(1, 1, 1, policy=prec.TPU_BF16, backend="hopper")
    assert path in str(e.value)
    with pytest.raises(ValueError, match=why):
        autotune.record_tile(key, tiling.TileConfig(
            bm=entry["bm"], bn=entry["bn"], bk=entry["bk"],
            splits=entry.get("splits", 0)))


# ------------------------------------------------------------------ #
# The engine: explicit > cache > heuristic at every dispatch site
# ------------------------------------------------------------------ #
def _tiles(fn):
    with engine.instrument() as ev:
        out = fn()
    return [e.spec.tile for e in ev], out


def test_engine_resolution_explicit_cache_heuristic():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 1, 2048))).bfloat16()
    w = torch.from_numpy(rng.standard_normal((2048, 4096))).bfloat16()
    run = lambda **kw: _tiles(lambda: engine.matmul(x, w, policy=prec.TPU_BF16, **kw))
    (t,), z0 = run()
    assert t == T16                                  # heuristic, splits 0
    tuned = dataclasses.replace(T64, splits=5)
    # the decode step's 2D-weight launch folds its 4 x 1 rows into M = 4
    autotune.record_tile(_key(4, 2048, 4096), tuned)
    (t,), z1 = run()
    assert t == tuned                                # cache beats heuristic
    explicit = dataclasses.replace(T16, splits=3)
    (t,), _ = run(tile=explicit)
    assert t == explicit                             # argument beats cache
    assert torch.equal(z0, z1)                       # the plain version


def test_split_tuned_on_2d_is_not_applied_to_a_batched_launch():
    """The key carries the launch's batch: an entry tuned on the 2D launch
    (4 x 2048 x 4096) serves a 2D-weight dispatch that folds to it, never
    a batched launch of the same (m, n, k)."""
    tuned = dataclasses.replace(T64, splits=5)
    autotune.record_tile(_key(4, 2048, 4096), tuned)
    x = torch.zeros((4, 4, 2048), dtype=torch.bfloat16)
    (t,), _ = _tiles(lambda: engine.matmul(
        x, torch.zeros((4, 2048, 4096), dtype=torch.bfloat16), policy=prec.TPU_BF16))
    assert t == T16                                  # the heuristic
    (t,), _ = _tiles(lambda: engine.matmul(
        x[:, :1], torch.zeros((2048, 4096), dtype=torch.bfloat16),
        policy=prec.TPU_BF16))
    assert t == tuned                                # 2D weight: M = 4, batch 1
    batched = dataclasses.replace(T16, splits=2)
    autotune.record_tile(_key(4, 2048, 4096, batch=4), batched)
    (t,), _ = _tiles(lambda: engine.matmul(
        x, torch.zeros((4, 2048, 4096), dtype=torch.bfloat16), policy=prec.TPU_BF16))
    assert t == batched


def test_backward_and_grouped_dispatches_resolve_their_own_launch():
    """dX ("nt") and dW ("tn") resolve under their launch's own key, as do
    a grouped and an einsum2d dispatch; every event carries its tile."""
    pol = prec.TPU_BF16
    x = torch.randn(64, 96, requires_grad=True)
    w = torch.randn(96, 80, requires_grad=True)
    dx_t, dw_t = dataclasses.replace(T16, splits=2), dataclasses.replace(T64, splits=3)
    gpol = engine._grad_policy(pol)        # the backward stores the accumulator
    autotune.record_tile(_key(64, 80, 96, policy=gpol, layout="nt"), dx_t)
    autotune.record_tile(_key(96, 64, 80, policy=gpol, layout="tn"), dw_t)
    with engine.instrument() as ev:
        engine.matmul(x, w, policy=pol).float().sum().backward()
    tiles = {e.spec.op: e.spec.tile for e in ev}
    assert tiles == {"matmul": T64, "matmul_dx": dx_t, "matmul_dw": dw_t}
    g_t = dataclasses.replace(T16, splits=4)
    autotune.record_tile(_key(8, 96, 80, batch=6), g_t)
    (t,), _ = _tiles(lambda: engine.grouped_matmul(
        torch.randn(2, 3, 8, 96), torch.randn(3, 96, 80), policy=pol))
    assert t == g_t
    (t,), _ = _tiles(lambda: engine.einsum2d("bmn,bnk->bmk", torch.randn(6, 8, 96),
                                             torch.randn(6, 96, 80), policy=pol))
    assert t == g_t


def test_sweep_chunk_resolution_and_its_numerics():
    """linear_attention's chunk: explicit > cache (sweep key lattn, keyed on
    S, dk, dv and B·H) > 64; a cached chunk computes what the explicit one
    does, bitwise."""
    rng = np.random.default_rng(0)
    B, H, S, dk, dv = 1, 2, 40, 16, 8
    q, k = (torch.from_numpy(rng.standard_normal((B, H, S, dk))).float() for _ in "qk")
    v = torch.from_numpy(rng.standard_normal((B, H, S, dv))).float()
    g = -torch.from_numpy(rng.random((B, H, S))).float() * 0.1
    run = lambda **kw: _tiles(lambda: engine.linear_attention(q, k, v, g, **kw))
    tiles, _ = run()
    assert {t.bm for t in tiles} == {64}
    res = autotune.autotune_attention(S, dk, dv, kind="linear_attention",
                                      batch=B * H, mode="model")
    assert {bm for (bm, *_), _ in res.scores} == {c for c in cla.CHUNKS if c <= 48}
    autotune.record_tile(res.key, tiling.TileConfig(bm=16, bn=16, bk=16))
    tiles, (o1, s1) = run()
    assert {t.bm for t in tiles} == {16}
    tiles, (o2, s2) = run(chunk=32)
    assert {t.bm for t in tiles} == {32}
    _, (o3, s3) = run(chunk=16)
    assert torch.equal(o1, o3) and torch.equal(s1, s3)


def test_flash_sweep_key_has_one_candidate():
    res = autotune.autotune_attention(128, 144, 128, kind="attention", mode="model")
    assert [g for g, _ in res.scores] == [(tiling.FLASH_BQ, tiling.FLASH_BKV,
                                           tiling.FLASH_BKV, 0)]
    q = torch.randn(1, 2, 128, 128)
    kv = torch.randn(1, 2, 144, 128)
    tiles, _ = _tiles(lambda: engine.attention(q, kv, kv, policy=prec.FP32,
                                               q_offset=16))
    assert {(t.bm, t.bn) for t in tiles} == {(tiling.FLASH_BQ, tiling.FLASH_BKV)}


# ------------------------------------------------------------------ #
# The faithful accumulator with a cache
# ------------------------------------------------------------------ #
def test_faithful_result_unchanged_by_a_cached_tile():
    """A paper_fp16 forward and backward with every launch's tile taken from
    the cache equal the uncached run bitwise."""
    pol = prec.PAPER_FP16
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((16, 640))).half()
    w0 = torch.from_numpy(rng.standard_normal((640, 128)) * 0.05).half()
    b0 = torch.from_numpy(rng.standard_normal(128) * 0.1).half()

    def step():
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        with engine.instrument() as ev:
            z = engine.linear(x, w, b, activation="relu", policy=pol)
            z.float().square().sum().backward()
        return [z, x.grad, w.grad, b.grad], [e.spec.tile for e in ev]

    want, plain_tiles = step()
    for M, N, K, kw in ((16, 640, 128, dict(epilogue="relu")),
                        (16, 128, 640, dict(layout="nt", fused_bwd=True)),
                        (640, 16, 128, dict(layout="tn", fused_bwd=True))):
        autotune.record_tile(_key(M, N, K, policy=pol, **kw), T64)
    got, tiles = step()
    assert all(t == T64 for t in tiles) and tiles != plain_tiles
    for a, b in zip(got, want):
        assert torch.equal(a, b)
