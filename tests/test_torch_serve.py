"""The port's serving path against the JAX package, on reduced qwen3-1.7b.

Both packages start from the reference's own initial parameters
(``repro.models.transformer.init_params``, carried across by
``repro_torch.convert.params_from_jax``) and see the same prompts.

Tolerances: under ``fp32`` logits and caches agree to 1e-4 relative to the
largest reference magnitude (summation order, and the port's flash prefill
against the reference's q-chunked one) and greedy tokens are identical;
under ``tpu_bf16`` logits agree to 2^-4 relative — every GEMM output, norm
and residual add is rounded to bf16 (2^-8) and the two frameworks round
at different places (the port keeps fp32 softmax probabilities into the
PV product, the reference casts them to bf16 first), over two layers.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as jt
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched

from repro_torch import configs as tconfigs
from repro_torch import convert, resolve_device
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import scheduler as tsched


def _rel(got, want) -> float:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _setup(policy: str, arch: str = "qwen3-1.7b"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name=policy)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), policy_name=policy)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def fp32():
    return _setup("fp32")


def _prompt(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, (1, n)).astype(np.int32)


def _prefill_both(setup, prompt, max_len):
    jcfg, tcfg, jparams, tparams = setup
    jl, jc = jt.prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt)}, max_len)
    tl, tc = tt.prefill(tparams, tcfg, {"inputs": torch.from_numpy(prompt).long()},
                        max_len)
    return (jl, jc), (tl, tc)


def test_prefill_logits_and_cache_fp32(fp32):
    (jl, jc), (tl, tc) = _prefill_both(fp32, _prompt(9, 0), 16)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (1, 512)
    assert _rel(tl, jl) <= 1e-4
    for name in ("k", "v"):
        assert _rel(tc["layers"][name], jc["layers"][name]) <= 1e-4


@pytest.mark.parametrize("steps", (1, 4))
def test_decode_steps_at_per_slot_positions_fp32(fp32, steps):
    """Two requests of different prompt lengths in a 3-slot pool (one
    parked), advanced together as the scheduler does."""
    jcfg, tcfg, jparams, tparams = fp32
    n, max_len = 3, 16
    jpool = jt.init_cache(jcfg, n, max_len)
    tpool = tt.init_cache(tcfg, n, max_len, device="cpu")
    lens = {0: 7, 2: 4}
    toks = np.zeros((n, 1), np.int32)
    for slot, plen in lens.items():
        (jl, jc), (tl, tc) = _prefill_both(fp32, _prompt(plen, slot), max_len)
        jpool = jkv.insert_slot(jpool, jc, jnp.int32(slot), jnp.float32)
        tkv.insert_slot(tpool, tc, slot)
        toks[slot, 0] = int(np.argmax(np.asarray(jl[0])))
    pos = np.array([lens[0], max_len - 1, lens[2]], np.int32)
    for _ in range(steps):
        sizes = np.where(np.arange(n) == 1, 0, pos + 1).astype(np.int32)
        jl, jpool = jt.serve_step(jparams, jcfg, jnp.asarray(toks), jpool,
                                  jnp.asarray(pos), kv_group_sizes=jnp.asarray(sizes))
        tl, tpool = tt.serve_step(tparams, tcfg, torch.from_numpy(toks).long(),
                                  tpool, torch.from_numpy(pos).long(),
                                  kv_group_sizes=sizes)
        for slot in lens:
            assert _rel(tl[slot], jl[slot]) <= 1e-4
        toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0, 1], np.int32)
    for name in ("k", "v"):
        for slot in lens:
            assert _rel(tpool["layers"][name][:, slot],
                        np.asarray(jpool["layers"][name])[:, slot]) <= 1e-4


@pytest.mark.parametrize("batch,plen,gen", ((2, 6, 5), (3, 4, 3)))
def test_generate_tokens_equal_reference_fp32(fp32, batch, plen, gen):
    jcfg, tcfg, jparams, tparams = fp32
    prompts = np.random.default_rng(batch).integers(0, 512, (batch, plen)).astype(np.int32)
    want = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts), gen))
    got = tserve.generate(tparams, tcfg, prompts, gen)
    np.testing.assert_array_equal(got, want)


def test_generate_state_is_consistent_fp32(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    prompts = np.random.default_rng(9).integers(0, 512, (2, 5)).astype(np.int32)
    seqs, cache, final = tserve.generate(tparams, tcfg, prompts, 3, return_state=True)
    _, _, jfinal = jserve.generate(jparams, jcfg, jnp.asarray(prompts), 3,
                                   return_state=True)
    assert _rel(final, jfinal) <= 1e-4
    # the drain invariant: a gen+1 run emits argmax(final) next
    longer = tserve.generate(tparams, tcfg, prompts, 4)
    np.testing.assert_array_equal(longer[:, :-1], seqs)
    np.testing.assert_array_equal(longer[:, -1], np.argmax(final, axis=-1))


def _arrivals(module, seed: int = 0):
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for rid in range(5):
        t += float(rng.exponential(1.5))
        plen = int(rng.choice([3, 6]))
        reqs.append(module.Request(
            rid=rid, arrival=round(t, 3),
            prompt=rng.integers(0, 512, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(1, 5))))
    return reqs


def test_scheduler_trace_equals_reference_fp32(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    js = jsched.Scheduler(jparams, jcfg, jsched.SchedulerConfig(n_slots=2, max_len=12))
    js.submit(_arrivals(jsched))
    jres = js.run()
    ts = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(n_slots=2, max_len=12))
    ts.submit(_arrivals(tsched))
    tres = ts.run()
    assert ts.trace == js.trace
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert [(r.first_token_tick, r.finish_tick, r.status) for r in tres] == \
           [(r.first_token_tick, r.finish_tick, r.status) for r in jres]


def test_scheduler_rejects_like_reference(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    reqs = lambda m: [m.Request(rid=0, arrival=0.0, prompt=np.zeros(3, np.int32),
                                max_new_tokens=0),
                      m.Request(rid=1, arrival=0.0, prompt=np.zeros(11, np.int32),
                                max_new_tokens=4)]
    js = jsched.Scheduler(jparams, jcfg, jsched.SchedulerConfig(n_slots=1, max_len=12))
    js.submit(reqs(jsched))
    ts = tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(n_slots=1, max_len=12))
    ts.submit(reqs(tsched))
    assert ts.trace == js.trace
    assert not ts.run()[0].tokens


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "yi-9b"))
def test_prefill_logits_bf16_bound(arch):
    setup = _setup("tpu_bf16", arch)
    (jl, _), (tl, _) = _prefill_both(setup, _prompt(9, 1), 16)
    assert tl.dtype == torch.bfloat16
    assert _rel(tl, jl) <= 2.0 ** -4


def test_unported_paths_raise(fp32):
    _, tcfg, _, tparams = fp32
    # every reference arch is registered now (hymba-1.5b since the recurrent
    # slice), and the FP8 KV cache, the resilience layer and --sched are
    # ported, and so are the injector's checkpoint modes; since the sharding
    # slice manual expert parallelism and the serving specs are too
    # (tests/test_torch_sharding.py, test_torch_shard_exec.py); serving the
    # FP8 cache on a mesh is still to port
    from repro_torch import serving
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import FailureInjector, sharding as ts
    tt.init_params(dataclasses.replace(tconfigs.get_reduced("deepseek-moe-16b"),
                                       moe_impl="shard_map"), device="cpu")
    assert FailureInjector(fail_at_step=1, mode="ckpt_crash").mode == "ckpt_crash"
    _, spec = serving.decode_cache_specs(tcfg, tserve.serve_rules(),
                                         tmesh.make_production_mesh(), 32, 64)
    assert tuple(spec["layers"]["k"]) == (None, "data", None, "model")
    with ts.use_rules(tserve.serve_rules()), \
            ts.use_mesh(tmesh.Mesh((1, 2), ("data", "model"), device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt.init_cache(tcfg, 2, 8, storage_dtype="float8_e4m3fn", device="cpu")
    cache = tt.init_cache(tcfg, 1, 8, storage_dtype="float8_e4m3fn", device="cpu")
    assert cache["layers"]["k"].dtype == torch.float8_e4m3fn
    tsched.Scheduler(tparams, tcfg, tsched.SchedulerConfig(max_queue=2, audit_every=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_serve_cli_on_cpu(capsys):
    seqs = tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "5", "--gen", "3", "--instrument"])
    assert seqs.shape == (2, 8) and ((seqs >= 0) & (seqs < 512)).all()
    out = capsys.readouterr().out
    assert "[engine] prefill attention_score" in out
    assert "[engine] decode total" in out
    # --sched on reduced yi-9b: the load sweep's serve/* rows under the FP8
    # cache and mixed_fp8_e4m3 (the defaults), then serve_slo.json's
    # scenario with a fault, its [slo] line and rows
    res = tserve.main(["--sched", "--device", "cpu", "--arch", "yi-9b", "--slots", "2",
                       "--requests", "6", "--rates", "1.5", "--prompt-len", "4",
                       "--gen", "4", "--max-queue", "2", "--deadline", "18",
                       "--inject", "kv_corrupt@2", "--json", "", "--instrument"])
    out = capsys.readouterr().out
    for row in ("serve/yi-9b/r1.5/ttft", "serve/yi-9b/r1.5/tps",
                "serve/yi-9b/slo_kv_corrupt_goodput"):
        assert f"\n{row}," in out, row
    assert "[slo] goodput=0.9600 deadline_hit=1.000 finished=6/6" in out
    assert "[kv] layers/k: max_scale=" in out and "kv_bytes=" in out
    assert res["slo"]["slo_recoveries"] == 1
    assert all(p["n_finished"] == 6 for p in res["points"])


def test_no_jax_in_the_port():
    """An AST scan finds no jax / repro import in the package or in
    chip_smoke.py, and importing the serving entry point loads neither."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    names = {f.relative_to(root / "src").as_posix() for f in files[:-1]}
    assert {"repro_torch/runtime/fault_tolerance.py", "repro_torch/serving/loadgen.py",
            "repro_torch/serving/resilience.py", "repro_torch/roofline/analysis.py",
            "repro_torch/core/autotune.py", "repro_torch/core/perf_model.py"} <= names
    assert len(files) > 15
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "flax"), (f, n)
    code = ("import sys, repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.convert, repro_torch.runtime, repro_torch.serving, "
            "repro_torch.roofline, repro_torch.core.autotune, "
            "repro_torch.core.perf_model, repro_torch.examples.quickstart; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
