"""The port's compressed gradient wire against the JAX package, on the CPU.

``repro_torch.optim.compression`` against ``repro.optim.compression`` on
the same numpy gradients and error feedback, over three steps so the FP8
delayed-scale windows fill: the wire values, the scales, the residuals
and the windows must be bitwise equal (both compute them with the same
fp32 operations in the same order).  Then the per-rank-scale reduce
against the fp32 oracle over two gloo ranks (as ``tests/test_optim.py``
does over two simulated devices), the wire bytes over reduced qwen3
pinned as literals, and the port's ``build_compressed_dp_train_step`` at
dp 2 (two gloo ranks) against the reference's on two simulated devices
from the same parameters and batches.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.optim import Compressor as JCompressor

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import transformer as tt
from repro_torch.optim import (Compressor, Fp8LeafState, collective_wire_bytes,
                               compressed_mean_allreduce, init_fp8_scale_tree,
                               observe_amax_tree)
from repro_torch.runtime import procs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2")
# tests/test_torch_lm_train.py's bound: loss and parameters, relative
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_rank():
    """The ranks are tiny: one intra-op thread each keeps them from
    oversubscribing a shared CPU (they inherit the environment)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _grads(step: int):
    rng = np.random.default_rng([5, step])
    return {"w": rng.standard_normal((16, 24)).astype(np.float32) * 1e-3,
            "b": {"c": rng.standard_normal(40).astype(np.float32) * 30.0}}


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x) -> np.ndarray:
    """A wire leaf's stored bits (FP8 codes as bytes)."""
    if isinstance(x, torch.Tensor) and x.element_size() == 1:
        return x.view(torch.uint8).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("kind", KINDS + ("fp8",))
def test_compress_matches_reference_bitwise(kind):
    jc, tc = JCompressor(kind), Compressor(kind)
    assert tc.kind == jc.kind and tc.wire_bits == jc.wire_bits
    g0 = _grads(0)
    jef = jc.init(jax.tree.map(jnp.asarray, g0))
    tef = tc.init(jax.tree.map(torch.from_numpy, g0))
    for step in range(3):
        g = _grads(step)
        if step == 2:
            g["w"] = g["w"] * 64.0     # a sudden growth: the FP8 clip fires
        jw, jef = jc.compress(jax.tree.map(jnp.asarray, g), jef)
        tw, tef = tc.compress(jax.tree.map(torch.from_numpy, g), tef)
        jl = jax.tree.leaves(jw)
        tl = [x for leaf in (tw["b"]["c"], tw["w"])
              for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(_bits(b), _bits(a))
        if jef is not None:
            je = jax.tree.leaves(jef)
            te = [x for leaf in (tef["b"]["c"], tef["w"])
                  for x in ([leaf.ef, *leaf.scale] if isinstance(leaf, Fp8LeafState)
                            else [leaf])]
            assert len(je) == len(te)
            for a, b in zip(je, te):
                np.testing.assert_array_equal(_np(b), np.asarray(a))
        jd = jax.tree.leaves(jc.decompress(jw))
        td = tc.decompress(tw)
        for a, b in zip(jd, (td["b"]["c"], td["w"])):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
    # the reference's state, with a host axis, converts bit for bit
    if jef is not None:
        hosts = jax.tree.map(lambda x: np.stack([np.asarray(x)] * 2), jef)
        conv = convert.compressor_state_from_jax(hosts, device="cpu")
        leaf = conv["w"]
        flat = [leaf.ef, *leaf.scale] if isinstance(leaf, Fp8LeafState) else [leaf]
        want = jax.tree.leaves(hosts["w"])
        assert len(flat) == len(want)
        for a, b in zip(want, flat):
            assert tuple(b.shape)[0] == 2
            np.testing.assert_array_equal(_np(b), a)


def test_fp8_scale_tree_helpers_match_reference():
    from repro.optim.scale import init_fp8_scale_tree as j_init
    from repro.optim.scale import observe_amax_tree as j_observe
    g = _grads(1)
    js = j_observe(j_init(jax.tree.map(jnp.asarray, g), 4), jax.tree.map(jnp.asarray, g))
    ts = observe_amax_tree(init_fp8_scale_tree(jax.tree.map(torch.from_numpy, g), 4),
                           jax.tree.map(torch.from_numpy, g))
    for a, b in zip(jax.tree.leaves(js), [*ts["b"]["c"], *ts["w"]]):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown compression kind"):
        Compressor("int4")


def test_wire_bytes_pinned_and_ordered():
    """Reduced qwen3's wire bytes a step, pinned as literals (the values
    of benchmarks/baselines/collective_bytes.json), fp8 < fp16 < fp32."""
    params = tt.init_params(tconfigs.get_reduced("qwen3-1.7b"), device="cpu")
    got = {k: collective_wire_bytes(k, params) for k in KINDS}
    assert got == {"none": 427_520, "fp16": 213_760, "int8": 106_920,
                   "fp8_e4m3": 106_920, "fp8_e5m2": 106_920}
    assert got["fp8_e4m3"] < got["fp16"] < got["none"]
    jparams = jt.abstract_params(jconfigs.get_reduced("qwen3-1.7b"))
    assert got == {k: JCompressor(k).wire_bytes(jparams) for k in KINDS}


def _ranks(tmp_path, n: int, code: str) -> None:
    """Run ``code`` as ``n`` gloo ranks on the CPU (rank 0 writes its
    answer under ``tmp_path``)."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(code))
    rc = procs.spawn(n, [str(script), str(tmp_path)], run_dir=str(tmp_path))
    assert rc == 0, rc


def test_per_rank_scales_match_fp32_oracle(tmp_path):
    """Two ranks with gradients seven orders of magnitude apart: the
    reduce weights each rank's payload by its own scale (both 8-bit wires
    against the fp32 oracle, as tests/test_optim.py:200 pins the
    reference), and one rank alone gets its own gradients back."""
    _ranks(tmp_path, 2, """
        import json, sys
        import numpy as np, torch
        from repro_torch.optim import Compressor
        from repro_torch.runtime import procs
        r, n = procs.init_group()
        rng = np.random.default_rng(0)
        g = np.stack([rng.normal(size=256).astype(np.float32) * 1e-4,
                      rng.normal(size=256).astype(np.float32) * 1e3])
        oracle = g.astype(np.float64).mean(axis=0)
        out = {}
        for kind in ("int8", "fp8_e4m3", "fp8_e5m2"):
            comp = Compressor(kind)
            ef = comp.init({"w": torch.zeros(256)})
            sent = torch.zeros(256)
            for _ in range(6):
                wire, ef = comp.compress({"w": torch.from_numpy(g[r])}, ef)
                sent = sent + comp.psum_wire(wire)["w"]
            sent = (sent / 6).numpy()
            out[kind] = float(np.max(np.abs(sent - oracle)) / np.max(np.abs(oracle)))
        if r == 0:
            json.dump(out, open(sys.argv[1] + "/out.json", "w"))
        procs.finish()
    """)
    rel = json.loads((tmp_path / "out.json").read_text())
    assert set(rel) == {"int8", "fp8_e4m3", "fp8_e5m2"}
    for kind, err in rel.items():
        assert err < 0.02, (kind, err)
    g = {"w": torch.linspace(-1, 1, 7)}
    mean, ef = compressed_mean_allreduce(g, None, Compressor("none"))
    assert torch.equal(mean["w"], g["w"]) and ef is None


# ------------------------------------------------------------------ #
# The compressed data-parallel train step, port (two gloo ranks) against
# the reference (two simulated devices), from the same parameters
# ------------------------------------------------------------------ #
STEPS, BATCH, SEQ, LR = 3, 4, 16, 0.05
_CONSTS = f"STEPS, LR = {STEPS}, {LR}\n"
# the parameters' change over the run, port against reference, relative to
# the reference's largest change in the leaf: TOL on the fp32 wire; one
# E4M3 step (2^-3) on the FP8 wire, where an fp32 rounding difference may
# move a gradient element across a code boundary (the error feedback
# carries the rest into the next step)
UPDATE_TOL = {"none": TOL, "fp8_e4m3": 2.0 ** -3}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    jcfg = jconfigs.get_reduced("qwen3-1.7b")
    params = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    np.savez(d / "params.npz", **_flat(params))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(BATCH, SEQ + 1))
    np.save(d / "toks.npy", toks.astype(np.int32))
    ref = subprocess.run([sys.executable, "-c", _CONSTS + textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import json, sys
        import jax, jax.numpy as jnp, numpy as np
        from repro import configs
        from repro.launch.train import build_compressed_dp_train_step
        import dataclasses
        from repro.optim import SGD, Compressor
        from repro.runtime import compat
        d = sys.argv[1]
        cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), policy_name="fp32")
        mesh = compat.make_mesh((2,), ("data",))
        flat = np.load(d + "/params.npz")
        toks = np.load(d + "/toks.npy")
        batch = {"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
        out = {}
        for kind in ("none", "fp8_e4m3"):
            step, init_fn = build_compressed_dp_train_step(
                cfg, SGD(lr=LR), mesh, Compressor(kind))
            ts, ef = init_fn(jax.random.PRNGKey(0))
            paths = jax.tree_util.tree_flatten_with_path(ts.params)[0]
            leaves = [jnp.asarray(flat["/".join(k.key for k in p)]) for p, _ in paths]
            ts = ts._replace(params=jax.tree.unflatten(jax.tree.structure(ts.params), leaves))
            state, losses = (ts, ef), []
            with compat.set_mesh(mesh):
                jstep = jax.jit(step)
                for _ in range(STEPS):
                    state, m = jstep(state, batch)
                    losses.append(float(m["loss"]))
            np.savez(d + "/ref_" + kind + ".npz", **{
                "/".join(k.key for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(state[0].params)[0]})
            out[kind] = losses
        json.dump(out, open(d + "/ref.json", "w"))
    """), str(d)], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    _ranks(d, 2, _CONSTS + textwrap.dedent("""
        import json, sys
        import numpy as np, torch
        from repro_torch import configs, convert
        from repro_torch.launch.train import build_compressed_dp_train_step
        import dataclasses
        from repro_torch.optim import SGD, Compressor, tree_leaves
        from repro_torch.runtime import procs
        d = sys.argv[1]
        procs.init_group()
        cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), policy_name="fp32")
        flat = np.load(d + "/params.npz")
        tree = {}
        for k in flat.files:
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = flat[k]
        toks = np.load(d + "/toks.npy")
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        out = {}
        for kind in ("none", "fp8_e4m3"):
            opt = SGD(lr=LR)
            step, init_fn = build_compressed_dp_train_step(cfg, opt, Compressor(kind))
            ts, ef = init_fn(seed=0, device="cpu")
            params = convert.params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            ts = ts._replace(params=params, opt=opt.init(params))
            state, losses = (ts, ef), []
            for _ in range(STEPS):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            if procs.rank() == 0:
                flat_out = {}
                def walk(t, pre=""):
                    for k, v in t.items():
                        if isinstance(v, dict):
                            walk(v, pre + k + "/")
                        else:
                            flat_out[pre + k] = v.detach().numpy()
                walk(state[0].params)
                np.savez(d + "/port_" + kind + ".npz", **flat_out)
                out[kind] = losses
        if procs.rank() == 0:
            json.dump(out, open(d + "/port.json", "w"))
        procs.finish()
    """))
    return d


@pytest.mark.parametrize("kind", ["none", "fp8_e4m3"])
def test_dp_train_step_matches_reference(dp_runs, kind):
    """Three dp-2 steps under the fp32 policy (SGD with momentum, linear
    in the gradients) on the fp32 and the FP8 wire: losses within TOL of
    the reference's two-device run, every parameter's change within
    UPDATE_TOL of the reference's."""
    d = dp_runs
    jl = json.loads((d / "ref.json").read_text())[kind]
    tl = json.loads((d / "port.json").read_text())[kind]
    assert len(jl) == len(tl) == STEPS
    for a, b in zip(jl, tl):
        assert abs(a - b) <= TOL * abs(a), (kind, jl, tl)
    jp, tp = np.load(d / f"ref_{kind}.npz"), np.load(d / f"port_{kind}.npz")
    assert sorted(jp.files) == sorted(tp.files)
    p0 = np.load(d / "params.npz")
    for k in jp.files:
        moved = np.max(np.abs(jp[k] - p0[k]))
        assert moved > 0, k
        err = np.max(np.abs(tp[k] - jp[k])) / moved
        assert err <= UPDATE_TOL[kind], (kind, k, err)
