"""The port's checkpoints and fault-tolerant loop, on the CPU.

Mirrors every contract of ``tests/test_checkpoint_ft.py`` on
``repro_torch.checkpoint`` and ``repro_torch.runtime.fault_tolerance``
(round trip, ``keep``, atomicity, async save, shape mismatch, checksums,
skip-to-previous-valid, the injector's latch, the watchdog, crash and
resume bit-identical, a plain iterator rejected on resume, SIGTERM in a
worker process), and holds the on-disk format against the reference's:
a checkpoint the reference wrote of reduced qwen3's ``TrainState``
restores in the port to the same tensors, and one the port wrote passes
the reference's ``_load_verified`` with the same ``leaf_i`` order.
"""

import json
import os
import signal
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.launch import train as jtrain
from repro.optim import AdamW as JAdamW

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointCorruptError, CheckpointManager,
                                    tree_flatten, tree_unflatten)
from repro_torch.runtime.fault_tolerance import (FailureInjector, InjectedFault,
                                                 StragglerWatchdog, TrainLoop,
                                                 reshard)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(x=1.0):
    return {"a": torch.full((4, 3), x), "b": {"c": torch.arange(5, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(2.5)
    mgr.save(7, t, {"note": "hi"})
    restored, meta = mgr.restore(7, t)
    assert meta["note"] == "hi"
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["b"]["c"], t["b"]["c"])
    assert restored["b"]["c"].dtype == torch.int32


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(float(s)))
    assert mgr.all_steps() == [3, 4]


def test_atomicity_no_tmp_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    assert mgr.latest() == 1


def test_async_save_snapshots_before_returning(tmp_path):
    """The port's steps update tensors in place: the snapshot is taken
    before ``save_async`` returns, so a later in-place write is not saved."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(9.0)
    mgr.save_async(3, t)
    t["a"].fill_(-1.0)
    mgr.wait()
    assert mgr.latest() == 3
    assert torch.equal(mgr.restore(3, t)[0]["a"], torch.full((4, 3), 9.0))


def test_restore_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    bad = {"a": torch.zeros((2, 2)), "b": {"c": torch.zeros(5, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        mgr.restore(1, bad)


class _Opt(NamedTuple):
    step: int
    mu: dict
    nu: object


def test_flatten_order_is_jax_tree_order():
    """Dict keys sorted, NamedTuple fields in order, None and () holding no
    leaf, a Python int a 0-d int32 leaf: jax.tree's order."""
    rng = np.random.default_rng(0)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = ({"z": mk(2), "a": {"y": mk(3), "b": mk(1)}},
            _Opt(step=3, mu={"k": mk(2), "c": mk(4)}, nu=None), ())
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, tree))
    tleaves = tree_flatten(tree)
    assert len(tleaves) == len(jleaves) == 6
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = tree_unflatten(tree, tleaves)
    assert list(back[0]) == ["z", "a"] and back[1].nu is None and back[2] == ()


# ------------------------------------------------------------------ #
# Fault-tolerant loop
# ------------------------------------------------------------------ #
def _toy_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    return {"w": w, "step": state["step"] + 1}, {"loss": torch.sum((w - batch) ** 2)}


def _batches():
    while True:
        yield torch.ones(3)


def test_crash_and_resume_bit_identical(tmp_path):
    """Crash at step 7, restart: the final state equals the uninterrupted
    run's bit for bit (step-indexed data, checkpointed state)."""
    init = {"w": torch.zeros(3), "step": torch.tensor(0, dtype=torch.int32)}
    batch_fn = lambda i: torch.ones(3)
    ref = CheckpointManager(str(tmp_path / "ref"), keep=2)
    out_ref = TrainLoop(_toy_step, ref, save_every=5).run(
        init, batch_fn, 12, log=lambda s: None)

    mgr = CheckpointManager(str(tmp_path / "crash"), keep=2)
    loop = TrainLoop(_toy_step, mgr, save_every=5,
                     injector=FailureInjector(fail_at_step=7))
    with pytest.raises(RuntimeError):
        loop.run(init, batch_fn, 12, log=lambda s: None)
    assert mgr.latest() == 5  # the last complete checkpoint

    out = TrainLoop(_toy_step, mgr, save_every=5).run(init, batch_fn, 12,
                                                      log=lambda s: None)
    assert torch.equal(out["final_state"]["w"], out_ref["final_state"]["w"])
    assert int(out["final_state"]["step"]) == int(out_ref["final_state"]["step"]) == 12


def test_resume_with_plain_iterator_rejected(tmp_path):
    init = {"w": torch.zeros(3), "step": torch.tensor(0, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    TrainLoop(_toy_step, mgr, save_every=2).run(init, lambda i: torch.ones(3), 4,
                                                log=lambda s: None)
    assert mgr.latest() == 4
    with pytest.raises(TypeError, match="plain iterator"):
        TrainLoop(_toy_step, mgr, save_every=2).run(init, _batches(), 8,
                                                    log=lambda s: None)
    fresh = CheckpointManager(str(tmp_path / "fresh"), keep=2)
    out = TrainLoop(_toy_step, fresh, save_every=100).run(init, _batches(), 3,
                                                          log=lambda s: None)
    assert out["last_step"] == 2


def test_resume_places_state_like_init(tmp_path):
    """A restored state takes the init state's placement: a parameter
    that takes gradients takes them again, a Python int stays one."""
    w = torch.zeros(3, requires_grad=True)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(2, _Opt(step=2, mu={"w": torch.ones(3)}, nu={"w": w.detach() + 1}))
    got = TrainLoop(lambda s, b: (s, {"loss": torch.zeros(())}), mgr).run(
        _Opt(step=0, mu={"w": torch.zeros(3)}, nu={"w": w}), lambda i: None, 2,
        log=lambda s: None)["final_state"]
    assert got.step == 2 and isinstance(got.step, int)
    assert got.nu["w"].requires_grad and torch.equal(got.nu["w"].detach(), torch.ones(3))
    placed = reshard({"w": torch.ones(2)}, "cpu")
    assert placed["w"].device.type == "cpu"


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(threshold=2.0, ema_decay=0.5)
    for _ in range(5):
        assert not wd.observe(0.10)
    assert wd.observe(0.50)
    assert wd.straggler_steps == 1
    assert not wd.observe(0.10)


def test_straggler_detection_in_loop(tmp_path):
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 9:
            time.sleep(0.25)
        return state, {"loss": torch.zeros(())}

    loop = TrainLoop(slow_step, CheckpointManager(str(tmp_path), keep=1),
                     save_every=100, watchdog=StragglerWatchdog(threshold=3.0))
    out = loop.run({"w": torch.zeros(1)}, _batches(), 12, log=lambda s: None)
    assert out["straggler_steps"] >= 1


# ------------------------------------------------------------------ #
# Checksums + self-healing restore
# ------------------------------------------------------------------ #
def test_manifest_carries_per_leaf_checksums(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(3.0))
    with open(os.path.join(mgr._dir(1), "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest["checksums"]) == {"leaf_0", "leaf_1"}
    assert all(isinstance(v, int) for v in manifest["checksums"].values())


def test_corrupt_payload_raises_corrupt_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(1.5)
    mgr.save(2, t)
    leaves = {f"leaf_{i}": x.numpy() for i, x in enumerate(tree_flatten(t))}
    leaves["leaf_0"] = np.zeros_like(leaves["leaf_0"])  # a flipped block
    np.savez(os.path.join(mgr._dir(2), "arrays.npz"), **leaves)
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        mgr.restore(2, t)


def test_restore_latest_skips_corrupt_to_previous_valid(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _tree(float(s)))
    with open(os.path.join(mgr._dir(3), "arrays.npz"), "wb") as f:
        f.write(b"PK\x03\x04torn")
    warnings = []
    got = mgr.restore_latest(_tree(0.0), log=warnings.append)
    assert got is not None
    step, tree, _ = got
    assert step == 2
    assert torch.equal(tree["a"], torch.full((4, 3), 2.0))
    assert any("skipping corrupt checkpoint step 3" in w for w in warnings)


def test_restore_latest_all_corrupt_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1.0))
    with open(os.path.join(mgr._dir(1), "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    assert mgr.restore_latest(_tree(1.0), log=lambda s: None) is None


# ------------------------------------------------------------------ #
# Failure injector and watchdog
# ------------------------------------------------------------------ #
def test_failure_injector_is_one_shot():
    inj = FailureInjector(fail_at_step=3, mode="raise")
    inj.maybe_fail(2)
    with pytest.raises(InjectedFault, match="injected failure at step 3"):
        inj.maybe_fail(3)
    assert inj.fired
    inj.maybe_fail(3)  # the latch holds


def test_failure_injector_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown failure mode"):
        FailureInjector(fail_at_step=1, mode="meteor")


def test_straggler_ema_not_poisoned_numerically():
    wd = StragglerWatchdog(threshold=2.0, ema_decay=0.5)
    for _ in range(4):
        wd.observe(0.10)
    ema_before = wd.ema
    assert wd.observe(10.0)
    assert wd.observe(10.0)
    assert wd.ema == ema_before
    assert wd.straggler_steps == 2


# ------------------------------------------------------------------ #
# Preemption: a real SIGTERM to a real worker (and, at dp 2, through the
# launcher to both ranks, whose flags are all-reduced)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dp", [1, 2])
def test_sigterm_worker_checkpoints_and_exits_clean(tmp_path, dp):
    ckpt = tmp_path / "ckpt"
    result = tmp_path / "out.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.runtime.elastic", "--device", "cpu",
         "--ckpt", str(ckpt), "--steps", "500", "--save-every", "1",
         "--dp", str(dp), "--compress", "none", "--handle-sigterm",
         "--step-ms", "100", "--result", str(result), "--log-every", "1000"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
    try:
        hb = ckpt / "heartbeat.json"
        for _ in range(600):
            if hb.exists():
                break
            time.sleep(0.1)
        else:
            proc.kill()
            pytest.fail("worker never reached its first step: "
                        + proc.communicate()[0][-800:])
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-1200:]
    assert "preempted: checkpointed at step" in out
    with open(result) as f:
        res = json.load(f)
    assert res["preempted"] is True
    assert res["last_step"] < 499
    # every rank checkpointed at the same step: the last one saved
    step = int(out.split("checkpointed at step ")[1].split(",")[0])
    assert CheckpointManager(str(ckpt)).latest() == step == res["last_step"] + 1


def test_sigterm_racing_the_agreement_is_taken_by_every_rank(tmp_path):
    """A SIGTERM that lands while a step's preemption agreement runs is
    taken at the next step, on the agreed value, so every rank stops at
    one step.  (The handler used to set the decision itself: landing in
    the agreement, the agreed value overwrote it and the preemption was
    lost; landing after it, one rank stopped while its peers went on into
    the next step's collectives and waited for it.)"""
    init = {"w": torch.zeros(3), "step": torch.tensor(0, dtype=torch.int32)}
    old = signal.getsignal(signal.SIGTERM)
    agreed = []

    def sync(flag):
        # one rank agreeing with a peer that has not seen the signal: the
        # group's flag is this rank's; the signal arrives during step 2's
        out = bool(flag)
        if len(agreed) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        agreed.append(out)
        return out

    try:
        loop = TrainLoop(_toy_step, CheckpointManager(str(tmp_path), keep=2),
                         save_every=100, async_save=False, handle_sigterm=True,
                         sync_preempt=sync)
        out = loop.run(init, lambda i: torch.ones(3), 50, log=lambda s: None)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["preempted"] is True
    assert agreed == [False, False, False, True]
    assert out["last_step"] == 3


# ------------------------------------------------------------------ #
# The on-disk format across the two packages
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def qwen_state():
    """Reduced qwen3's reference TrainState (loss scale on, moments drawn
    so that no leaf is trivial) and the port's conversion of it."""
    jcfg = jconfigs.get_reduced("qwen3-1.7b")
    tcfg = tconfigs.get_reduced("qwen3-1.7b")
    st = jtrain.init_state(jax.random.PRNGKey(0), jcfg, JAdamW(), use_scale=True)
    rng = np.random.default_rng(3)
    noise = lambda t: jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), t)
    st = st._replace(opt=st.opt._replace(step=jnp.int32(5), mu=noise(st.opt.mu),
                                         nu=noise(st.opt.nu)))
    host = jax.tree.map(np.asarray, st)
    return host, convert.train_state_from_jax(host, tcfg, device="cpu")


def test_reference_checkpoint_restores_in_port(tmp_path, qwen_state):
    host, tstate = qwen_state
    JCheckpointManager(str(tmp_path), keep=2).save(5, host, {"from": "jax"})
    got, meta = CheckpointManager(str(tmp_path)).restore(5, tstate)
    assert meta == {"from": "jax"}
    assert got.opt.step == 5 and isinstance(got.opt.step, int)
    jl, tl = jax.tree.leaves(host), tree_flatten(got)
    assert len(jl) == len(tl) == len(tree_flatten(tstate))
    for a, b, c in zip(jl, tl, tree_flatten(tstate)):
        np.testing.assert_array_equal(np.asarray(b), a)
        np.testing.assert_array_equal(np.asarray(c.detach() if hasattr(c, "detach") else c), a)


def test_port_checkpoint_passes_reference_load_verified(tmp_path, qwen_state):
    host, tstate = qwen_state
    CheckpointManager(str(tmp_path), keep=2).save(5, tstate)
    arrays, manifest = JCheckpointManager(str(tmp_path))._load_verified(5)
    jl = jax.tree.leaves(host)
    assert manifest["n_leaves"] == len(jl)
    for i, a in enumerate(jl):
        assert arrays[f"leaf_{i}"].dtype == a.dtype, i
        np.testing.assert_array_equal(arrays[f"leaf_{i}"], a)
    restored, _ = JCheckpointManager(str(tmp_path)).restore(5, host)
    assert int(restored.opt.step) == 5


def test_lm_ckpt_dir_kill_and_resume_bit_identical(tmp_path):
    """launch/train.py --ckpt-dir on one process (reduced qwen3): a hard
    death at step 3 exits 13 after the step-2 checkpoint, and the run
    again resumes there and ends with the digests and loss of a run
    without checkpoints."""
    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
             "--steps", "4", "--batch", "2", "--seq", "16", "--save-every", "2",
             *extra], capture_output=True, text=True, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                 "OMP_NUM_THREADS": "1"})

    ref = run("--result", str(tmp_path / "ref.json"))
    assert ref.returncode == 0, ref.stderr[-800:]
    ckpt = str(tmp_path / "ckpt")
    died = run("--ckpt-dir", ckpt, "--fail-step", "3", "--fail-mode", "die")
    assert died.returncode == 13, died.stderr[-800:]
    assert CheckpointManager(ckpt).latest() == 2
    again = run("--ckpt-dir", ckpt, "--result", str(tmp_path / "out.json"),
                "--instrument")
    assert again.returncode == 0, again.stderr[-800:]
    assert "resumed from checkpoint step 2" in again.stdout
    assert "recomputed_steps=1 restarts=1" in again.stdout
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "out.json").read_text())
    assert got == want


def _example(tmp_path, name, *args):
    """Run ``repro_torch.examples.<name>`` on the CPU with ``TMPDIR`` at
    ``tmp_path``."""
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device", "cpu",
         *args], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)})


def test_example_train_lm_faulttolerant_resumes(tmp_path):
    """The fault-tolerant example (reduced qwen3) checkpoints under
    ``$TMPDIR`` by default, and a second, longer run resumes there."""
    args = ("--batch", "2", "--seq", "16", "--save-every", "2")
    first = _example(tmp_path, "train_lm_faulttolerant", "--steps", "4", *args)
    assert first.returncode == 0, first.stderr[-800:]
    assert "done at step 3" in first.stdout
    assert CheckpointManager(str(tmp_path / "repro_torch_ckpt")).latest() == 4
    again = _example(tmp_path, "train_lm_faulttolerant", "--steps", "6", *args)
    assert again.returncode == 0, again.stderr[-800:]
    assert "resumed from checkpoint step 4" in again.stdout
    assert "done at step 5" in again.stdout
    assert "1 restart(s)" in again.stdout


def test_example_serve_batched(tmp_path):
    """The batched-serving example (reduced deepseek-v2-lite, MLA) serves
    its requests and prices the compressed cache."""
    out = _example(tmp_path, "serve_batched", "--batch", "2", "--prompt-len", "8",
                   "--gen", "4")
    assert out.returncode == 0, out.stderr[-800:]
    assert "2 requests x 4 tokens" in out.stdout
    assert "MLA compressed cache" in out.stdout
