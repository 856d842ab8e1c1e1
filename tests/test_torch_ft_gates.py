"""The port's fault-tolerance gates (``tests/test_ft_gates.py``), on the CPU.

The elastic worker (``repro_torch.runtime.elastic``, the toy MLP) and the
LM training CLI (``repro_torch.launch.train --compress fp8_e4m3
--dp-procs 2 --ckpt-dir``) run as real rank processes over gloo; each
launcher runs in this process (``main(argv)``) and the ranks are its
children, so a rank's ``os._exit`` shows as the launcher's return code.

* kill and resume bit-identical, on the fp32 and the FP8 wire;
* a torn checkpoint write resumes from the previous complete one;
* the 4 -> 2 elastic attach, held to the regroup's invariants (residuals
  summed and their total conserved, scale windows the group maxima,
  ``last_step`` 7, a finite loss) rather than to the reference's
  comparison of two single-step losses on different batches, which its
  own run does not meet;
* the LM's params, error-feedback and optimizer digests and loss after a
  kill and resume, equal to the uninterrupted run's;
* ``_regroup_axis0`` against the reference's on numpy arrays.
"""

import json

import numpy as np
import pytest

from repro.runtime.elastic import _regroup_axis0 as j_regroup

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as ttrain
from repro_torch.runtime import elastic


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_rank():
    """The ranks are tiny: one intra-op thread each keeps them from
    oversubscribing a shared CPU (they inherit the environment)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _worker(ckpt, *, steps=8, save_every=2, dp=2, compress="none",
            fail_step=None, fail_mode="die", result=None) -> int:
    argv = ["--device", "cpu", "--ckpt", str(ckpt), "--steps", str(steps),
            "--save-every", str(save_every), "--dp", str(dp),
            "--compress", compress, "--log-every", "100"]
    if fail_step is not None:
        argv += ["--fail-step", str(fail_step), "--fail-mode", fail_mode]
    if result is not None:
        argv += ["--result", str(result)]
    return elastic.main(argv)


def _result(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=["none", "fp8_e4m3"])
def reference_run(request, tmp_path_factory):
    """The uninterrupted 8-step digest, one per wire."""
    kind = request.param
    d = tmp_path_factory.mktemp(f"ref_{kind}")
    assert _worker(d / "ckpt", compress=kind, result=d / "out.json") == 0
    return kind, _result(d / "out.json")


def test_kill_and_resume_bit_identical(reference_run, tmp_path, capfd):
    kind, ref = reference_run
    assert _worker(tmp_path / "ckpt", compress=kind, fail_step=5) == 13
    assert _worker(tmp_path / "ckpt", compress=kind, result=tmp_path / "out.json") == 0
    assert "resumed from checkpoint step 4" in capfd.readouterr().out
    out = _result(tmp_path / "out.json")
    assert out["digest"] == ref["digest"], f"{kind}: resumed digest diverged"
    assert out["loss"] == ref["loss"]
    g = out["goodput"]
    assert g["restarts"] == 1
    assert g["recomputed_steps"] == 1   # died at 5, last checkpoint at 4


def test_torn_checkpoint_write_recovers(reference_run, tmp_path, capfd):
    kind, ref = reference_run
    ckpt = tmp_path / "ckpt"
    assert _worker(ckpt, compress=kind, fail_step=4, fail_mode="ckpt_crash") == 13
    names = [p.name for p in ckpt.iterdir()]
    assert "step_000000004.tmp" in names, names
    assert "step_000000004" not in names      # the torn write never published
    assert _worker(ckpt, compress=kind, result=tmp_path / "out.json") == 0
    assert "resumed from checkpoint step 2" in capfd.readouterr().out
    assert _result(tmp_path / "out.json")["digest"] == ref["digest"]


def test_elastic_resume_4_to_2(tmp_path, capfd):
    """A dp-4 FP8 checkpoint continues on 2 ranks: its per-host state is
    regrouped as _regroup_axis0 says and the run reaches its last step."""
    ckpt = tmp_path / "ckpt"
    assert _worker(ckpt, steps=4, dp=4, compress="fp8_e4m3",
                   result=tmp_path / "out4.json") == 0
    arrays4, m4 = CheckpointManager(str(ckpt))._load_verified(4)
    arrays4 = {k: v.copy() for k, v in arrays4.items()}
    assert _worker(ckpt, steps=8, dp=2, compress="fp8_e4m3",
                   result=tmp_path / "out2.json") == 0
    out = capfd.readouterr().out
    assert "elastic attach: regrouping step-4 checkpoint from dp=4 to dp=2" in out
    assert "resumed from checkpoint step 4" in out
    out2 = _result(tmp_path / "out2.json")
    assert out2["dp"] == 2 and out2["last_step"] == 7
    assert np.isfinite(out2["loss"])
    arrays2, m2 = CheckpointManager(str(ckpt))._load_verified(4)
    assert m2["metadata"]["elastic_migrated_from_dp"] == 4
    # the state {"ef", "opt", "params"} flattens "ef" first: per parameter
    # (b1, b2, w1, w2) the residual, then the window's scale, history and
    # overflow count
    for i in range(16):
        k = f"leaf_{i}"
        a4, a2 = arrays4[k], arrays2[k]
        assert m4["shapes"][k][0] == 4 and m2["shapes"][k][0] == 2
        if i % 4 == 0:
            np.testing.assert_allclose(a2, a4.reshape(2, 2, *a4.shape[1:]).sum(1),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(a2.sum(0), a4.sum(0), rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(a2, a4.reshape(2, 2, *a4.shape[1:]).max(1))
    for i in range(16, m2["n_leaves"]):            # replicated: unchanged
        k = f"leaf_{i}"
        np.testing.assert_array_equal(arrays2[k], arrays4[k])


def _lm(ckpt, *, fail_step=None, result=None):
    argv = ["--device", "cpu", "--arch", "qwen3-1.7b", "--steps", "6",
            "--batch", "4", "--seq", "16", "--compress", "fp8_e4m3",
            "--dp-procs", "2", "--save-every", "2", "--seed", "0"]
    if ckpt is not None:
        argv += ["--ckpt-dir", str(ckpt)]
    if fail_step is not None:
        argv += ["--fail-step", str(fail_step), "--fail-mode", "die"]
    if result is not None:
        argv += ["--result", str(result)]
    return ttrain.main(argv)["returncode"]


def test_lm_compressed_dp_kill_resume_bit_identical(tmp_path, capfd):
    """launch/train.py --compress fp8_e4m3 --dp-procs 2 --ckpt-dir: a run
    killed at step 5 and resumed ends with the params, error-feedback
    and optimizer digests and the loss of an uninterrupted run."""
    assert _lm(None, result=tmp_path / "ref.json") == 0
    want = _result(tmp_path / "ref.json")
    assert _lm(tmp_path / "ckpt", fail_step=5) == 13
    assert _lm(tmp_path / "ckpt", result=tmp_path / "out.json") == 0
    assert "resumed from checkpoint step 4" in capfd.readouterr().out
    out = _result(tmp_path / "out.json")
    for key in ("digest", "ef_digest", "opt_digest", "loss"):
        assert out[key] == want[key], key
    assert out["goodput"]["restarts"] == 1 and out["goodput"]["recomputed_steps"] == 1
    assert len(out["step_s"]) == 2 and len(out["save_s"]) == 1


@pytest.mark.parametrize("shape,dp_new", [((4, 3), 2), ((4, 3), 1), ((2, 5), 4),
                                          ((3, 2, 2), 2), ((2, 3), 3)])
@pytest.mark.parametrize("how", ["sum", "max"])
def test_regroup_axis0_matches_reference(shape, dp_new, how):
    """Divisible merges, multiples (splits) and non-divisible resizes."""
    x = np.random.default_rng(sum(shape) + dp_new).standard_normal(shape).astype(np.float32)
    got = elastic._regroup_axis0(x, dp_new, how)
    want = np.asarray(j_regroup(x, dp_new, how))
    assert got.dtype == want.dtype and got.shape == want.shape == (dp_new,) + shape[1:]
    np.testing.assert_array_equal(got, want)
