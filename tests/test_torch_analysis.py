"""The port's static-analysis suite (``repro_torch.analysis``) against the
reference's (``tests/test_static_analysis.py``), test for test:

* the escape audit finds a planted raw contraction with its shape and
  flops, audits an engine-only model clean (through a loop's multiplicity
  and a remat recompute) and reconciles backward GEMMs; every public
  spelling of a contraction is recorded;
* the ratchet: covered passes, new and stale fail (escapes and dtype
  findings alike);
* the dtype audit flags fp64, a raw FP8 contraction and an off-policy
  fp32 contraction, and stays silent on the engine's FP8 dispatch;
* the five entries build, audit clean against the manifest (its one fp64
  finding, ``chunk_cumsum``, recorded) and bill the reference's dispatch
  footprint under ``"aten"`` / ``"xla"``;
* the lint's rules and artifact validators on planted violations, and
  clean over the real port and the shipped baselines.
"""

import dataclasses
import json
import os
import shutil
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis import aten_audit, audit, dtype_audit, entries, lint
from repro_torch.core import engine
from repro_torch.core import precision as prec

F16 = torch.float16


def _rand(*shape, dtype=F16, seed=0):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.normal(size=shape) * 0.3, dtype=torch.float32).to(dtype)


def _audit(fn, *args):
    return aten_audit.audit("toy", fn, args)


# --------------------------------------------------------------------- #
# the escape audit
# --------------------------------------------------------------------- #
def test_planted_matmul_detected_with_shape_and_flops():
    def model(x, w, v):
        h = engine.matmul(x, w, policy=prec.PAPER_FP16)
        return torch.matmul(h, v)          # planted escape

    res = _audit(model, _rand(8, 16), _rand(16, 32), _rand(32, 4))
    assert not res.clean and len(res.escapes) == 1
    esc = res.escapes[0]
    assert esc.op == "aten::mm" and esc.shapes == ((8, 32), (32, 4))
    assert esc.flops == 2 * 8 * 32 * 4 and esc.count == 1
    assert "float16" in esc.fingerprint
    assert esc.where == ("<outside repro_torch>",)    # a test, not the port


def test_clean_engine_only_model_zero_escapes():
    def model(x, w, v):
        h = engine.matmul(x, w, policy=prec.PAPER_FP16)
        return engine.matmul(h, v, policy=prec.PAPER_FP16)

    res = _audit(model, _rand(8, 16), _rand(16, 32), _rand(32, 4))
    assert res.clean and not res.unmatched_events
    assert res.n_events == 2


def test_loop_multiplicity_reconciles_and_escapes():
    """The reference's scan multiplicity: eagerly, a loop of 5 dispatches
    five times (and bills five events); a planted contraction in the loop
    is one site of count 5."""
    w = _rand(16, 16)

    def clean(x):
        for _ in range(5):
            x = engine.matmul(x, w, policy=prec.PAPER_FP16)
        return x

    res = _audit(clean, _rand(4, 16))
    assert res.clean and not res.unmatched_events and res.n_events == 5

    def planted(x):
        for _ in range(5):
            x = torch.matmul(x, w)
        return x

    res = _audit(planted, _rand(4, 16))
    assert len(res.escapes) == 1 and res.escapes[0].count == 5


def test_checkpoint_recompute_is_recorded():
    """A remat region's recompute runs inside the backward: the mode records
    it — the planted contraction twice, the engine's re-run reconciled by
    its recompute-tagged event."""
    v, w = _rand(16, 12, dtype=torch.float32), _rand(12, 8, dtype=torch.float32)

    def region(x):
        return engine.matmul(torch.matmul(x, v), w, policy=prec.FP32)

    def step(x):
        x = x.clone().requires_grad_(True)
        engine.checkpoint(region, x).sum().backward()

    tr = aten_audit.trace_entry(step, (_rand(4, 16, dtype=torch.float32),))
    res = aten_audit.reconcile("toy", tr.sites, tr.events)
    planted = [s for s in res.escapes if s.shapes == ((4, 16), (16, 12))]
    assert len(planted) == 1 and planted[0].count == 2     # forward + recompute
    assert [ev.recompute for ev in tr.events].count(True) == 1
    assert not res.unmatched_events


def test_backward_gemms_reconcile():
    """The engine's autograd Functions dispatch their backward GEMMs through
    the registry: a gradient run is where escapes would silently double."""
    x = _rand(8, 16)

    def step(w):
        w = w.clone().requires_grad_(True)
        y = engine.matmul(x, w, policy=prec.PAPER_FP16)
        return torch.autograd.grad((y.float() ** 2).sum(), w)

    res = _audit(step, _rand(16, 32))
    assert res.clean, [s.describe() for s in res.escapes]
    assert not res.unmatched_events and res.n_events == 3


@pytest.mark.parametrize("spelling", ["matmul", "at", "einsum", "linear",
                                      "tensordot", "sdpa"])
def test_every_public_spelling_is_recorded(spelling):
    """Each public spelling reaches the dispatcher as one of CONTRACTIONS,
    inside and outside inference mode."""
    x, w = _rand(6, 8, dtype=torch.float32), _rand(8, 5, dtype=torch.float32)
    q = _rand(1, 2, 4, 8, dtype=torch.float32)
    fn = {"matmul": lambda: torch.matmul(x, w), "at": lambda: x @ w,
          "einsum": lambda: torch.einsum("ij,jk->ik", x, w),
          "linear": lambda: F.linear(x, w.t()),
          "tensordot": lambda: torch.tensordot(x, w, dims=1),
          "sdpa": lambda: F.scaled_dot_product_attention(q, q, q)}[spelling]
    for ctx in (torch.enable_grad, torch.inference_mode):
        with ctx():
            tr = aten_audit.trace_entry(fn, ())
        assert sum(s.count for s in tr.sites) == 1, (spelling, tr.sites)
        assert all(s.op in aten_audit.CONTRACTIONS for s in tr.sites)


# --------------------------------------------------------------------- #
# the ratchet
# --------------------------------------------------------------------- #
def _toy_result(planted: bool):
    def model(x, w, v):
        h = engine.matmul(x, w, policy=prec.PAPER_FP16)
        return torch.matmul(h, v) if planted else h

    return _audit(model, _rand(8, 16), _rand(16, 32), _rand(32, 4))


def test_ratchet_new_escape_fails():
    errors = audit.ratchet_errors("toy", _toy_result(planted=True),
                                  {"aten": {"toy": []}})
    assert errors and "NEW escaped contraction" in errors[0]


def test_ratchet_manifest_covered_escape_passes():
    res = _toy_result(planted=True)
    manifest = {"aten": {"toy": [{"fingerprint": res.escapes[0].fingerprint,
                                  "count": 1}]}}
    assert audit.ratchet_errors("toy", res, manifest) == []


def test_ratchet_stale_entry_fails():
    manifest = {"aten": {"toy": [{"fingerprint": "aten::mm float16[1, 1]·"
                                  "float16[1, 1]->float16", "count": 1}]}}
    errors = audit.ratchet_errors("toy", _toy_result(planted=False), manifest)
    assert errors and "STALE manifest entry" in errors[0]


def test_dtype_ratchet_new_covered_stale():
    x = _rand(4, 4, dtype=torch.float32)
    tr = aten_audit.trace_entry(lambda: x.double(), ())
    findings = dtype_audit.audit_dtypes(tr)
    key = findings[0].key
    entry = {"entry": "toy", "backend": "aten", "key": key, "count": 1, "note": "n"}
    assert "NEW" in audit.dtype_ratchet_errors("toy", "aten", findings, {})[0]
    assert audit.dtype_ratchet_errors("toy", "aten", findings, {"dtype": [entry]}) == []
    # the same entry under the card's backend does not cover the CPU's
    other = dict(entry, backend="hopper")
    assert audit.dtype_ratchet_errors("toy", "aten", findings, {"dtype": [other]})
    stale = audit.dtype_ratchet_errors("toy", "aten", [], {"dtype": [entry]})
    assert stale and "STALE" in stale[0]


# --------------------------------------------------------------------- #
# the dtype audit
# --------------------------------------------------------------------- #
def test_dtype_audit_flags_planted_fp64():
    def model(x):
        return (x.to(torch.float64) * 2.0).sum()

    tr = aten_audit.trace_entry(model, (_rand(4, 4, dtype=torch.float32),))
    findings = dtype_audit.audit_dtypes(tr)
    assert any(f.kind == "fp64" for f in findings), findings


def test_dtype_audit_flags_raw_fp8_contraction():
    def model(x, w):
        x8, w8 = x.to(torch.float8_e4m3fn), w.to(torch.float8_e4m3fn)
        return torch._scaled_mm(x8, w8.t().contiguous().t(),
                                scale_a=torch.ones(()), scale_b=torch.ones(()),
                                out_dtype=torch.float32)

    try:
        tr = aten_audit.trace_entry(model, (_rand(16, 16, dtype=torch.float32),
                                            _rand(16, 16, dtype=torch.float32)))
    except (RuntimeError, NotImplementedError):
        # no CPU kernel for _scaled_mm in this build: record on meta tensors
        tr = aten_audit.trace_entry(model, (torch.empty(16, 16, device="meta"),
                                            torch.empty(16, 16, device="meta")))
    findings = dtype_audit.audit_dtypes(tr, extra_allowed=("float32",))
    assert [f.kind for f in findings] == ["fp8_uncovered"]


def test_dtype_audit_flags_off_policy_fp32_contraction():
    def model(x, w):
        h = engine.matmul(x, w, policy=prec.PAPER_FP16)    # declares fp16 only
        return torch.matmul(h.float(), w.float().t())

    tr = aten_audit.trace_entry(model, (_rand(8, 16), _rand(16, 32)))
    assert [f.kind for f in dtype_audit.audit_dtypes(tr)] == ["fp32_materialization"]


def test_dtype_audit_silent_on_engine_fp8_dispatch():
    """The engine widens FP8 storage before its one aten contraction: a
    scaled dispatch gives no finding, and the audit still reconciles."""
    def model(x, w):
        return engine.matmul(x, w, policy=prec.MIXED_FP8_E4M3)

    tr = aten_audit.trace_entry(model, (_rand(8, 16), _rand(16, 32)))
    assert tr.events and tr.events[0].spec.x_dtype == "float8_e4m3fn"
    assert dtype_audit.audit_dtypes(tr) == []
    assert aten_audit.reconcile("toy", tr.sites, tr.events).clean


def test_shipped_policies_conform():
    assert dtype_audit.check_shipped_policies() == []


# --------------------------------------------------------------------- #
# the entries and the CLI
# --------------------------------------------------------------------- #
def test_every_entry_audits_clean_against_manifest(capsys):
    """Acceptance: ``python -m repro_torch.analysis.audit`` exits 0 over the
    five entries under "aten": zero escapes, and only the manifest's fp64
    finding (chunk_cumsum in xlstm_fwd)."""
    assert audit.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("clean") == len(entries.ENTRY_POINTS)
    assert "[fp64] aten::cumsum -> float64 x2" in out


def test_cli_nonzero_on_planted_escape(monkeypatch, tmp_path):
    def build(device="cpu", overrides=None):
        def model(x, w):
            return torch.matmul(x, w)
        return model, (_rand(8, 16), _rand(16, 4))

    monkeypatch.setitem(entries.ENTRY_POINTS, "toy_planted", build)
    manifest = tmp_path / "escapes.json"
    manifest.write_text(json.dumps({"aten": {}, "ast": [], "dtype": []}))
    report = tmp_path / "report.json"
    assert audit.run(["toy_planted"], str(manifest), str(report)) == 1
    rep = json.loads(report.read_text())
    assert rep["errors"] and rep["entries"]["toy_planted"]["escapes"]


def test_cli_nonzero_on_planted_fp64_and_stale_entry(monkeypatch, tmp_path):
    def build(device="cpu", overrides=None):
        return (lambda x: engine.matmul(x.double().float(), x.t(),
                                        policy=prec.FP32)), (_rand(4, 4, dtype=torch.float32),)

    monkeypatch.setitem(entries.ENTRY_POINTS, "toy_fp64", build)
    manifest = tmp_path / "escapes.json"
    manifest.write_text(json.dumps({"aten": {}, "ast": [], "dtype": []}))
    assert audit.run(["toy_fp64"], str(manifest)) == 1
    # the shipped manifest with its fp64 entry's count raised: stale
    m = json.loads(open(audit.DEFAULT_MANIFEST).read())
    m["dtype"][0]["count"] += 1
    manifest.write_text(json.dumps(m))
    assert audit.run(["xlstm_fwd"], str(manifest)) == 1


def test_every_registered_entry_builds():
    for name in entries.ENTRY_POINTS:
        fn, args = entries.get_entry(name, "meta")
        assert callable(fn) and len(args) >= 1
    with pytest.raises(KeyError):
        entries.get_entry("nope")


@pytest.fixture(scope="module")
def reference_footprints():
    """The reference's five entries traced under "xla" (jax.eval_shape,
    about 4 s): ``engine.dispatch_footprint`` of each."""
    from repro.analysis import entries as jentries
    from repro.core import engine as jeng

    out = {}
    for name in jentries.ENTRY_POINTS:
        fn, args = jentries.get_entry(name)
        with jeng.use_backend("xla"), jeng.instrument() as events:
            jax.eval_shape(fn, *args)
        out[name] = jeng.dispatch_footprint(events)
    return out


@pytest.mark.parametrize("name", sorted(entries.ENTRY_POINTS))
def test_entry_footprint_equals_reference(name, reference_footprints):
    """The port under "aten" bills the reference's dense footprint under
    "xla", entry by entry, with no exception at these configs: both route
    attention (the prefill and the forwards) through the q-chunked path
    and linear attention through the composition, since neither backend
    declares "attention", and every entry here is a forward or the AE's
    un-rematted gradient, so the sweep recompute is not billed."""
    a = audit.audit_entry(name)
    assert a["footprint"] == reference_footprints[name]
    assert a["result"].clean and not a["result"].unmatched_events


def test_hopper_cpu_footprint_and_implied_launches():
    """Under "hopper" the same xlstm forward bills the sweep kernel (four
    events a launch) with the composition's dense total, and implies one
    kernel-4 launch per mLSTM block."""
    a = audit.audit_entry("xlstm_fwd", "hopper", "cpu")
    ref = audit.audit_entry("xlstm_fwd")
    foot = a["footprint"]
    assert sum(f * n for f, n in foot.items()) == sum(
        f * n for f, n in ref["footprint"].items())
    implied = aten_audit.launches_implied(a["trace"].events)
    assert implied == {"gemm": 47, "flash_attention": 0, "chunked_linear_attention": 2}


# --------------------------------------------------------------------- #
# the lint
# --------------------------------------------------------------------- #
def _plant_tree(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def test_lint_flags_planted_violations(tmp_path):
    _plant_tree(tmp_path, "models/bad.py", """
        import os
        import torch

        EVENT_LOG = []

        def f(x, w, spec):
            spec.m = 5
            os._exit(1)
            y = torch.einsum("ij,jk->ik", x, w)
            return y @ w
    """)
    manifest = tmp_path / "escapes.json"
    manifest.write_text(json.dumps({"aten": {}, "ast": [], "dtype": []}))
    rules = {v[2] for v in lint.lint_sources(str(tmp_path), str(manifest))}
    assert rules == {"models-gemm", "os-exit", "spec-mutation", "module-collector"}


def test_lint_catches_every_contraction_spelling(tmp_path):
    _plant_tree(tmp_path, "models/spell.py", """
        import torch
        import torch.nn.functional as F
        from repro_torch.core import engine

        def f(x, w, q):
            a = torch.matmul(x, w) + x.mm(w) + x.bmm(w) + x.matmul(w)
            b = F.linear(x, w) + torch.tensordot(x, w, dims=1)
            c = F.scaled_dot_product_attention(q, q, q)
            return engine.matmul(a, w) + engine.einsum2d("ij,jk->ik", b, w) + c
    """)
    manifest = tmp_path / "escapes.json"
    manifest.write_text(json.dumps({"aten": {}, "ast": [], "dtype": []}))
    calls = sorted(v[3].split()[1] for v in lint.lint_sources(str(tmp_path),
                                                              str(manifest)))
    assert calls == [".bmm", ".matmul", ".mm", "F.linear",
                     "F.scaled_dot_product_attention", "torch.matmul",
                     "torch.tensordot"]


def test_lint_manifest_allows_and_ratchets(tmp_path):
    _plant_tree(tmp_path, "models/ok.py", """
        import torch

        def f(x, w):
            return torch.einsum("ij,jk->ik", x, w)
    """)
    rel = os.path.relpath(tmp_path, lint._REPO_ROOT)
    m = tmp_path / "escapes.json"
    m.write_text(json.dumps({"aten": {}, "dtype": [], "ast": [
        {"file": os.path.join(rel, "models/ok.py"), "call": "torch.einsum",
         "equation": "ij,jk->ik", "count": 1}]}))
    assert lint.lint_sources(str(tmp_path), str(m)) == []
    (tmp_path / "models" / "ok.py").write_text("def f():\n    return 0\n")
    stale = lint.lint_sources(str(tmp_path), str(m))
    assert stale and stale[0][2] == "models-gemm" and "STALE" in stale[0][3]


def test_lint_cli_nonzero_on_planted_einsum(tmp_path, monkeypatch):
    """Acceptance: a planted torch.einsum in a model file makes the lint
    exit 1 (a copy of the port's tree, never the tree itself)."""
    src = tmp_path / "repro_torch"
    shutil.copytree(lint._SRC_ROOT, src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(src / "models" / "layers.py", "a") as fh:
        fh.write("\n\ndef _planted(x, w):\n    return torch.einsum('ij,jk->ik', x, w)\n")
    monkeypatch.setattr(lint, "_SRC_ROOT", str(src))
    assert lint.main(["--no-artifacts"]) == 1
    monkeypatch.undo()
    assert lint.main([]) == 0


def test_lint_real_repo_is_clean():
    assert lint.lint_sources() == []


def test_gemmspec_field_list_in_sync():
    """The lint keeps GemmSpec's field names as literals; fail here when the
    dataclass drifts."""
    assert lint._GEMMSPEC_FIELDS == {f.name for f in dataclasses.fields(engine.GemmSpec)}


# --------------------------------------------------------------------- #
# artifact validation
# --------------------------------------------------------------------- #
def test_autotune_cache_validation(tmp_path):
    good = {"m256-n512-k256-bfloat16-float32-bfloat16-none-hopper":
            {"bm": 64, "bn": 32, "bk": 64, "source": "heuristic", "us": 1.0},
            # the reference's entries are the reference's: skipped
            "m4096-n4096-k4096-float32-float32-float32-none-pallas-d4":
            {"bm": 2048, "bn": 2048, "bk": 2048}}
    p = tmp_path / "cache.json"
    p.write_text(json.dumps(good))
    assert lint.validate_autotune_cache(str(p)) == []

    bad = {"m4096-n4096-k4096-float32-float32-float32-none-hopper":
           {"bm": 2048, "bn": 2048, "bk": 2048, "source": "measured", "us": 1.0},
           "not a key": {"bm": 1, "bn": 1, "bk": 1}}
    p.write_text(json.dumps(bad))
    rules = [v[2] for v in lint.validate_autotune_cache(str(p))]
    assert rules == ["autotune-cache", "autotune-cache"]


def test_shipped_baselines_satisfy_analytic_identities():
    assert lint.validate_baselines() == []


def test_baseline_validation_catches_broken_identity(tmp_path):
    for name in os.listdir(lint.BASELINES):
        if name.endswith(".json"):
            shutil.copy(os.path.join(lint.BASELINES, name), tmp_path / name)
    tf = json.loads((tmp_path / "train_flops.json").read_text())
    tf["ae_train_B16"]["bwd"] += 2          # breaks bwd == 2*fwd and the total
    (tmp_path / "train_flops.json").write_text(json.dumps(tf))
    sv = json.loads((tmp_path / "serve_bytes.json").read_text())
    sv["yi-9b"]["fp8_bytes"] += 1            # off the port's formula
    (tmp_path / "serve_bytes.json").write_text(json.dumps(sv))
    probs = [v[3] for v in lint.validate_baselines(str(tmp_path))]
    assert any("total != fwd + bwd" in p for p in probs)
    assert any("decode_step_kv_bytes" in p for p in probs)


def test_shipped_escape_manifest_is_well_formed():
    assert lint.validate_escape_manifest() == []
