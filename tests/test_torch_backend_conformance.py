"""The port's backend registry contract (``repro_torch.analysis.contract``),
the counterpart of ``tests/test_backend_conformance.py``: every registered
port backend against every contract its capabilities declare (and base and
attention, which every backend answers), the capability coverage, the
negative tests with deliberately broken dummy backends, and the
``"aten"`` backend's own limits (never the default, no CUDA tensor).
``chip_smoke.py`` runs the same checks for ``"hopper"`` on CUDA tensors.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import contract
from repro_torch.core import engine
from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec


def _declared():
    return [(b, c) for b in engine.registered_backends() for c in contract.CONTRACTS
            if c in ("base", "attention") or engine.backend_supports(b, c)]


@pytest.mark.parametrize("backend,contract_name", _declared())
def test_backend_conformance(backend, contract_name):
    assert engine.get_backend(backend).is_available()
    # "attention" runs on every backend: the engine serves non-capable
    # backends through its composition, so all must answer
    contract.run_contract(backend, contract_name)


def test_both_port_backends_are_swept():
    assert {"aten", "hopper"} <= set(engine.registered_backends())
    assert {c for b, c in _declared() if b == "hopper"} == set(contract.CONTRACTS)


def test_every_declared_capability_has_a_check():
    """No registered backend may declare a capability the harness cannot
    exercise (except "tiled", covered by the base check's real tiles)."""
    for name in engine.registered_backends():
        for cap in engine.get_backend(name).capabilities:
            assert cap == "tiled" or cap in contract.CONTRACT_CHECKS, (
                f"backend {name!r} declares capability {cap!r} with no "
                f"conformance check — extend repro_torch/analysis/contract.py")


def test_violating_backend_fails_readably():
    def broken_fn(x, w, *, spec, bias=None, fuse_epilogue=False, deriv=None,
                  bias_grad=False):
        # claims fused_epilogue but silently ignores the bias row
        z = torch.matmul(x.float(), w.float())
        if fuse_epilogue:
            z = epi.apply_epilogue(spec.epilogue, z)
        return z.to(spec.policy.out_dtype)

    engine.register_backend("broken-dummy", broken_fn,
                            capabilities=("fused_epilogue",),
                            description="conformance negative test: drops the bias")
    try:
        contract.run_contract("broken-dummy", "base")   # the pure GEMM is fine
        with pytest.raises(AssertionError) as e:
            contract.run_contract("broken-dummy", "fused_epilogue")
        msg = str(e.value)
        assert "broken-dummy" in msg and "fused_epilogue" in msg, msg
    finally:
        engine.unregister_backend("broken-dummy")


def test_violating_attention_backend_fails_readably():
    def ok_gemm(x, w, *, spec):
        return torch.matmul(x.float(), w.float()).to(spec.policy.out_dtype)

    def broken_attention(kind, operands, **params):
        # claims the attention capability but returns zeros
        q = operands[0]
        if kind == "attention":
            return torch.zeros_like(q)
        dk, dv = operands[1].shape[-1], operands[2].shape[-1]
        return (torch.zeros(operands[2].shape, dtype=q.dtype),
                torch.zeros((q.shape[0], dk, dv)))

    engine.register_backend("broken-attn", ok_gemm, capabilities=("attention",),
                            attention_fn=broken_attention,
                            description="conformance negative test: zeros")
    try:
        contract.run_contract("broken-attn", "base")
        with pytest.raises(AssertionError) as e:
            contract.run_contract("broken-attn", "attention")
        msg = str(e.value)
        assert "broken-attn" in msg and "attention" in msg, msg
    finally:
        engine.unregister_backend("broken-attn")


def test_attention_capability_requires_attention_fn():
    with pytest.raises(ValueError, match="attention"):
        engine.register_backend("attn-no-fn", lambda x, w, *, spec: x,
                                capabilities=("attention",))
    assert "attn-no-fn" not in engine.registered_backends()


def test_unknown_capability_rejected_at_registration():
    with pytest.raises(ValueError, match="unknown backend capabilities"):
        engine.register_backend("bad-caps", lambda x, w, *, spec: x,
                                capabilities=("warp_speed",))
    assert "bad-caps" not in engine.registered_backends()


def test_aten_is_never_the_default_and_refuses_cuda_tensors():
    assert engine.default_backend() == "hopper"
    with engine.use_backend("aten"):
        assert engine.default_backend() == "aten"
    assert engine.default_backend() == "hopper"
    spec = engine.GemmSpec(op="matmul", tag="t", m=4, n=4, k=4, policy=prec.FP32)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(4, 4, device="cuda")     # a fake: no card is needed
        with pytest.raises(ValueError, match="'aten' backend runs CPU and meta"):
            engine.get_backend("aten").fn(x, x, spec=spec)


def test_aten_issues_one_contraction_per_dispatch_in_compute_dtype():
    from repro_torch.analysis import aten_audit

    x = torch.randn(2, 3, 8, 16, dtype=torch.bfloat16)
    w = torch.randn(16, 8, dtype=torch.bfloat16)
    wb = torch.randn(3, 16, 8, dtype=torch.bfloat16)
    for fn in (lambda: engine.matmul(x, w, backend="aten", policy=prec.TPU_BF16),
               lambda: engine.matmul(x, wb, backend="aten", policy=prec.TPU_BF16),
               lambda: engine.grouped_matmul(x, wb, backend="aten",
                                             policy=prec.PAPER_FP16)):
        tr = aten_audit.trace_entry(fn, ())
        assert sum(s.count for s in tr.sites) == 1
        spec = tr.events[0].spec
        assert tr.sites[0].flops == spec.dense_flops
        assert set(tr.sites[0].dtypes) == {prec.dtype_name(spec.policy.compute_dtype)}
