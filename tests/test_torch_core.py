"""The port's precision policies, epilogues, tiles and oracles against the
JAX package's, on the same numpy inputs.

Tolerances: elementwise fp32 functions 1e-6 relative (libm differences;
the derivatives also 1e-5 absolute, see there);
oracles as the kernels (fp32 1e-5, fp16 2^-9, bf16 2^-7 of the largest
reference magnitude); FP8 quantization is exact (both round to nearest
even from the same fp32 quotient).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import epilogues as jepi
from repro.core import precision as jprec
from repro.core import tiling as jtiling
from repro.kernels import ref as jref

from repro_torch.core import epilogues as tepi
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.kernels import ref as tref


@pytest.mark.parametrize("name", sorted(jprec.known_policies()))
def test_policies_match_reference(name):
    j, t = jprec.resolve(name), tprec.resolve(name)
    for field in ("compute_dtype", "accum_dtype", "out_dtype", "x_storage_dtype",
                  "w_storage_dtype", "grad_storage_dtype"):
        assert tprec.dtype_name(getattr(t, field)) == jnp.dtype(getattr(j, field)).name
    assert (t.faithful_accum, t.mixed_storage, t.scaled) == \
           (j.faithful_accum, j.mixed_storage, j.scaled)


def test_policy_validation_and_resolve():
    assert tprec.resolve(None) is tprec.TPU_BF16
    with pytest.raises(ValueError, match="unknown precision policy"):
        tprec.resolve("fp13")
    with pytest.raises(ValueError, match="not a floating dtype"):
        tprec.Policy("bad", torch.int32, torch.float32)
    assert tprec.is_fp8("float8_e5m2") and not tprec.is_fp8(torch.float16)


@pytest.mark.parametrize("fmt", tprec.FP8_FORMATS)
@pytest.mark.parametrize("case", ("random", "zeros", "given_scale"))
def test_quantize_fp8_matches_reference(fmt, case):
    rng = np.random.default_rng(0)
    v = {"random": rng.standard_normal((7, 9)) * 3,
         "zeros": np.zeros((4, 4)),
         "given_scale": rng.standard_normal((5,))}[case].astype(np.float32)
    scale = 4.0 if case == "given_scale" else None
    jq, js = jprec.quantize_fp8(jnp.asarray(v), fmt, scale=scale)
    tq, ts = tprec.quantize_fp8(torch.from_numpy(v), fmt, scale=scale)
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(
        tprec.dequantize_fp8(tq, ts).numpy(),
        np.asarray(jprec.dequantize_fp8(jq, js), np.float32))


@pytest.mark.parametrize("name", sorted(jepi.EPILOGUES))
def test_epilogues_match_reference(name):
    x = np.linspace(-6, 6, 97).astype(np.float32)
    want = np.asarray(jepi.apply_epilogue(name, jnp.asarray(x)))
    got = tepi.apply_epilogue(name, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tepi.EPILOGUE_IDS[name] > 0
    with pytest.raises(ValueError, match="unknown epilogue"):
        tepi.validate_epilogue("swish2")


@pytest.mark.parametrize("name", sorted(jepi.EPILOGUE_GRADS))
def test_epilogue_derivatives_match_reference(name):
    s = np.linspace(-6, 6, 97).astype(np.float32)
    jg, tg = jepi.epilogue_grad(name), tepi.epilogue_grad(name)
    # gelu' = 0.5 (1 + t) + ...: where tanh saturates the sum cancels, and a
    # one-ulp libm difference in t is then ~4e-6 absolute on values of O(1)
    np.testing.assert_allclose(tg.deriv(torch.from_numpy(s)).numpy(),
                               np.asarray(jg.deriv(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-5)
    assert (tg.deriv_from_output is None) == (jg.deriv_from_output is None)
    if tg.deriv_from_output is not None:
        z = np.array(jepi.apply_epilogue(name, jnp.asarray(s)))
        np.testing.assert_allclose(
            tg.deriv_from_output(torch.from_numpy(z)).numpy(),
            np.asarray(jg.deriv_from_output(jnp.asarray(z))), rtol=1e-6, atol=1e-6)
    assert set(tepi.EPILOGUE_GRADS) == set(tepi.EPILOGUES)


_REF_TILE_SHAPES = ((16, 640, 128), (640, 16, 128), (640, 4096, 128),
                    (128, 4096, 640), (128, 4096, 128), (4096, 640, 128),
                    (3, 5000, 7), (1000, 1000, 1000), (0, 300, 77))


@pytest.mark.parametrize("fused_bwd", (False, True))
@pytest.mark.parametrize("shape", _REF_TILE_SHAPES)
def test_reference_tiles_match_reference_heuristic(shape, fused_bwd):
    """The faithful accumulator's block is the reference's tile.bn, so the
    heuristic copy must agree with ``repro.core.tiling.choose_tiles`` for
    every dtype pair a policy gives it."""
    for c, a in (("float16", "float16"), ("float16", "float32"),
                 ("bfloat16", "float32"), ("float32", "float32")):
        want = jtiling.choose_tiles(*shape, compute_dtype=jnp.dtype(c),
                                    accum_dtype=jnp.dtype(a), fused_bwd=fused_bwd)
        got = tiling.reference_tiles(*shape, compute_dtype=getattr(torch, c),
                                     accum_dtype=getattr(torch, a),
                                     fused_bwd=fused_bwd)
        assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk), (c, a)
        assert tiling.accum_block(*shape, compute_dtype=getattr(torch, c),
                                  accum_dtype=getattr(torch, a),
                                  fused_bwd=fused_bwd) == want.bn
        assert tiling.vmem_bytes(got, getattr(torch, c), getattr(torch, a),
                                 fused_bwd=fused_bwd) == jtiling.vmem_bytes(
            want, jnp.dtype(c), jnp.dtype(a), fused_bwd=fused_bwd)


def test_tile_rule_fits_shared_memory():
    assert tiling.choose_tiles(4, 2048, 151936) == tiling.TileConfig(16, 32, 128)
    assert tiling.choose_tiles(128, 2048, 4096) == tiling.TileConfig(64, 32, 64)
    for t in tiling.GEMM_TILES:
        for dt in (torch.float16, torch.bfloat16):
            assert tiling.smem_bytes(t, dt) <= tiling.SMEM_BUDGET
    with pytest.raises(ValueError):
        tiling.TileConfig(bm=0)


@pytest.mark.parametrize("policy", ("fp32", "tpu_fp16", "tpu_bf16", "paper_fp16"))
def test_matmul_ref_matches_reference_oracle(policy):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 300)).astype(np.float32)
    w = rng.standard_normal((300, 5)).astype(np.float32)
    want = jref.matmul_ref(jnp.asarray(x), jnp.asarray(w),
                           policy=jprec.resolve(policy),
                           tile=jtiling.TileConfig(bm=8, bn=128, bk=128))
    got = tref.matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                          policy=tprec.resolve(policy),
                          tile=tiling.TileConfig(bm=8, bn=128, bk=128))
    assert got.dtype == tprec.resolve(policy).out_dtype
    tol = {"fp32": 1e-5, "tpu_bf16": 2.0 ** -7}.get(policy, 2.0 ** -9)
    w_ = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - w_).max() <= tol * np.abs(w_).max()
    np.testing.assert_allclose(tref.matmul_exact(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jref.matmul_exact(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", (True, False))
def test_attention_ref_matches_reference_oracle(causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    k = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = tref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
