"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernels in
interpret mode on the CPU) and ``repro_torch.kernels`` (whose wrappers take
the plain PyTorch version for CPU tensors).  The CUDA kernels themselves
run only on the card (``chip_smoke.py``); the index arithmetic that feeds
them — batch-stride collapsing and the 16-byte-load rule — is pure Python
and is checked here by emulating the kernel's addressing.

Tolerances, by output dtype (both sides multiply the same compute-dtype
values and accumulate in fp32; only the summation order differs, after
which the output rounding may differ by one ulp): fp32 1e-5, fp16 2^-9,
bf16 2^-7, each relative to the largest reference magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import precision as jprec
from repro.kernels import ops as jops
from repro.kernels.chunked_linear_attention import chunked_linear_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.core import precision as tprec
from repro_torch.kernels import chunked_linear_attention as tcla
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import redmule_matmul as trm

POLICIES = ("fp32", "tpu_fp16", "tpu_bf16")
TOL = {"fp32": 1e-5, "tpu_fp16": 2.0 ** -9, "tpu_bf16": 2.0 ** -7}
EPILOGUES = (None, "relu", "gelu", "silu", "tanh")


def _close(got: torch.Tensor, want, tol_rel: float) -> None:
    g = got.float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max() if g.size else 0.0
    assert err <= tol_rel * max(np.abs(w).max(), 1e-6), (err, np.abs(w).max())


def _pair(a: np.ndarray, policy: str):
    """The same values in both packages, cast to the policy's compute dtype."""
    jp, tp = jprec.resolve(policy), tprec.resolve(policy)
    return jnp.asarray(a).astype(jp.compute_dtype), torch.from_numpy(a).to(tp.compute_dtype)


def _stored(rng, layout: str, M: int, N: int, K: int):
    x = rng.standard_normal((N, M) if layout == "tn" else (M, N)).astype(np.float32)
    w = rng.standard_normal((K, N) if layout == "nt" else (N, K)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("layout", ("nn", "nt", "tn"))
def test_plain_gemm_matches_interpret_kernel(layout, policy, epilogue):
    rng = np.random.default_rng([("nn", "nt", "tn").index(layout),
                                 POLICIES.index(policy), EPILOGUES.index(epilogue)])
    M, N, K = 13, 37, 21                       # odd: every edge is ragged
    x, w = _stored(rng, layout, M, N, K)
    b = rng.standard_normal(K).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, policy), _pair(w, policy)
    want = jops.redmule_matmul(jx, jw, policy=jprec.resolve(policy),
                               bias=jnp.asarray(b), epilogue=epilogue,
                               layout=layout, interpret=True)
    got = tops.redmule_matmul(tx, tw, policy=tprec.resolve(policy),
                              bias=torch.from_numpy(b), epilogue=epilogue,
                              layout=layout)
    assert got.dtype == tprec.resolve(policy).out_dtype
    _close(got, want, TOL[policy])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("layout", ("nn", "nt", "tn"))
def test_plain_batched_gemm_matches_interpret_kernel(layout, policy):
    rng = np.random.default_rng(7)
    B, M, N, K = 3, 5, 19, 11
    xs, ws = [], []
    for _ in range(B):
        x, w = _stored(rng, layout, M, N, K)
        xs.append(x)
        ws.append(w)
    (jx, tx), (jw, tw) = _pair(np.stack(xs), policy), _pair(np.stack(ws), policy)
    b = rng.standard_normal(K).astype(np.float32)
    want = jops.redmule_matmul_batched(jx, jw, policy=jprec.resolve(policy),
                                       bias=jnp.asarray(b), epilogue="silu",
                                       layout=layout, interpret=True)
    got = tops.redmule_matmul_batched(tx, tw, policy=tprec.resolve(policy),
                                      bias=torch.from_numpy(b), epilogue="silu",
                                      layout=layout)
    _close(got, want, TOL[policy])


@pytest.mark.parametrize("policy", POLICIES)
def test_plain_batched_gemm_broadcast_operand(policy):
    """The decode PV: p (B, Hkv, G, 1, T) @ v (B, Hkv, 1, T, hd), V shared
    by the G query heads of its KV head."""
    rng = np.random.default_rng(3)
    B, Hkv, G, T, hd = 2, 2, 3, 10, 8
    p = rng.random((B, Hkv, G, 1, T)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, 1, T, hd)).astype(np.float32)
    (jp_, tp_), (jv, tv) = _pair(p, policy), _pair(v, policy)
    jvb = jnp.broadcast_to(jv, (B, Hkv, G, T, hd)).reshape(-1, T, hd)
    want = jops.redmule_matmul_batched(
        jp_.reshape(-1, 1, T), jvb, policy=jprec.resolve(policy),
        interpret=True).reshape(B, Hkv, G, 1, hd)
    got = tops.redmule_matmul_batched(tp_, tv, policy=tprec.resolve(policy))
    assert tuple(got.shape) == (B, Hkv, G, 1, hd)
    _close(got, want, TOL[policy])


def _emulate_kernel_addressing(t: torch.Tensor, lead, outer: int, inner: int):
    """Gather every element the kernel would read: batch b -> (b // n_inner,
    b % n_inner) times the two level strides, rows and columns by their own
    strides — from the raw storage, as the kernel does."""
    flat = t.as_strided((t.untyped_storage().nbytes() // t.element_size(),),
                        (1,), 0)
    n_inner = lead[-1] if lead else 1
    nb = int(np.prod(lead)) if lead else 1
    R, C = t.shape[-2:]
    out = torch.empty((nb, R, C), dtype=t.dtype)
    for b in range(nb):
        base = t.storage_offset() + (b // n_inner) * outer + (b % n_inner) * inner
        for r in range(R):
            for c in range(C):
                out[b, r, c] = flat[base + r * t.stride(-2) + c * t.stride(-1)]
    return out.reshape(*lead, R, C)


@pytest.mark.parametrize("case", ["contiguous", "broadcast_inner",
                                  "broadcast_outer", "permuted", "2d"])
def test_batch_stride_collapse_addresses_the_expanded_operand(case):
    base = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32)
    if case == "contiguous":
        t, lead = base.reshape(2, 3, 4, 5), (2, 3)
    elif case == "broadcast_inner":            # the decode PV's V
        t, lead = base[:2 * 4 * 5].reshape(2, 1, 4, 5), (2, 3)
    elif case == "broadcast_outer":
        t, lead = base[:3 * 4 * 5].reshape(1, 3, 4, 5), (2, 3)
    elif case == "permuted":                   # outer dims do not collapse
        big = torch.arange(2 * 3 * 2 * 4 * 5, dtype=torch.float32)
        t, lead = big.reshape(2, 3, 2, 4, 5).permute(1, 0, 2, 3, 4), (3, 2, 2)
    else:
        t, lead = base[:20].reshape(4, 5), ()
    tt, outer, inner = trm._collapse(t, lead)
    want = t.expand(*lead, *t.shape[-2:])
    torch.testing.assert_close(_emulate_kernel_addressing(tt, lead, outer, inner),
                               want, rtol=0, atol=0)
    if case == "broadcast_inner":
        assert inner == 0 and tt.data_ptr() == t.data_ptr()  # never materialised


def test_vector_load_rule():
    x = torch.zeros(64, 128, dtype=torch.bfloat16)
    assert trm._vec_ok(x, (0, 0), 128, 1, 64, 128) == 1      # rows of 8-runs
    assert trm._vec_ok(x, (0, 0), 128, 1, 64, 130) == 0      # ragged width
    assert trm._vec_ok(x, (0, 4), 128, 1, 64, 128) == 0      # misaligned batch
    assert trm._vec_ok(x, (0, 0), 1, 2048, 2048, 64) == 1    # "nt": rows contiguous
    assert trm._vec_ok(x, (0, 0), 1, 100, 100, 64) == 0      # rows not a multiple of 8
    assert trm._vec_ok(x, (0, 0), 3, 5, 64, 64) == 0         # neither axis contiguous
    assert trm._vec_ok(x[:, 1:], (0, 0), 128, 1, 64, 120) == 0  # 2-byte offset


def test_plain_gemm_rejects_later_slice_features():
    x = torch.ones(4, 8)
    with pytest.raises(NotImplementedError, match="faithful_accum"):
        tops.redmule_matmul(x.half(), x.t().half(), policy=tprec.PAPER_FP16)
    with pytest.raises(NotImplementedError, match="backward"):
        tops.redmule_matmul(x, x.t(), policy=tprec.FP32, bias_grad=True)
    with pytest.raises(NotImplementedError, match="FP8"):
        tops.redmule_matmul(x.to(torch.float8_e4m3fn), x.t(), policy=tprec.FP32)
    with pytest.raises(ValueError, match="contraction mismatch"):
        tops.redmule_matmul(x, x, policy=tprec.FP32)


_FLASH_CASES = {
    # name: (Hq, Hkv, S, T, t_valid, q_offset, causal)
    "causal": (2, 2, 16, 16, 16, 0, True),
    "gqa": (4, 2, 16, 16, 16, 0, True),
    "t_valid_tail": (4, 2, 16, 24, 19, 0, True),
    "q_offset": (4, 2, 8, 24, 24, 13, True),
    "non_causal": (4, 1, 16, 24, 21, 0, False),
}


@pytest.mark.parametrize("name", sorted(_FLASH_CASES))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_plain_flash_matches_interpret_kernel(name, dtype):
    Hq, Hkv, S, T, t_valid, q_offset, causal = _FLASH_CASES[name]
    rng = np.random.default_rng(11)
    D = 16
    q = rng.standard_normal((Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((Hkv, T, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(group=Hq // Hkv, causal=causal, t_valid=t_valid, q_offset=q_offset)
    want = flash_attention_pallas(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                                  bq=8, bkv=8, interpret=True, **kw)
    got = tfa.flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)), **kw)
    assert got.dtype == td
    # fp32 softmax on both sides; the online (blocked) and one-shot softmax
    # differ by summation order only.  bf16 output: one ulp (2^-8) of |o| <= 1.
    _close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7)


def test_plain_flash_no_visible_kv_is_exact_zero():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 16)).astype(np.float32)
    want = flash_attention_pallas(*(jnp.asarray(a) for a in (q, k, k)), group=2,
                                  bq=8, bkv=8, t_valid=0, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, k)), group=2,
                              t_valid=0)
    assert np.all(np.asarray(want) == 0.0)
    assert torch.equal(got, torch.zeros_like(got))


def test_flash_rejects_mismatched_groups():
    q, k = torch.zeros(3, 8, 16), torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="group"):
        tfa.flash_attention(q, k, k, group=2)


_CLA_CASES = {
    # name: (BH, S, dk, dv, chunk)
    "c16_dk_lt_dv": (3, 48, 16, 24, 16),      # hymba's SSD shape kind
    "c32_dk_gt_dv": (2, 64, 24, 8, 32),
    "c16_square": (2, 32, 16, 16, 16),
}


def _cla_inputs(rng, BH, S, dk, dv):
    q = rng.standard_normal((BH, S, dk)).astype(np.float32)
    k = (0.5 * rng.standard_normal((BH, S, dk))).astype(np.float32)
    v = rng.standard_normal((BH, S, dv)).astype(np.float32)
    log_g = -rng.random((BH, S)).astype(np.float32)           # <= 0
    return q, k, v, log_g


@pytest.mark.parametrize("name", sorted(_CLA_CASES))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_plain_chunked_linear_attention_matches_interpret_kernel(name, dtype):
    BH, S, dk, dv, chunk = _CLA_CASES[name]
    rng = np.random.default_rng([sorted(_CLA_CASES).index(name), len(dtype)])
    q, k, v, log_g = _cla_inputs(rng, BH, S, dk, dv)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_o, want_s = chunked_linear_attention_pallas(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), jnp.asarray(log_g),
        chunk=chunk, interpret=True)
    got_o, got_s = tcla.chunked_linear_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), torch.from_numpy(log_g),
        chunk=chunk)
    assert got_o.dtype == td and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == (BH, dk, dv)
    # fp32 everywhere inside; the two sides differ in summation order only.
    # The state is fp32 on both sides (1e-5); the output is stored in the
    # input dtype, so bf16 may flip one output rounding (2^-8), doubled.
    _close(got_s, want_s, 1e-5)
    _close(got_o, want_o, 1e-5 if dtype == "float32" else 2.0 ** -7)


def test_plain_chunked_linear_attention_rejects_ragged_sequence():
    q = torch.zeros(2, 20, 8)
    with pytest.raises(ValueError, match="multiple of"):
        tcla.chunked_linear_attention(q, q, q, torch.zeros(2, 20), chunk=16)
    with pytest.raises(ValueError, match="expected"):
        tcla.chunked_linear_attention(q, q, q, torch.zeros(2, 21), chunk=4)


def test_chunked_linear_attention_zero_decay_padding_is_inert():
    """The engine pads S to a chunk multiple with g = 0 and k = 0: the
    padded rows leave the state and the real rows' output unchanged."""
    rng = np.random.default_rng(2)
    q, k, v, log_g = (torch.from_numpy(a) for a in _cla_inputs(rng, 2, 24, 8, 8))
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 8)) if t.ndim == 3 \
        else torch.nn.functional.pad(t, (0, 8))
    o1, s1 = tcla.chunked_linear_attention(q, k, v, log_g, chunk=8)
    o2, s2 = tcla.chunked_linear_attention(*(pad(t) for t in (q, k, v, log_g)),
                                           chunk=16)
    torch.testing.assert_close(o2[:, :24], o1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s1, rtol=1e-5, atol=1e-5)
