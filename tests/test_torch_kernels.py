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

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import precision as jprec
from repro.core import tiling as jtiling
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
    # FP8 operands widen on load to an fp16 compute dtype only (and there
    # run); the fused backward keeps the reference kernel's contract
    # (transpose layouts, bias_grad on "tn", deriv shaped like dZ)
    x = torch.ones(4, 8)
    with pytest.raises(NotImplementedError, match="FP8.*fp16 compute"):
        tops.redmule_matmul(x.to(torch.float8_e4m3fn), x.t(), policy=tprec.FP32)
    with pytest.raises(NotImplementedError, match="FP8"):
        tops.redmule_matmul_batched(x[None].to(torch.float8_e5m2), x.t()[None],
                                    policy=tprec.FP32)
    z = tops.redmule_matmul(x.to(torch.float8_e4m3fn), x.t().to(torch.float8_e4m3fn),
                            policy=tprec.MIXED_FP8_E4M3)
    assert z.dtype == torch.float16 and torch.equal(z, torch.full((4, 4), 8.0).half())
    zb = tops.redmule_matmul_batched(x[None].to(torch.float8_e5m2),
                                     x.t()[None].to(torch.float8_e5m2),
                                     policy=tprec.MIXED_FP8_E5M2)
    assert torch.equal(zb, torch.full((1, 4, 4), 8.0).half())
    with pytest.raises(ValueError, match="tn"):
        tops.redmule_matmul(x, x.t(), policy=tprec.FP32, bias_grad=True)
    with pytest.raises(ValueError, match="transpose-layout"):
        tops.redmule_matmul(x, x.t(), policy=tprec.FP32, deriv=x,
                            grad_epilogue="relu")
    with pytest.raises(ValueError, match="shaped like the dZ operand"):
        tops.redmule_matmul(x, x, policy=tprec.FP32, layout="nt",
                            deriv=x.t(), grad_epilogue="relu")
    with pytest.raises(ValueError, match="output-form"):
        tops.redmule_matmul(x, x, policy=tprec.FP32, layout="nt", deriv=x,
                            grad_epilogue="gelu", grad_from_output=True)
    with pytest.raises(ValueError, match="multiple of 32"):
        tops.redmule_matmul(x.half(), x.t().half(), policy=tprec.PAPER_FP16,
                            accum_block=48)
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


# --------------------------------------------------------------------- #
# Kernel 1's faithful fp16 accumulator and fused backward epilogue
# --------------------------------------------------------------------- #
# The reference kernel under explicit tiles whose bn is smaller than N, so
# the faithful accumulator re-rounds several times; the port's plain
# version gets the same block as ``accum_block``.  Tolerances: faithful
# fp16 one fp16 ulp (2^-10 relative) per reduction block, relative to max
# |z|; fp32 accumulation 1e-5; a transcendental derivative under fp16
# compute the reference's own 2e-2 (tests/test_bwd_fused.py: both sides
# round act' and ds at different points).
REF_TILE = jtiling.TileConfig(bm=16, bn=128, bk=128)
BWD_POLICIES = ("paper_fp16", "tpu_fp16", "fp32")


def _grad_policies(name: str):
    """The backward dispatches' policy in both packages: the output held in
    the accumulator dtype (the engines' "+grad" policy)."""
    jp, tp = jprec.resolve(name), tprec.resolve(name)
    return (dataclasses.replace(jp, name=jp.name + "+grad",
                                output_dtype=jp.accum_dtype),
            dataclasses.replace(tp, name=tp.name + "+grad",
                                output_dtype=tp.accum_dtype))


def _bwd_tol(policy: str, act, n_blocks: int) -> float:
    if act not in (None, "relu") and policy != "fp32":
        return 2e-2
    if policy == "paper_fp16":
        return n_blocks * 2.0 ** -10
    return 1e-5


@pytest.mark.parametrize("bias", (False, True))
@pytest.mark.parametrize("layout", ("nn", "nt", "tn"))
def test_plain_faithful_gemm_matches_interpret_kernel(layout, bias):
    rng = np.random.default_rng([7, ("nn", "nt", "tn").index(layout), bias])
    M, N, K = 13, 600, 21                  # N: 5 blocks of 128, ragged tail
    x, w = _stored(rng, layout, M, N, K)
    b = rng.standard_normal(K).astype(np.float32) if bias else None
    (jx, tx), (jw, tw) = _pair(x, "paper_fp16"), _pair(w, "paper_fp16")
    want = jops.redmule_matmul(jx, jw, policy=jprec.PAPER_FP16, tile=REF_TILE,
                               bias=None if b is None else jnp.asarray(b),
                               layout=layout, interpret=True)
    got = tops.redmule_matmul(tx, tw, policy=tprec.PAPER_FP16,
                              bias=None if b is None else torch.from_numpy(b),
                              layout=layout, accum_block=128)
    assert got.dtype == torch.float16
    _close(got, want, _bwd_tol("paper_fp16", None, 5))


def test_plain_faithful_default_block_is_the_reference_tile():
    # no tile on either side: the reference picks bn = 2048 for N = 2600,
    # and so does the port's default accum_block (two rounding blocks)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 2600)).astype(np.float32)
    w = rng.standard_normal((2600, 16)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, "paper_fp16"), _pair(w, "paper_fp16")
    want = jops.redmule_matmul(jx, jw, policy=jprec.PAPER_FP16, interpret=True)
    got = tops.redmule_matmul(tx, tw, policy=tprec.PAPER_FP16)
    _close(got, want, _bwd_tol("paper_fp16", None, 2))
    # a single rounding of the whole sum is a different function here
    one = trm.redmule_matmul_plain(tx, tw, policy=tprec.PAPER_FP16,
                                   accum_block=2624)
    assert not torch.equal(one, got)


def test_plain_faithful_batched_gemm_matches_interpret_kernel():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 13, 300)).astype(np.float32)
    w = rng.standard_normal((3, 300, 21)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, "paper_fp16"), _pair(w, "paper_fp16")
    want = jops.redmule_matmul_batched(jx, jw, policy=jprec.PAPER_FP16,
                                       tile=REF_TILE, interpret=True)
    got = tops.redmule_matmul_batched(tx, tw, policy=tprec.PAPER_FP16,
                                      accum_block=128)
    _close(got, want, _bwd_tol("paper_fp16", None, 3))


@pytest.mark.parametrize("policy", BWD_POLICIES)
def test_plain_bias_grad_matches_interpret_kernel(policy):
    rng = np.random.default_rng([10, BWD_POLICIES.index(policy)])
    M, N, K = 13, 600, 21                  # the reduction N is the batch
    x, dz = _stored(rng, "tn", M, N, K)
    jp, tp = _grad_policies(policy)
    (jx, tx), (jw, tw) = _pair(x, policy), _pair(dz, policy)
    want_z, want_db = jops.redmule_matmul(jx, jw, policy=jp, tile=REF_TILE,
                                          layout="tn", bias_grad=True,
                                          interpret=True)
    got_z, got_db = tops.redmule_matmul(tx, tw, policy=tp, layout="tn",
                                        bias_grad=True, accum_block=128)
    assert got_z.dtype == got_db.dtype == tp.accum_dtype
    tol = _bwd_tol(policy, None, 5)
    _close(got_z, want_z, tol)
    _close(got_db, want_db, tol)


_DERIVS = (("relu", True), ("relu", False), ("tanh", True), ("tanh", False),
           ("gelu", False), ("silu", False))


@pytest.mark.parametrize("act,from_output", _DERIVS)
@pytest.mark.parametrize("layout", ("nt", "tn"))
@pytest.mark.parametrize("policy", BWD_POLICIES)
def test_plain_fused_bwd_deriv_matches_interpret_kernel(policy, layout, act,
                                                        from_output):
    """``deriv`` scales dZ (the x slot on "nt", the w slot on "tn") by
    act'; on "tn" the same dispatch also returns db."""
    rng = np.random.default_rng([11, BWD_POLICIES.index(policy),
                                 layout == "tn", _DERIVS.index((act, from_output))])
    M, N, K = (13, 300, 21) if layout == "tn" else (13, 21, 300)
    x, w = _stored(rng, layout, M, N, K)
    d = rng.standard_normal(x.shape if layout == "nt" else w.shape)
    if from_output and act == "tanh":
        d = np.tanh(d)                     # an output of tanh
    d = d.astype(np.float32)
    jp, tp = _grad_policies(policy)
    (jx, tx), (jw, tw), (jd, td) = (_pair(x, policy), _pair(w, policy),
                                    _pair(d, policy))
    bias_grad = layout == "tn"
    kw = dict(layout=layout, grad_epilogue=act, grad_from_output=from_output,
              bias_grad=bias_grad)
    want = jops.redmule_matmul(jx, jw, policy=jp, tile=REF_TILE, deriv=jd,
                               interpret=True, **kw)
    got = tops.redmule_matmul(tx, tw, policy=tp, deriv=td, accum_block=128,
                              **kw)
    want, got = (want, got) if bias_grad else ((want,), (got,))
    tol = _bwd_tol(policy, act, -(-N // 128))
    for g, w_ in zip(got, want):
        _close(g, w_, tol)
