"""The tensor-core numerics of kernels 3 and 4, emulated on the CPU.

The CUDA kernels (``csrc/flash_attention.cu``,
``csrc/chunked_linear_attention.cu``) run only on the card, where
``chip_smoke.py`` holds them against their plain versions.  What makes them
agree is arithmetic that plain PyTorch can repeat exactly on the CPU:

* flash attention multiplies the fp32 softmax weights P by V on bf16 / fp16
  tensor cores, so it splits P into three pieces in V's dtype (each the
  rest of the last, rounded) and accumulates the three products in fp32
  (its score products are exact); its four warps each keep a softmax
  state over every fourth KV tile and merge them at the end;
* the chunked sweep runs on TF32 tensor cores (``mma.sync`` m16n8k8): for
  bf16 / fp16 inputs (exact in TF32) each fp32 operand — the state S, the
  decayed scores A, kdec = k exp(L_C - L) — is split into a big TF32 piece
  (``cvt.rna``: round to nearest, ties away) and the small rest (which the
  MMA reads truncated to TF32), and every piece product but small x small
  accumulates in fp32; for fp32 inputs every fp32 operand, q, k and v
  included, is split into three pieces (big, the rest rounded to TF32, and
  what is left) and every product a_i b_j with i + j < 3 accumulates.

Each emulation below is held against the plain version
(``flash_attention_plain``, ``chunked_linear_attention_plain``) and the JAX
package's Pallas kernels in interpret mode, beside a control that must
fail: the same product with P rounded once to V's dtype, or with S, A or
kdec in one TF32 piece.

Tolerances: the split products are fp32-level, so in fp32 (before the
output is rounded to the input dtype) the emulation sits within 1e-5 of the
largest reference value, the fp32 bound of the port's CPU tests (summation
order only); a control one piece short is off by 2^-9 .. 2^-12 relative
per term and misses that bound.  After the output rounding the chip
tolerances hold: bf16 2^-7, fp16 2^-9 of max, the state 1e-4.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.chunked_linear_attention import chunked_linear_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.core import tiling
from repro_torch.kernels import chunked_linear_attention as tcla
from repro_torch.kernels import flash_attention as tfa

FP32_TOL = 1e-5
OUT_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9, torch.float32: 1e-4}
STATE_TOL = 1e-4


def _rel_err(got, want) -> float:
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, dtype=np.float32))
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# --------------------------------------------------------------------- #
# kernel 3: P in pieces for PV
# --------------------------------------------------------------------- #
WARPS = 4     # the kernel's warps per block, each with its own softmax state


def flash_emulated(q, k, v, *, group, causal=True, t_valid=None, q_offset=0,
                   pieces=3):
    """The kernel's arithmetic: warp w takes KV tiles w, w + 4, ... of
    ``tiling.FLASH_BKV`` columns, each warp runs its own online softmax
    (weights exp(s * scale - m), running max from -1e30, masked columns
    weigh exactly 0) with P as ``pieces`` pieces in V's dtype (1: P
    rounded once, the control) and fp32 accumulation; the warps' (m, l, O)
    merge at the end.  Returns fp32."""
    BHq, S, D = q.shape
    T = k.shape[1]
    t_valid = T if t_valid is None else t_valid
    dt = v.dtype
    kf = k.float().repeat_interleave(group, 0)
    vf = v.float().repeat_interleave(group, 0)
    s_all = torch.matmul(q.float(), kf.transpose(1, 2)) * D ** -0.5
    cols = torch.arange(T)
    vis = (cols < t_valid)[None, :].expand(S, T)
    if causal:
        vis = vis & (cols[None, :] <= q_offset + torch.arange(S)[:, None])
    parts = []
    bkv = tiling.FLASH_BKV
    for w in range(WARPS):
        m = torch.full((BHq, S, 1), -1e30)
        l = torch.zeros(BHq, S, 1)
        o = torch.zeros(BHq, S, D)
        for c0 in range(w * bkv, T, WARPS * bkv):
            sl = slice(c0, c0 + bkv)
            s = torch.where(vis[None, :, sl], s_all[:, :, sl], torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv, rest = 0, p
            for _ in range(pieces):
                piece = rest.to(dt).float()
                pv = pv + torch.matmul(piece, vf[:, sl])
                rest = rest - piece
            o = o * alpha + pv
            m = m_new
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    wts = [torch.exp(m - mx) for m, _, _ in parts]
    l = sum(wt * l_ for wt, (_, l_, _) in zip(wts, parts))
    o = sum(wt * o_ for wt, (_, _, o_) in zip(wts, parts))
    return torch.where(l == 0, o, o / torch.where(l == 0, torch.ones(()), l))


_FLASH_CASES = {
    # name: (Hq, Hkv, S, T, t_valid, q_offset, causal, D)
    "prefill_two_tiles": (4, 2, 40, 80, 72, 0, True, 64),
    "continuation": (4, 2, 8, 96, 96, 88, True, 64),
    "non_causal_ragged": (2, 1, 24, 72, 65, 0, False, 64),
}


def _flash_inputs(name, dt):
    Hq, Hkv, S, T, t_valid, q_offset, causal, D = _FLASH_CASES[name]
    rng = np.random.default_rng([sorted(_FLASH_CASES).index(name), 3])
    # logits of a few units: the softmax weights spread over many columns
    q = torch.from_numpy(2 * rng.standard_normal((Hq, S, D)).astype(np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((Hkv, T, D)).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((Hkv, T, D)).astype(np.float32)).to(dt)
    kw = dict(group=Hq // Hkv, causal=causal, t_valid=t_valid, q_offset=q_offset)
    return q, k, v, kw


@pytest.mark.parametrize("name", sorted(_FLASH_CASES))
@pytest.mark.parametrize("dt", (torch.bfloat16, torch.float16), ids=("bf16", "fp16"))
def test_flash_pieces_of_p_are_fp32_level(name, dt):
    q, k, v, kw = _flash_inputs(name, dt)
    # the reference's function in fp32 on the same values (exact upcasts)
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert _rel_err(flash_emulated(q, k, v, **kw), want) <= FP32_TOL
    # and after the output rounding, the chip tolerance against the plain
    # version in the input dtype
    got = flash_emulated(q, k, v, **kw).to(dt)
    assert _rel_err(got, tfa.flash_attention_plain(q, k, v, **kw)) <= OUT_TOL[dt]


@pytest.mark.parametrize("name", sorted(_FLASH_CASES))
@pytest.mark.parametrize("dt", (torch.bfloat16, torch.float16), ids=("bf16", "fp16"))
def test_flash_control_p_rounded_once_misses(name, dt):
    q, k, v, kw = _flash_inputs(name, dt)
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert _rel_err(flash_emulated(q, k, v, pieces=1, **kw), want) > FP32_TOL


@pytest.mark.parametrize("name", sorted(_FLASH_CASES))
def test_flash_emulation_matches_interpret_kernel(name):
    q, k, v, kw = _flash_inputs(name, torch.bfloat16)
    want = flash_attention_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
        bq=8, bkv=8, interpret=True, **kw)
    got = flash_emulated(q, k, v, **kw).to(torch.bfloat16)
    assert _rel_err(got, np.asarray(want.astype(jnp.float32))) <= OUT_TOL[torch.bfloat16]


def test_flash_emulation_no_visible_column_is_exact_zero():
    q, k, v, kw = _flash_inputs("prefill_two_tiles", torch.bfloat16)
    got = flash_emulated(q, k, v, **{**kw, "t_valid": 0})
    assert torch.equal(got, torch.zeros_like(got))


# --------------------------------------------------------------------- #
# kernel 4: TF32 pieces
# --------------------------------------------------------------------- #
def _tf32(x):
    """``cvt.rna.tf32.f32``: round the fp32 significand to 10 stored bits,
    ties away from zero."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _trunc(x):
    """The TF32 operand the MMA reads from an fp32 register: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _pieces(x, n):
    """x as n TF32 pieces as the MMA reads them: the big one; (n = 2) the
    rest, truncated; (n = 3) the rest rounded to TF32, and what is left
    (a few bits, exact)."""
    x = x.float()
    hi = _tf32(x)
    if n == 1:
        return [hi]
    if n == 2:
        return [hi, _trunc(x - hi)]
    mid = _tf32(x - hi)
    return [hi, mid, _trunc(x - hi - mid)]


def _mm(a, b):
    """sum over the piece products a_i @ b_j with i + j < max(len(a),
    len(b)): two pieces drop small x small, three the products below
    fp32's rounding."""
    n = max(len(a), len(b))
    out = 0
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            if i + j < n:
                out = out + torch.matmul(ai, bj)
    return out


def _n_pieces(dt):
    """(pieces of q / k / v, pieces of the fp32 S, A and kdec) for inputs
    of ``dt``, as the kernel splits them."""
    return (3, 3) if dt == torch.float32 else (1, 2)


def chunk_scores_emulated(q, k, log_g, *, chunk, in_pieces=None):
    """The scores launch: L by cumsum, q k^T on TF32 pieces (one piece for
    bf16 / fp16 inputs, where it is exact), then decayed and masked."""
    n_in = in_pieces or _n_pieces(q.dtype)[0]
    BH, S, dk = q.shape
    n = S // chunk
    L = torch.cumsum(log_g.float().reshape(BH, n, chunk), -1)
    qc = q.float().reshape(BH, n, chunk, dk)
    kc = k.float().reshape(BH, n, chunk, dk)
    s = _mm(_pieces(qc, n_in), [p.transpose(-1, -2) for p in _pieces(kc, n_in)])
    idx = torch.arange(chunk)
    keep = idx[:, None] >= idx[None, :]
    A = torch.where(keep, s * torch.exp(L[..., :, None] - L[..., None, :]),
                    torch.zeros(()))
    return L.reshape(BH, S), A


def sweep_emulated(q, k, v, log_g, *, chunk, s_pieces=None, a_pieces=None,
                   kdec_pieces=None, in_pieces=None):
    """The sweep on TF32 pieces, chunk by chunk, from the scores launch's L
    and A: out = exp(L) (q S) + A v, S <- exp(L_C) S + kdec^T v.  Returns
    (out in fp32, the fp32 state).  The piece counts default to the
    kernel's for the input dtype; a control passes fewer."""
    n_in, n32 = _n_pieces(q.dtype)
    n_in = in_pieces or n_in
    s_pieces, a_pieces, kdec_pieces = (n or n32 for n in
                                       (s_pieces, a_pieces, kdec_pieces))
    BH, S, dk = q.shape
    dv = v.shape[-1]
    L, A = chunk_scores_emulated(q, k, log_g, chunk=chunk, in_pieces=in_pieces)
    state = torch.zeros(BH, dk, dv)
    outs = []
    for c in range(S // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc = (t[:, rows].float() for t in (q, k, v))
        Lc = L[:, rows]
        vp = _pieces(vc, _n_pieces(v.dtype)[0] if in_pieces is None else n_in)
        inter = _mm(_pieces(qc, n_in), _pieces(state, s_pieces))
        out = torch.exp(Lc)[..., None] * inter + _mm(_pieces(A[:, c], a_pieces), vp)
        kdec = kc * torch.exp(Lc[:, -1:] - Lc)[..., None]
        state = (torch.exp(Lc[:, -1])[:, None, None] * state
                 + _mm([p.transpose(1, 2) for p in _pieces(kdec, kdec_pieces)], vp))
        outs.append(out)
    return torch.cat(outs, 1), state


_CLA_CASES = {
    # name: (BH, S, dk, dv, chunk)
    "c16_three_chunks": (3, 48, 24, 40, 16),
    "c32_dk_gt_dv": (2, 96, 64, 16, 32),
}


def _cla_inputs(name, dt):
    BH, S, dk, dv, chunk = _CLA_CASES[name]
    rng = np.random.default_rng([sorted(_CLA_CASES).index(name), 7])
    q = rng.standard_normal((BH, S, dk)).astype(np.float32) * dk ** -0.5
    k = 0.5 * rng.standard_normal((BH, S, dk)).astype(np.float32)
    v = rng.standard_normal((BH, S, dv)).astype(np.float32)
    log_g = (-0.1 * rng.random((BH, S))).astype(np.float32)
    return ([torch.from_numpy(a).to(dt) for a in (q, k, v)]
            + [torch.from_numpy(log_g)], chunk)


_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_DT_IDS = ("bf16", "fp16", "fp32")


@pytest.mark.parametrize("name", sorted(_CLA_CASES))
@pytest.mark.parametrize("dt", _DTYPES, ids=_DT_IDS)
def test_chunk_scores_plain_is_the_reference_per_chunk_step(name, dt):
    (q, k, v, log_g), chunk = _cla_inputs(name, dt)
    L, A = tcla.chunk_scores_plain(q, k, log_g, chunk=chunk)
    BH, S, _ = q.shape
    idx = torch.arange(chunk)
    for c in range(S // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        Lc = torch.cumsum(log_g[:, rows], -1)
        torch.testing.assert_close(L[:, rows], Lc, rtol=0, atol=0)
        decay = torch.where(idx[:, None] >= idx[None, :],
                            torch.exp(Lc[:, :, None] - Lc[:, None, :]), torch.zeros(()))
        s = torch.matmul(q[:, rows].float(), k[:, rows].float().transpose(1, 2))
        torch.testing.assert_close(A[:, c], s * decay, rtol=0, atol=0)
    assert torch.equal(A, A.tril())     # causally masked: exact zeros above


@pytest.mark.parametrize("name", sorted(_CLA_CASES))
@pytest.mark.parametrize("dt", _DTYPES, ids=_DT_IDS)
def test_emulated_scores_match_plain(name, dt):
    (q, k, v, log_g), chunk = _cla_inputs(name, dt)
    L, A = chunk_scores_emulated(q, k, log_g, chunk=chunk)
    Lw, Aw = tcla.chunk_scores_plain(q, k, log_g, chunk=chunk)
    assert torch.equal(L, Lw)
    assert _rel_err(A, Aw) <= FP32_TOL


@pytest.mark.parametrize("name", sorted(_CLA_CASES))
@pytest.mark.parametrize("dt", _DTYPES, ids=_DT_IDS)
def test_sweep_tf32_pieces_are_fp32_level(name, dt):
    (q, k, v, log_g), chunk = _cla_inputs(name, dt)
    out, state = sweep_emulated(q, k, v, log_g, chunk=chunk)
    # the same function in fp32 on the same values (exact upcasts)
    want_o, want_s = tcla.chunked_linear_attention_plain(
        q.float(), k.float(), v.float(), log_g, chunk=chunk)
    assert _rel_err(state, want_s) <= FP32_TOL
    assert _rel_err(out, want_o) <= FP32_TOL
    # and at the chip tolerances against the plain version in the input dtype
    plain_o, plain_s = tcla.chunked_linear_attention_plain(q, k, v, log_g, chunk=chunk)
    assert _rel_err(out.to(dt), plain_o) <= OUT_TOL[dt]
    assert _rel_err(state, plain_s) <= STATE_TOL


@pytest.mark.parametrize("control, what", [
    ("s_pieces", "out"), ("a_pieces", "out"), ("kdec_pieces", "state")])
@pytest.mark.parametrize("name", sorted(_CLA_CASES))
def test_sweep_control_one_piece_misses(name, control, what):
    (q, k, v, log_g), chunk = _cla_inputs(name, torch.bfloat16)
    out, state = sweep_emulated(q, k, v, log_g, chunk=chunk, **{control: 1})
    want_o, want_s = tcla.chunked_linear_attention_plain(
        q.float(), k.float(), v.float(), log_g, chunk=chunk)
    got, want = (out, want_o) if what == "out" else (state, want_s)
    assert _rel_err(got, want) > FP32_TOL


@pytest.mark.parametrize("dt", (torch.bfloat16, torch.float32), ids=("bf16", "fp32"))
def test_sweep_emulation_matches_interpret_kernel(dt):
    (q, k, v, log_g), chunk = _cla_inputs("c16_three_chunks", dt)
    jd = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    want_o, want_s = chunked_linear_attention_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jd) for t in (q, k, v)),
        jnp.asarray(log_g.numpy()), chunk=chunk, interpret=True)
    out, state = sweep_emulated(q, k, v, log_g, chunk=chunk)
    # the fp32 state: summation order only (1e-5); the output is rounded to
    # the input dtype on both sides (bf16: one flipped rounding, 2^-7)
    assert _rel_err(state, np.asarray(want_s)) <= FP32_TOL
    assert _rel_err(out.to(dt), np.asarray(want_o.astype(jnp.float32))) <= \
        (FP32_TOL if dt == torch.float32 else OUT_TOL[dt])


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      3.0 + 2 ** -12])
    # ties go away from zero; the 10 stored bits keep 2^-10 steps near 1
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0])
    assert torch.equal(_tf32(x), want)
    hi, lo = _pieces(torch.tensor([math.pi]), 2)
    assert abs((hi + lo).item() - math.pi) < 2 ** -20
