"""Kernel 4 (the chunked sweep) on fp32 inputs, emulated on the CPU.

``csrc/chunked_linear_attention.cu`` runs on TF32 tensor cores.  For fp32
q / k (xLSTM under the fp32 policy; Mamba2 / SSD's C and B in every
policy) it splits every fp32 operand into three TF32 pieces and
accumulates every piece product at or above fp32's rounding, and it sums
each chunk's cumsum L in fp64, rounded once.  The kernel before that kept
two pieces (the small one read truncated to TF32) and scanned L in fp32,
a few ulps of |L| off, which exp(L) turned into relative errors of the
same size: on the card its fp32 xLSTM super-block sat 11x further from the
CPU than the block with the sweep composed on the fp32 GEMM route.

The emulation (``test_torch_attn_numerics.sweep_emulated``) repeats the
kernel's piece products and L exactly, summed in fp32; it does not model an
MMA's own accumulation (which does not round to nearest: the kernel sums
each k-step's products apart and adds them in fp32, and ``chip_smoke.py``
holds it on the card).  It is held against an fp64 recurrence and
against the plain fp32 composition (``chunked_linear_attention_plain``),
whose own distance from the fp64 recurrence ``d32`` is the yardstick:

* the kernel sits within 4 x d32 of the fp64 recurrence (fp32 level);
* it sits closer to the plain composition than d32 (its remaining
  difference is the products' summation order, not L or the pieces);
* a control that must fail: the old kernel (two pieces, L scanned in fp32
  as the scores kernel's warp scan did) sits further than d32 from it;
* and the pieces matter on their own: with L in fp64 and two pieces the
  state sits further from the composition, in RMS, than with three (its
  largest error is one summation-order rounding either way).
"""

import numpy as np
import pytest
import torch

from test_torch_attn_numerics import sweep_emulated

from repro_torch.kernels import chunked_linear_attention as tcla

# name: (BH, S, dk, dv, chunk, v dtype, gate)
CASES = {
    # the mLSTM's fp32 sweep: log-sigmoid forget gates, |L| up to ~60
    "xlstm_fp32": (4, 256, 128, 64, 64, torch.float32, "logsigmoid"),
    # Mamba2 / SSD: fp32 C / B with a bf16 dt·x, dk = the SSM state size
    "ssd_fp32_bf16v": (8, 256, 16, 64, 64, torch.bfloat16, "uniform"),
    "chunk128_fp32": (2, 256, 96, 40, 128, torch.float32, "logsigmoid"),
}


def _inputs(name):
    BH, S, dk, dv, chunk, vdt, gate = CASES[name]
    rng = np.random.default_rng([sorted(CASES).index(name), 21])
    q = torch.from_numpy(rng.standard_normal((BH, S, dk)).astype(np.float32)) * dk ** -0.5
    k = torch.from_numpy(rng.standard_normal((BH, S, dk)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((BH, S, dv)).astype(np.float32)).to(vdt)
    pre = torch.from_numpy(rng.standard_normal((BH, S)).astype(np.float32))
    g = (torch.nn.functional.logsigmoid(pre) if gate == "logsigmoid"
         else -0.7 * torch.rand(BH, S, generator=torch.Generator().manual_seed(3)))
    return q, k, v, g, chunk


def _recurrence64(q, k, v, g):
    """S_t = exp(g_t) S_{t-1} + k_t v_t^T, out_t = q_t S_t, in fp64."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    st = torch.zeros(q.shape[0], q.shape[-1], v.shape[-1], dtype=torch.float64)
    outs = []
    for t in range(q.shape[1]):
        st = torch.exp(g[:, t])[:, None, None] * st + k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bk,bkv->bv", q[:, t], st))
    return torch.stack(outs, 1), st


def _warp_scan_cumsum(g, chunk):
    """L as the old scores kernel summed it in fp32: each lane runs C / 32
    consecutive elements, a shuffle scan over the lanes, then the exclusive
    prefix as incl - run."""
    BH, S = g.shape
    E = max(chunk // 32, 1)
    x = g.float().reshape(BH, S // chunk, chunk // E, E)
    runs, run = [], torch.zeros(x.shape[:-1])
    for e in range(E):
        run = run + x[..., e]
        runs.append(run)
    incl, lane = run.clone(), torch.arange(x.shape[-2])
    o = 1
    while o < 32:
        up = torch.zeros_like(incl)
        up[..., o:] = incl[..., :-o]
        incl = torch.where(lane >= o, incl + up, incl)
        o <<= 1
    excl = incl - run
    return torch.stack([excl + r for r in runs], -1).reshape(BH, S)


def _rel(got, want) -> float:
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _emulate(name, *, pieces=None, fp32_scan=False, monkeypatch=None):
    q, k, v, g, chunk = _inputs(name)
    if fp32_scan:
        monkeypatch.setattr(torch, "cumsum", lambda x, dim: _warp_scan_cumsum(
            x.reshape(-1, x.shape[-1]), x.shape[-1]).reshape(x.shape))
    n = {} if pieces is None else dict(in_pieces=pieces, s_pieces=pieces,
                                       a_pieces=pieces, kdec_pieces=pieces)
    out, state = sweep_emulated(q, k, v, g, chunk=chunk, **n)
    if fp32_scan:
        monkeypatch.undo()
    return out, state


def _yardsticks(name):
    q, k, v, g, chunk = _inputs(name)
    o64, s64 = _recurrence64(q, k, v, g)
    po, ps = tcla.chunked_linear_attention_plain(q, k, v, g, chunk=chunk)
    return (o64, s64), (po, ps), max(_rel(po, o64), _rel(ps, s64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_pieces_sit_at_fp32_level(name):
    (o64, s64), _, d32 = _yardsticks(name)
    out, state = _emulate(name)
    assert max(_rel(out, o64), _rel(state, s64)) <= 4 * d32


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_pieces_closer_to_the_composition_than_its_rounding(name, monkeypatch):
    _, (po, ps), d32 = _yardsticks(name)
    out, state = _emulate(name)
    assert max(_rel(out, po), _rel(state, ps)) < d32
    # the control: the kernel as it was (two pieces, L scanned in fp32)
    old_o, old_s = _emulate(name, pieces=2, fp32_scan=True, monkeypatch=monkeypatch)
    assert max(_rel(old_o, po), _rel(old_s, ps)) > d32


def _rms(got, want) -> float:
    want = want.double()
    return ((got.double() - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()


@pytest.mark.parametrize("name", ("chunk128_fp32", "xlstm_fp32"))
def test_three_pieces_move_the_state(name):
    _, (po, ps), _ = _yardsticks(name)
    _, s3 = _emulate(name)
    _, s2 = _emulate(name, pieces=2)
    assert _rms(s3, ps) < _rms(s2, ps)


def test_warp_scan_emulation_is_an_fp32_scan():
    g = torch.nn.functional.logsigmoid(torch.randn(4, 128, generator=torch.Generator().manual_seed(0)))
    L = _warp_scan_cumsum(g, 64)
    want = tcla.chunk_cumsum(g.reshape(4, 2, 64)).reshape(4, 128)
    err = (L - want).abs().max().item()
    assert 0 < err <= 8 * torch.finfo(torch.float32).eps * want.abs().max().item()
