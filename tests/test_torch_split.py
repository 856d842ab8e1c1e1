"""The split of a GEMM's reduction inside one launch, on the CPU.

The CUDA kernels (``csrc/redmule_matmul.cu``) cut the reduction of a launch
with few output tiles into S slices (``repro_torch.core.tiling.split_plan``,
from the shapes alone).  Each block writes its slice's fp32 partial; the
last block of an output tile sums the S partials in split order and stores
once (under the faithful fp16 accumulator: each rounding block's slices
summed in fp32, then folded as ``run = round16(run + round16(part))``).
The kernels run only on the card (``chip_smoke.py`` holds them against the
plain version there, and every split launch against itself run to run).
Here: the plan's properties, the wrapper's check of a plan, and a plain
PyTorch emulation of the split-and-ordered-fold arithmetic held against
``redmule_matmul_plain`` and, for one case, against the reference's Pallas
kernel in interpret mode.

Tolerances: at S = 1 the emulation is the plain version's arithmetic, so
bitwise equal.  At S > 1 the slices of one rounding block are summed in
fp32 in another order than the plain version's single dot, and then
rounded: within 2 fp16 ulps (2^-9) of the largest output under the
faithful accumulator, 1e-5 of it for fp32 outputs, two bf16 ulps (2^-7)
for bf16 outputs.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.core import precision as jprec
from repro.core import tiling as jtiling
from repro.kernels import ops as jops

from repro_torch.core import epilogues as epi
from repro_torch.core import precision as prec
from repro_torch.core import tiling
from repro_torch.kernels import ops
from repro_torch.kernels import redmule_matmul as rm

ULP16 = 2.0 ** -10


def _plan(M, N, K, *, batch=1, accum_block=0, route="tensor", fused_bwd=False):
    tile = tiling.choose_tiles(M, N, K)
    return tiling.split_plan(M, N, K, tile=tile, batch=batch,
                             accum_block=accum_block, route=route,
                             fused_bwd=fused_bwd)


# --------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------- #
_dims = st.integers(min_value=1, max_value=20000)


@settings(max_examples=300, deadline=None)
@given(M=_dims, N=_dims, K=_dims, batch=st.integers(1, 64),
       route=st.sampled_from(sorted(tiling.SPLIT_STEP)),
       blocks=st.sampled_from((0, 128, 384, 512, 640, 1024, 2048)),
       fused=st.booleans())
def test_split_plan_properties(M, N, K, batch, route, blocks, fused):
    accum_block = blocks if route == "tensor" else 0
    plan = _plan(M, N, K, batch=batch, accum_block=accum_block, route=route,
                 fused_bwd=fused)
    S, depth = plan
    assert S >= 1
    if S == 1:
        assert depth == N
    else:
        step = tiling.SPLIT_STEP[route]
        assert depth % step == 0                      # whole kernel steps
        assert (S - 1) * depth < N <= S * depth       # the last slice is not empty
        assert S <= tiling.MAX_SPLITS
        assert not fused                              # deriv / db never split
        if accum_block:
            assert accum_block % depth == 0           # no slice straddles a block
    # the kernel's own check takes every plan the wrapper asks for
    rm.check_split(plan, N, route=route, accum_block=accum_block,
                   fused_bwd=fused)
    # a pure function of its inputs
    assert _plan(M, N, K, batch=batch, accum_block=accum_block, route=route,
                 fused_bwd=fused) == plan


def test_split_plan_reads_no_storage_dtype():
    # an FP8 launch and its pre-widened fp16 twin must split alike, so the
    # plan takes no dtype at all
    params = set(inspect.signature(tiling.split_plan).parameters)
    assert params == {"M", "N", "K", "tile", "batch", "accum_block", "route",
                      "fused_bwd"}


@pytest.mark.parametrize("shape, route, accum_block, want", [
    # qwen3-1.7b serving, batch 4 / prompt 128: the decode projections split
    # to about two waves; the tied head and the prefill w_in fill the card
    ((4, 6144, 2048), "tensor", 0, (16, 384)),
    ((4, 2048, 4096), "tensor", 0, (8, 256)),
    ((4, 2048, 12288), "tensor", 0, (3, 704)),
    ((4, 2048, 151936), "tensor", 0, (1, 2048)),
    ((128, 2048, 12288), "tensor", 0, (1, 2048)),
    ((128, 6144, 2048), "tensor", 0, (5, 1248)),
    # the same under mixed_fp8_e4m3: slices inside the 2048-row block
    ((4, 2048, 4096), "tensor", 2048, (8, 256)),
    ((128, 6144, 2048), "tensor", 2048, (3, 2048)),
    # xlstm-1.3b training, fp32: the mLSTM gates and their dW
    ((1024, 4096, 8), "simt", 0, (16, 256)),
    ((4096, 1024, 8), "simt", 0, (5, 208)),
])
def test_split_plan_on_the_main_paths(shape, route, accum_block, want):
    assert tuple(_plan(*shape, route=route, accum_block=accum_block)) == want


def test_split_plan_batched_and_fused():
    # the sLSTM recurrence (4 heads) splits; the sweep's inter-chunk read
    # (256 tiles) and every fused backward do not
    assert _plan(4, 512, 2048, batch=4, route="simt").splits == 5
    assert _plan(4, 2048, 512, batch=4, route="simt").splits == 16
    assert _plan(64, 1024, 1024, batch=16, route="simt").splits == 1
    assert _plan(640, 4096, 128, accum_block=1024, fused_bwd=True).splits == 1
    assert tuple(_plan(640, 4096, 128, accum_block=1024)) == (8, 512)
    with pytest.raises(ValueError):
        _plan(4, 2048, 4096, route="wgmma")


@pytest.mark.parametrize("plan, N, kw, why", [
    ((2, 48), 96, {}, "multiple of the tensor step"),
    ((3, 64), 96, {}, "non-empty last one"),
    ((2, 32), 96, {}, "do not cover"),
    ((4, 32), 128, {"fused_bwd": True}, "fused backward"),
    ((4, 96), 384, {"accum_block": 128}, "straddling"),
    ((2, 24), 48, {"route": "simt"}, "multiple of the simt step"),
    ((70000, 32), 70000 * 32, {}, "outside"),
])
def test_check_split_refuses_what_the_kernel_refuses(plan, N, kw, why):
    kw = {"route": "tensor", **kw}
    with pytest.raises(ValueError, match=why):
        rm.check_split(tiling.SplitPlan(*plan), N, **kw)


def test_split_counter_exists_and_cpu_calls_do_not_count():
    for fn in (ops.redmule_matmul, ops.redmule_matmul_batched):
        fn.launches_split = 0
    x, w = torch.randn(4, 2048), torch.randn(2048, 4096)
    ops.redmule_matmul(x, w, policy=prec.FP32)
    ops.redmule_matmul_batched(x[None], w[None], policy=prec.FP32)
    assert ops.redmule_matmul.launches_split == 0
    assert ops.redmule_matmul_batched.launches_split == 0


# --------------------------------------------------------------------- #
# the split-and-ordered-fold arithmetic, emulated
# --------------------------------------------------------------------- #
def _emulate(x, w, policy, plan, accum_block, bias=None, epilogue=None):
    """What the kernel computes under ``plan`` ("nn", leading dims
    broadcast): each slice's fp32 partial of the compute-dtype operands,
    summed in split order — under the faithful accumulator per rounding
    block, then folded into the fp16 running sum (unsplit, each rounding
    block is one slice) — then bias, epilogue and one cast."""
    S, depth = plan
    N = x.shape[-1]
    xc = x.to(policy.compute_dtype).float()
    wc = w.to(policy.compute_dtype).float()
    faithful = policy.blockwise_accum
    if faithful and S == 1:
        depth = accum_block
        S = -(-N // depth)
    parts = [torch.matmul(xc[..., s * depth:(s + 1) * depth],
                          wc[..., s * depth:(s + 1) * depth, :]) for s in range(S)]
    if faithful:
        per_block = accum_block // depth
        run = torch.zeros_like(parts[0]).half()
        for j0 in range(0, S, per_block):
            blk = torch.zeros_like(parts[0])
            for p in parts[j0:j0 + per_block]:
                blk = blk + p
            run = (run.float() + blk.half().float()).half()
        z = run
    else:
        z = torch.zeros_like(parts[0])
        for p in parts:
            z = z + p
        z = z.to(policy.accum_dtype)
    if bias is not None:
        z = z + bias.reshape(-1).to(policy.accum_dtype)
    return epi.apply_epilogue(epilogue, z).to(policy.out_dtype)


_E4 = torch.float8_e4m3fn
_POLICIES = {
    "paper_fp16": (prec.PAPER_FP16, None, 2 * ULP16),
    "tpu_bf16": (prec.TPU_BF16, None, 2.0 ** -7),
    "fp32": (prec.FP32, None, 1e-5),
    "mixed_fp8_e4m3": (prec.MIXED_FP8_E4M3, _E4, 2 * ULP16),
}


def _operands(seed, M, N, K, batch, storage, dtype=torch.float32):
    """x (batch, M, N) or (M, N) and w (N, K) from a seed, in ``dtype`` (the
    compute dtype the kernel takes) or quantized to FP8 ``storage``."""
    rng = np.random.default_rng(seed)
    shape_x = (batch, M, N) if batch else (M, N)
    x = torch.from_numpy(rng.standard_normal(shape_x).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((N, K)) / np.sqrt(N)).astype(np.float32))
    if storage is not None:
        return prec.quantize_fp8(x, storage)[0], prec.quantize_fp8(w, storage)[0]
    return x.to(dtype), w.to(dtype)


def _max_rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("blocks", (1, 2, 3, 4))
@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_emulated_split_matches_plain(policy, blocks):
    pol, storage, tol = _POLICIES[policy]
    faithful = pol.blockwise_accum
    ab = 256
    # N spans `blocks` rounding blocks, the last one ragged past the first
    N = ab * blocks - (40 if blocks > 1 else 0)
    M, K = 5, 72
    x, w = _operands([11, blocks, sorted(_POLICIES).index(policy)], M, N, K, 0,
                     storage, pol.compute_dtype)
    bias = torch.randn(K, generator=torch.Generator().manual_seed(blocks))
    if faithful:
        bias = bias.half()
    kw = dict(bias=bias, epilogue="gelu")
    ab_kw = ab if faithful else None
    want = rm.redmule_matmul_plain(x, w, policy=pol, accum_block=ab_kw, **kw)
    step = tiling.SPLIT_STEP["simt" if pol.compute_dtype == torch.float32
                             else "tensor"]
    # S = 1, and splits of 1, 2 and 8 steps (faithful: inside each block)
    one = _emulate(x, w, pol, tiling.SplitPlan(1, N), ab, **kw)
    assert torch.equal(one, want)
    for depth in (step, 2 * step, 8 * step):
        plan = tiling.SplitPlan(-(-N // depth), depth)
        rm.check_split(plan, N, route="tensor" if step == 32 else "simt",
                       accum_block=ab if faithful else 0)
        got = _emulate(x, w, pol, plan, ab, **kw)
        assert got.dtype == want.dtype
        assert _max_rel(got, want) <= tol, (depth, _max_rel(got, want))


@pytest.mark.parametrize("policy", ("paper_fp16", "tpu_bf16", "fp32"))
def test_emulated_split_of_the_planned_decode_shape(policy):
    # the plan the wrapper would launch for a 4-slot decode projection,
    # batched over 3 broadcast weights
    pol, storage, tol = _POLICIES[policy]
    M, N, K = 4, 1024, 512
    ab = 512 if pol.blockwise_accum else 0
    route = "simt" if pol.compute_dtype == torch.float32 else "tensor"
    plan = _plan(M, N, K, batch=3, accum_block=ab, route=route)
    assert plan.splits > 1
    x, w = _operands(12, M, N, K, 3, storage, pol.compute_dtype)
    want = rm.redmule_matmul_plain(x, w, policy=pol, accum_block=ab or None)
    got = _emulate(x, w, pol, plan, ab)
    assert _max_rel(got, want) <= tol


def test_emulated_split_matches_the_reference_kernel():
    # the faithful accumulator over 3 rounding blocks of 128, each in 4
    # slices of 32, against the reference's Pallas kernel (interpret mode)
    M, N, K = 8, 384, 48
    rng = np.random.default_rng(13)
    x = rng.standard_normal((M, N)).astype(np.float32)
    w = (rng.standard_normal((N, K)) / np.sqrt(N)).astype(np.float32)
    jx, jw = (jnp.asarray(a).astype(jnp.float16) for a in (x, w))
    want = np.asarray(jops.redmule_matmul(
        jx, jw, policy=jprec.PAPER_FP16,
        tile=jtiling.TileConfig(bm=16, bn=128, bk=128), interpret=True),
        dtype=np.float32)
    got = _emulate(torch.from_numpy(x).half(), torch.from_numpy(w).half(),
                   prec.PAPER_FP16, tiling.SplitPlan(12, 32), 128)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * ULP16 * np.abs(want).max()


def test_emulated_fp8_split_equals_its_widened_twin():
    # the plan reads no dtype, so the FP8 launch and the launch on the
    # pre-widened fp16 operands split alike and compute the same bits
    pol = prec.MIXED_FP8_E4M3
    x, w = _operands(14, 4, 2048, 256, 0, _E4)
    ab = tiling.accum_block(4, 2048, 256, compute_dtype=torch.float16,
                            accum_dtype=torch.float16, x_dtype=_E4, w_dtype=_E4)
    plan = _plan(4, 2048, 256, accum_block=ab)
    assert plan.splits > 1
    assert torch.equal(_emulate(x, w, pol, plan, ab),
                       _emulate(x.half(), w.half(), pol, plan, ab))


def test_faithful_split_differs_from_one_rounding():
    # the fold is per rounding block: one rounding of the whole fp32 sum is
    # another function (a control for the emulation)
    x, w = _operands(15, 6, 1024, 40, 0, None, torch.float16)
    pol = prec.PAPER_FP16
    folded = _emulate(x, w, pol, tiling.SplitPlan(8, 128), 256)
    once = dataclasses.replace(pol, name="x")
    once_z = rm.redmule_matmul_plain(x, w, policy=once, accum_block=1024)
    assert not torch.equal(folded, once_z)
