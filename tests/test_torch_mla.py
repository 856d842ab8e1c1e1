"""The port's MLA attention and its q-chunked attention path against the
JAX package.

* ``mla_attention``: prefill into a cache (the re-expanded k / v through
  the q-chunked path, qk dim != v dim), then decode steps from that cache
  (the absorbed form: five fp32-out ``einsum2d`` contractions) at uniform
  and per-slot positions, with the reference's own parameters
  (``repro.models.attention.mla_schema``);
* ``chunked_attention``'s q-chunked path: ``Dv != D``, a sliding
  ``window``, ``S > q_chunk`` (q padded to whole chunks), per-slot offsets
  without ``kv_group_sizes``, and its gradients;
* ``insert_slot`` on MLA leaves, stacked and not (the MoE kind's
  ``layer0``).

The reference runs on its "interpret" backend.  Tolerances: fp32 outputs,
caches and gradients 1e-4 of the largest reference magnitude (summation
order); events exactly.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import engine as je
from repro.core import precision as jprec
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.serving import kv_cache as jkv

from repro_torch import configs as tconfigs
from repro_torch.core import engine as te
from repro_torch.core import precision as tprec
from repro_torch.models import attention as tattn
from repro_torch.serving import kv_cache as tkv

TOL = 1e-4
ARCH = "deepseek-v2-lite-16b"


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))


def _bill(events):
    out = collections.Counter()
    for e in events:
        s = e.spec
        out[(s.op, s.tag, s.m, s.n, s.k, s.batch, s.groups, s.flops,
             s.bytes)] += e.count
    return out


@pytest.fixture(scope="module")
def mla():
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jp = jlayers.init_tree(jax.random.PRNGKey(0), jattn.mla_schema(jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jcfg, tcfg, jp, tp


def _run_both(mla, x, pos, jcache, tcache, **kw):
    jcfg, tcfg, jp, tp = mla
    with je.use_backend("interpret"), je.instrument() as jev:
        jo, jc = jattn.mla_attention(jp, jnp.asarray(x), jcfg, pos_offset=pos,
                                     cache=jcache, policy=jprec.FP32,
                                     q_chunk=jcfg.q_chunk, **kw)
    tpos = torch.from_numpy(np.asarray(pos)).long() if np.ndim(pos) else pos
    with te.instrument() as tev:
        to, tc = tattn.mla_attention(tp, torch.from_numpy(x), tcfg,
                                     pos_offset=tpos, cache=tcache,
                                     policy=tprec.FP32, q_chunk=tcfg.q_chunk)
    return (jo, jc, jev), (to, tc, tev)


@pytest.mark.parametrize("S", (5, 12))
def test_mla_prefill_into_a_cache_matches_reference(mla, S):
    jcfg, tcfg, _, _ = mla
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jc = jattn.init_mla_cache(jcfg, 2, 16, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, 2, 16, torch.float32, device="cpu")
    (jo, jc, jev), (to, tc, tev) = _run_both(mla, x, 0, jc, tc)
    assert _rel(to, jo) <= TOL
    for name in ("ckv", "kr"):
        assert _rel(tc[name], jc[name]) <= TOL
    assert _bill(tev) == _bill(jev)


def test_mla_without_a_cache_matches_reference(mla):
    """Training's call: no cache, T = S."""
    jcfg = mla[0]
    x = np.random.default_rng(3).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    (jo, _, jev), (to, _, tev) = _run_both(mla, x, 0, None, None)
    assert _rel(to, jo) <= TOL
    assert _bill(tev) == _bill(jev)


@pytest.mark.parametrize("per_slot", (False, True))
def test_mla_absorbed_decode_from_a_cache_matches_reference(mla, per_slot):
    """Three decode steps after a 6-token prefill; per-slot: the two slots
    at different positions (slot 1 a step behind)."""
    jcfg, tcfg, _, _ = mla
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    jc = jattn.init_mla_cache(jcfg, 2, 12, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, 2, 12, torch.float32, device="cpu")
    (_, jc, _), (_, tc, _) = _run_both(mla, x, 0, jc, tc)
    for step in range(3):
        xs = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        pos = (np.asarray([6 + step, 5 + step], np.int32) if per_slot
               else 6 + step)
        (jo, jc, jev), (to, tc, tev) = _run_both(mla, xs, pos, jc, tc)
        assert _rel(to, jo) <= TOL, step
        assert _bill(tev) == _bill(jev)
    for name in ("ckv", "kr"):
        assert _rel(tc[name], jc[name]) <= TOL
    ops = collections.Counter(e.spec.op for e in tev)
    assert ops == {"matmul": 3, "einsum2d": 5}    # wq, wdkv, wo; absorbed


# q (B, Hkv, G, S, D), k (B, Hkv, T, D), v (B, Hkv, T, Dv)
QCHUNK_CASES = {
    "dv_ne_d": dict(B=2, Hkv=2, G=2, S=7, T=7, D=12, Dv=8, q_chunk=64),
    "dv_ne_d_kv_tail": dict(B=1, Hkv=2, G=1, S=5, T=9, D=24, Dv=16, q_chunk=64,
                            kv_valid=5),
    "window": dict(B=2, Hkv=1, G=2, S=10, T=10, D=8, Dv=8, q_chunk=64, window=3),
    "padded_chunks": dict(B=1, Hkv=2, G=1, S=11, T=11, D=12, Dv=4, q_chunk=4),
    "padded_window": dict(B=2, Hkv=2, G=2, S=9, T=9, D=8, Dv=8, q_chunk=4,
                          window=4),
    "per_slot": dict(B=3, Hkv=2, G=2, S=1, T=8, D=8, Dv=8, q_chunk=64,
                     q_offset=(3, 7, 0), kv_valid=(4, 8, 1)),
    "per_slot_window": dict(B=2, Hkv=1, G=3, S=1, T=10, D=8, Dv=6, q_chunk=64,
                            q_offset=(9, 4), kv_valid=(10, 5), window=4),
}


def _qchunk_inputs(case):
    c = QCHUNK_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((c["B"], c["Hkv"], c["G"], c["S"], c["D"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["Hkv"], c["T"], c["D"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["Hkv"], c["T"], c["Dv"])).astype(np.float32)
    off, kvv = c.get("q_offset", 0), c.get("kv_valid", c["T"])
    return c, q, k, v, off, kvv


def _ref_chunked(c, q, k, v, off, kvv):
    with je.use_backend("interpret"), je.instrument() as jev:
        out = jattn.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_offset=jnp.asarray(off, jnp.int32), kv_valid=jnp.asarray(kvv, jnp.int32),
            window=c.get("window"), q_chunk=c["q_chunk"], policy=jprec.FP32)
    return out, jev


def _port_chunked(c, q, k, v, off, kvv):
    as_t = lambda a: torch.as_tensor(a).long() if np.ndim(a) else a
    return tattn.chunked_attention(
        q, k, v, q_offset=as_t(off), kv_valid=as_t(kvv), window=c.get("window"),
        q_chunk=c["q_chunk"], policy=tprec.FP32)


@pytest.mark.parametrize("case", sorted(QCHUNK_CASES))
def test_q_chunked_path_matches_reference(case):
    c, q, k, v, off, kvv = _qchunk_inputs(case)
    jo, jev = _ref_chunked(c, q, k, v, off, kvv)
    with te.instrument() as tev:
        to = _port_chunked(c, *(torch.from_numpy(a) for a in (q, k, v)), off, kvv)
    assert _rel(to, jo) <= TOL
    assert not any(e.spec.op.startswith("attention_") for e in tev)
    assert _bill(tev) == _bill(jev)


@pytest.mark.parametrize("case", ("dv_ne_d", "padded_chunks", "padded_window"))
def test_q_chunked_path_grads_match_reference(case):
    """The path MLA trains through: dq, dk, dv of a weighted sum of the
    output against ``jax.grad`` of the reference."""
    c, q, k, v, off, kvv = _qchunk_inputs(case)
    w = np.random.default_rng(5).standard_normal(
        (c["B"], c["Hkv"], c["G"], c["S"], c["Dv"])).astype(np.float32)

    def jloss(qq, kk, vv):
        with je.use_backend("interpret"):
            out = jattn.chunked_attention(
                qq, kk, vv, q_offset=off, kv_valid=kvv, window=c.get("window"),
                q_chunk=c["q_chunk"], policy=jprec.FP32)
        return jnp.sum(out * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = _port_chunked(c, *ts, off, kvv)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for name, a, b in zip("qkv", tg, jg):
        assert _rel(a, b) <= TOL, name


@pytest.mark.parametrize("stacked", (True, False))
def test_insert_slot_on_mla_leaves_matches_reference(mla, stacked):
    """A batch-1 MLA cache written into slot 2 of a 3-slot pool: stacked
    over 2 layers (batch dim 1) and unstacked (``layer0``: batch dim 0)."""
    jcfg = mla[0]
    r, dr = jcfg.mla.kv_lora_rank, jcfg.mla.qk_rope_dim
    rng = np.random.default_rng(9)
    lead = (2,) if stacked else ()
    pool = {n: rng.standard_normal((*lead, 3, 10, c)).astype(np.float32)
            for n, c in (("ckv", r), ("kr", dr))}
    single = {n: rng.standard_normal((*lead, 1, 10, c)).astype(np.float32)
              for n, c in (("ckv", r), ("kr", dr))}
    want = jkv.insert_slot({"sub": jax.tree.map(jnp.asarray, pool)},
                           {"sub": jax.tree.map(jnp.asarray, single)},
                           jnp.int32(2), jnp.float32)
    tpool = {"sub": {n: torch.from_numpy(a.copy()) for n, a in pool.items()}}
    got = tkv.insert_slot(tpool, {"sub": {n: torch.from_numpy(a) for n, a in
                                          single.items()}}, 2)
    assert got is tpool
    for n in ("ckv", "kr"):
        np.testing.assert_array_equal(got["sub"][n].numpy(),
                                      np.asarray(want["sub"][n]))


def test_fp8_mla_cache_is_refused(mla):
    """The FP8 MLA cache is ported (per-tensor delayed scales on ckv / kr,
    leaf for leaf the reference's: ``tests/test_torch_serve_fp8.py`` holds
    its numerics); a storage dtype that is not FP8 is refused, as the
    reference refuses it."""
    with pytest.raises(ValueError, match="storage_dtype must be an FP8 format"):
        tattn.init_mla_cache(mla[1], 1, 8, torch.float32, storage_dtype="float16",
                             device="cpu")
    with pytest.raises(ValueError, match="storage_dtype must be an FP8 format"):
        jattn.init_mla_cache(mla[0], 1, 8, jnp.float32, storage_dtype="float16")
    got = tattn.init_mla_cache(mla[1], 1, 8, torch.float32,
                               storage_dtype="float8_e4m3fn", device="cpu")
    want = jattn.init_mla_cache(mla[0], 1, 8, jnp.float32, storage_dtype="float8_e4m3fn")
    flat = lambda tree, f: {k: (flat(v, f) if isinstance(v, dict) else f(v))
                            for k, v in tree.items()}
    assert flat(got, lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1],
                                t.float().sum().item())) == \
        flat(want, lambda a: (tuple(a.shape), a.dtype.name, float(np.asarray(a, np.float32).sum())))
