"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against the port's own runs.

A dry-run cell traces one rank's program on meta tensors.  Held here:

* the roofline's second half against the reference's formulas: the ring
  model of every collective kind, the report's derived fields, the
  record's keys (the reference's, less the XLA-only ones, plus the
  port's three), and the archs that take the long_500k decode;
* the engine bill of the trace against the port's real CPU run of the
  same step, exactly, for every reduced arch x {train, prefill, decode}
  on a one-rank mesh; against the reference's ``engine.instrument()``
  around ``jax.eval_shape`` of its step (xlstm-1.3b under remat "dots",
  where the reference bills the saved GEMM outputs as recompute events
  and the sweep backward's composition twice, ROADMAP Queue C);
* the sharded bill: four FSDP ranks of reduced qwen3-1.7b sum to the
  unsharded flops in each direction; on hymba-1.5b with 5 / 1 heads the
  excess is exactly the dispatches every rank replicates;
* the guards: a meta tensor outside the dry run and a description mesh
  outside it still raise, a CPU tensor inside it raises in a collective;
* one production cell at full width (qwen3-1.7b decode_32k on pod16x16):
  its resident parameter and KV bytes are the local blocks of the
  sanitized spec trees;
* remat "dots": gradients bitwise equal to "full" (reduced qwen3-1.7b and
  xlstm-1.3b on the CPU), only batched / grouped / attention / sweep
  dispatches re-run, and the traced peak of qwen3-1.7b train_4k on
  pod16x16 orders "none" > "dots" > "full".
"""

import ast
import collections
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import engine as je
from repro.models import transformer as jt
from repro.roofline import analysis as jA

from repro_torch import configs as tconfigs
from repro_torch.core import engine as te
from repro_torch.core import precision as prec
from repro_torch.kernels import chunked_linear_attention as tcla
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.roofline import analysis as tA
from repro_torch.runtime import collectives as tcoll
from repro_torch.runtime import sharding as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
ONE = tmesh.Mesh((1, 1), ("data", "model"))
B, S = 2, 16            # the reduced cells' batch and sequence


def _by_op(events):
    out = collections.Counter()
    for e in events:
        out[(e.spec.op, e.spec.flops, e.spec.bytes, e.recompute)] += e.count
    return out


def _stream(events):
    """Every event, in order: its spec, count and recompute tag."""
    return [(e.spec, e.count, e.recompute) for e in events]


# --------------------------------------------------------------------- #
# the roofline's second half, against the reference's formulas
# --------------------------------------------------------------------- #
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("kind", KINDS)
def test_ring_model_matches_reference(kind):
    for g in (1, 2, 4, 16):
        for R in (250, 1000, 3 * 2 ** 20):
            want = jA.CollectiveOp(kind, result_bytes=R, group_size=g,
                                   computation="x").wire_bytes
            got = tA.CollectiveOp(kind, result_bytes=R, group_size=g,
                                  computation="x").wire_bytes
            assert got == want, (kind, g, R)
    # tests/test_sharding_roofline.py::test_ring_cost_model's cases
    op = tA.CollectiveOp("all-reduce", result_bytes=1000, group_size=4, computation="x")
    assert op.wire_bytes == 2 * 1000 * 3 / 4
    op = tA.CollectiveOp("reduce-scatter", result_bytes=250, group_size=4,
                         computation="x")
    assert op.wire_bytes == 250 * 3


def test_port_kinds_map_onto_the_reference_kinds():
    assert set(tA.KIND.values()) <= set(KINDS)
    assert set(tA.KIND) == {"psum", "pmax", "all_gather", "psum_scatter",
                            "all_to_all", "redistribute"}


def test_long_context_support_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in tconfigs.ARCH_IDS:
        assert (tconfigs.get(arch).supports_long_context_decode
                == jconfigs.get(arch).supports_long_context_decode), arch


def test_report_fields_match_reference_formulas():
    rng = np.random.default_rng(0)
    for _ in range(20):
        c, m, k, f, mf = (float(x) for x in rng.uniform(1e-3, 10.0, 5))
        fields = dict(arch="a", shape="s", mesh="m", n_devices=256,
                      flops_per_device=f * 1e12, bytes_per_device=1.0,
                      coll_bytes_per_device=1.0, compute_s=c, memory_s=m,
                      collective_s=k, model_flops=mf * 1e14, collectives={},
                      memory_analysis={})
        got, want = tA.RooflineReport(**fields), jA.RooflineReport(**fields)
        assert got.dominant == want.dominant
        assert got.bound_s == want.bound_s
        assert got.useful_flops_ratio == want.useful_flops_ratio
        # the reference's formula, at the H100's peak
        assert got.roofline_fraction == (
            want.model_flops / (want.bound_s * want.n_devices * tA.PEAK_FLOPS))


def _reference_record_keys():
    """The keys ``repro.launch.dryrun.dryrun_cell`` writes: its report's
    ``to_json`` and its own ``rec.update`` (read from the source, so the
    reference module's device-count flag stays out of this process)."""
    jkeys = {f.name for f in dataclasses.fields(jA.RooflineReport)}
    jkeys |= {"dominant", "useful_flops_ratio", "roofline_fraction", "bound_s"}
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "rec"):
            jkeys |= {kw.arg for kw in node.keywords}
    return jkeys


@pytest.fixture(scope="module")
def decode_cell():
    return dryrun.dryrun_cell("qwen3-1.7b", "decode_32k", verbose=False)


def test_record_keys_are_the_reference_s(decode_cell):
    xla = {k for k in dryrun.XLA_ONLY_KEYS if "." not in k}
    assert set(decode_cell) == (_reference_record_keys() - xla) | set(dryrun.PORT_KEYS)
    # memory_analysis: the reference's fields less XLA's flops / bytes
    src = (ROOT / "src/repro/roofline/analysis.py").read_text()
    body = src[src.index("mem = {"):src.index("}", src.index("mem = {"))]
    jmem = {line.split('"')[1] for line in body.splitlines() if '"' in line}
    nested = {k.split(".")[1] for k in dryrun.XLA_ONLY_KEYS if "." in k}
    assert set(decode_cell["memory_analysis"]) == jmem - nested


def _local_bytes(specs, shapes, mesh) -> int:
    if isinstance(specs, ts.PartitionSpec):
        return (int(np.prod(ts.local_shape(tuple(shapes.shape), specs, mesh)))
                * shapes.element_size())
    return sum(_local_bytes(specs[k], shapes[k], mesh) for k in specs)


def test_production_decode_cell_holds_the_spec_blocks(decode_cell):
    """qwen3-1.7b decode_32k on pod16x16 at full width: the resident
    parameters and KV cache are the local blocks of the sanitized spec
    trees (parameters in the compute dtype, as the reference serves)."""
    rec = decode_cell
    assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256 and rec["rank"] == 0
    assert rec["links"] == {"data": "infiniband", "model": "infiniband"}
    cfg = dataclasses.replace(tconfigs.get("qwen3-1.7b"), param_dtype="bfloat16")
    mesh = tmesh.make_production_mesh()
    rules = tserve.serve_rules(ts.Rules())
    pabs = tt.abstract_params(cfg)
    pspec = ts.sanitize_tree(tt.param_specs(cfg, rules), pabs, mesh)
    assert rec["resident_bytes"]["param_bytes"] == _local_bytes(pspec, pabs, mesh)
    cabs, cspec = tserve.specs_lib.decode_cache_specs(cfg, rules, mesh, 128, 32768)
    assert rec["resident_bytes"]["kv_bytes"] == _local_bytes(cspec, cabs, mesh)
    assert 0 < rec["per_device_hbm_gib"] < 80
    assert rec["memory_analysis"]["alias_bytes"] > 0      # the cache, in place
    assert rec["collectives"] and rec["engine_flops"] > 0


def test_long_500k_skips_where_the_reference_does():
    for arch in tconfigs.ARCH_IDS:
        if not tconfigs.get(arch).supports_long_context_decode:
            rec = dryrun.dryrun_cell(arch, "long_500k", verbose=False)
            assert set(rec) == {"arch", "shape", "mesh", "skipped"}


# --------------------------------------------------------------------- #
# the bill: the trace against the port's real CPU run
# --------------------------------------------------------------------- #
def _reduced(arch, **kw):
    return dataclasses.replace(tconfigs.get_reduced(arch), **kw)


def _real_batch(cfg, rows, seq, labels=True):
    g = torch.Generator().manual_seed(0)
    if cfg.input_mode == "embeddings":
        out = {"embeddings": torch.randn(rows, seq, cfg.d_model, generator=g)
               .to(cfg.compute_dtype)}
    else:
        out = {"inputs": torch.randint(0, cfg.vocab_size, (rows, seq), generator=g)}
    if labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (rows, seq), generator=g)
    return out


def _real_events(cfg, kind):
    """The engine events of one real CPU step of ``kind``."""
    if kind == "train":
        opt = AdamW(lr=1e-4)
        state = ttrain.init_state(cfg, opt, seed=0, device="cpu")
        step = ttrain.build_train_step(cfg, opt, ts.Rules())
        batch = _real_batch(cfg, B, S)
        with te.instrument() as ev:
            step(state, batch)
        return ev
    params = tt.init_params(cfg, seed=0, device="cpu")
    rules = tserve.serve_rules(ts.Rules())
    if kind == "prefill":
        pre = tserve.build_prefill(cfg, rules, S)
        batch = _real_batch(cfg, B, S, labels=False)
        with te.instrument() as ev:
            pre(params, batch)
        return ev
    cache = tt.init_cache(cfg, B, S, device="cpu")
    step = tserve.build_serve_step(cfg, rules)
    toks = torch.zeros((B, 1), dtype=torch.long)
    with te.instrument() as ev:
        step(params, cache, toks, S - 1)
    return ev


def _dry(cfg, kind, mesh=ONE, rules=None):
    if kind == "train":
        return dryrun.trace_train(cfg, mesh, rules or ts.Rules(), batch=B, seq=S,
                                  contract="cpu")
    rules = rules or tserve.serve_rules(ts.Rules())
    if kind == "prefill":
        return dryrun.trace_prefill(cfg, mesh, rules, batch=B, seq=S, contract="cpu")
    return dryrun.trace_decode(cfg, mesh, rules, batch=B, max_len=S, contract="cpu")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_bill_equals_the_cpu_run(arch, kind):
    cfg = _reduced(arch)
    if kind != "train":     # served weights are held in the compute dtype
        cfg = dataclasses.replace(cfg, param_dtype=prec.dtype_name(cfg.compute_dtype))
    got = _dry(cfg, kind)
    assert got.trace.collectives == []              # one rank: none
    assert _stream(got.trace.events) == _stream(_real_events(cfg, kind))


def test_bill_under_dots_matches_reference():
    """xlstm-1.3b (fp32, remat "dots"): the trace bills what runs; the
    reference bills every dispatch of the region's re-trace as recompute,
    the saved no-batch GEMMs too, and the sweep backward's composition
    forward twice (ROADMAP Queue C).  The difference is exactly those."""
    arch = "xlstm-1.3b"
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), policy_name="fp32",
                               remat="dots")
    tcfg = _reduced(arch, policy_name="fp32", remat="dots")
    jparams = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    spec = jax.ShapeDtypeStruct((B, S), jnp.int32)
    f = jax.value_and_grad(lambda p, x: jt.loss_fn(p, jcfg, x), has_aux=True)
    with je.use_backend("interpret"), je.instrument() as jev:
        jax.eval_shape(f, jparams, {"inputs": spec, "labels": spec})
    got = _dry(tcfg, "train")
    # the saved dots the reference bills as recompute
    saved = _by_op([e for e in jev if e.recompute and e.spec.w_shared
                    and e.spec.groups == 1])
    # its second bill of the sweep backward's composition forward
    H = jcfg.n_heads
    hd = jcfg.ssm.mlstm_proj_factor * jcfg.d_model // H
    z = jnp.zeros((B, H, S, hd), jnp.float32)
    with je.instrument() as comp:
        je._linear_attention_reference(z, z, z, z[..., 0], chunk=jcfg.ssm.chunk,
                                       state=None, backend="interpret")
    n_mlstm = jcfg.n_layers // jcfg.ssm.slstm_period * (jcfg.ssm.slstm_period - 1)
    twice = collections.Counter({(op, fl, by, True): n * n_mlstm
                                 for (op, fl, by, _), n in _by_op(comp).items()})
    assert sum(saved.values()) > 0
    assert _by_op(got.trace.events) == _by_op(jev) - saved - twice
    assert _by_op(jev) - _by_op(got.trace.events) == saved + twice


def test_sharded_bill_sums_to_the_unsharded_one():
    """Reduced qwen3-1.7b under Rules(fsdp=True) on (2, 2): every rank
    traces the same program, and four of them do the unsharded step's
    GEMM flops in each direction (the bytes do not sum: each data rank
    reads its whole weights)."""
    cfg = _reduced("qwen3-1.7b")
    whole = _dry(cfg, "train").bill()["flops"]
    ranks = [_dry(cfg, "train", tmesh.Mesh((2, 2), ("data", "model"), rank=r),
                  ts.Rules(fsdp=True)) for r in (0, 3)]
    assert ranks[0].collective_stats() == ranks[1].collective_stats()
    assert _stream(ranks[0].trace.events) == _stream(ranks[1].trace.events)
    for d in ("fwd", "bwd"):
        assert 4 * ranks[0].bill()["flops"][d] == whole[d], d


def test_replicated_dispatches_make_the_excess():
    """hymba-1.5b with 5 query / 1 KV heads on a (1, 2) model axis: the
    heads do not divide, so the attention (q-chunked, batched GEMMs) and
    the SSD core run whole on both ranks.  Each rank dispatches what the
    unsharded step does, in its order; two ranks' flops exceed the
    unsharded step's by exactly the dispatches whose specs are the
    unsharded ones (run whole, not cut)."""
    cfg = _reduced("hymba-1.5b", n_heads=5, n_kv_heads=1, d_model=80,
                   vocab_size=511, policy_name="fp32")
    whole = _dry(cfg, "train")
    rank = _dry(cfg, "train", tmesh.Mesh((1, 2), ("data", "model")), ts.Rules())
    pairs = list(zip(rank.trace.events, whole.trace.events, strict=True))
    assert all(a.spec.op == b.spec.op and a.recompute == b.recompute for a, b in pairs)
    repl = [a for a, b in pairs if a.spec == b.spec]
    excess = {d: 2 * rank.bill()["flops"][d] - whole.bill()["flops"][d]
              for d in ("fwd", "bwd")}
    assert excess == tA.flops_by_direction(repl)
    names = collections.Counter((e.spec.op, e.spec.tag) for e in repl)
    # the attention's scores and PV (fwd + recompute) and their dX / dW,
    # the SSD sweep (fwd + recompute), and its backward's composition
    assert names[("matmul", "bmn,bnk->bmk")] == 14
    assert names[("matmul_dx", "bmk,bnk->bmn")] == names[("matmul_dw", "bmn,bmk->bnk")] == 12
    for op in ("score", "pv", "inter", "state"):
        assert names[(f"linear_attention_{op}", {"score": "bik,bjk->bij",
                                                  "pv": "bij,bjv->biv",
                                                  "inter": "bik,bkv->biv",
                                                  "state": "bki,bkv->biv"}[op])] == 4


# --------------------------------------------------------------------- #
# guards
# --------------------------------------------------------------------- #
def test_meta_outside_the_dry_run_raises():
    m = lambda *s: torch.empty(*s, device="meta")
    pol = tconfigs.get("qwen3-1.7b").policy
    with pytest.raises(ValueError, match="unsupported device"):
        tops.redmule_matmul(m(4, 8).bfloat16(), m(8, 4).bfloat16(), policy=pol)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.redmule_matmul_batched(m(2, 4, 8).bfloat16(), m(2, 8, 4).bfloat16(),
                                    policy=pol)
    q = m(2, 16, 64).bfloat16()
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        tcla.chunked_linear_attention(q.float(), q.float(), q, m(2, 16), chunk=16)
    # inside it: shapes, and no launch counted
    n = tops.redmule_matmul.launches
    with tcoll.dry_run():
        z = tops.redmule_matmul(m(4, 8).bfloat16(), m(8, 4).bfloat16(), policy=pol)
        assert z.shape == (4, 4) and z.device.type == "meta"
        assert tflash.flash_attention(q, q, q).shape == q.shape
        out, st = tcla.chunked_linear_attention(q.float(), q.float(), q, m(2, 16),
                                                chunk=16)
        assert out.shape == q.shape and st.shape == (2, 64, 64)
        # the card's contract holds on meta
        with pytest.raises(ValueError, match="D in"):
            tflash.flash_attention(m(2, 16, 16).bfloat16(), m(2, 16, 16).bfloat16(),
                                   m(2, 16, 16).bfloat16())
    assert tops.redmule_matmul.launches == n


def test_description_mesh_and_host_tensors():
    mesh = tmesh.make_production_mesh()
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(RuntimeError, match="not bound to a process group"):
        tcoll.psum(x, mesh, "model")
    with tcoll.dry_run() as entries:
        y = tcoll.all_gather(x, mesh, "model", 1)
        assert y.shape == (4, 128) and y.device.type == "meta"
        with pytest.raises(ValueError, match="meta tensors"):
            tcoll.psum(torch.zeros(4, 8), mesh, "model")
    assert [(e.kind, e.group_size, e.payload, e.result_bytes) for e in entries] == [
        ("all_gather", 16, 4 * 8 * 4, 4 * 128 * 4)]
    with pytest.raises(RuntimeError, match="not bound to a process group"):
        tcoll.psum(x, mesh, "model")


def test_link_model_follows_the_node():
    """Row-major ranks, eight to a node: a group of two along the model
    axis of (1, 2) stays inside a node, any group of pod16x16 spans two."""
    assert tcoll._intra_node(tmesh.Mesh((1, 2), ("data", "model")), "model")
    assert tcoll._intra_node(tmesh.Mesh((2, 2), ("data", "model"), rank=3), "data")
    big = tmesh.make_production_mesh()
    assert not tcoll._intra_node(big, "model") and not tcoll._intra_node(big, "data")
    ops = tA.parse_collectives(tA.DryTrace(
        [tcoll.DryCollective("psum", "model", 2, 100, 100, True),
         tcoll.DryCollective("psum", "model", 16, 100, 100, False)], [], {}, {}))
    assert [op.link_bw for op in ops] == [tA.NVLINK_BW, tA.IB_BW]


# --------------------------------------------------------------------- #
# remat "dots"
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-1.3b"])
def test_dots_gradients_equal_full(arch):
    grads, events = {}, {}
    for remat in ("dots", "full"):
        cfg = _reduced(arch, policy_name="fp32", remat=remat)
        params = tt.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _real_batch(cfg, B, S)
        with te.instrument() as ev:
            loss, _ = tt.loss_fn(params, cfg, batch)
            grads[remat] = torch.autograd.grad(loss, leaves)
        events[remat] = ev
    assert all(torch.equal(a, b) for a, b in zip(grads["dots"], grads["full"]))
    rec = [e for e in events["dots"] if e.recompute]
    assert rec and not any(te._no_batch_dims(e.spec) for e in rec)
    # "full" re-runs the saved ones as well
    saved = _by_op([e for e in events["full"] if e.recompute
                    and te._no_batch_dims(e.spec)])
    assert _by_op(events["full"]) - _by_op(events["dots"]) == saved


def test_dots_peak_lies_between_none_and_full():
    peak = {r: dryrun.dryrun_cell("qwen3-1.7b", "train_4k", remat=r,
                                  verbose=False)["per_device_hbm_gib"]
            for r in ("none", "dots", "full")}
    assert peak["none"] > peak["dots"] > peak["full"], peak
