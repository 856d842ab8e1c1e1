"""The dry run: every (arch x shape x mesh) cell traced as one rank's
program on meta tensors, with its three-term roofline.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell over 256 or 512 forced host devices and reads XLA's
compiled text.  The port has neither a compiler nor 256 ranks, so a cell
here runs **one rank's program** — rank 0 of the production mesh
(``launch.mesh.make_production_mesh``: ``(16, 16)`` one pod, ``(2, 16,
16)`` two) — through the entry points the gloo ranks run, on
``device="meta"`` tensors at that rank's local shapes:

* train: ``launch.train.make_sharded_train_step`` under ``Rules(fsdp=,
  sequence_parallel=)`` with ``grad_accum`` and ``cast_params`` (AdamW,
  lr 1e-4 as the reference's), the global batch of ``configs.input_specs``;
* prefill: ``launch.serve.build_prefill`` under ``serve_rules(Rules(
  sequence_parallel=))`` on the rank's rows of the prompt;
* decode: ``launch.serve.make_sharded_serve_step`` under
  ``serve_rules(Rules())`` on the rank's blocks of the full cache
  (``serving.specs.decode_cache_specs``), ``pos`` the Python int
  ``seq_len - 1``.

Parameters, AdamW moments and the cache are meta tensors at the local
shapes of the sanitized spec trees (``runtime.sharding.local_shape``).
``sanitize_spec`` keeps a cut only where the mesh axes divide the dim, so
every rank's blocks have one size and rank 0's program is every rank's
(the record names the rank traced).  Inside the trace
(:func:`trace`) the collectives record and do not run
(``runtime.collectives.dry_run``), the kernel wrappers check the card's
contract and allocate their outputs without launching, the engine bills
its events as always (``engine.instrument``) and
:class:`repro_torch.roofline.memory.MemoryTracker` follows every storage
the step allocates.  ``roofline.analysis.roofline`` turns that into the
record.

The record has the reference's keys (``RooflineReport.to_json`` and
``dryrun_cell``'s own), less those that name XLA artifacts
(:data:`XLA_ONLY_KEYS`: ``compile_s``, ``hlo_bytes``, and
``memory_analysis``'s ``xla_flops`` / ``xla_bytes``), plus
:data:`PORT_KEYS`: the ``rank`` traced, the ``links`` each mesh axis's
collectives were priced at (``"nvlink"`` inside one 8-card node,
``"infiniband"`` across nodes) and the rank's ``resident_bytes``
(parameters, moments, cache).  ``lower_s`` is the trace's seconds and
``per_device_hbm_gib`` the tracked peak over 2^30 (what
``torch.cuda.max_memory_allocated()`` reads on the card).  The
reference's ``donate`` is not a flag here: eager code updates the state
(and the decode cache) in place, which is what donation buys XLA, and
the tracker counts those results as ``alias_bytes``.

What a meta trace cannot see: kernel time (every term is an estimate from
the H100 data-sheet constants of ``roofline.analysis``), the caching
allocator's fragmentation and the CUDA context, the NCCL buffers a real
collective would hold (every collective here is a record), and any
value-dependent work (MoE capacity drops are counted at capacity, not at
the routing a batch would give).  A cell that does not fit in 80 GB is a
reading, not an error: :func:`main` exits non-zero only when a cell
raises, as the reference's does.

::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both            # experiments/dryrun/*.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.core import engine
from repro_torch.core import precision as prec
from repro_torch.kernels import redmule_matmul as rm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import transformer
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.roofline import analysis as roofline_lib
from repro_torch.roofline.memory import MemoryTracker, tree_bytes
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding
from repro_torch.serving import specs as serving_specs

__all__ = ["dryrun_cell", "cell_line", "main", "trace", "trace_train", "trace_prefill",
           "trace_decode", "local_meta", "Traced", "XLA_ONLY_KEYS", "PORT_KEYS"]

XLA_ONLY_KEYS = ("compile_s", "hlo_bytes", "memory_analysis.xla_flops",
                 "memory_analysis.xla_bytes")
PORT_KEYS = ("rank", "links", "resident_bytes")
GIB = 2 ** 30


@dataclasses.dataclass
class Traced:
    """One traced step: its result, the :class:`roofline.analysis.DryTrace`,
    the seconds the trace took and the rank's resident bytes."""

    out: Any
    trace: roofline_lib.DryTrace
    seconds: float
    resident: Dict[str, int]

    @property
    def peak_bytes(self) -> int:
        return self.trace.memory["peak_bytes"]

    def collective_stats(self) -> Dict[str, Dict[str, int]]:
        """``{kind: {"count", "bytes"}}``, as ``collectives.STATS`` counts
        a run."""
        out: Dict[str, Dict[str, int]] = {}
        for c in self.trace.collectives:
            s = out.setdefault(c.kind, {"count": 0, "bytes": 0})
            s["count"] += 1
            s["bytes"] += c.payload
        return out

    def bill(self) -> Dict[str, Dict[str, float]]:
        """The engine's flops and bytes by direction."""
        ev = self.trace.events
        return {"flops": roofline_lib.flops_by_direction(ev),
                "bytes": roofline_lib.bytes_by_direction(ev)}


def trace(fn, *arguments, resident: Optional[Dict[str, int]] = None,
          contract: str = "card") -> Traced:
    """Run ``fn()`` as a dry-run step: collectives recorded, engine events
    collected and every allocation tracked, ``arguments`` (trees of meta
    tensors) live at its entry; ``contract`` the run it predicts
    (``collectives.dry_run``: "card", or "cpu" for the plain versions)."""
    # the split's tile counters live as long as the process on the card;
    # each trace starts as a fresh rank would, without them
    rm._COUNTERS.pop(torch.device("meta"), None)
    with coll.dry_run(contract) as colls, engine.instrument() as events, \
            MemoryTracker() as mt:
        mt.arguments(*arguments)
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        memory = mt.summary(out)
    return Traced(out, roofline_lib.DryTrace(list(colls), list(events), mt.ops,
                                             memory), seconds, resident or {})


def local_meta(abstract, specs, mesh, dtype=None):
    """Meta tensors at the rank's local block shapes of a sanitized spec
    tree (``dtype``: each leaf's own when None)."""
    if isinstance(abstract, torch.Tensor):
        shape = sharding.local_shape(tuple(abstract.shape), specs, mesh)
        return torch.empty(shape, dtype=dtype or abstract.dtype, device="meta")
    return {k: local_meta(abstract[k], specs[k], mesh, dtype) for k in abstract}


def _batch(cfg, batch: int, seq: int, *, labels: bool = True):
    """A batch of ``batch`` x ``seq`` (token ids int32, or the compute
    dtype's embeddings), as ``configs.input_specs`` describes it."""
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    out = ({"embeddings": meta((batch, seq, cfg.d_model), cfg.compute_dtype)}
           if cfg.input_mode == "embeddings"
           else {"inputs": meta((batch, seq), torch.int32)})
    if labels:
        out["labels"] = meta((batch, seq), torch.int32)
    return out


def trace_train(cfg, mesh, rules, *, batch: int, seq: int, grad_accum: int = 1,
                cast_params: bool = False, opt=None, contract: str = "card",
                return_grads: bool = False) -> Traced:
    """One training step of this rank (``make_sharded_train_step``;
    ``return_grads``: the step keeps a copy of the gradients, as
    ``launch.mesh``'s rank worker asks)."""
    opt = opt or AdamW(lr=1e-4)
    step, sspec = train_lib.make_sharded_train_step(
        cfg, mesh, rules, opt, grad_accum=grad_accum, cast_params=cast_params,
        return_grads=return_grads)
    params = local_meta(transformer.abstract_params(cfg), sspec.params, mesh)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = train_lib.TrainState(params, opt.init(params), ())
    data = _batch(cfg, batch, seq)
    resident = {"param_bytes": tree_bytes(state.params),
                "moment_bytes": tree_bytes(state.opt.mu) + tree_bytes(state.opt.nu)}
    return trace(lambda: step(state, data), state, resident=resident,
                 contract=contract)


def _serve_params(cfg, mesh, rules):
    pspec = sharding.sanitize_tree(transformer.param_specs(cfg, rules),
                                   transformer.abstract_params(cfg), mesh)
    return local_meta(transformer.abstract_params(cfg), pspec, mesh,
                      getattr(torch, cfg.param_dtype))


def trace_prefill(cfg, mesh, rules, *, batch: int, seq: int,
                  max_len: Optional[int] = None, contract: str = "card") -> Traced:
    """The prefill of this rank's rows of a ``batch`` x ``seq`` prompt
    (``build_prefill``), building a ``max_len`` cache."""
    n = math.prod(mesh.shape[a] for a in mesh_lib.data_axes(mesh))
    if batch % n:
        raise ValueError(f"a prefill batch of {batch} rows does not cut over the "
                         f"data axes of {mesh.shape}")
    pre = serve_lib.build_prefill(cfg, rules, max_len or seq, mesh=mesh)
    params = _serve_params(cfg, mesh, rules)
    data = _batch(cfg, batch // n, seq, labels=False)
    out = trace(lambda: pre(params, data), params,
                resident={"param_bytes": tree_bytes(params)}, contract=contract)
    out.resident["kv_bytes"] = tree_bytes(out.out[1])
    return out


def trace_decode(cfg, mesh, rules, *, batch: int, max_len: int,
                 pos: Optional[int] = None, contract: str = "card") -> Traced:
    """One decode step of this rank on its blocks of a ``batch`` x
    ``max_len`` cache at ``pos`` (default ``max_len - 1``: the prompt has
    filled the cache)."""
    step, pspec, cspec = serve_lib.make_sharded_serve_step(
        cfg, mesh, rules, batch=batch, max_len=max_len)
    params = local_meta(transformer.abstract_params(cfg), pspec, mesh,
                        getattr(torch, cfg.param_dtype))
    cabs, _ = serving_specs.decode_cache_specs(cfg, rules, mesh, batch, max_len)
    cache = local_meta(cabs, cspec, mesh)
    tokens = torch.empty((batch, 1), dtype=torch.long, device="meta")
    pos = max_len - 1 if pos is None else int(pos)
    return trace(lambda: step(params, cache, tokens, pos), params, cache,
                 resident={"param_bytes": tree_bytes(params),
                           "kv_bytes": tree_bytes(cache)}, contract=contract)


def _links(mesh) -> Dict[str, str]:
    return {a: "nvlink" if coll._intra_node(mesh, a) else "infiniband"
            for a, n in mesh.shape.items() if n > 1}


def dryrun_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    fsdp: bool = True,
    sequence_parallel: bool = False,
    remat: Optional[str] = None,
    policy: Optional[str] = None,
    q_chunk: Optional[int] = None,
    ce_chunk: Optional[int] = None,
    cast_params: bool = False,
    grad_accum: int = 1,
    moe_impl: Optional[str] = None,
    ssm_chunk: Optional[int] = None,
    verbose: bool = True,
) -> dict:
    """Trace one cell as rank 0 of its production mesh; return the
    roofline / memory record."""
    cfg = configs.get(arch)
    overrides = {}
    if remat is not None:
        overrides["remat"] = remat
    if policy is not None:
        overrides["policy_name"] = policy
    if q_chunk is not None:
        overrides["q_chunk"] = q_chunk
    if ce_chunk is not None:
        overrides["ce_chunk"] = ce_chunk
    if moe_impl is not None:
        overrides["moe_impl"] = moe_impl
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if ssm_chunk is not None and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    shape = configs.SHAPES[shape_name]
    if shape.kind != "train":
        # serving stores parameters in the serving compute precision
        cfg = dataclasses.replace(cfg, param_dtype=prec.dtype_name(cfg.compute_dtype))
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_dev = mesh.size

    if shape.kind == "decode" and shape.name == "long_500k" \
            and not cfg.supports_long_context_decode:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "skipped": "pure full-attention arch: quadratic 500k decode "
                       "(DESIGN.md §5)",
        }

    if shape.kind == "train":
        rules = sharding.Rules(fsdp=fsdp, sequence_parallel=sequence_parallel)
        got = trace_train(cfg, mesh, rules, batch=shape.global_batch,
                          seq=shape.seq_len, grad_accum=grad_accum,
                          cast_params=cast_params)
    elif shape.kind == "prefill":
        rules = serve_lib.serve_rules(
            sharding.Rules(sequence_parallel=sequence_parallel))
        got = trace_prefill(cfg, mesh, rules, batch=shape.global_batch,
                            seq=shape.seq_len)
    else:  # decode
        rules = serve_lib.serve_rules(sharding.Rules())
        got = trace_decode(cfg, mesh, rules, batch=shape.global_batch,
                           max_len=shape.seq_len)

    report = roofline_lib.roofline(
        got.trace, arch=arch, shape=shape_name, mesh_name=mesh_name,
        n_devices=n_dev, model_flops_val=roofline_lib.model_flops(cfg, shape))
    rec = report.to_json()
    rec.update(
        lower_s=round(got.seconds, 2),
        fsdp=fsdp,
        sequence_parallel=sequence_parallel,
        remat=cfg.remat,
        policy=cfg.policy_name,
        ce_chunk=cfg.ce_chunk,
        cast_params=cast_params,
        grad_accum=grad_accum,
        per_device_hbm_gib=round(got.peak_bytes / GIB, 3),
        rank=mesh.rank,
        links=_links(mesh),
        resident_bytes=got.resident,
    )
    if verbose:
        print(cell_line(rec), flush=True)
    return rec


def cell_line(rec: dict) -> str:
    """The reference's printed line of a record (``trace`` for its
    lower / compile seconds)."""
    return (f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: "
            f"mem={rec['per_device_hbm_gib']:.2f} GiB/dev  "
            f"compute={rec['compute_s']*1e3:.2f}ms "
            f"memory={rec['memory_s']*1e3:.2f}ms "
            f"collective={rec['collective_s']*1e3:.2f}ms "
            f"-> {rec['dominant']}-bound  "
            f"(useful={rec['useful_flops_ratio']:.2f}, "
            f"roofline={rec['roofline_fraction']:.2%}; "
            f"trace {rec['lower_s']:.1f}s)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="all",
                   help="arch id or 'all'")
    p.add_argument("--shape", default="all",
                   choices=["all"] + list(configs.SHAPES))
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--out", default="experiments/dryrun")
    p.add_argument("--tag", default="baseline")
    p.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    p.add_argument("--sp", dest="sequence_parallel", action="store_true")
    p.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    p.add_argument("--policy", default=None)
    p.add_argument("--q-chunk", type=int, default=None)
    p.add_argument("--ce-chunk", type=int, default=None)
    p.add_argument("--cast-params", action="store_true")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--moe-impl", default=None, choices=[None, "gspmd", "shard_map"])
    p.add_argument("--ssm-chunk", type=int, default=None)
    args = p.parse_args(argv)

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                fname = os.path.join(
                    args.out, f"{args.tag}__{arch}__{shape_name}__{mesh_name}.json")
                try:
                    rec = dryrun_cell(
                        arch, shape_name, multi_pod=multi, fsdp=args.fsdp,
                        sequence_parallel=args.sequence_parallel,
                        remat=args.remat, policy=args.policy,
                        q_chunk=args.q_chunk, ce_chunk=args.ce_chunk,
                        cast_params=args.cast_params,
                        grad_accum=args.grad_accum,
                        moe_impl=args.moe_impl,
                        ssm_chunk=args.ssm_chunk)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_name, repr(e)))
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "error": repr(e)}
                rec["tag"] = args.tag
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        raise SystemExit(1)
    print(f"\nall dry-run cells traced OK ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
