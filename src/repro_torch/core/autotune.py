"""Launch-geometry autotuning for the Hopper kernels.

Counterpart of ``repro.core.autotune``.  RedMulE sizes its (H, L, P)
geometry against its memory system once, at design time (paper Fig. 4b);
the port's kernels face the same trade per launch: which compiled tile
(``tiling.GEMM_TILES``) and how many slices S of the reduction kernels 1
and 2 run, and which chunk kernel 4's sweep runs.  The heuristics
(``tiling.choose_tiles`` + ``tiling.split_plan``; ``tiling.SWEEP_CHUNK``)
measure nothing; this module closes the loop:

* :func:`candidate_tiles` enumerates the geometries the compiled kernels
  take — each menu tile times each S whose plan ``check_split`` accepts —
  with the heuristic's own pick always among them; nothing needs a build;
* :func:`autotune_gemm` scores each: the device time of the public
  wrapper's launches on the card (:func:`measured_cost_us`, CUDA events,
  weights cycled past the 50 MB L2), or the deterministic model
  :func:`predicted_cost_us` on the CPU (where the plain version's time
  says nothing of the kernel);
* winners are keyed on a canonical spec (:func:`canonical_key`: shape
  buckets, dtypes, epilogue, backend, layout) and kept in an in-process
  LRU over a JSON file named by ``REPRO_AUTOTUNE_CACHE``, so one tuning
  run serves every later process.

The engine resolves every GEMM and sweep dispatch as explicit argument >
:func:`cached_tile` > heuristic and stamps the result on its event.

Port-specific rules:

* **The split is keyed on a bucketed batch.**  The split depends on the
  launch's output tiles, ``ceil(M / bm) * ceil(K / bk) * batch``, but the
  reference's key has no batch: an S tuned on a 2D launch would cut a
  batched launch of the same (m, n, k) into blocks for the wrong number of
  tiles.  So the port's key adds ``batch`` (the launch's batch count,
  bucketed like the dims; 1 for kernel 1, whose leading dims fold into M)
  and keys m / n / k on the launch's own logical dims.  At batch 1 the key
  string is the reference's format.  An entry's S is re-derived for the
  exact N of each launch (``tiling.plan_for_splits``).
* **A faithful accumulator's split is numerics.**  Under an fp16
  accumulator the slices of a rounding block are summed in fp32 in split
  order, so the plan stays the heuristic's (``tiling.launch_plan``): the
  tuner offers tiles only (``splits`` 0) and an entry asking for splits
  there is refused.  A launch with the fused backward is never split.
* **One file, two packages.**  The reference's entries (backends
  ``pallas`` / ``interpret`` / ``xla``) are skipped on load and written
  back untouched; an entry for a port backend naming a geometry the
  kernels do not run raises ``ValueError`` naming the file.  An
  unparseable file is ignored, as the reference ignores it.

The cost model's constants are one H100 SXM's (``roofline.analysis``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import math
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import precision as prec
from repro_torch.core import tiling

__all__ = [
    "ENV_VAR",
    "AutotuneKey",
    "AutotuneResult",
    "canonical_key",
    "candidate_tiles",
    "predicted_cost_us",
    "measured_cost_us",
    "autotune_gemm",
    "cached_tile",
    "record_tile",
    "clear_cache",
    "cache_stats",
    "attention_cost_us",
    "linear_attention_cost_us",
    "autotune_attention",
]

ENV_VAR = "REPRO_AUTOTUNE_CACHE"

# one H100 SXM (roofline/analysis.py): the tensor cores' bf16 / fp16 rate
# (FP8 operands are widened to fp16 on load), float32 outside them (the
# GEMM kernels' fp32 route), TF32 (kernel 4's sweep) and HBM3
_PEAK = {"tensor": 989e12, "simt": 67e12}
_TF32_PEAK = 495e12
_HBM_BW = 3.35e12
# a fixed cost per block (prologue, copy-ring fill, epilogue), calibrated
# loosely: it only needs to penalise grids of needlessly many blocks
_BLOCK_OVERHEAD_S = 1.0e-6
# a fixed cost per chunk of the sequential sweep (kernel 4)
_CHUNK_OVERHEAD_S = 0.3e-6
# the measured mode reads weight copies past the 50 MB L2
_COLD_BYTES = 100 * 2 ** 20
_MAX_COPIES = 256
# cycles a second of torch.cuda._sleep's spin (at or above the H100's SM
# clock, so a wait lasts at least as long as asked)
_SLEEP_HZ = 2.0e9

_LRU_CAPACITY = 512


# --------------------------------------------------------------------- #
# Canonical keys
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AutotuneKey:
    """A canonicalized dispatch — the unit of autotune reuse.

    The reference's fields (bucketed m / n / k, dtypes, epilogue, backend,
    layout, ``fused_bwd``, ``depth``, per-operand storage ``xstore`` /
    ``wstore``, ``sweep``: "" for GEMMs, "attn" / "attnc" / "lattn" for the
    sweeps) and ``batch``, the launch's bucketed batch count (see the
    module docstring).  ``depth`` stays 2: the port's copy ring is fixed,
    so no entry tunes it."""

    m: int
    n: int
    k: int
    compute: str
    accum: str
    out: str
    epilogue: str      # "" when the GEMM has no fused epilogue
    backend: str
    layout: str = "nn"
    fused_bwd: bool = False
    depth: int = 2
    xstore: str = ""   # "" = same as compute (uniform-precision policies)
    wstore: str = ""
    sweep: str = ""    # "" = plain GEMM; "attn"/"attnc"/"lattn" = attention
    batch: int = 1

    def to_str(self) -> str:
        ep = self.epilogue or "none"
        base = (f"m{self.m}-n{self.n}-k{self.k}-{self.compute}-{self.accum}"
                f"-{self.out}-{ep}-{self.backend}")
        if self.layout != "nn":
            base = f"{base}-{self.layout}"
        if self.fused_bwd:
            base = f"{base}-fbwd"
        if self.depth != 2:
            base = f"{base}-d{self.depth}"
        if self.xstore:
            base = f"{base}-x{self.xstore}"
        if self.wstore:
            base = f"{base}-w{self.wstore}"
        if self.sweep:
            base = f"{base}-S{self.sweep}"
        if self.batch != 1:
            base = f"{base}-B{self.batch}"
        return base


def _parse_key(s: str) -> Optional[AutotuneKey]:
    """The key a :meth:`AutotuneKey.to_str` string names; None where the
    string is not one (a foreign or hand-mangled entry)."""
    parts = s.split("-")
    if len(parts) < 8:
        return None
    try:
        m, n, k = (int(p[1:]) for p, c in zip(parts[:3], "mnk") if p[:1] == c)
    except ValueError:
        return None
    compute, accum, out, ep, backend = parts[3:8]
    kw: Dict[str, object] = {}
    for p in parts[8:]:
        if p in ("nt", "tn"):
            kw["layout"] = p
        elif p == "fbwd":
            kw["fused_bwd"] = True
        elif p[:1] in ("d", "B") and p[1:].isdigit():
            kw["depth" if p[0] == "d" else "batch"] = int(p[1:])
        elif p[:1] in ("x", "w", "S") and len(p) > 1:
            kw[{"x": "xstore", "w": "wstore", "S": "sweep"}[p[0]]] = p[1:]
        else:
            return None
    return AutotuneKey(m=m, n=n, k=k, compute=compute, accum=accum, out=out,
                       epilogue="" if ep == "none" else ep, backend=backend,
                       **kw)


def bucket_dim(v: int) -> int:
    """Round a problem dim up to its bucket: the next power of two below
    512, then the next multiple of 512 (the reference's buckets)."""
    v = max(int(v), 1)
    if v >= 512:
        return -(-v // 512) * 512
    b = 1
    while b < v:
        b *= 2
    return b


def _store_name(dtype, compute) -> str:
    """Per-operand storage in the key: "" when the operand is stored in the
    compute dtype (the uniform-precision default)."""
    if dtype is None:
        return ""
    name = prec.dtype_name(dtype)
    return "" if name == prec.dtype_name(compute) else name


def canonical_key(
    m: int, n: int, k: int, *,
    policy: prec.Policy,
    backend: str,
    epilogue: Optional[str] = None,
    layout: str = "nn",
    fused_bwd: bool = False,
    x_dtype=None,
    w_dtype=None,
    sweep: str = "",
    batch: int = 1,
) -> AutotuneKey:
    return AutotuneKey(
        m=bucket_dim(m), n=bucket_dim(n), k=bucket_dim(k),
        compute=prec.dtype_name(policy.compute_dtype),
        accum=prec.dtype_name(policy.accum_dtype),
        out=prec.dtype_name(policy.out_dtype),
        epilogue=epilogue or "",
        backend=backend,
        layout=layout,
        fused_bwd=fused_bwd,
        xstore=_store_name(x_dtype, policy.compute_dtype),
        wstore=_store_name(w_dtype, policy.compute_dtype),
        sweep=sweep,
        batch=bucket_dim(batch),
    )


# --------------------------------------------------------------------- #
# What the kernels run
# --------------------------------------------------------------------- #
def _refusal(key: AutotuneKey, tile: tiling.TileConfig) -> Optional[str]:
    """Why the kernels cannot run ``tile`` under ``key``; None if they can."""
    from repro_torch.kernels.chunked_linear_attention import CHUNKS

    if key.sweep == "lattn":
        if not tile.bm == tile.bn == tile.bk or tile.bm not in CHUNKS:
            return f"kernel 4 runs the chunks {CHUNKS}"
        return "a sweep has no split" if tile.splits else None
    if key.sweep in ("attn", "attnc"):
        if (tile.bm, tile.bn) != (tiling.FLASH_BQ, tiling.FLASH_BKV):
            return (f"the flash kernel runs bq {tiling.FLASH_BQ}, bkv "
                    f"{tiling.FLASH_BKV}")
        return "a sweep has no split" if tile.splits else None
    if key.sweep:
        return f"unknown sweep {key.sweep!r}"
    try:
        tiling.tile_index(tile)
    except ValueError as e:
        return str(e)
    if tile.splits > 65535:
        return "more than 65535 slices"
    if key.fused_bwd and tile.splits > 1:
        return "a launch with the fused backward is never split"
    if key.accum == "float16" and tile.splits:
        return ("under the faithful fp16 accumulator the split is numerics "
                "(the heuristic's)")
    return None


# --------------------------------------------------------------------- #
# Two-level cache: in-process LRU over a JSON file (REPRO_AUTOTUNE_CACHE)
# --------------------------------------------------------------------- #
_lock = threading.Lock()
_lru: "collections.OrderedDict[str, tiling.TileConfig]" = collections.OrderedDict()
_disk_path: Optional[str] = None
_disk_mtime: Optional[float] = None
_hits = 0
_misses = 0
_evictions = 0


def _cache_path() -> Optional[str]:
    return os.environ.get(ENV_VAR) or None


def _port_backends() -> Tuple[str, ...]:
    from repro_torch.core import engine  # the engine resolves through here

    return engine.registered_backends()


def _load_disk_locked(path: str) -> None:
    """(Re)load the JSON cache into the LRU when the file is new or changed:
    the entries of the port's backends, each checked against what the
    kernels run (ValueError naming the file); other entries are skipped."""
    global _disk_path, _disk_mtime
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        _disk_path, _disk_mtime = path, None
        return
    if path == _disk_path and mtime == _disk_mtime:
        return
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        _disk_path, _disk_mtime = path, None
        return
    if not isinstance(data, dict):
        _disk_path, _disk_mtime = path, None
        return
    ours = _port_backends()
    for key_str, entry in data.items():
        key = _parse_key(key_str)
        if key is None or key.backend not in ours:
            continue
        try:
            t = tiling.TileConfig(bm=int(entry["bm"]), bn=int(entry["bn"]),
                                  bk=int(entry["bk"]),
                                  splits=int(entry.get("splits", 0)))
        except (KeyError, TypeError, ValueError, AttributeError):
            continue
        why = _refusal(key, t)
        if why:
            raise ValueError(f"{path}: autotune entry {key_str!r} names "
                             f"{t}, which the kernels do not run: {why}")
        _lru[key_str] = t
        _lru.move_to_end(key_str)
    # trimming an over-capacity *loaded* file is not working-set pressure:
    # only record_tile() insertions count toward the evictions counter
    while len(_lru) > _LRU_CAPACITY:
        _lru.popitem(last=False)
    _disk_path, _disk_mtime = path, mtime


def _write_disk_locked(path: str, key: AutotuneKey, tile: tiling.TileConfig,
                       *, source: str, us: Optional[float]) -> None:
    """Read-modify-write the JSON file atomically (tempfile + rename); every
    other entry, the reference's included, is written back as it was."""
    global _disk_path, _disk_mtime
    data: Dict[str, dict] = {}
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        pass
    if not isinstance(data, dict):
        data = {}
    entry = {"bm": tile.bm, "bn": tile.bn, "bk": tile.bk,
             "splits": tile.splits, "source": source}
    if us is not None:
        entry["us"] = round(float(us), 3)
    data[key.to_str()] = entry
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _disk_path, _disk_mtime = path, os.stat(path).st_mtime


def cached_tile(
    m: int, n: int, k: int, *,
    policy: prec.Policy,
    backend: str,
    epilogue: Optional[str] = None,
    layout: str = "nn",
    fused_bwd: bool = False,
    x_dtype=None,
    w_dtype=None,
    sweep: str = "",
    batch: int = 1,
) -> Optional[tiling.TileConfig]:
    """Cache-only lookup (LRU, then the JSON file).  Never tunes."""
    global _hits, _misses
    key = canonical_key(m, n, k, policy=policy, backend=backend,
                        epilogue=epilogue, layout=layout, fused_bwd=fused_bwd,
                        x_dtype=x_dtype, w_dtype=w_dtype, sweep=sweep,
                        batch=batch).to_str()
    with _lock:
        t = _lru.get(key)
        if t is None:
            path = _cache_path()
            if path:
                _load_disk_locked(path)
                t = _lru.get(key)
        if t is not None:
            _lru.move_to_end(key)
            _hits += 1
            return t
        _misses += 1
        return None


def record_tile(
    key: AutotuneKey, tile: tiling.TileConfig, *,
    source: str = "manual",
    us: Optional[float] = None,
) -> None:
    """Store a geometry under ``key`` — LRU write-through to the JSON file;
    ValueError for one the kernels do not run."""
    global _evictions
    why = _refusal(key, tile)
    if why:
        raise ValueError(f"cannot record {tile} under {key.to_str()!r}: {why}")
    with _lock:
        _lru[key.to_str()] = tile
        _lru.move_to_end(key.to_str())
        while len(_lru) > _LRU_CAPACITY:
            _lru.popitem(last=False)
            _evictions += 1
        path = _cache_path()
        if path:
            _write_disk_locked(path, key, tile, source=source, us=us)


def clear_cache(*, memory_only: bool = True) -> None:
    """Drop the in-process LRU (the JSON file is left alone unless
    ``memory_only=False``)."""
    global _disk_path, _disk_mtime, _hits, _misses, _evictions
    with _lock:
        _lru.clear()
        _disk_path = _disk_mtime = None
        _hits = _misses = _evictions = 0
        if not memory_only:
            path = _cache_path()
            if path and os.path.exists(path):
                os.unlink(path)


def cache_stats() -> Dict[str, int]:
    """In-process LRU observability: entry count plus hit / miss / evict
    counters since the last :func:`clear_cache`."""
    with _lock:
        return {"entries": len(_lru), "hits": _hits, "misses": _misses,
                "evictions": _evictions}


# --------------------------------------------------------------------- #
# Candidates
# --------------------------------------------------------------------- #
def _route(policy: prec.Policy) -> str:
    return "simt" if policy.compute_dtype == torch.float32 else "tensor"


def _accum_block(m: int, n: int, k: int, policy: prec.Policy, fused_bwd: bool,
                 x_dtype, w_dtype) -> int:
    if not policy.blockwise_accum:
        return 0
    return tiling.accum_block(m, n, k, compute_dtype=policy.compute_dtype,
                              accum_dtype=policy.accum_dtype,
                              fused_bwd=fused_bwd, x_dtype=x_dtype,
                              w_dtype=w_dtype)


def _heuristic(m: int, n: int, k: int, *, policy: prec.Policy, batch: int,
               fused_bwd: bool) -> tiling.TileConfig:
    """The heuristic's geometry with its split written out (0 where the
    split is the faithful accumulator's numerics)."""
    t = tiling.choose_tiles(m, n, k)
    if policy.blockwise_accum:
        return t
    plan = tiling.split_plan(m, n, k, tile=t, batch=batch, route=_route(policy),
                             fused_bwd=fused_bwd)
    return dataclasses.replace(t, splits=plan.splits)


def candidate_tiles(
    m: int, n: int, k: int, *,
    policy: prec.Policy,
    batch: int = 1,
    max_candidates: int = 64,
    fused_bwd: bool = False,
    x_dtype=None,
    w_dtype=None,
) -> List[tiling.TileConfig]:
    """The launch geometries of one GEMM: every menu tile with every S the
    kernel takes for this reduction (distinct plans only; S 1 alone with the
    fused backward; the heuristic's plan alone under a faithful
    accumulator), cheapest by :func:`predicted_cost_us` first, at most
    ``max_candidates`` — and always the heuristic's own pick."""
    from repro_torch.kernels.redmule_matmul import check_split

    route = _route(policy)
    heur = _heuristic(m, n, k, policy=policy, batch=batch, fused_bwd=fused_bwd)
    if policy.blockwise_accum:
        splits = [0]
    elif fused_bwd:
        splits = [1]
    else:
        plans = {}
        for s in range(1, tiling.MAX_SPLITS + 1):
            plan = tiling.plan_for_splits(n, s, route=route)
            try:
                check_split(plan, n, route=route)
            except ValueError:
                continue
            plans.setdefault(plan, plan.splits)
        splits = sorted(set(plans.values()))
    out = [dataclasses.replace(t, splits=s) for t in tiling.GEMM_TILES
           for s in splits]
    if heur not in out:
        out.append(heur)
    cost = lambda t: predicted_cost_us(m, n, k, t, policy=policy, batch=batch,
                                       fused_bwd=fused_bwd, x_dtype=x_dtype,
                                       w_dtype=w_dtype)
    out.sort(key=cost)
    out = out[:max(1, max_candidates)]
    if heur not in out:
        out[-1] = heur
    return out


# --------------------------------------------------------------------- #
# Scoring: the model (CPU) and the wall clock (the card)
# --------------------------------------------------------------------- #
def _itemsize(d, default: int) -> int:
    return default if d is None else prec.as_dtype(d).itemsize


def predicted_cost_us(
    m: int, n: int, k: int,
    tile: tiling.TileConfig, *,
    policy: prec.Policy,
    batch: int = 1,
    fused_bwd: bool = False,
    layout: str = "nn",
    bias_grad: bool = False,
    x_dtype=None,
    w_dtype=None,
) -> float:
    """Deterministic cost model of one GEMM launch on one H100, in µs.

    The launch runs ``ceil(m / bm) * ceil(k / bk) * batch`` output tiles
    times S slices (the plan :func:`tiling.launch_plan` gives ``tile``)
    as blocks, in waves of 132 (one block an SM at a time).  A block
    streams its X slab (bm x depth) and W slab (depth x bk) and writes its
    tile (fp32 when split) at 1/132 of the card's 3.35 TB/s, or computes
    its padded MACs at 1/132 of the route's peak (989 TFLOP/s on the
    tensor cores, 67 on the fp32 route), whichever is longer, plus a fixed
    cost per block.  A split adds the last block's fold: the S fp32
    partials read back.  So a launch that fills few SMs pays for the work
    each block does alone — the reference's tiny-grid penalty turned round
    — and a fine split pays in blocks and partials.  ``fused_bwd`` adds
    the derivative stream (shadowing dZ: the X slab on "nt", the W slab on
    "tn"), ``bias_grad`` the db row.  Per-operand storage ``x_dtype`` /
    ``w_dtype`` prices FP8 slabs at one byte an element."""
    route = _route(policy)
    blk = _accum_block(m, n, k, policy, fused_bwd or bias_grad, x_dtype, w_dtype)
    plan = tiling.launch_plan(m, n, k, tile=tile, batch=batch, accum_block=blk,
                              route=route, fused_bwd=fused_bwd or bias_grad)
    step = tiling.SPLIT_STEP[route]
    cb = policy.compute_dtype.itemsize
    ob = policy.out_dtype.itemsize
    ab = policy.accum_dtype.itemsize
    xb, wb = _itemsize(x_dtype, cb), _itemsize(w_dtype, cb)
    depth = tiling._round_up(max(plan.depth, 1), step)
    tiles = (-(-max(m, 1) // tile.bm)) * (-(-max(k, 1) // tile.bk)) * max(batch, 1)
    blocks = tiles * plan.splits
    waves = -(-blocks // tiling.NUM_SMS)
    block_bytes = (tile.bm * depth * xb + depth * tile.bk * wb
                   + tile.bm * tile.bk * (4 if plan.splits > 1 else ob))
    if fused_bwd:
        block_bytes += (depth * tile.bk if layout == "tn" else tile.bm * depth) * cb
    if bias_grad:
        block_bytes += tile.bk * ab
    block_flops = 2.0 * tile.bm * tile.bk * depth
    per_sm_bw = _HBM_BW / tiling.NUM_SMS
    per_sm_peak = _PEAK[route] / tiling.NUM_SMS
    block_s = max(block_bytes / per_sm_bw, block_flops / per_sm_peak)
    t = waves * (block_s + _BLOCK_OVERHEAD_S)
    if plan.splits > 1:
        t += plan.splits * batch * m * k * 4 / _HBM_BW
    return t * 1e6


def _card(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the kernel on the card, and "
                           "torch.cuda.is_available() is False; use the model "
                           "(mode='model') on the CPU")
    return torch.device("cuda")


def _cycled(make, n_bytes: int) -> List[torch.Tensor]:
    """Copies of one operand, enough to pass the L2 between two reads."""
    n = min(_MAX_COPIES, max(1, math.ceil(_COLD_BYTES / max(n_bytes, 1))))
    first = make()
    return [first] + [first.clone() for _ in range(n - 1)]


def _time_us(fn, warmup: int, iters: int) -> float:
    """Device time of one call of ``fn``, in µs: ``iters`` calls between two
    CUDA events, queued behind a device-side wait longer than the host
    takes to launch them all, so the events time the kernels back to back
    and not the host's launch path (a decode GEMM runs in less time than
    one Python launch takes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2.0 * iters * host_s, 1e-3) * _SLEEP_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def measured_cost_us(
    m: int, n: int, k: int,
    tile: tiling.TileConfig, *,
    policy: prec.Policy,
    batch: int = 1,
    epilogue: Optional[str] = None,
    with_bias: bool = False,
    layout: str = "nn",
    fused_bwd: bool = False,
    grad_epilogue: Optional[str] = None,
    bias_grad: bool = False,
    x_dtype=None,
    w_dtype=None,
    warmup: int = 3,
    iters: int = 20,
) -> float:
    """One launch of the public wrapper (``ops.redmule_matmul``, or
    ``ops.redmule_matmul_batched`` at ``batch`` > 1) with ``tile``, timed
    with CUDA events on the card, in µs.  Each call reads the next of
    several copies of the weight (more than the 50 MB L2 holds), so a
    decode-shaped GEMM is timed with its weights cold, as a serving step
    finds them.  ``fused_bwd`` times the fused backward (a random
    derivative, ``grad_epilogue`` default "gelu", and db with
    ``bias_grad`` on "tn"; output in the accumulator dtype).  Raises
    without a card."""
    from repro_torch.kernels import ops

    dev = _card("measured_cost_us")
    g = torch.Generator(device=dev).manual_seed(0)
    lead = (batch,) if batch > 1 else ()
    x_shape = (*lead, n, m) if layout == "tn" else (*lead, m, n)
    w_shape = (*lead, k, n) if layout == "nt" else (*lead, n, k)

    def rnd(shape, dtype, scale=1.0):
        v = torch.randn(shape, generator=g, device=dev) * scale
        return prec.quantize_fp8(v, dtype)[0] if prec.is_fp8(dtype) else v.to(dtype)

    cd = policy.compute_dtype
    x = rnd(x_shape, x_dtype or cd)
    ws = _cycled(lambda: rnd(w_shape, w_dtype or cd, n ** -0.5),
                 math.prod(w_shape) * _itemsize(w_dtype, cd.itemsize))
    kw = dict(tile=tile, layout=layout, epilogue=epilogue,
              bias=rnd((k,), policy.accum_dtype) if with_bias else None)
    if fused_bwd:
        policy = dataclasses.replace(policy, output_dtype=policy.accum_dtype)
        kw.update(grad_epilogue=grad_epilogue or "gelu", bias_grad=bias_grad,
                  deriv=rnd(x_shape if layout == "nt" else w_shape, cd))
    fn = ops.redmule_matmul_batched if lead else ops.redmule_matmul
    nxt = itertools.cycle(ws).__next__
    return _time_us(lambda: fn(x, nxt(), policy=policy, **kw), warmup, iters)


# --------------------------------------------------------------------- #
# The tuner
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    key: AutotuneKey
    tile: tiling.TileConfig
    us: float            # winning score (wall-clock µs or model µs)
    source: str          # "measured" | "model"
    n_candidates: int
    scores: Tuple[Tuple[Tuple[int, int, int, int], float], ...] = ()
    heuristic: Optional[tiling.TileConfig] = None   # the heuristic's pick


def _mode(mode: Optional[str]) -> str:
    if mode is None:
        mode = "measured" if torch.cuda.is_available() else "model"
    if mode not in ("measured", "model"):
        raise ValueError(f"unknown autotune mode {mode!r}")
    return mode


def _geom(t: tiling.TileConfig) -> Tuple[int, int, int, int]:
    return (t.bm, t.bn, t.bk, t.splits)


def autotune_gemm(
    m: int, n: int, k: int, *,
    policy=None,
    backend: str = "hopper",
    batch: int = 1,
    epilogue: Optional[str] = None,
    with_bias: bool = False,
    layout: str = "nn",
    fused_bwd: bool = False,
    bias_grad: bool = False,
    max_candidates: int = 64,
    mode: Optional[str] = None,
    record: bool = True,
    x_dtype=None,
    w_dtype=None,
) -> AutotuneResult:
    """Tune one GEMM launch and (by default) record the winner.

    ``m`` / ``n`` / ``k`` / ``batch`` are the launch's own: a 2D-weight
    dispatch folds its leading dims into ``m`` (as the engine keys it).
    ``mode``: "measured" times each candidate on the card, "model" scores
    it with :func:`predicted_cost_us`; None picks "measured" exactly when
    a card is present.  ``layout`` / ``fused_bwd`` / ``bias_grad`` tune
    the backward's launches."""
    policy = prec.resolve(policy)
    mode = _mode(mode)
    heur = _heuristic(m, n, k, policy=policy, batch=batch,
                      fused_bwd=fused_bwd or bias_grad)
    cands = candidate_tiles(m, n, k, policy=policy, batch=batch,
                            max_candidates=max_candidates,
                            fused_bwd=fused_bwd or bias_grad,
                            x_dtype=x_dtype, w_dtype=w_dtype)
    scores: List[Tuple[Tuple[int, int, int, int], float]] = []
    best: Optional[tiling.TileConfig] = None
    best_us = float("inf")
    for t in cands:
        if mode == "measured":
            us = measured_cost_us(m, n, k, t, policy=policy, batch=batch,
                                  epilogue=epilogue, with_bias=with_bias,
                                  layout=layout, fused_bwd=fused_bwd,
                                  bias_grad=bias_grad, x_dtype=x_dtype,
                                  w_dtype=w_dtype)
        else:
            us = predicted_cost_us(m, n, k, t, policy=policy, batch=batch,
                                   fused_bwd=fused_bwd, layout=layout,
                                   bias_grad=bias_grad, x_dtype=x_dtype,
                                   w_dtype=w_dtype)
        scores.append((_geom(t), us))
        if us < best_us:
            best, best_us = t, us
    key = canonical_key(m, n, k, policy=policy, backend=backend,
                        epilogue=epilogue, layout=layout,
                        fused_bwd=fused_bwd, x_dtype=x_dtype, w_dtype=w_dtype,
                        batch=batch)
    if record:
        record_tile(key, best, source=mode, us=best_us)
    return AutotuneResult(key=key, tile=best, us=best_us, source=mode,
                          n_candidates=len(cands), scores=tuple(scores),
                          heuristic=heur)


# --------------------------------------------------------------------- #
# Sweep tuning (the engine's "attention" capability)
# --------------------------------------------------------------------- #
def attention_cost_us(
    s: int, t: int, d: int, bq: int, bkv: int, *,
    policy: prec.Policy,
    causal: bool = True,
    batch: int = 1,
) -> float:
    """Cost model of one flash sweep over ``batch`` heads, in µs: a block
    per q tile (132 at a time), each streaming K and V once per executed
    block pair (causally dead pairs are skipped) at 1/132 of the card's
    bandwidth, or computing their two GEMMs at 1/132 of its peak, plus a
    fixed cost per block."""
    cb = policy.compute_dtype.itemsize
    route = _route(policy)
    pairs = tiling.attn_pairs(s, t, bq, bkv, causal=causal)
    q_tiles = -(-max(int(s), 1) // bq)
    blocks = batch * q_tiles
    flops = batch * pairs * 4.0 * bq * bkv * d
    hbm = batch * (2 * q_tiles * bq * d + pairs * 2 * bkv * d) * cb
    block_s = max(hbm / blocks / (_HBM_BW / tiling.NUM_SMS),
                  flops / blocks / (_PEAK[route] / tiling.NUM_SMS))
    return -(-blocks // tiling.NUM_SMS) * (block_s + _BLOCK_OVERHEAD_S) * 1e6


def linear_attention_cost_us(
    s: int, dk: int, dv: int, chunk: int, *,
    policy: prec.Policy,
    batch: int = 1,
) -> float:
    """Cost model of one chunked sweep over ``batch`` heads, in µs: the
    sweep's blocks (one per head and 32 columns of v, 132 at a time) walk
    the padded sequence's chunks one after another, each chunk's four
    GEMMs on the TF32 tensor cores at 1/132 of their peak or its q / k /
    v / out traffic at 1/132 of the bandwidth, plus a fixed cost per
    chunk; the state is stored once."""
    cb = policy.compute_dtype.itemsize
    nc = -(-max(int(s), 1) // chunk)
    tv = 32
    blocks = batch * -(-dv // tv)
    chunk_flops = 2.0 * chunk * (chunk * dk + chunk * tv + 2 * dk * tv)
    chunk_bytes = chunk * (2 * dk + 2 * tv) * cb + chunk * 4
    chunk_s = max(chunk_bytes / (_HBM_BW / tiling.NUM_SMS),
                  chunk_flops / (_TF32_PEAK / tiling.NUM_SMS))
    waves = -(-blocks // tiling.NUM_SMS)
    state_s = batch * dk * dv * 4 / _HBM_BW
    return (waves * nc * (chunk_s + _CHUNK_OVERHEAD_S) + state_s) * 1e6


def _sweep_measured(kind: str, s: int, t: int, d: int, geom: int, *,
                    policy: prec.Policy, causal: bool, batch: int,
                    warmup: int = 3, iters: int = 20) -> float:
    """One launch of the sweep's public wrapper on the card, in µs."""
    from repro_torch.kernels import chunked_linear_attention as cla
    from repro_torch.kernels import flash_attention as fa

    dev = _card("autotune_attention")
    g = torch.Generator(device=dev).manual_seed(0)
    dt = policy.compute_dtype
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dt)
    if kind == "attention":
        q, kk, v = rnd(batch, s, d), rnd(batch, t, d), rnd(batch, t, d)
        return _time_us(lambda: fa.flash_attention(q, kk, v, causal=causal),
                        warmup, iters)
    sp = tiling._round_up(max(int(s), 1), geom)
    q, kk, v = rnd(batch, sp, t) * t ** -0.5, rnd(batch, sp, t), rnd(batch, sp, d)
    log_g = -torch.rand((batch, sp), generator=g, device=dev) * 0.1
    return _time_us(lambda: cla.chunked_linear_attention(q, kk, v, log_g,
                                                         chunk=geom),
                    warmup, iters)


def autotune_attention(
    s: int, t: int, d: int, *,
    policy=None,
    backend: str = "hopper",
    kind: str = "attention",
    causal: bool = True,
    batch: int = 1,
    mode: Optional[str] = None,
    record: bool = True,
) -> AutotuneResult:
    """Tune a sweep geometry and record it under its sweep key.

    ``kind="attention"``: the flash kernel (``t`` the KV length, ``d`` the
    head dim) is compiled for one block pair, (``FLASH_BQ``,
    ``FLASH_BKV``), so its key has that one candidate.
    ``kind="linear_attention"``: kernel 4's chunk over ``CHUNKS`` up to the
    padded sequence (``t`` is dk, ``d`` dv); the key's policy is fp32, as
    the engine looks it up, and ``policy`` only sets the operands' dtype
    when measuring.  The stored :class:`~repro_torch.core.tiling.TileConfig`
    encodes the sweep: ``bm=bq, bn=bkv`` (flash) or ``bm=bn=bk=chunk``."""
    from repro_torch.kernels.chunked_linear_attention import CHUNKS

    policy = prec.resolve(policy)
    mode = _mode(mode)
    if kind == "attention":
        sweep, key_policy = ("attnc" if causal else "attn"), policy
        geoms = [(tiling.FLASH_BQ, tiling.FLASH_BKV)]
        heur = tiling.TileConfig(bm=tiling.FLASH_BQ, bn=tiling.FLASH_BKV,
                                 bk=tiling.FLASH_BKV)
    elif kind == "linear_attention":
        sweep, key_policy = "lattn", prec.FP32
        geoms = [(c, c) for c in CHUNKS
                 if c <= tiling._round_up(max(int(s), 1), CHUNKS[0])]
        c = tiling.SWEEP_CHUNK
        heur = tiling.TileConfig(bm=c, bn=c, bk=c)
    else:
        raise ValueError(f"unknown attention kind {kind!r}")
    scores: List[Tuple[Tuple[int, int, int, int], float]] = []
    best: Optional[tiling.TileConfig] = None
    best_us = float("inf")
    for a, b in geoms:
        tile = tiling.TileConfig(bm=a, bn=b, bk=b)
        if mode == "measured":
            us = _sweep_measured(kind, s, t, d, a, policy=policy, causal=causal,
                                 batch=batch)
        elif kind == "attention":
            us = attention_cost_us(s, t, d, a, b, policy=policy, causal=causal,
                                   batch=batch)
        else:
            us = linear_attention_cost_us(s, t, d, a, policy=policy, batch=batch)
        scores.append((_geom(tile), us))
        if us < best_us:
            best, best_us = tile, us
    if best is None:
        raise ValueError(f"no sweep candidates for S = {s}")
    key = canonical_key(s, t, d, policy=key_policy, backend=backend,
                        sweep=sweep, batch=batch if kind != "attention" else 1)
    if record:
        record_tile(key, best, source=mode, us=best_us)
    return AutotuneResult(key=key, tile=best, us=best_us, source=mode,
                          n_candidates=len(scores), scores=tuple(scores),
                          heuristic=heur)
