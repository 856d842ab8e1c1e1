"""Repo-invariant lint over the port: ``python -m repro_torch.analysis.lint``.

Counterpart of ``repro.analysis.lint``, pointed at ``src/repro_torch``.
AST rules the engine depends on, checked without importing the code:

* **models-gemm** — no raw contraction in ``repro_torch/models/``: the
  ``torch.`` / ``F.`` contraction calls (``matmul``, ``mm``, ``bmm``,
  ``einsum``, ``tensordot``, ``linear``, ``scaled_dot_product_attention``,
  ...), the ``.mm`` / ``.bmm`` / ``.matmul`` methods of anything but the
  engine, and the ``@`` operator bypass the engine's events, policies and
  autotuned tiles.  Known sites would live in the manifest's ``"ast"``
  list, matched by ``(file, call, equation)``; new sites and stale
  entries both fail;
* **os-exit** — ``os._exit`` only in ``runtime/fault_tolerance.py`` and
  ``runtime/elastic.py`` (the fault-injection kill sites);
* **spec-mutation** — no ``object.__setattr__`` outside a class's own
  ``__post_init__`` and no assignment to a ``GemmSpec`` field of a
  ``*spec`` name: the spec is frozen, its identity is the event's;
* **module-collector** — no module-level mutable named like an event
  collector: instrumentation state is ``engine.instrument``'s
  thread-local.

And the shipped artifacts:

* autotune cache JSONs — every port-backend entry's tile is one the
  kernels run (``core/autotune.py::_refusal``) within the H100's shared
  memory budget (``core/tiling.py::SMEM_BUDGET``); the reference's
  entries are skipped, as the cache skips them;
* ``benchmarks/baselines/*.json`` (read, never written) — the flop
  identities, the serving KV bytes re-derived with
  ``serving.kv_cache.decode_step_kv_bytes`` and the wire bytes with the
  port's compressor;
* the manifest's form.
"""

from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import sys
from typing import Any, Dict, List, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.abspath(os.path.join(_HERE, *[os.pardir] * 3))
_SRC_ROOT = os.path.join(_REPO_ROOT, "src", "repro_torch")
DEFAULT_MANIFEST = os.path.join(_HERE, "engine_escapes.json")
BASELINES = os.path.join(_REPO_ROOT, "benchmarks", "baselines")

# calls that contract tensors without going through the engine
_GEMM_ATTRS = {"matmul", "mm", "bmm", "einsum", "tensordot", "dot", "vdot",
               "inner", "mv", "addmm", "addbmm", "baddbmm", "addmv",
               "chain_matmul", "linear", "bilinear", "_scaled_mm",
               "scaled_dot_product_attention", "conv1d", "conv2d", "conv3d"}
_GEMM_MODULES = {"torch", "F", "nn", "functional"}
_GEMM_METHODS = {"mm", "bmm", "matmul"}
_OS_EXIT_ALLOWED = {
    os.path.join("runtime", "fault_tolerance.py"),
    os.path.join("runtime", "elastic.py"),
}
# the frozen GemmSpec's fields, kept literal so the lint imports nothing;
# tests/test_torch_analysis.py fails when the dataclass drifts
_GEMMSPEC_FIELDS = {
    "op", "tag", "m", "n", "k", "batch", "groups", "policy", "tile",
    "epilogue", "w_shared", "layout", "valid_rows", "ragged_dim", "io_bytes",
    "grad_epilogue", "grad_mode", "fused_bwd", "fused_bias_grad",
    "x_dtype", "w_dtype", "scaled", "accum_block",
}


class Violation(Tuple[str, int, str, str]):
    """(file, line, rule, message) — a plain tuple with a formatter."""

    def __str__(self) -> str:
        f, line, rule, msg = self
        return f"{f}:{line}: [{rule}] {msg}"


def _rel(path: str) -> str:
    return os.path.relpath(path, _REPO_ROOT)


def _v(path: str, line: int, rule: str, msg: str) -> Violation:
    return Violation((_rel(path), line, rule, msg))


def _dotted(node: ast.AST) -> str:
    """'torch.einsum' for Attribute(Name('torch'), 'einsum'), '' otherwise
    (a call on a call's result keeps only the attribute chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("")
    return ".".join(reversed(parts))


def _einsum_equation(call: ast.Call) -> str:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return ""


# --------------------------------------------------------------------- #
# AST rules
# --------------------------------------------------------------------- #
def _find_gemm_calls(path: str, tree: ast.Module) -> List[Dict[str, Any]]:
    found: List[Dict[str, Any]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            found.append({"file": _rel(path), "call": "@", "equation": "",
                          "line": node.lineno})
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            name = _dotted(node.func)
            head, _, attr = name.rpartition(".")
            root = head.split(".")[0]
            if attr in _GEMM_ATTRS and root in _GEMM_MODULES:
                call = f"{head.split('.')[-1]}.{attr}"
            elif attr in _GEMM_METHODS and root not in _GEMM_MODULES | {"engine"}:
                call = f".{attr}"
            else:
                continue
            found.append({"file": _rel(path), "call": call,
                          "equation": _einsum_equation(node) if attr == "einsum" else "",
                          "line": node.lineno})
    return found


def _check_os_exit(path: str, tree: ast.Module, src_root: str) -> List[Violation]:
    if os.path.relpath(path, src_root) in _OS_EXIT_ALLOWED:
        return []
    return [
        _v(path, node.lineno, "os-exit",
           "os._exit outside runtime/fault_tolerance.py / runtime/elastic.py — "
           "hard death elsewhere skips flush / atexit and corrupts checkpoints "
           "outside the torn-write recovery path")
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and _dotted(node.func) == "os._exit"]


def _check_spec_mutation(path: str, tree: ast.Module) -> List[Violation]:
    # the one legitimate frozen-dataclass escape hatch: a class normalizing
    # ITSELF in __post_init__ via object.__setattr__(self, ...)
    post_init_ok = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == "__post_init__":
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and _dotted(node.func) == "object.__setattr__"
                        and node.args and isinstance(node.args[0], ast.Name)
                        and node.args[0].id == "self"):
                    post_init_ok.add(id(node))
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted(node.func) == "object.__setattr__" \
                and id(node) not in post_init_ok:
            out.append(_v(path, node.lineno, "spec-mutation",
                          "object.__setattr__ outside __post_init__(self) defeats "
                          "frozen dataclasses (a GemmSpec is its event's identity)"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                        and t.value.id.lower().endswith("spec")
                        and t.attr in _GEMMSPEC_FIELDS):
                    out.append(_v(path, node.lineno, "spec-mutation",
                                  f"assignment to {t.value.id}.{t.attr} — GemmSpec "
                                  f"is frozen; build a new one with "
                                  f"dataclasses.replace"))
    return out


def _check_module_collectors(path: str, tree: ast.Module) -> List[Violation]:
    """Instrumentation state must be thread-local: a module-global mutable
    named like an event sink is shared across threads (autograd's device
    threads among them)."""
    out: List[Violation] = []
    mutable_calls = {"list", "dict", "set", "defaultdict", "deque",
                     "OrderedDict", "Counter"}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set)) or (
            isinstance(value, ast.Call)
            and _dotted(value.func).split(".")[-1] in mutable_calls)
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and any(
                    w in t.id.lower() for w in ("event", "collector")):
                out.append(_v(path, node.lineno, "module-collector",
                              f"module-level mutable {t.id!r} looks like an event "
                              f"collector — instrumentation state lives in "
                              f"engine.instrument's threading.local"))
    return out


def lint_sources(src_root: str = "",
                 manifest_path: str = DEFAULT_MANIFEST) -> List[Violation]:
    src_root = src_root or _SRC_ROOT
    with open(manifest_path) as fh:
        manifest_ast = json.load(fh).get("ast", [])
    allowed = {(e["file"], e["call"], e.get("equation", "")): int(e.get("count", 1))
               for e in manifest_ast}
    violations: List[Violation] = []
    gemm_sites: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(src_root, "**", "*.py"),
                                 recursive=True)):
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        violations += _check_os_exit(path, tree, src_root)
        violations += _check_spec_mutation(path, tree)
        violations += _check_module_collectors(path, tree)
        if os.path.relpath(path, src_root).split(os.sep)[0] == "models":
            gemm_sites += _find_gemm_calls(path, tree)

    # the raw-GEMM ratchet: group the sites, diff against the manifest
    found: Dict[Tuple[str, str, str], List[int]] = {}
    for s in gemm_sites:
        found.setdefault((s["file"], s["call"], s["equation"]), []).append(s["line"])
    for key, lines in sorted(found.items()):
        have = allowed.get(key, 0)
        if len(lines) > have:
            f, call, eq = key
            eqs = f" ({eq!r})" if eq else ""
            violations.append(Violation((
                f, lines[0], "models-gemm",
                f"raw {call}{eqs} x{len(lines)} at line(s) {lines} but the "
                f"manifest allows {have} — route it through the engine "
                f"(engine.matmul / einsum2d / attention) or, exceptionally, add "
                f"a manifest entry with a note")))
    for key, have in sorted(allowed.items()):
        got = len(found.get(key, []))
        if got < have:
            f, call, eq = key
            violations.append(Violation((
                f, 0, "models-gemm",
                f"STALE manifest entry: {call} {eq!r} ({got}/{have} observed) — "
                f"the escape was fixed, delete it from engine_escapes.json")))
    return violations


# --------------------------------------------------------------------- #
# Artifact validation
# --------------------------------------------------------------------- #
def validate_autotune_cache(path: str) -> List[Violation]:
    """Every port-backend entry's tile must be one the kernels run under
    the flags of its own key, within the H100's shared-memory budget."""
    from repro_torch.core import autotune, engine, tiling
    from repro_torch.core import precision as prec

    try:
        with open(path) as fh:
            cache = json.load(fh)
    except (OSError, ValueError) as e:
        return [_v(path, 0, "autotune-cache", f"unreadable cache: {e}")]
    if not isinstance(cache, dict):
        return [_v(path, 0, "autotune-cache", "the cache is not a JSON object")]
    ours = engine.registered_backends()
    out: List[Violation] = []
    for key_str, entry in sorted(cache.items()):
        if key_str.startswith("_"):
            continue
        key = autotune._parse_key(key_str)
        if key is None:
            out.append(_v(path, 0, "autotune-cache", f"unparseable key {key_str!r}"))
            continue
        if key.backend not in ours:
            continue            # the reference's entries: skipped and kept
        try:
            tile = tiling.TileConfig(bm=int(entry["bm"]), bn=int(entry["bn"]),
                                     bk=int(entry["bk"]),
                                     splits=int(entry.get("splits", 0)))
        except (KeyError, TypeError, ValueError) as e:
            out.append(_v(path, 0, "autotune-cache",
                          f"{key_str!r}: malformed entry ({e})"))
            continue
        why = autotune._refusal(key, tile)
        if why is None and not key.sweep:
            need = tiling.smem_bytes(tile, prec.as_dtype(key.compute))
            if need > tiling.SMEM_BUDGET:
                why = (f"needs {need} B of shared memory, over the "
                       f"{tiling.SMEM_BUDGET} B budget")
        if why:
            out.append(_v(path, 0, "autotune-cache",
                          f"{key_str!r}: tile ({tile.bm}, {tile.bn}, {tile.bk}, "
                          f"splits {tile.splits}) — {why}; this cache was tuned "
                          f"for another kernel geometry"))
    return out


def _load(base_dir: str, name: str) -> Any:
    with open(os.path.join(base_dir, name)) as fh:
        return json.load(fh)


def validate_baselines(base_dir: str = "") -> List[Violation]:
    """The shipped baseline JSONs against the identities they are derived
    from, re-derived with the port's own formulas."""
    from repro_torch import configs
    from repro_torch.core import engine
    from repro_torch.models import autoencoder, transformer
    from repro_torch.optim import compression
    from repro_torch.serving import kv_cache

    base_dir = base_dir or BASELINES
    out: List[Violation] = []

    def bad(name: str, msg: str) -> None:
        out.append(_v(os.path.join(base_dir, name), 0, "baseline", msg))

    eng = _load(base_dir, "engine_flops.json")
    for k, v in eng.items():
        if not k.startswith("_") and (not isinstance(v, int) or v <= 0):
            bad("engine_flops.json", f"{k}: non-positive flops {v!r}")
    if not (eng["attn_flash_fwd_B2_H4_S256_D64_causal"]
            < eng["attn_flash_fwd_B2_H4_S256_D64_dense"]):
        bad("engine_flops.json", "causal attention flops not below dense at the "
            "same geometry (causally dead KV blocks are not billed)")
    dims = autoencoder.AE_DIMS
    ae_fwd = sum(engine.GemmSpec(op="linear", tag="mn,nk->mk", m=16, n=a, k=b).flops
                 for a, b in zip(dims[:-1], dims[1:]))
    if eng["ae_fwd_B16"] != ae_fwd:
        bad("engine_flops.json", f"ae_fwd_B16 {eng['ae_fwd_B16']} != the port's "
            f"GemmSpec bill of the AutoEncoder at batch 16, {ae_fwd}")

    tr = _load(base_dir, "train_flops.json")["ae_train_B16"]
    if tr["total"] != tr["fwd"] + tr["bwd"]:
        bad("train_flops.json", "total != fwd + bwd")
    if tr["bwd"] != 2 * tr["fwd"]:
        bad("train_flops.json", "bwd != 2*fwd (pure-GEMM model: dX + dW per layer)")
    if tr["fwd"] != eng["ae_fwd_B16"]:
        bad("train_flops.json", "train fwd != engine_flops.json ae_fwd_B16")

    tb = _load(base_dir, "train_bytes.json")
    fused, two = tb["ae_train_B16"]["fused"], tb["ae_train_B16"]["two_pass"]
    if not fused["bwd"] < two["bwd"]:
        bad("train_bytes.json", "fused bwd bytes not below two-pass")
    fp8 = tb["ae_train_fp8"]
    if not fp8["total"] < fp8["fp16_total"]:
        bad("train_bytes.json", "FP8 train bytes not below FP16")
    if fp8["engine_flops"] != tr["total"]:
        bad("train_bytes.json", "FP8 trace flops != FP16 train total (narrower "
            "storage drops bytes, never flops)")
    attn = tb["attn_fwd_B2_H4_S96_D16"]
    if not attn["kernel"]["bytes"] < attn["reference"]["bytes"]:
        bad("train_bytes.json", "attention kernel bytes not below the composition")
    if not attn["kernel"]["flops"] < attn["reference"]["flops"]:
        bad("train_bytes.json", "causal attention kernel flops not below the "
            "dense composition")

    sv = _load(base_dir, "serve_bytes.json")
    for arch in ("yi-9b", "deepseek-moe-16b"):
        cfg = configs.get_reduced(arch)
        for key, storage in (("fp16_bytes", None), ("fp8_bytes", "float8_e4m3fn")):
            want = kv_cache.decode_step_kv_bytes(cfg, sv["lengths"], storage)
            if sv[arch][key] != want:
                bad("serve_bytes.json", f"{arch}: {key} {sv[arch][key]} != the "
                    f"port's decode_step_kv_bytes {want}")
        if not sv[arch]["fp8_bytes"] < sv[arch]["fp16_bytes"]:
            bad("serve_bytes.json", f"{arch}: fp8 not below fp16")

    cb = _load(base_dir, "collective_bytes.json")
    co = cb["collective_bytes"]
    tree = transformer.abstract_params(configs.get_reduced(cb["arch"]))
    for kind, got in co.items():    # "fp32" is the uncompressed wire
        want = compression.collective_wire_bytes(
            "none" if kind == "fp32" else kind, tree)
        if got != want:
            bad("collective_bytes.json", f"{kind}: {got} != the port's "
                f"compressor's wire bytes {want}")
    if not co["fp8_e4m3"] < co["fp16"] < co["fp32"]:
        bad("collective_bytes.json", "wire bytes not ordered fp8 < fp16 < fp32")
    return out


def validate_escape_manifest(path: str = DEFAULT_MANIFEST) -> List[Violation]:
    from repro_torch.analysis import entries
    from repro_torch.core import engine

    try:
        with open(path) as fh:
            m = json.load(fh)
    except (OSError, ValueError) as e:
        return [_v(path, 0, "manifest", f"unreadable manifest: {e}")]
    out: List[Violation] = []
    for e in m.get("ast", []):
        if not os.path.exists(os.path.join(_REPO_ROOT, e.get("file", ""))):
            out.append(_v(path, 0, "manifest",
                          f"ast entry names missing file {e.get('file')!r}"))
    for name, escapes in m.get("aten", {}).items():
        if name not in entries.ENTRY_POINTS:
            out.append(_v(path, 0, "manifest", f"aten section names unknown "
                          f"entry {name!r}"))
        for e in escapes:
            if "fingerprint" not in e or int(e.get("count", 0)) <= 0:
                out.append(_v(path, 0, "manifest",
                              f"aten entry {name}: malformed {e!r}"))
    for e in m.get("dtype", []):
        if (e.get("entry") not in entries.ENTRY_POINTS
                or e.get("backend") not in engine.registered_backends()
                or not str(e.get("key", "")).startswith("[")
                or int(e.get("count", 0)) <= 0 or not e.get("note")):
            out.append(_v(path, 0, "manifest", f"dtype entry malformed (entry, "
                          f"backend, key, count > 0 and a note): {e!r}"))
    return out


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--manifest", default=DEFAULT_MANIFEST)
    ap.add_argument("--autotune-cache", action="append", default=[],
                    metavar="PATH", help="autotune cache JSON(s) to validate "
                    "(repeatable)")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="AST rules only (skip baseline / cache validation)")
    args = ap.parse_args(argv)

    violations = lint_sources(manifest_path=args.manifest)
    if not args.no_artifacts:
        violations += validate_escape_manifest(args.manifest)
        violations += validate_baselines()
        for path in args.autotune_cache:
            violations += validate_autotune_cache(path)
    for v in violations:
        print(str(v), file=sys.stderr)
    if violations:
        print(f"[lint] FAIL — {len(violations)} violation(s)", file=sys.stderr)
        return 1
    print("[lint] OK — port invariants and shipped artifacts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
