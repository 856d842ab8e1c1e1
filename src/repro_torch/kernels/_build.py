"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/lib<name>-<digest>.so`` at the repository root
(``.gitignore`` lists ``build/``), with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v --split-compile=0

and is loaded with ``ctypes``.  ``--split-compile=0`` runs the device
optimiser's passes on every host core: ``redmule_matmul.cu`` builds in
about 42 s instead of 106 and the sweep in 20 instead of 41 on the H100's
8-core host.  The SASS of every function but two fp32-route GEMM
instantiations is identical, and the file's floating-point opcode counts
are equal in sum, not in those two functions
(``tools/nvcc_split_probe.sh``); ``tools/split_compile_ab.py`` runs the
fp32-route rows on both builds in one process, holds their outputs
bitwise equal and times them.  The digest covers the
source and the flags, so an edited source never reuses a stale library.
All sources build in parallel, one ``nvcc`` each, started together.
Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("redmule_matmul", "flash_attention", "chunked_linear_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper kernels "
            "are built from src/repro_torch/csrc at first use on the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns ``{name: {"seconds": wall time or 0.0 if already built,
    "ptxas": the compiler's register/shared-memory report}}``; raises
    RuntimeError with the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if p.returncode != 0:
            failed.append(f"--- {name} (exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
