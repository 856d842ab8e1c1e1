"""Data-parallel process groups: one OS process per rank, gloo between them.

The port's counterpart of ``repro.runtime.compat.make_mesh`` for a data
axis (the reference simulates N hosts as N XLA devices in one process).
:func:`spawn` starts N copies of a module's command line with the rank,
the world size and a ``file://`` rendezvous in the environment, and each
copy calls :func:`init_group`.  The rendezvous file lives in a fresh
directory (the run's own, else the temporary directory), so concurrent
runs never share a port or a store.

The launcher reaps its ranks: when one exits with a non-zero code the
others are killed and the launcher returns that code (an injected ``die``
gives 13); a SIGTERM to the launcher is forwarded to every rank (the
preemption path: each drains into a checkpoint and exits 0).  Rank 0
keeps the launcher's standard output; the others' is dropped, their
standard error kept.

On one card every rank runs on ``cuda:0``: NCCL refuses two ranks on one
device, so the group is gloo, and its reductions run on host copies
(``optim.compression.all_reduce_sum``, :func:`gather_to_rank0`).  The
group's timeout (``GROUP_TIMEOUT_S``) bounds a collective's wait for a lost
peer; a dead rank is usually caught first by the launcher.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["spawn", "rank_env", "init_group", "finish", "rank", "world",
           "barrier", "gather_to_rank0", "agree_any", "GROUP_TIMEOUT_S"]

ENV_RANK, ENV_WORLD, ENV_STORE = "REPRO_DP_RANK", "REPRO_DP_WORLD", "REPRO_DP_STORE"
# a rank waits this long in a collective: long enough for rank 0 to write a
# full-width checkpoint while its peer waits in the next step's reduce
GROUP_TIMEOUT_S = 300
_SRC = str(Path(__file__).resolve().parents[2])


def rank_env() -> Optional[tuple]:
    """``(rank, world, store)`` when this process is a spawned rank."""
    if ENV_RANK not in os.environ:
        return None
    return (int(os.environ[ENV_RANK]), int(os.environ[ENV_WORLD]),
            os.environ[ENV_STORE])


def spawn(n: int, argv: Sequence[str], *, run_dir: Optional[str] = None,
          stdout=None, timeout: Optional[float] = None) -> int:
    """Run ``python *argv`` as ``n`` ranks and wait for them; returns 0
    when every rank exits 0, else the first failing rank's code (a rank
    killed by signal ``s`` gives ``128 + s``; ranks still running after
    ``timeout`` seconds are killed and give 124).  Rank 0 writes to
    ``stdout`` (a file) when given, else to this process's output."""
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="dp_store_", dir=run_dir or None)
    env0 = dict(os.environ)
    env0["PYTHONPATH"] = os.pathsep.join(
        p for p in (_SRC, env0.get("PYTHONPATH", "")) if p)
    procs: List[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    # a signal handler can only be set from the main thread
    main = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, forward) if main else None
    try:
        for r in range(n):
            env = {**env0, ENV_RANK: str(r), ENV_WORLD: str(n),
                   ENV_STORE: os.path.join(store_dir, "store")}
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=env,
                stdout=stdout if r == 0 else subprocess.DEVNULL))
        t0 = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0] if bad[0] > 0 else 128 - bad[0]
            if all(c == 0 for c in codes):
                return 0
            if timeout is not None and time.monotonic() - t0 > timeout:
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if main:
            signal.signal(signal.SIGTERM, old)
        shutil.rmtree(store_dir, ignore_errors=True)


def init_group() -> tuple:
    """Join the gloo group this process was spawned into; returns
    ``(rank, world)``.  Outside a spawned rank: ``(0, 1)``, no group."""
    env = rank_env()
    if env is None:
        return 0, 1
    import torch.distributed as dist
    r, n, store = env
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=r, world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return r, n


def finish() -> None:
    """Leave the group cleanly once every rank is done: a rank that exits
    while a peer's gloo threads still hold its connections can abort
    either process at shutdown."""
    if _initialized():
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _initialized() else 0


def world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


def barrier() -> None:
    if _initialized():
        import torch.distributed as dist
        dist.barrier()


def gather_to_rank0(t: torch.Tensor) -> Optional[np.ndarray]:
    """Every rank's ``t`` stacked on a new leading axis, as a host array
    on rank 0 (None elsewhere); one rank gives ``t[None]``."""
    host = t.detach().cpu().contiguous()
    if not _initialized():
        return host.numpy()[None].copy()
    import torch.distributed as dist
    r, n = dist.get_rank(), dist.get_world_size()
    flat = host.reshape(-1)
    parts = [torch.empty_like(flat) for _ in range(n)] if r == 0 else None
    dist.gather(flat, parts, dst=0)
    if r != 0:
        return None
    return np.stack([p.numpy().reshape(tuple(t.shape)) for p in parts])


def agree_any(flag: bool) -> bool:
    """True on every rank when the flag is set on any rank."""
    if not _initialized():
        return bool(flag)
    import torch.distributed as dist
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
