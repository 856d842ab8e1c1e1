"""End-to-end LM pretraining with the fault-tolerant loop: checkpoints,
auto-resume, straggler watchdog, goodput.  Counterpart of the repository's
``examples/train_lm_faulttolerant.py``.  Kill it mid-run (Ctrl-C, ``kill``)
and run it again: it resumes from the last complete checkpoint and replays
the exact data stream (a SIGTERM checkpoints and exits cleanly)::

    PYTHONPATH=src python -m repro_torch.examples.train_lm_faulttolerant \\
        --arch qwen3-1.7b --steps 150 --ckpt ckpt_lm

``--ckpt`` defaults to ``repro_torch_ckpt`` under the temporary directory
(``$TMPDIR``); a run resumes from whatever checkpoint it finds there.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import build_train_step, init_state
from repro_torch.optim import AdamW
from repro_torch.runtime.fault_tolerance import StragglerWatchdog, TrainLoop

__all__ = ["main"]


def main(argv=None) -> Dict[str, Any]:
    """Train (reduced ``--arch``); returns the loop's output."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen3-1.7b", choices=configs.ARCH_IDS)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt",
                   default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--save-every", type=int, default=25)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    cfg = configs.get_reduced(args.arch)
    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = build_train_step(cfg, opt)
    state = init_state(cfg, opt, seed=0, device=resolve_device(args.device))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch,
                     embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0)
    loop = TrainLoop(step, CheckpointManager(args.ckpt, keep=2),
                     save_every=args.save_every,
                     watchdog=StragglerWatchdog(threshold=3.0),
                     handle_sigterm=True)
    out = loop.run(state, ds.batch, args.steps)  # step-indexed: exact replay
    g = out["goodput"]
    last = out["history"][-1]["loss"] if out["history"] else float("nan")
    print(f"\ndone at step {out['last_step']}: loss {last:.4f}, "
          f"stragglers flagged: {out['straggler_steps']}")
    print(f"goodput {g['goodput']:.3f} "
          f"(useful {g['useful_time']:.1f}s / wall {g['wall_time']:.1f}s, "
          f"{g['restarts']} restart(s), "
          f"{g['recomputed_steps']} recomputed step(s), "
          f"{g['time_lost_to_restart']:.1f}s lost to restarts)")
    return out


if __name__ == "__main__":
    main()
