"""Batched serving: prefill once, decode greedily from the pooled KV cache.
Counterpart of the repository's ``examples/serve_batched.py``::

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch deepseek-v2-lite-16b

MLA archs serve from the compressed ``c_kv`` cache (rank 512 at full
width), which the example prices against a naive GQA cache.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import transformer

__all__ = ["main"]


def main(argv=None) -> Dict[str, Any]:
    """Serve (reduced ``--arch``); returns ``{"seqs", "seconds"}`` and,
    for an MLA arch, the two cache sizes in bytes."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="deepseek-v2-lite-16b",
                   choices=configs.ARCH_IDS)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--gen", type=int, default=24)
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    params = transformer.init_params(cfg, seed=0, device=device)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    seqs = generate(params, cfg, prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: {args.batch} requests x {args.gen} tokens "
          f"in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s incl. the "
          "first launches)")
    print("first completion:", seqs[0, args.prompt_len:])
    out: Dict[str, Any] = {"seqs": seqs, "seconds": dt}
    if cfg.mla:
        c = transformer.init_cache(cfg, args.batch, args.prompt_len + args.gen,
                                   device=device)
        kv = sum(x.numel() * x.element_size() for x in _leaves(c))
        naive = (cfg.n_layers * args.batch * (args.prompt_len + args.gen)
                 * cfg.n_heads * (cfg.mla.qk_nope_dim + cfg.mla.v_head_dim) * 2 * 2)
        print(f"MLA compressed cache: {kv / 1e6:.2f} MB "
              f"vs naive GQA cache ~{naive / 1e6:.2f} MB ({naive / kv:.1f}x smaller)")
        out.update(cache_bytes=kv, naive_bytes=naive)
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree.values() for t in _leaves(v)]


if __name__ == "__main__":
    main()
