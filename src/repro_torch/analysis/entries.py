"""Audited entry points: the programs the static audit runs.

Counterpart of ``repro.analysis.entries``: the reference's five entries at
its reduced configs, batch, lengths, ragged ``kv_group_sizes``, FP8 cache
and policies.  Each builder takes a device and returns ``(fn, args)``;
:func:`repro_torch.analysis.aten_audit.trace_entry` runs ``fn(*args)``
once under a backend, so the same entry runs under ``"aten"`` and
``"hopper"`` on the CPU and under ``"hopper"`` on the card.

Weights and inputs come from seed 0.  On ``device="meta"`` they are meta
tensors (``abstract_params``): every entry's path takes them under
``"aten"``, which is how the audit CLI runs, in about a second for all
five.  The plain kernel versions of a CPU ``"hopper"`` run and the card's
kernels read data, so there the entries draw seeded tensors (the MoE
router then sorts real scores).

* ``ae_train`` — the AutoEncoder's gradient step under ``paper_fp16``
  (forward and backward contractions);
* ``yi9b_decode`` — one continuous-batching decode step of reduced yi-9b
  on the FP8 KV cache, slots of 4 / 9 / 17 / 0 positions;
* ``serve_recover`` — the scheduler's slot rebuild: re-prefill of 12
  tokens into an FP8 cache, the batch-1 replay decode step, the slot
  re-inserted into the FP8 pool;
* ``deepseek_moe_fwd`` — reduced deepseek-moe-16b forward at 2 x 16;
* ``xlstm_fwd`` — reduced xlstm-1.3b forward at 2 x 16 (the mLSTM sweep
  on a fresh state, the sLSTM recurrence).

The flash kernel takes head sizes 64 and 128; the reduced configs' is 16.
On the card the entries that reach it run with :data:`CARD_OVERRIDES`
(``head_dim`` 64), and their CPU ``"hopper"`` twin takes the same
overrides, so the two footprints describe one program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ENTRY_POINTS", "CARD_OVERRIDES", "get_entry", "EntrySpec"]

EntrySpec = Tuple[Callable[..., Any], Sequence[Any]]
FP8_CACHE = "float8_e4m3fn"


def _cfg(arch: str, overrides: Optional[Dict[str, Any]]):
    from repro_torch import configs

    cfg = configs.get_reduced(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _params(cfg, device: str):
    from repro_torch.models import transformer

    if device == "meta":
        return transformer.abstract_params(cfg)
    return transformer.init_params(cfg, seed=0, device=device,
                                   dtype=getattr(torch, cfg.param_dtype))


def _tokens(cfg, shape, device: str, seed: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.integers(0, cfg.vocab_size, shape),
                           dtype=torch.long, device=device)


def _ae_train(device: str, overrides=None) -> EntrySpec:
    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.models import autoencoder, layers

    if device == "meta":
        params = layers.abstract_tree(autoencoder.ae_schema())
    else:
        params = autoencoder.init_ae(seed=0, device=device)
    x = torch.as_tensor(SyntheticAE(batch=16).sample(0), device=device)
    leaves = [v for sub in params.values() for v in sub.values()]

    def step(p, xb):
        for t in leaves:
            t.requires_grad_(True)
        loss = autoencoder.ae_loss(p, xb, policy=prec.PAPER_FP16)[0]
        return loss, torch.autograd.grad(loss, leaves)

    return step, (params, x)


def _yi9b_decode(device: str, overrides=None) -> EntrySpec:
    from repro_torch.models import transformer

    cfg = _cfg("yi-9b", overrides)
    params = _params(cfg, device)
    n, max_len = 4, 32
    sizes = np.asarray([4, 9, 17, 0], np.int32)
    cache = transformer.init_cache(cfg, n, max_len, dtype=cfg.policy.compute_dtype,
                                   storage_dtype=FP8_CACHE, device=device)
    tok = _tokens(cfg, (n, 1), device, 1)
    pos = torch.as_tensor(np.maximum(sizes - 1, 0), dtype=torch.long, device=device)

    def step(p, c, t, q):
        return transformer.serve_step(p, cfg, t, c, q, kv_group_sizes=sizes)

    return step, (params, cache, tok, pos)


def _serve_recover(device: str, overrides=None) -> EntrySpec:
    from repro_torch.models import transformer
    from repro_torch.serving import kv_cache

    cfg = _cfg("yi-9b", overrides)
    params = _params(cfg, device)
    n, max_len, plen = 4, 32, 12
    pool = transformer.init_cache(cfg, n, max_len, dtype=cfg.policy.compute_dtype,
                                  storage_dtype=FP8_CACHE, device=device)
    seq = _tokens(cfg, (1, plen), device, 2)
    tok = _tokens(cfg, (1, 1), device, 3)
    sizes = np.asarray([plen + 1], np.int32)

    def recover(p, pool_, seq_, tok_):
        # the scheduler's slot rebuild: re-prefill the absorbed tokens,
        # replay the poisoned decode step batch-1, re-insert the slot
        _, single = transformer.prefill(p, cfg, {"inputs": seq_}, max_len,
                                        storage_dtype=FP8_CACHE)
        row, single = transformer.serve_step(
            p, cfg, tok_, single, torch.tensor([plen], device=tok_.device),
            kv_group_sizes=sizes)
        return row, kv_cache.insert_slot(pool_, single, 2, cfg.policy.compute_dtype)

    return recover, (params, pool, seq, tok)


def _lm_fwd(arch: str, batch: int, seq: int, device: str, overrides) -> EntrySpec:
    from repro_torch.models import transformer

    cfg = _cfg(arch, overrides)
    params = _params(cfg, device)
    feed = {"inputs": _tokens(cfg, (batch, seq), device, 4)}

    @torch.no_grad()
    def fwd(p, b):
        return transformer.forward(p, cfg, b)[0]

    return fwd, (params, feed)


def _deepseek_moe_fwd(device: str, overrides=None) -> EntrySpec:
    return _lm_fwd("deepseek-moe-16b", 2, 16, device, overrides)


def _xlstm_fwd(device: str, overrides=None) -> EntrySpec:
    return _lm_fwd("xlstm-1.3b", 2, 16, device, overrides)


ENTRY_POINTS: Dict[str, Callable[..., EntrySpec]] = {
    "ae_train": _ae_train,
    "yi9b_decode": _yi9b_decode,
    "serve_recover": _serve_recover,
    "deepseek_moe_fwd": _deepseek_moe_fwd,
    "xlstm_fwd": _xlstm_fwd,
}
# what the card needs of an entry (the flash kernel's head sizes)
CARD_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "serve_recover": {"head_dim": 64},
    "deepseek_moe_fwd": {"head_dim": 64},
}


def get_entry(name: str, device: str = "cpu",
              overrides: Optional[Dict[str, Any]] = None) -> EntrySpec:
    """``(fn, args)`` of entry ``name`` with its tensors on ``device``."""
    try:
        build = ENTRY_POINTS[name]
    except KeyError:
        raise KeyError(f"unknown audit entry {name!r}; known: "
                       f"{sorted(ENTRY_POINTS)}") from None
    return build(device, overrides)
