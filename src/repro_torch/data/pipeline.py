"""Deterministic, prefetching synthetic data pipeline.

Counterpart of ``repro.data.pipeline`` (``SyntheticLM``, ``SyntheticAE``
and ``Prefetcher``).  Every batch is a pure function of (seed, step, host),
drawn with numpy exactly as the reference draws it, so the port and the
reference see the same data bit for bit.  Token streams are
Zipf-distributed with document boundaries (EOS every ~doc_len tokens); the
AutoEncoder's frames are low-rank spectra plus noise.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "SyntheticAE", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    doc_len: int = 512
    embed_dim: int = 0          # >0 -> "embeddings" mode (audio/vlm stubs)
    num_hosts: int = 1
    host_id: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s = self.local_batch, self.seq_len
        # Zipf tokens (clipped to vocab); EOS=0 at document boundaries
        toks = rng.zipf(1.2, size=(b, s + 1)).astype(np.int64)
        toks = np.minimum(toks, self.vocab_size - 1).astype(np.int32)
        doc_off = rng.integers(0, self.doc_len, size=(b, 1))
        pos = np.arange(s + 1)[None, :]
        toks = np.where((pos + doc_off) % self.doc_len == 0, 0, toks)
        out: Dict[str, np.ndarray] = {
            "inputs": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
        }
        if self.embed_dim:
            emb = rng.standard_normal((b, s, self.embed_dim), dtype=np.float32)
            out = {"embeddings": emb, "labels": out["labels"]}
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class SyntheticAE:
    """ToyADMOS-like mel-frame windows for the AutoEncoder use case."""

    batch: int
    dim: int = 640
    seed: int = 0

    def sample(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        # smooth spectra: low-rank structure + noise, normalised per row
        base = rng.standard_normal((self.batch, 8)) @ rng.standard_normal((8, self.dim))
        x = base + 0.1 * rng.standard_normal((self.batch, self.dim))
        return (x / np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-6)).astype(np.float32)


class Prefetcher:
    """Background-thread prefetch (double-buffered host pipeline)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
