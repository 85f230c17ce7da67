"""Synthetic-corpus data pipeline: deterministic, resumable (the
reference's `train/data.py`, in numpy).

The "corpus" is a seeded Zipfian token stream with document structure (EOS
every ~doc_len tokens). Batch `i` depends only on (seed, i), so resuming
from step k after a failure replays identically, and a batch is bit-equal
to the reference's for the same config. A background thread prefetches
`prefetch` batches ahead of the consumer.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    doc_len: int = 512
    zipf_a: float = 1.2
    n_codebooks: int = 0        # audio: (B, K, S) token grids
    n_patches: int = 0          # vlm: synthetic patch embeddings
    d_model: int = 0


def _batch_at(cfg: DataConfig, index: int) -> dict:
    """Batch `index`, deterministically (resume == replay)."""
    rng = np.random.default_rng((cfg.seed, index))
    shape = ((cfg.global_batch, cfg.n_codebooks, cfg.seq_len + 1)
             if cfg.n_codebooks else (cfg.global_batch, cfg.seq_len + 1))
    # Zipf with rejection to vocab (heavy-tailed like real token streams).
    toks = rng.zipf(cfg.zipf_a, size=shape) % (cfg.vocab_size - 2) + 2
    # document boundaries
    eos_mask = rng.random(shape) < (1.0 / cfg.doc_len)
    toks = np.where(eos_mask, 1, toks).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
    if cfg.n_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (cfg.global_batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


class DataPipeline:
    """Iterator of (index, batch) with background prefetch and
    step-indexed resume."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2,
                 shard_fn=None):
        self.cfg = cfg
        self._shard_fn = shard_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        i = self._next
        while not self._stop.is_set():
            batch = _batch_at(self.cfg, i)
            try:
                self._q.put((i, batch), timeout=0.5)
                i += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        i, batch = self._q.get()
        return i, {k: self._shard_fn(v) for k, v in batch.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def batch_for_step(cfg: DataConfig, step: int) -> dict:
    """Direct access (tests / single steps)."""
    return _batch_at(cfg, step)
