"""Deterministic synthetic token pipeline with exact-resume semantics.

Copy of ``src/repro/data/tokens.py`` (numpy only): the same
``SeedSequence`` per (seed, step, shard), so its batches are the
reference's bit for bit.  The train loop puts them on its device.

The batch for global step s on data shard i is a PURE FUNCTION of
(seed, s, i): restart/elastic-resize recompute their shards with no
state handoff — the fault-tolerance property the train loop relies on
(tests/test_torch_train.py asserts bitwise-identical loss curves
across a kill/restart).

Content: Zipf-distributed tokens with short Markov "phrases" so the
model has learnable structure (loss decreases measurably within a few
hundred steps for the ~100M example run).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _batch_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def shard_batch(cfg: DataConfig, step: int, shard: int,
                n_shards: int) -> Dict[str, np.ndarray]:
    """The (step, shard) batch: tokens (B/n_shards, seq_len+0) int32."""
    assert cfg.global_batch % n_shards == 0, (cfg.global_batch, n_shards)
    b = cfg.global_batch // n_shards
    rng = _batch_rng(cfg, step, shard)
    # Zipf body with a Markov phrase process: token_{t+1} is token_t+1
    # with prob .5 (learnable successor structure), else a fresh draw.
    fresh = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len)).astype(np.int64)
    fresh = np.minimum(fresh, cfg.vocab_size - 1)
    keep = rng.random((b, cfg.seq_len)) < 0.5
    toks = fresh.copy()
    for t in range(1, cfg.seq_len):
        toks[:, t] = np.where(keep[:, t],
                              (toks[:, t - 1] + 1) % cfg.vocab_size,
                              fresh[:, t])
    return {"tokens": toks.astype(np.int32)}


def global_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """All shards concatenated (single-host testing path)."""
    parts = [shard_batch(cfg, step, i, 1) for i in (0,)]
    return parts[0]


class Prefetcher:
    """Double-buffered host-side prefetch (straggler mitigation: input
    stalls never serialize with compute)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1):
        import threading
        import queue
        self.cfg, self.shard, self.n_shards = cfg, shard, n_shards
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._step = start_step
        self._stop = threading.Event()

        def worker():
            s = start_step
            while not self._stop.is_set():
                batch = shard_batch(cfg, s, shard, n_shards)
                self._q.put((s, batch))
                s += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except Exception:
            pass
