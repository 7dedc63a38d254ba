"""Deterministic host-side data pipeline with prefetch + replay
(``repro.data.pipeline``, copied: numpy only, so both packages give the
same batches for one seed).

Restart semantics: the pipeline is a pure function of (seed, step), so an
elastic restart at step N replays exactly the batches N+1.. that the lost
run would have seen — no data loss or duplication (checkpoint stores only
the step).  A background thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class DeterministicPipeline:
    """make_batch(seed, step) -> dict; iterable from any start step."""

    def __init__(
        self,
        make_batch: Callable[[int, int], dict],
        seed: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        self.make_batch = make_batch
        self.seed = seed
        self.step = start_step
        self.prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.make_batch(self.seed, step)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch > 0:
            self._q = queue.Queue(maxsize=self.prefetch)
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
            while True:
                step, batch = self._q.get()
                self.step = step + 1
                yield batch
        else:
            while True:
                batch = self.make_batch(self.seed, self.step)
                self.step += 1
                yield batch

    def close(self):
        self._stop.set()


def lm_batch_fn(batch: int, seq_len: int, vocab: int):
    def make(seed: int, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        toks = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
        return {
            "tokens": toks,
            "targets": np.roll(toks, -1, axis=1),
            "loss_mask": np.ones((batch, seq_len), np.float32),
        }

    return make


def paired_batch_fn(vocab: int, batch: int, seq: int):
    """Query/doc pairs sharing token overlap (the positive signal of the
    SPLADE contrastive loss): ``examples/train_splade.py``'s batches."""

    def make(seed: int, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        topics = rng.integers(0, vocab // 64, size=batch)
        d = (topics[:, None] * 64 + rng.integers(0, 64, (batch, seq))) % vocab
        q = (topics[:, None] * 64 + rng.integers(0, 64, (batch, seq))) % vocab
        return {
            "q_tokens": q.astype(np.int32),
            "q_mask": np.ones((batch, seq), np.float32),
            "d_tokens": d.astype(np.int32),
            "d_mask": np.ones((batch, seq), np.float32),
        }

    return make
