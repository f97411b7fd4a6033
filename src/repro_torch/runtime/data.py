"""Training data pipeline: a *replayable source* in the paper's sense.

A copy of ``repro/runtime/data.py`` (numpy and a host thread only; the
port keeps its own copy rather than import the JAX package).

Batches are a pure function of the step index (seeded splitmix), so a
restart from checkpoint step N regenerates exactly the batches N+1, N+2...
— the data pipeline participates in exactly-once recovery the same way a
Jet replayable source does (§4.5).  ``Prefetcher`` double-buffers batch
construction on a host thread so ingestion overlaps device compute (the
host-side analogue of Jet's dedicated non-cooperative source threads).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class SyntheticLMData:
    """Deterministic synthetic token stream (zipf-ish unigram mix)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, embed_dim: Optional[int] = None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.embed_dim = embed_dim   # vlm stub: emit embeddings instead

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step)
                                    % (2**31 - 1))
        tokens = rng.randint(0, self.vocab_size,
                             size=(self.batch, self.seq_len + 1),
                             dtype=np.int32)
        if self.embed_dim:
            embeds = rng.randn(self.batch, self.seq_len,
                               self.embed_dim).astype(np.float32)
            return {"embeds": embeds, "labels": tokens[:, 1:]}
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class Prefetcher:
    """Host-thread double buffering: build batch N+1 while N computes."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop:
            batch = self.source.batch_at(step)
            self._q.put((step, batch))
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
