"""Synthetic LM batches with host-side prefetch: the port's copy of
``repro.data.pipeline`` (numpy only, array for array the reference's).

Every batch is a pure function of ``(seed, step)``, so a restart or an
elastic re-mesh replays the exact stream; a background thread prefetches
batches so that the device step never waits on host RNG.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np

from repro_torch.lm.config import LMConfig, ShapeCell


class SyntheticLMStream:
    """Deterministic synthetic LM batches: step -> {tokens, targets}.

    A Zipf-1.1 unigram distribution over the vocabulary (a realistic
    softmax load) and shifted-copy targets. ``batch(step)`` is a pure
    function of (seed, step), the property fault tolerance relies on.
    Configs with an encoder or a frontend also get stubbed ``frontend``
    embeddings, as in the reference.
    """

    def __init__(self, cfg: LMConfig, cell: ShapeCell, seed: int = 0):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.cell.global_batch, self.cell.seq_len
        toks = rng.choice(self.cfg.vocab_size, size=(b, s + 1),
                          p=self._p).astype(np.int32)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.encoder_layers:
            out["frontend"] = rng.normal(
                size=(b, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32)
        elif self.cfg.frontend_tokens:
            out["frontend"] = rng.normal(
                size=(b, self.cfg.frontend_tokens, self.cfg.frontend_dim)
            ).astype(np.float32)
        return out


class PrefetchIterator:
    """``(step, batch)`` pairs from ``start_step`` on, ``depth`` batches
    made ahead on a background thread. ``close()`` stops the thread."""

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.stream.batch(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
