"""Deterministic synthetic token pipeline with host sharding + prefetch.

The JAX package's ``repro/data/pipeline.py``, unchanged but for its
imports: batches are NumPy arrays, equal to the JAX package's bit for bit
for the same config, and the trainer moves them to its device.

Production shape: each host materializes only its slice of the global batch
(``host_count``/``host_index``), batches are derivable from the step number
alone (resumable without data-state checkpoints), and a background thread
prefetches ahead of the training loop.

The synthetic stream is a mixture of Zipf-distributed unigrams and repeated
n-gram motifs, so models show a real learning curve (loss drops below the
uniform-entropy floor) while remaining fully offline and reproducible.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import Family, ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5
    prefetch: int = 2


class SyntheticLM:
    """Step-indexed deterministic batches: batch(i) is a pure function."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        assert dc.global_batch % dc.host_count == 0
        self.cfg = cfg
        self.dc = dc
        self.local_batch = dc.global_batch // dc.host_count
        root = np.random.default_rng(dc.seed)
        v = cfg.vocab_size
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-dc.zipf_a)
        self.probs = probs / probs.sum()
        # fixed motif table (n-grams the model can learn to complete)
        self.motifs = root.integers(0, v, size=(dc.n_motifs, dc.motif_len))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        rng = np.random.default_rng(
            (dc.seed, step, dc.host_index))  # host-disjoint, step-derivable
        B, S = self.local_batch, dc.seq_len
        toks = rng.choice(self.cfg.vocab_size, size=(B, S + 1), p=self.probs)
        # splice motifs at random offsets
        n_splice = int(S * dc.motif_prob / dc.motif_len)
        for b in range(B):
            for _ in range(n_splice):
                m = self.motifs[rng.integers(0, dc.n_motifs)]
                off = rng.integers(0, S + 1 - dc.motif_len)
                toks[b, off: off + dc.motif_len] = m
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == Family.AUDIO:
            batch["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_seq_len, self.cfg.d_model),
            ).astype(np.float32)
        if self.cfg.family == Family.VLM:
            batch["patches"] = rng.standard_normal(
                (B, self.cfg.n_vision_tokens, self.cfg.d_model),
            ).astype(np.float32)
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch of a step-indexed source."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: Optional[int] = None):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(
            maxsize=depth or source.dc.prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
