"""Deterministic, restart-safe token pipeline (counterpart of
`repro.data.pipeline`, numpy only, with the reference's batches bit for bit).

The batch for step N is a pure function of (seed, N, host): no iterator state
to checkpoint, so a supervisor restart resumes exactly by replaying the step
counter. A background thread keeps `steps_ahead` batches in flight.

Synthetic corpus: a Zipfian token stream over the model's vocabulary. Batches
are numpy arrays on the host; the train step moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        """Pure (seed, step) -> batch. Zipfian tokens, next-token labels."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.host_batch, self.seq_len, self.vocab_size
        # Zipf via inverse-CDF on a truncated harmonic distribution
        u = rng.random((b, s + 1))
        ranks = np.minimum((np.exp(u * np.log(v)) - 1).astype(np.int64), v - 1)
        toks = ranks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def iterate(self, start_step: int = 0, steps_ahead: int = 2) -> Iterator[dict]:
        """Prefetching iterator (daemon thread), resumable at any step."""
        q: queue.Queue = queue.Queue(maxsize=steps_ahead)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_pipeline(cfg, seq_len: int, global_batch: int, seed: int = 0, n_hosts: int = 1,
                  host_id: int = 0) -> TokenPipeline:
    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=global_batch, seed=seed, n_hosts=n_hosts,
                         host_id=host_id)
