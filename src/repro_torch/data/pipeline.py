"""Deterministic synthetic data pipeline with host sharding + prefetch.

Production posture without external datasets: token streams are generated
from a counter-based PRNG (reproducible across restarts and elastic
rescales — shard i of N always sees the same stream), packed to fixed
``(batch, seq)`` blocks, and double-buffered so host generation overlaps the
device step.  Restart semantics: the pipeline is a pure function of
``(seed, step)`` — checkpoint stores only the step counter.

The port keeps its own copy of the reference's ``repro.data.pipeline``
(numpy only, unchanged), so that the same ``(seed, step, host)`` gives the
same tokens in both packages.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _batch_at(cfg: DataConfig, step: int) -> dict:
    """Pure function (seed, step, host) -> host-local batch.

    Zipfian token draws (natural-language-like marginals) + a next-token
    structure (shifted mixing) so the LM loss is learnable, not pure noise.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )
    b, s = cfg.host_batch, cfg.seq_len
    # zipf marginals clipped to vocab
    raw = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
    toks = (raw - 1) % cfg.vocab
    # inject learnable bigram structure: with p=0.5, t[i+1] = f(t[i]);
    # applied sequentially so the rule chains through rewritten positions
    mask = rng.random((b, s)) < 0.5
    for i in range(s):
        sel = mask[:, i]
        toks[sel, i + 1] = (toks[sel, i] * 31 + 7) % cfg.vocab
    return {"tokens": toks.astype(np.int32)}


class Pipeline:
    """Prefetching iterator over deterministic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: Queue = Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = _batch_at(self.cfg, step)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except Exception:
            pass


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Random-access batch (restart / straggler re-issue path)."""
    return _batch_at(cfg, step)
