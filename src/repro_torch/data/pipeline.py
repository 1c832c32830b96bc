"""Host data pipeline (the port of `repro.data.pipeline`): deterministic
LM batches a host shard at a time, and a background prefetcher that
recomputes a batch itself when its producer is late.

A batch is a function of its step alone (seeded by the step), so any
host can recompute any other's shard: the straggler path below and a
resharded restart rely on that. Batches are numpy; the trainer moves
them to its device."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class ShardSpec:
    host_index: int = 0
    host_count: int = 1


class LMBatcher:
    """(tokens, labels) LM batches cut from a token stream."""

    def __init__(self, stream: np.ndarray, batch: int, seq: int,
                 shard: ShardSpec = ShardSpec(), seed: int = 0):
        self.stream = stream
        self.batch = batch
        self.seq = seq
        self.shard = shard
        self.rng = np.random.default_rng(seed)
        self.per_step = batch * (seq + 1)

    def batch_at(self, step: int) -> dict:
        """The batch of global step `step`: `batch` windows of seq + 1
        tokens at starts drawn from a generator seeded (step << 16) ^
        0x5EED, tokens the first seq of each and labels the last seq; this
        host's rows [index * batch // count, (index + 1) * batch //
        count), int32."""
        n = len(self.stream) - self.seq - 1
        rng = np.random.default_rng((step << 16) ^ 0x5EED)
        starts = rng.integers(0, n, self.batch)
        tok = np.stack([self.stream[s: s + self.seq] for s in starts])
        lab = np.stack([self.stream[s + 1: s + self.seq + 1] for s in starts])
        lo = self.shard.host_index * self.batch // self.shard.host_count
        hi = (self.shard.host_index + 1) * self.batch // self.shard.host_count
        return {"tokens": tok[lo:hi].astype(np.int32),
                "labels": lab[lo:hi].astype(np.int32)}


class Prefetcher:
    """batch_fn(step) for steps start, start + 1, ... (0 by default) made
    ahead by a daemon thread into a queue of `depth`. `next` waits up to
    `timeout_s` for the producer; past that it computes the expected
    step's batch itself (the straggler path). `stop` ends the thread."""

    def __init__(self, batch_fn, depth: int = 2, timeout_s: float = 30.0,
                 start: int = 0):
        self.batch_fn = batch_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.timeout_s = timeout_s
        self._stop = threading.Event()
        self._step = start
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.batch_fn(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> dict:
        try:
            step, b = self.q.get(timeout=self.timeout_s)
        except queue.Empty:
            b = self.batch_fn(self._step)
            step = self._step
        self._step = step + 1
        return b

    def stop(self, timeout_s: float = 5.0) -> bool:
        """Ask the thread to end and wait up to `timeout_s` for it (it
        ends within 0.5 s of the ask unless batch_fn is running). Returns
        whether it ended."""
        self._stop.set()
        self._thread.join(timeout_s)
        return not self._thread.is_alive()
