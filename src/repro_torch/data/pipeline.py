"""Deterministic, restartable host data pipeline.

The port's own copy of ``repro/data/pipeline.py`` (same seeds). Batch
``step`` is a pure function of ``(base_seed, step, host_id)``, so a restart
from a checkpoint sets the step and the stream resumes bit-identically
with no replay, and each host of a multi-host job draws a disjoint slice of
the global batch. ``Prefetcher`` overlaps host-side generation with device
work through a bounded background-thread queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class DeterministicStream:
    """make_batch(seed) -> batch dict; seeds derived per (base_seed, step, host)."""

    def __init__(self, make_batch: Callable[[int], dict], base_seed: int = 0,
                 start_step: int = 0, host_id: int = 0, n_hosts: int = 1):
        self.make_batch = make_batch
        self.base_seed = base_seed
        self.step = start_step
        self.host_id = host_id
        self.n_hosts = n_hosts

    def seed_for(self, step: int) -> int:
        # SplitMix-style mix keeps per-(step, host) seeds decorrelated
        z = (self.base_seed + 0x9E3779B97F4A7C15 * (step * self.n_hosts + self.host_id + 1)) % (1 << 63)
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 % (1 << 63)
        return int(z % (1 << 31))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self.make_batch(self.seed_for(self.step))
        self.step += 1
        return batch

    def skip_to(self, step: int) -> None:
        self.step = step


class Prefetcher:
    """Bounded background prefetch of an iterator; an exception in the
    worker is raised again by ``__next__`` once the queue drains."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: Optional[Exception] = None

        def work():
            try:
                for item in it:
                    self.q.put(item)
            except Exception as e:  # re-raised by __next__
                self.err = e
            finally:
                self.q.put(self._SENTINEL)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._SENTINEL:
            if self.err is not None:
                raise self.err
            raise StopIteration
        return item


def shard_batch(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Slice the leading (global-batch) dim for this host."""
    def slc(x):
        if not hasattr(x, "shape") or x.ndim == 0:
            return x
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]

    return {k: slc(v) for k, v in batch.items()}
