"""Throughput metrics and per-phase timing.

Counterpart of :mod:`mapreduce_tpu.runtime.metrics`: a wall-clock timer of
named phases and the end-of-run summary (bytes, words, GB/s).  Host clock
only: a phase that ends in an event wait or a host read measures the card
too, one that only enqueues work measures the enqueue.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase.

    ``stop`` on a phase that was never started (or is already stopped)
    returns 0.0 and accumulates nothing, so a ``finally`` may stop a phase
    whose ``start`` never ran without replacing the exception in flight.
    Restarting an open phase discards the earlier start.
    """

    phases: dict = dataclasses.field(default_factory=dict)
    _open: dict = dataclasses.field(default_factory=dict)

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        t0 = self._open.pop(name, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        return dt

    def __getitem__(self, name: str) -> float:
        return self.phases.get(name, 0.0)


@dataclasses.dataclass(frozen=True)
class RunMetrics:
    """End-of-run throughput summary."""

    bytes_processed: int
    words_counted: int
    elapsed_s: float
    phases: dict

    @property
    def gb_per_s(self) -> float:
        return self.bytes_processed / 1e9 / self.elapsed_s \
            if self.elapsed_s else 0.0

    @property
    def words_per_s(self) -> float:
        return self.words_counted / self.elapsed_s if self.elapsed_s else 0.0

    def as_dict(self) -> dict:
        return {
            "bytes": self.bytes_processed,
            "words": self.words_counted,
            "elapsed_s": round(self.elapsed_s, 4),
            "gb_per_s": round(self.gb_per_s, 4),
            "words_per_s": round(self.words_per_s, 1),
            "phases": {k: round(v, 4) for k, v in self.phases.items()},
        }
