"""Process-wide metrics registry: counters, gauges and histograms with
labels.

The port's copy of :mod:`mapreduce_tpu.obs.registry` (stdlib only), with
the same instruments, names and snapshot shape, so a ``--metrics-out`` file
of either package reads the same.  Every instrument is a host-side dict
update under a lock: nothing here touches the card or waits on it.

* :class:`Counter` -- monotonically increasing (``inc``);
* :class:`Gauge` -- last write wins (``set``);
* :class:`Histogram` -- fixed log-spaced seconds buckets (1 ms .. 60 s)
  plus count, sum, min and max (``observe``).

``registry.counter("executor.faults", seam="dispatch")`` keys the
instrument by ``(name, sorted(labels))``, flattened to ``name{k=v,...}`` in
:meth:`MetricsRegistry.snapshot`.  :func:`get_registry` is the
process-global default that a run's :class:`...obs.telemetry.Telemetry`
binds to unless given another.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

# Log-spaced seconds buckets: 1 ms granularity at the bottom (a single fast
# dispatch), a minute at the top (a wedged-relay compile).  Upper bounds,
# inclusive; observations past the last bound land in +Inf.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _flat_name(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()  # prefetch thread + main loop both inc

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, got {amount}")
        with self._lock:
            self.value += amount


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, bounds: Iterable[float] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self.bounds = tuple(bounds)
        if any(b <= a for a, b in zip(self.bounds, self.bounds[1:])):
            raise ValueError(f"bucket bounds must ascend: {self.bounds}")
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": round(self.min, 6) if self.count else None,
            "max": round(self.max, 6) if self.count else None,
            "buckets": {("+Inf" if i == len(self.bounds)
                         else repr(self.bounds[i])): c
                        for i, c in enumerate(self.bucket_counts) if c},
        }


class MetricsRegistry:
    """Thread-safe instrument store.  Instruments are created on first use
    and live for the registry's lifetime; a name must keep one kind (asking
    for ``counter("x")`` after ``gauge("x")`` is a programming error and
    raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str, _LabelKey], object] = {}
        # Bumped by reset(): an instrument a caller keeps from an earlier
        # generation is no longer in the registry.
        self.generation = 0

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                for other_kind, other_name, _ in self._instruments:
                    if other_name == name and other_kind != kind:
                        raise ValueError(
                            f"metric {name!r} already registered as "
                            f"{other_kind}, requested as {kind}")
                inst = self._instruments[key] = factory()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets or DEFAULT_BUCKETS))

    def observe(self, name: str, seconds: float, **labels) -> None:
        """Shorthand: one histogram observation (the common timing call)."""
        self.histogram(name, **labels).observe(seconds)

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything recorded so far, stably keyed
        by flattened ``name{labels}``."""
        with self._lock:
            items = sorted(self._instruments.items(),
                           key=lambda kv: (kv[0][1], kv[0][2], kv[0][0]))
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for (kind, name, key), inst in items:
                flat = _flat_name(name, key)
                if kind == "counter":
                    v = inst.value
                    out["counters"][flat] = int(v) if v == int(v) else v
                elif kind == "gauge":
                    out["gauges"][flat] = inst.value
                else:
                    out["histograms"][flat] = inst.as_dict()
            return out

    def reset(self) -> None:
        """Drop every instrument (tests; a long-lived process between runs)."""
        with self._lock:
            self._instruments.clear()
            self.generation += 1


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (see module docstring)."""
    return _DEFAULT
