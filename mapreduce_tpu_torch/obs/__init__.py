"""Observability of the port, the JAX package's planes: phase spans on the
profiler timeline (:mod:`.spans`), the metrics registry (:mod:`.registry`),
the JSONL run ledger (:mod:`.ledger`), the flight recorder
(:mod:`.flight`), the ``Telemetry`` handle over them (:mod:`.telemetry`),
and the readers of a ledger, all stdlib only:

* :mod:`.timeline` -- the per-resource timeline and critical-path
  ``bottleneck`` reconstructed from the ``group`` records, and its Chrome
  trace;
* :mod:`.datahealth` -- the ``data`` record's verdict (spill-bound,
  rescue-heavy, skew-hot, occupancy-starved, table-pressure, clean), the
  fleet's host balance and a run's reliability;
* :mod:`.fleet` -- per-host shard ledgers (``<ledger>.h<p>.jsonl``)
  merged into one clock-aligned fleet view with the ``fleet_bottleneck``
  verdict;
* :mod:`.history` -- the run-history warehouse (ingest, drift verdicts)
  and :func:`.history.resolve_prior`, the one prior-run read that
  ``combiner='auto'``, ``geometry='auto'``, ``merge_strategy='auto'`` and
  the autotuner resolve through.
"""

import importlib

from mapreduce_tpu_torch.obs import datahealth, timeline
from mapreduce_tpu_torch.obs.flight import FlightRecorder, summarize_state
from mapreduce_tpu_torch.obs.ledger import (LEDGER_VERSION, RunLedger,
                                            read_ledger, shard_flight_path,
                                            shard_path)
from mapreduce_tpu_torch.obs.registry import MetricsRegistry, get_registry
from mapreduce_tpu_torch.obs.spans import span
from mapreduce_tpu_torch.obs.telemetry import (Telemetry,
                                               device_memory_stats, maybe)

__all__ = [
    "FlightRecorder", "LEDGER_VERSION", "MetricsRegistry", "RunLedger",
    "Telemetry", "datahealth", "device_memory_stats", "fleet",
    "get_registry", "history", "maybe", "read_ledger",
    "shard_flight_path", "shard_path", "span", "summarize_state",
    "timeline",
]


def __getattr__(name: str):
    """``fleet`` and ``history`` load on first use, so ``python -m
    mapreduce_tpu_torch.obs.history`` (or ``.fleet``) runs its module
    once, as ``__main__``."""
    if name in ("fleet", "history"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
