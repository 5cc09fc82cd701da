"""Per-run JSONL run ledger.

The port's copy of :mod:`mapreduce_tpu.obs.ledger`: the same record kinds,
field names and schema version, so the JAX package's readers
(``tools/obs_report.py``, ``tools/trace_export.py``, ``tools/obswatch.py``,
``obs/timeline.py``, ``obs/datahealth.py``) read a ledger the port wrote
as they read their own.  One JSON object per line, appended and flushed
per record, so a run that dies keeps every record up to its death.

=============  ===========================================================
kind           carries
=============  ===========================================================
run_start      run_id, ledger_version, the run's configuration (driver,
               job, devices, chunk_bytes, superstep, backend, map_impl,
               combiner, geometry, merge_strategy, input paths), the
               resume cursor, the retry budget and a chaotic run's
               ``fault_plan``
step           one per dispatched group, at dispatch: step_first/
               step_last/steps, group_bytes, cursor_bytes, per-phase
               second deltas, elapsed_s since the previous record, device
               memory, the builds that landed since (``compile_events``)
               and the in-flight depth
group          one per retired group: its lifecycle stamps (read_at,
               staged_at, dispatched_at, token_ready_at, retired_at on
               ``time.perf_counter``; h2d_done_at on the last group),
               retire_wait_s, replay retries and its ``data`` dict
progress       the live heartbeat on a wall-clock cadence: cursor, total
               bytes, groups dispatched and retired, depth, rate, ETA
fault          a typed fault at a seam: seam, fault_class, injected, the
               crossing index of an injected one
retry          step, attempt, error, fault_class (and seam off dispatch)
degrade        one per degradation-ladder step: ladder_step, field,
               from/to
checkpoint     step, cursor_bytes, save_s, path (preempt on a drain)
failure        step, cursor_bytes, error, fault_class, flight-dump path
collective     the finish: op, strategy, started_at/ended_at
data           the run's data-plane summary (before run_end)
tune           a ``Config(autotune='hint')`` run's autotuner
               recommendation (before run_end, after data): tuner_version,
               current/proposal knobs, changed, rule, reason, converged,
               the signals it read, the decision trail, mode='hint'
run_end        the run's metrics (bytes, words, elapsed, phases, GB/s)
               and the window statistics (``pipeline``)
=============  ===========================================================

A run without a ``run_end`` did not complete.  Readers skip unknown kinds
and fields, and lines that do not parse.  :func:`shard_path` and
:func:`shard_flight_path` name a multi-host run's per-host files
(:meth:`...obs.telemetry.Telemetry.attach_host`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterator, Optional

#: The schema version stamped on ``run_start``: the JAX package's.
LEDGER_VERSION = 10


def shard_path(path: str, process_index: int) -> str:
    """The per-host shard ledger next to the main file:
    ``run.jsonl`` -> ``run.jsonl.h3.jsonl`` for process 3."""
    return f"{path}.h{int(process_index)}.jsonl"


def shard_flight_path(path: str, process_index: int) -> str:
    """The per-host flight-dump path of a non-coordinator process."""
    return f"{path}.h{int(process_index)}.flight.json"


class RunLedger:
    """Append-only JSONL writer, flushed per record.  Written from the
    driving thread only."""

    def __init__(self, path: str, run_id: str):
        self.path = path
        self.run_id = run_id
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self.records_written = 0

    def write(self, kind: str, **fields) -> None:
        if kind == "run_start":
            fields.setdefault("ledger_version", LEDGER_VERSION)
        rec = {"ts": round(time.time(), 6), "run_id": self.run_id,
               "kind": kind, **fields}
        self._f.write(json.dumps(rec, default=_json_default) + "\n")
        self._f.flush()
        self.records_written += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RunLedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _json_default(obj):
    """numpy scalars and arrays, and 0-dim tensors, by ``tolist``; anything
    else by its repr (a record must never fail the run it observes)."""
    if hasattr(obj, "tolist"):
        try:
            return obj.tolist()
        except Exception:
            pass
    return repr(obj)


def read_ledger(path: str, kind: Optional[str] = None) -> Iterator[dict]:
    """Yield ledger records (of ``kind``, if given), skipping lines that
    do not parse: a record torn by a crash mid-write is forensics, not an
    error."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if kind is None or rec.get("kind") == kind:
                yield rec
