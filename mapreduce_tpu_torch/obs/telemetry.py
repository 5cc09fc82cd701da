"""Telemetry facade: metrics registry, run ledger and flight recorder as
one handle.

Counterpart of :mod:`mapreduce_tpu.obs.telemetry`.  The streamed executor
and the CLI take ONE optional ``telemetry`` object:

* ``Telemetry.create(ledger_path=...)`` -- full telemetry: the JSONL
  ledger, the flight recorder (dumped to ``<ledger>.flight.json``), device
  memory in each step record and the builds that landed since the previous
  record, all writing into the process-global metrics registry;
* ``Telemetry.disabled()`` -- the shared no-op handle (what ``maybe(None)``
  gives): every method returns at once on ``self.enabled``.

Two parts differ from the JAX package's, because the device differs:

* :func:`device_memory_stats` reads the caching allocator's counters of
  the run's card (``torch.cuda.memory_allocated`` and
  ``max_memory_allocated``, in one read): metadata, with no sync.  The JAX
  ``live_arrays``/``live_bytes`` have no torch counterpart and are left
  out; on the CPU the dict is empty.
* ``compile_events`` are the port's first-use builds, the nvcc build of
  each ``csrc/*.cu`` (``ops/cuda/_build.py``) and the g++ build of the
  host chunker (``native/__init__.py``): each build reports through
  :func:`record_build`, and the next step record of every live handle
  carries the builds that landed in its window as
  ``{name: {"count", "seconds"}}``, the JAX shape.  A build in the middle
  of a run then shows as a compile, not as an unexplained ``dispatch``
  spike.

Several hosts (:meth:`Telemetry.attach_host`, the JAX handle's): every
record carries its ``host``, ``run_start`` the topology and the
``run_epoch`` clock pair, and the global driver's handle writes every
record to its host's shard ledger ``<ledger>.h<p>.jsonl`` while the main
file keeps the coordinator's (the ``write`` gate).  A flight dump carries
the latest data summary and its ``data_health`` verdict
(:func:`...obs.datahealth.classify`), and :meth:`Telemetry.note_tune`
keeps a hint run's ``tune`` recommendation for callers that never see the
``RunResult`` (the command line).
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from typing import Any, Optional

from mapreduce_tpu_torch.obs import datahealth
from mapreduce_tpu_torch.obs import flight as flight_mod
from mapreduce_tpu_torch.obs import ledger as ledger_mod
from mapreduce_tpu_torch.obs import registry as registry_mod

# Live handles receive every build; weak, so a handle dropped without
# close() is collected.
_LIVE: "weakref.WeakSet[Telemetry]" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def record_build(name: str, seconds: float) -> None:
    """One first-use build (``nvcc_<source>`` or ``gxx_chunker``) of
    ``seconds``: into the registry's ``build.seconds`` histogram and the
    pending compile events of every live handle."""
    registry_mod.get_registry().observe("build.seconds", seconds,
                                        build=name)
    with _LIVE_LOCK:
        live = list(_LIVE)
    for tel in live:
        tel._pend_compile(name, seconds)


def device_memory_stats(device=None) -> dict:
    """The caching allocator's view of ``device`` (a CUDA device):
    ``bytes_in_use`` and ``peak_bytes_in_use`` (what
    ``torch.cuda.memory_allocated`` and ``max_memory_allocated`` return,
    from one read of the allocator's statistics: each of those flattens
    and sorts all of them) and ``devices_reporting``.  Empty for the CPU
    or None.  Reads no device memory and waits on nothing."""
    out: dict = {}
    if device is None or getattr(device, "type", None) != "cuda":
        return out
    try:
        import torch

        alloc = torch.cuda.memory_stats_as_nested_dict(device)[
            "allocated_bytes"]["all"]
        out["bytes_in_use"] = int(alloc["current"])
        if alloc["peak"]:
            out["peak_bytes_in_use"] = int(alloc["peak"])
        out["devices_reporting"] = 1
    except Exception:
        pass  # observing must never take down the observed run
    return out


#: Default wall-clock seconds between two ``progress`` records.
DEFAULT_PROGRESS_EVERY_S = 5.0


class Telemetry:
    """One handle over the three planes.  See the module docstring."""

    def __init__(self, *, enabled: bool = True,
                 registry: Optional[registry_mod.MetricsRegistry] = None,
                 ledger: Optional[ledger_mod.RunLedger] = None,
                 flight: Optional[flight_mod.FlightRecorder] = None,
                 flight_path: Optional[str] = None,
                 progress_every_s: float = DEFAULT_PROGRESS_EVERY_S):
        self.enabled = enabled
        self.registry = registry if registry is not None \
            else registry_mod.get_registry()
        self.ledger = ledger
        self.flight = flight
        self.flight_path = flight_path
        # The run's id: the ledger's, or a fresh one (a hint run without a
        # ledger still tags the records it gives the tuner).
        self.run_id = ledger.run_id if ledger is not None \
            else uuid.uuid4().hex[:12]
        # Several hosts (attach_host): the record stamp, run_start's
        # topology and the host's shard ledger; empty on one host, so its
        # records keep their shapes.
        self.host: dict = {}
        self.topology: Optional[dict] = None
        self.shard: Optional[ledger_mod.RunLedger] = None
        # The latest data-plane summary: a flight dump carries it.
        self.last_data: Optional[dict] = None
        # A hint run's autotune recommendation (the ``tune`` record's
        # payload), for callers that never see the RunResult.
        self.last_tune: Optional[dict] = None
        self.progress_every_s = float(progress_every_s)
        self._last_progress_t: Optional[float] = None
        self._progress_t0: Optional[float] = None
        self._last_phases: dict = {}
        self._last_record_t: Optional[float] = None
        self._pending_compiles: list = []
        self._pending_lock = threading.Lock()
        if enabled:
            with _LIVE_LOCK:
                _LIVE.add(self)

    @classmethod
    def create(cls, ledger_path: Optional[str] = None,
               registry: Optional[registry_mod.MetricsRegistry] = None,
               progress_every_s: float = DEFAULT_PROGRESS_EVERY_S) \
            -> "Telemetry":
        """Full telemetry.  The flight dump goes next to the ledger
        (``<ledger>.flight.json``); without a ledger there is none.
        ``progress_every_s`` 0 writes a heartbeat at every opportunity.
        An unopenable ledger raises ``OSError``."""
        ledger = ledger_mod.RunLedger(ledger_path, uuid.uuid4().hex[:12]) \
            if ledger_path else None
        return cls(enabled=True, registry=registry, ledger=ledger,
                   flight=flight_mod.FlightRecorder(),
                   flight_path=ledger_path + ".flight.json"
                   if ledger_path else None,
                   progress_every_s=progress_every_s)

    _DISABLED: "Optional[Telemetry]" = None

    @classmethod
    def disabled(cls) -> "Telemetry":
        """The shared no-op handle."""
        if cls._DISABLED is None:
            cls._DISABLED = cls(enabled=False)
        return cls._DISABLED

    # -- several hosts ----------------------------------------------------

    def attach_host(self, process_index: int, process_count: int, *,
                    local_devices: Optional[int] = None,
                    clock: Optional[dict] = None,
                    shard: bool = True) -> None:
        """Join this handle to a run over several hosts.

        Every later record is stamped with ``host`` (``process_index``);
        ``run_start`` also carries ``processes``, ``local_devices`` and
        the ``clock`` pair (``parallel.distributed.run_epoch``).  With
        ``shard`` (the global driver) the host's shard ledger
        ``<ledger>.h<p>.jsonl`` opens next to the main file and gets every
        record whatever the write gate says, and a host other than 0
        dumps its flight record to its own path (the shard's, or
        ``<flight>.h<p>`` without a ledger).  Without ``shard`` (each host
        drives its own run and owns its ledger) only the stamps."""
        if not self.enabled:
            return
        self.host = {"host": int(process_index)}
        self.topology = {"processes": int(process_count)}
        if local_devices is not None:
            self.topology["local_devices"] = int(local_devices)
        if clock is not None:
            self.topology["clock"] = dict(clock)
        if shard and self.ledger is not None and self.shard is None:
            self.shard = ledger_mod.RunLedger(
                ledger_mod.shard_path(self.ledger.path, process_index),
                self.ledger.run_id)
        if shard and process_index != 0:
            if self.ledger is not None:
                self.flight_path = ledger_mod.shard_flight_path(
                    self.ledger.path, process_index)
            elif self.flight_path:
                self.flight_path = f"{self.flight_path}.h{process_index}"

    # -- builds -----------------------------------------------------------

    def _pend_compile(self, name: str, seconds: float) -> None:
        with self._pending_lock:
            self._pending_compiles.append((name, seconds))

    def _drain_compiles(self) -> dict:
        """The pending builds, summed per name."""
        with self._pending_lock:
            pending, self._pending_compiles = self._pending_compiles, []
        out: dict = {}
        for name, seconds in pending:
            agg = out.setdefault(name, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += seconds
        for agg in out.values():
            agg["seconds"] = round(agg["seconds"], 4)
        return out

    # -- records (no-ops when disabled) -----------------------------------

    def event(self, kind: str, **fields) -> None:
        """Record into the flight ring (not a ledger write)."""
        if self.enabled and self.flight is not None:
            self.flight.record(kind, **fields)

    def ledger_write(self, kind: str, write: bool = True, **fields) -> None:
        """Write one ledger record.  ``write=False`` (a process without
        the main file's write gate) skips the main file; the host's shard
        gets the record either way."""
        if not self.enabled:
            return
        if self.host:
            fields = {**self.host, **fields}
        if kind == "run_start" and self.topology:
            fields = {**fields, **self.topology}
        if write and self.ledger is not None:
            self.ledger.write(kind, **fields)
        if self.shard is not None:
            self.shard.write(kind, **fields)

    @property
    def writing(self) -> bool:
        """Does any record land in a file (the main ledger or a shard)?"""
        return self.ledger is not None or self.shard is not None

    def step_record(self, *, step_first: int, step_last: int,
                    group_bytes: int, cursor_bytes: int, timer,
                    inflight_depth: Optional[int] = None,
                    device=None) -> None:
        """One ``step`` record at a group's dispatch: the phase-second
        deltas since the previous record (the timer holds run totals), the
        wall-clock since it, the memory of ``device``, the builds that
        landed in the window and the in-flight depth after the dispatch.
        The registry's step counters advance with or without a ledger."""
        if not self.enabled:
            return
        phases = {k: round(v - self._last_phases.get(k, 0.0), 6)
                  for k, v in timer.phases.items()
                  if v - self._last_phases.get(k, 0.0) > 0}
        self._last_phases = dict(timer.phases)
        now = time.perf_counter()
        elapsed = None if self._last_record_t is None \
            else round(now - self._last_record_t, 6)
        self._last_record_t = now
        compiles = self._drain_compiles()
        steps = step_last - step_first + 1
        self.registry.counter("executor.steps").inc(steps)
        self.registry.counter("executor.dispatch_groups").inc()
        self.registry.counter("executor.bytes_streamed").inc(group_bytes)
        if "dispatch" in phases:
            self.registry.observe("executor.dispatch_seconds",
                                  phases["dispatch"])
        self.event("step", step_first=step_first, step_last=step_last,
                   cursor_bytes=cursor_bytes)
        if not self.writing:
            return
        rec: dict[str, Any] = dict(step_first=step_first, step_last=step_last,
                                   steps=steps, group_bytes=group_bytes,
                                   cursor_bytes=cursor_bytes, phases=phases,
                                   mem=device_memory_stats(device))
        if elapsed is not None:
            rec["elapsed_s"] = elapsed
        if inflight_depth is not None:
            rec["inflight_depth"] = inflight_depth
        if compiles:
            rec["compile_events"] = compiles
        self.ledger_write("step", **rec)

    def progress(self, *, step: int, cursor_bytes: int, streamed_bytes: int,
                 total_bytes: Optional[int] = None,
                 groups_dispatched: Optional[int] = None,
                 groups_retired: Optional[int] = None,
                 inflight_depth: Optional[int] = None) -> bool:
        """The live heartbeat: one ``progress`` record per
        :attr:`progress_every_s` of wall clock (the first call writes one)
        with the cursor, completion fraction, groups dispatched and
        retired, depth, rate and ETA.  Host-side only; the not-due path is
        one monotonic read.  True when a record was written; always False
        without a ledger or a shard."""
        if not self.enabled or not self.writing:
            return False
        now = time.monotonic()
        if self._progress_t0 is None:
            self._progress_t0 = now
        if self._last_progress_t is not None \
                and now - self._last_progress_t < self.progress_every_s:
            return False
        self._last_progress_t = now
        elapsed = now - self._progress_t0
        rec: dict[str, Any] = {"step": int(step),
                               "cursor_bytes": int(cursor_bytes),
                               "streamed_bytes": int(streamed_bytes),
                               "elapsed_s": round(elapsed, 6)}
        if total_bytes:
            rec["total_bytes"] = int(total_bytes)
            rec["frac"] = round(min(1.0, int(streamed_bytes)
                                    / int(total_bytes)), 6)
        if elapsed > 0 and streamed_bytes:
            rate = int(streamed_bytes) / elapsed
            rec["bytes_per_s"] = round(rate, 1)
            rec["gb_per_s"] = round(rate / 1e9, 6)
            if total_bytes and int(total_bytes) > int(streamed_bytes):
                rec["eta_s"] = round(
                    (int(total_bytes) - int(streamed_bytes)) / rate, 3)
        if groups_dispatched is not None:
            rec["groups_dispatched"] = int(groups_dispatched)
        if groups_retired is not None:
            rec["groups_retired"] = int(groups_retired)
        if inflight_depth is not None:
            rec["inflight_depth"] = int(inflight_depth)
        self.ledger_write("progress", **rec)
        return True

    def note_data(self, data: Optional[dict]) -> None:
        """Keep the latest data-plane summary for a flight dump."""
        if self.enabled and data is not None:
            self.last_data = data

    def note_tune(self, tune: Optional[dict]) -> None:
        """Keep the run's autotune recommendation (a dict assignment)."""
        if self.enabled and tune is not None:
            self.last_tune = tune

    def flight_dump(self, context: Optional[dict] = None,
                    state: Any = None) -> Optional[str]:
        """Dump the flight ring, a summary of ``state`` (metadata only),
        the registry snapshot, the latest data summary and its
        ``data_health`` classification.  Returns the
        dump's path (None when disabled or pathless); the first dump of a
        run owns the file."""
        if not (self.enabled and self.flight is not None
                and self.flight_path):
            return None
        summary = None
        if state is not None:
            try:
                summary = flight_mod.summarize_state(state)
            except Exception:
                summary = {"error": "state summary failed"}
        data_health = None
        if self.last_data is not None:
            try:  # a dump must never mask the failure it records
                data_health = datahealth.classify(self.last_data)
            except Exception:
                data_health = {"error": "classification failed"}
        return self.flight.dump(self.flight_path, context=context,
                                state_summary=summary,
                                registry_snapshot=self.registry.snapshot(),
                                data=self.last_data,
                                data_health=data_health)

    def close(self) -> None:
        """Close the ledger (and the shard) and stop receiving builds."""
        with _LIVE_LOCK:
            _LIVE.discard(self)
        for f in (self.ledger, self.shard):
            if f is not None:
                f.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def maybe(telemetry: Optional[Telemetry]) -> Telemetry:
    """An optional telemetry argument as a usable handle."""
    return telemetry if telemetry is not None else Telemetry.disabled()
