"""Streamed jobs over files, on D ranks: the pipelined executor.

``run_job`` runs any job whose state is a NamedTuple of tensors (nested,
or with host ints): the word-count family (the word count, its top-k, the
n-gram job and the sketch wrappers, through ``count_file(ngram=,
distinct_sketch=, count_sketch=)``), grep (``models/grep.py:grep_file``)
and the reservoir sample (``models/sample.py:sample_file``).  A job
supplies ``init_state``, ``map_chunk`` (or the streamed
``map_chunk_sharded``), ``combine``, ``finalize``, ``identity`` and a
``device``; ``on_input_boundary`` and the data-statistics hooks
(``map_chunk_stats``, ``state_stats``) are optional.

Counterpart of :mod:`mapreduce_tpu.runtime.executor` (``run_job`` and its
``_drive_stream`` loop, ``count_file``, ``recover_from_file``,
``absolute_offsets``) over one data axis of D ranks, one card a rank
(:mod:`...parallel.mesh`; D = 1 outside a ``torch.distributed`` world).
Every rank runs the same loop over the same batches: a step cuts D rows,
and rank r maps row r as chunk ``step * D + r``, so a D-rank run equals
the JAX package's run on ``data_mesh(D)``.  Per run and rank:

  1. a reader thread (:func:`...data.reader.prefetch`) cuts the corpus into
     boundary-aligned chunks with the native chunker, each filled straight
     into a pinned staging buffer;
  2. each chunk is copied to the card on a copy stream the moment the loop
     takes it (``stage``); an event recorded after the copy is what the
     compute stream waits on before the step, and what frees the pinned
     buffer for the reader again;
  3. ``superstep`` chunks form a group, dispatched as one
     ``Engine.step`` a chunk (``dispatch``); an event recorded on the
     compute stream after them is the group's completion token;
  4. up to ``inflight_groups`` groups stay dispatched but unretired; the
     oldest retires by waiting on its token (``retire_wait``) when the
     window is full, and the window drains at checkpoint boundaries, at
     file boundaries and at the stream's end (``h2d_tail``,
     ``compute_tail``); at a file boundary a job with cross-chunk state
     (the n-gram seam carry) resets it through ``on_input_boundary``;
  5. every ``checkpoint_every`` steps the state and the ingest cursor are
     saved (:mod:`...runtime.checkpoint`), and a run with a snapshot at its
     checkpoint path resumes from it;
  6. the finished table's words are read back from the files (``recover``).

Failures (:mod:`...runtime.faults`).  Every exception that crosses a named
seam is classified (transient, resource, permanent, preemption), and the
run's :class:`...runtime.faults.FailurePolicy` decides:

- with a retry budget (``retry > 0``, or a policy with any budget), the
  window fills, drains as one batch and *re-anchors*: the anchor is the
  state after the drain, held by reference (``Engine.step`` never writes
  into its input state), and the pinned buffers of every group since the
  anchor stay out of the pool.  A failed group replays every group since
  the anchor serially, re-staged from those buffers, the failed group
  charged one attempt; a resource-classed exhaustion steps down the
  degradation ladder (combiner off, then the split map, then the torch
  sort) and replays again;
- a permanent failure (a sticky CUDA error among them) fails at once;
- preemption (``KeyboardInterrupt``, or an error that says so) drains the
  window, saves a snapshot if a checkpoint path is set, and raises
  :class:`...runtime.faults.Preempted` with the resume cursor;
- under ``token_timeout_s``, every wait of the loop on the compute stream
  polls an event against a deadline and raises ``TokenTimeout`` past it:
  a group's completion token, and the map's one host read of a chunk,
  which would otherwise block behind every kernel queued before it (it
  copies to pinned memory behind an event instead).  A kernel cannot be
  cancelled on CUDA: a replay queues behind a hung kernel on the same
  stream, so a kernel that never finishes ends the run with a
  ``TokenTimeout`` once the budget is spent, and keeps the card busy
  until it ends.

A :class:`...runtime.faults.FaultPlan` (``Config.fault_plan``) injects
faults at the seams ``reader-read``, ``stage-acquire``, ``h2d``,
``dispatch``, ``token-wait``, ``checkpoint-save``, ``collective-finish`` and
``process-kill``, crossed in the JAX loop's order, so one plan fires at
the same crossings in both packages.

What the window can hide is the reader, the H2D copy and host
bookkeeping: the map reads ``(spill, overlong, tokens)`` to the host once
per chunk (``models/wordcount.py:_map_kernel``, timed as ``host_read``
inside ``dispatch``), so compute never runs more than one chunk ahead of
the loop.  On the CPU (``device='cpu'``) the loop is the same, with no
streams, events or pinned memory.

Telemetry (``telemetry=``, :mod:`...obs.telemetry`): the run ledger's
records at the JAX package's points (``run_start``; a ``step`` record per
dispatched group and a ``group`` record per retired one; ``progress``;
``fault``, ``retry``, ``degrade``, ``checkpoint`` and ``failure``; the
``collective`` finish; the run's ``data`` record; ``run_end``), the
metrics registry's instruments under the JAX names, a flight dump on a
failure, and the data-plane statistics of a word count (read at each
group's retirement, from pinned memory behind its completion event: no new
sync).  The ``ledger-append`` seam is crossed when a ledger is attached.
Without a handle the loop runs as it did without telemetry.

Across ranks the finish is a collective merge (``merge_strategy``, over
one axis or a two-level mesh), a snapshot is the coordinator's to write,
and the ledger is the coordinator's, its ``data`` record summed over the
ranks.  Over several hosts, ``run_job(byte_range=)`` streams one host's
range over its own ranks (the JAX package's mode (a)), and
``run_job_global`` runs one program over every host's ranks with a
ledger shard a host (mode (b)).

The JAX reference runs one process over the mesh, where a fault or a
SIGINT stops every device at once; here each rank is a process, so the
ranks agree (:class:`_Accord`): at every crossing where a local event
decides the loop's next move (a read, a group's seams, its step, its
completion wait, a snapshot, a collective's seam) each rank gives the
class of its failure and a pending SIGINT in one small all_reduce over a
gloo control group, and every rank acts on the outcome.  Window replay,
the degradation ladder and preemption's drain and snapshot therefore run
across ranks as on one: every rank anchors, replays, steps down and drains
at the same group, and a SIGINT to one rank preempts every rank at the
same step.

Window-boundary merges (``Config.merge_overlap``, :class:`_OverlapMerger`)
merge the ranks' local states into a replicated accumulator every
``inflight_groups`` retired groups and at checkpoint, file and preemption
boundaries, and the finish merges only the residual.

Not ported yet (ROADMAP A8b (ii)): the autotuner.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import os
import signal
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from mapreduce_tpu_torch import convert, native
from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.models.wordcount import (
    FreqSketchedState, FreqSketchedWordCountJob, NGramCountJob,
    SketchedState, SketchedWordCountJob, TopKTable, TopKWordCountJob,
    WordCountJob, WordCountResult, _reported_distinct, apply_top_k,
    job_with_config)
from mapreduce_tpu_torch.obs import telemetry as obs_telemetry
from mapreduce_tpu_torch.obs.spans import span, timing_into
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops import ngram as ngram_ops
from mapreduce_tpu_torch.ops import sketch as sketch_ops
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.parallel import collectives, distributed
from mapreduce_tpu_torch.parallel.mapreduce import Engine
from mapreduce_tpu_torch.parallel.mesh import control_group, data_mesh
from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod
from mapreduce_tpu_torch.runtime import faults as faults_mod
from mapreduce_tpu_torch.runtime import metrics as metrics_mod
from mapreduce_tpu_torch.runtime.logging import get_logger, log_event

#: Phases in which the loop waits rather than works (see _overlap_fraction).
#: ``host_read`` is the map's one read of a chunk (inside ``dispatch``).
_BLOCKED = ("read_wait", "host_read", "retire_wait", "h2d_tail",
            "compute_tail")

#: Seconds between two polls of a completion token.
_POLL_S = 5e-5


@dataclasses.dataclass
class RunResult:
    """A streamed run's finished job state and its measurements."""

    value: Any  # the finished job state (a CountTable on the run's device)
    metrics: metrics_mod.RunMetrics
    bases: np.ndarray  # int64[steps, D] row base offsets (string recovery)
    pipeline: Optional[dict] = None  # the window statistics (``pipe``)
    rank: int = 0  # this process's rank on the data axis


def _overlap_fraction(timer) -> Optional[float]:
    """``1 - blocked_time / stream_time``: the share of the streamed
    wall-clock in which the loop was not waiting on the reader, on the
    card (the map's per-chunk host read, a full window) or on the
    end-of-stream tails, but doing host work (staging, launching,
    bookkeeping).  A loop that waits on the card most of the time trends
    toward 0, one whose host work is the bottleneck toward 1.  None
    before the stream was timed."""
    stream = timer["stream"]
    if not stream:
        return None
    blocked = sum(timer[p] for p in _BLOCKED)
    return round(max(0.0, 1.0 - blocked / stream), 4)


def _wait_token(stage, token, timeout_s: Optional[float] = None,
                interrupted=None, seam: str = "token-wait") -> None:
    """Wait until ``stage.ready(token)``, polling with a short sleep;
    ``interrupted()`` (raises ``KeyboardInterrupt`` once a SIGINT arrived)
    runs at every poll, and past ``timeout_s`` (None: no bound) the wait
    raises :class:`...runtime.faults.TokenTimeout` at ``seam``.  A failed
    kernel's error surfaces from ``ready`` (``Event.query``)."""
    if stage.ready(token):
        return
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        time.sleep(_POLL_S)
        if stage.ready(token):
            return
        if interrupted is not None:
            interrupted()
        if deadline is not None and time.monotonic() >= deadline:
            raise faults_mod.TokenTimeout(
                f"completion token not ready within {timeout_s}s (hung or "
                "slow kernel)", seam=seam)


@contextlib.contextmanager
def _sigint_deferred():
    """While the stream runs, a SIGINT is recorded instead of raised
    wherever the interpreter happens to be: the loop raises it as a
    ``KeyboardInterrupt`` at its safe points, where the committed state
    and the cursor agree (a snapshot taken between a group's accounting
    and its state would resume one group short).  Yields the record; a
    SIGINT left in it when the stream ends is delivered again.  Only in
    the main thread and over Python's default handler; elsewhere a SIGINT
    stays an immediate ``KeyboardInterrupt``."""
    pending: list = []
    if threading.current_thread() is not threading.main_thread() \
            or signal.getsignal(signal.SIGINT) \
            is not signal.default_int_handler:
        yield pending
        return
    signal.signal(signal.SIGINT, lambda signum, frame: pending.append(signum))
    try:
        yield pending
    except faults_mod.Preempted:
        # The run is already leaving in order: a second SIGINT during its
        # drain or snapshot must not turn that exit into an interrupt.
        pending.clear()
        raise
    finally:
        signal.signal(signal.SIGINT, signal.default_int_handler)
        if pending:
            signal.raise_signal(signal.SIGINT)


class _HostStage:
    """Staging of a CPU run: row ``row`` of the reader's array is the
    chunk (no copy, no events; work is done when the call returns, so
    every token is ready)."""

    take = None

    def __init__(self, row: int = 0):
        self.row = row

    def stage(self, batch, hold: bool = False):
        return torch.from_numpy(batch.data[self.row]), None

    @staticmethod
    def read(flags, timeout_s: Optional[float]) -> list:
        return flags.tolist()

    def release(self, batch) -> None:
        pass

    def wait_copies(self, events) -> None:
        pass

    def completion(self):
        return object()

    @staticmethod
    def ready(token) -> bool:
        return True

    def summary(self) -> dict:
        return {"pinned_buffers": 0, "h2d_ms_per_chunk": None}


class _PinnedStage:
    """Staging of a CUDA run: pinned host buffers and a copy stream.

    The reader thread fills a pinned buffer (the step's ``[D, C]`` batch)
    it gets from :meth:`take`; the loop copies this rank's row ``row`` to
    the card on the copy stream and records an event after the copy
    (:meth:`stage`).  The buffer returns to the pool with
    that event and is handed out again only once the event has completed,
    i.e. once the copy has read it; a buffer refilled earlier would corrupt
    a chunk silently.  A buffer staged with ``hold=True`` (a group a replay
    may need to stage again) stays out of the pool until :meth:`release`
    returns it with its last copy's event; ``held`` is how many the loop
    may hold at once, on top of the reader's.  The device chunk is
    allocated on the copy stream and marked as used by the compute stream
    (``record_stream``), so the caching allocator does not reuse its memory
    while a kernel reads it.
    """

    def __init__(self, device: torch.device, nbytes: int, depth: int,
                 held: int = 0, row: int = 0):
        self.nbytes = nbytes
        self.row = row
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        # Buffers held at once without a copy event: the prefetch queue's
        # `depth`, and the one the loop took but has not staged yet.  One
        # more is always back in the pool, or can be waited for.
        self.cap = depth + 2 + held
        self._lock = threading.Lock()
        self._returned: collections.deque = collections.deque()
        self._held: dict[int, tuple] = {}  # address -> (buffer, last copy)
        self._pinned: dict[int, torch.Tensor] = {}  # address -> buffer
        self._copies: list = []  # (start, done) events of every copy

    def take(self) -> np.ndarray:
        """A free pinned buffer (``nbytes`` uint8): a returned one whose
        copy has completed, a new one while fewer than ``cap`` exist, else
        the oldest returned one after its copy completes."""
        with self._lock:
            for i, (buf, ev) in enumerate(self._returned):
                if ev.query():
                    del self._returned[i]
                    return buf.numpy()
            if len(self._pinned) < self.cap:
                buf = torch.empty(self.nbytes, dtype=torch.uint8,
                                  pin_memory=True)
                self._pinned[buf.data_ptr()] = buf
                return buf.numpy()
            if not self._returned:
                raise RuntimeError("every pinned staging buffer is held "
                                   "without a copy: the pool is too small")
            buf, ev = self._returned.popleft()
        ev.synchronize()
        return buf.numpy()

    def stage(self, batch, hold: bool = False):
        """Copy this rank's row of a batch to the card on the copy
        stream: ``(device chunk, copy event)``.  ``hold`` keeps the buffer
        out of the pool."""
        host = torch.from_numpy(batch.data[self.row])
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record(self.copy_stream)
            chunk = torch.empty(host.shape[0], dtype=torch.uint8,
                                device=self.device)
            chunk.copy_(host, non_blocking=True)
            done.record(self.copy_stream)
        chunk.record_stream(self.compute)
        self._copies.append((start, done))
        addr = batch.data.ctypes.data
        with self._lock:
            if hold:
                self._held[addr] = (self._pinned[addr], done)
            else:
                self._returned.append((self._pinned[addr], done))
        return chunk, done

    def release(self, batch) -> None:
        """Return a held buffer to the pool with its last copy's event."""
        with self._lock:
            self._returned.append(self._held.pop(batch.data.ctypes.data))

    def read(self, flags: torch.Tensor, timeout_s: Optional[float]) -> list:
        """The map's host read of ``flags`` under a deadline: a copy to
        pinned memory on the compute stream, and a polled wait on an event
        after it, so a late or hung kernel queued before it raises
        ``TokenTimeout`` instead of blocking the loop."""
        host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        host.copy_(flags, non_blocking=True)
        _wait_token(self, self.completion(), timeout_s, seam="dispatch")
        return host.tolist()

    def wait_copies(self, events) -> None:
        """The compute stream waits for the group's copies."""
        for ev in events:
            self.compute.wait_event(ev)

    def completion(self) -> torch.cuda.Event:
        """A group's completion token: an event after its step."""
        ev = torch.cuda.Event()
        ev.record(self.compute)
        return ev

    @staticmethod
    def ready(event) -> bool:
        return event.query()

    def summary(self) -> dict:
        """Pinned buffers allocated and the H2D milliseconds of each copy
        (every copy has completed once the window is drained)."""
        ms = [a.elapsed_time(b) for a, b in self._copies]
        return {"pinned_buffers": len(self._pinned),
                "h2d_ms_per_chunk": round(sum(ms) / len(ms), 4) if ms
                else None}


@dataclasses.dataclass
class _Inflight:
    """One dispatched but unretired group: the window's unit."""

    done: Any  # completion token
    copy_done: Any  # the event of the group's last H2D copy
    step_first: int
    cursor_before: int  # bytes_done before the group (the failure cursor)
    life: dict  # lifecycle stamps and sizes (the `group` ledger record)
    # The group's data statistics on their way to the host (a telemetered
    # run's StatsFetch), read at retirement; None otherwise.
    stats: Any = None


class _DegradeSignal(Exception):
    """A resource-classed failure exhausted its budget inside a replay and
    the ladder may still have a step: ``recover`` decides."""

    def __init__(self, error: BaseException):
        self.error = error


#: The fault classes in the order the ranks' agreement ranks them: when
#: ranks fail at one crossing with different classes, every rank acts on
#: the last of them.
_AGREE_ORDER = ("transient", "resource", "permanent", "preemption")


class _Accord:
    """The ranks' agreement on the stream's control flow.

    At each crossing where a local event (a fault, a timeout, a SIGINT)
    decides the loop's next move, every rank calls it with its own error
    (None: none) and a flag (a pending SIGINT, or a landed snapshot): one
    all_reduce (max) of two int64 words over the run's gloo control group
    (:func:`...parallel.mesh.control_group`).  It returns the error every
    rank acts on (this rank's own when its class is the agreed one, else a
    :func:`...runtime.faults.peer_fault` of that class) and whether any
    rank raised the flag.  The words go through the host, never the
    card's stream, and the group is apart from the job's collectives, so
    an agreement waits on no kernel and never pairs with a map's gather.
    ``rounds`` and ``seconds`` count the calls and their time."""

    def __init__(self, axis):
        self.group = control_group(axis)
        self.rounds = 0
        self.seconds = 0.0

    def __call__(self, err: Optional[BaseException], seam: str,
                 flag: bool = False):
        mine = 0 if err is None \
            else _AGREE_ORDER.index(faults_mod.classify(err)) + 1
        t0 = time.perf_counter()
        word = torch.tensor([mine, int(flag)], dtype=torch.int64)
        dist.all_reduce(word, op=dist.ReduceOp.MAX, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.rounds += 1
        code, any_flag = int(word[0]), bool(word[1])
        if code == 0:
            return None, any_flag
        if code == mine:
            return err, any_flag
        return faults_mod.peer_fault(_AGREE_ORDER[code - 1], seam), any_flag


class _OverlapMerger:
    """Window-boundary merges (``Config.merge_overlap``): the JAX package's
    ``_OverlapMerger`` over the ranks of a run.

    One replicated accumulator and at most one partial in flight.  At a
    boundary (a window's worth of retired groups, a checkpoint, a file
    boundary of a job with a boundary hook, a preemption) :meth:`boundary`
    retires the previous partial, merges the ranks' local states into the
    accumulator with the run's strategy (``Engine.partial_merge``) through
    the ``collective-finish`` seam, so a plan's crossing 0 is the first
    partial, and returns the local state reset (``Engine.partial_reset``).
    :meth:`due` is a pure function of the group sequence, so every rank
    merges at the same boundary.

    The partial is issued on the loop's thread and the compute stream,
    where the job's collectives run, so it pairs with the same call on
    every rank.  Over gloo it copies through the host and returns once it
    is done: nothing overlaps it.  Under NCCL its kernels and collectives
    are queued on the stream behind the window's steps.  Each retired
    partial writes one ``op='partial'`` ``collective`` record, from the
    call to the moment its completion event was seen done (the next
    boundary or the finish)."""

    def __init__(self, engine, stage, tel, plan, policy, logger, strategy,
                 window_cap: int, accord=None):
        self.engine = engine
        self.stage = stage
        self.tel = tel
        self.plan = plan
        self.policy = policy
        self.logger = logger
        self.strategy = strategy
        self.window_cap = max(1, int(window_cap))
        self.accord = accord
        self.accum = None
        self.partials = 0
        self._retired_at_last = 0
        self._inflight = None  # (completion token, started_at, step)

    def disarm(self) -> None:
        """Preemption's shutdown: no further injected faults."""
        self.plan = None

    def due(self, retired_groups: int) -> bool:
        """A window's worth of groups retired since the last boundary."""
        return retired_groups - self._retired_at_last >= self.window_cap

    def retire(self) -> None:
        """See the previous partial done and write its ledger record."""
        if self._inflight is None:
            return
        token, t0, step = self._inflight
        self._inflight = None
        _wait_token(self.stage, token)
        self.tel.ledger_write("collective", op="partial",
                              strategy=self.strategy, step=step,
                              started_at=t0,
                              ended_at=round(time.perf_counter(), 6))

    def boundary(self, state, step: int, retired_groups: int):
        """Merge ``state`` into the accumulator; the reset local state."""
        self.retire()
        t0 = round(time.perf_counter(), 6)
        self.accum = _collective_call(
            lambda: self.engine.partial_merge(self.accum, state), self.plan,
            self.policy, self.tel, self.logger, self.accord)
        self._inflight = (self.stage.completion(), t0, step)
        self.partials += 1
        self._retired_at_last = retired_groups
        self.tel.event("partial_merge", step=step)
        return self.engine.partial_reset(state)

    def host_leaves(self) -> list:
        """The accumulator as a snapshot's leading leaves (the JAX package
        packs ``{"a": accumulator, "s": state}``, flattened in key order):
        replicated, so no device axis."""
        self.retire()
        return [leaf[0] for leaf in convert.state_to_leaves(self.accum)]

    def template(self) -> list:
        """The accumulator's leaves' shapes (a snapshot's template)."""
        return [leaf[0] for leaf in
                convert.state_to_leaves(self.engine.accum_template())]

    def restore(self, leaves: list, device) -> None:
        """The accumulator of a resumed snapshot."""
        self.accum = convert.leaves_to_state(
            [leaf[None] for leaf in leaves], self.engine.accum_template(),
            device)


def _config_summary(config: Config) -> dict:
    """The degradation ladder's view of a config (label values, the shape
    ``faults.next_degrade`` reads)."""
    return {"geometry": config.geometry_label,
            "combiner": config.resolved_combiner,
            "map_impl": config.map_impl, "sort_impl": config.sort_impl}


def _apply_degrade(config: Config, field: str, value: str) -> Config:
    """One ladder step applied to the config: revert-geometry sets the
    default geometry (None); combiner-off also drops the cache's sizing
    knob, which is valid only with the cache on."""
    if field == "geometry":
        return dataclasses.replace(config, geometry=None)
    kw: dict = {field: value}
    if field == "combiner":
        kw["combiner_slots"] = None
    return dataclasses.replace(config, **kw)


def _record_fault(tel, exc: BaseException, *, seam: str, injected: bool,
                  index: Optional[int] = None,
                  step: Optional[int] = None) -> str:
    """One typed-fault observation: the ``executor.faults`` counter, the
    flight ring and a ``fault`` ledger record (best-effort: the ledger may
    be what is failing, and a record must never mask the fault).  Returns
    the class."""
    cls = faults_mod.classify(exc)
    tel.registry.counter("executor.faults", seam=seam, fault_class=cls).inc()
    tel.event("fault", seam=seam, fault_class=cls, injected=injected,
              error=repr(exc))
    try:
        rec: dict = {"seam": seam, "fault_class": cls, "injected": injected,
                     "error": repr(exc)}
        if index is not None:
            rec["index"] = int(index)
        if step is not None:
            rec["step"] = int(step)
        tel.ledger_write("fault", **rec)
    except Exception:
        pass
    return cls


def _with_budget(thunk, seam: str, policy, *, injected_only: bool,
                 on_retry):
    """``thunk()``, retried on the failure's class budget with the policy's
    backoff; ``on_retry(attempt, error, fault_class)`` records each retry.
    Preemption, an exhausted budget and, with ``injected_only``, a real
    failure re-raise.  (A replayed group retries in ``serial_dispatch``,
    which charges the attempt it spent in the window.)"""
    attempt = 0
    while True:
        try:
            return thunk()
        except Exception as e:
            cls = faults_mod.classify(e)
            injected = isinstance(e, faults_mod.FaultError) and e.injected
            if cls == "preemption" or (injected_only and not injected) \
                    or attempt >= policy.budget(cls):
                raise
            attempt += 1
            on_retry(attempt, e, cls)
            s = policy.backoff_s(cls, attempt, seam=seam)
            if s > 0:
                time.sleep(s)


def _group_life(batches, read_at: Optional[float], group_bytes: int) -> dict:
    """Start a group's lifecycle record: identity, size and the stamps so
    far; ``staged_at`` is now (the caller is about to stage)."""
    return {"step_first": batches[0].step, "step_last": batches[-1].step,
            "steps": batches[-1].step - batches[0].step + 1,
            "group_bytes": group_bytes,
            "read_at": round(read_at, 6) if read_at is not None else None,
            "staged_at": round(time.perf_counter(), 6)}


#: ``data`` counters of a group record mirrored into registry counters at
#: retirement (per-group deltas), as the JAX package names them.
_DATA_COUNTER_METRICS = (
    ("overlong", "data.overlong_tokens"),
    ("rescued", "data.rescued_tokens"),
    ("dropped_tokens", "data.dropped_tokens"),
    ("fallback_chunks", "data.spill_fallback_chunks"),
    ("rescue_escalations", "data.rescue_escalations"),
    ("spill_rows", "data.spill_rows"),
)


def _group_record(tel, life: dict, token_ready_at: float, retired_at: float,
                  wait_s: float, retries: int = 0,
                  data: Optional[dict] = None) -> None:
    """One ``group`` ledger record for a retired group, and its registry
    instruments.  Host bookkeeping only: a few stamps and one JSONL
    append."""
    tel.registry.counter("executor.groups_retired").inc()
    d = life.get("dispatched_at")
    if d is not None:
        tel.registry.observe("executor.group_device_seconds",
                             max(0.0, token_ready_at - d))
    tel.registry.observe("executor.retire_wait_seconds", max(0.0, wait_s))
    if not tel.enabled:
        return
    rec = {k: v for k, v in life.items() if v is not None}
    rec["token_ready_at"] = round(token_ready_at, 6)
    rec["retired_at"] = round(retired_at, 6)
    rec["retire_wait_s"] = round(max(0.0, wait_s), 6)
    if retries:
        rec["retries"] = retries
    if data is not None:
        rec["data"] = data
        for field, metric in _DATA_COUNTER_METRICS:
            v = data.get(field)
            if v:
                tel.registry.counter(metric).inc(v)
        if data.get("occupancy") is not None:
            tel.registry.gauge("data.table_occupancy").set(data["occupancy"])
        if data.get("top_mass") is not None:
            tel.registry.gauge("data.top_mass").set(data["top_mass"])
    tel.ledger_write("group", **rec)


def _stream_total_bytes(path, start_offset: int,
                        end_offset: Optional[int] = None) -> Optional[int]:
    """The bytes this stream will read, the heartbeat's denominator: a
    byte range's own size, else the files' (None when the input cannot be
    sized)."""
    try:
        if end_offset is not None:
            return max(0, int(end_offset) - int(start_offset))
        paths = path if isinstance(path, (list, tuple)) else [path]
        return max(0, sum(os.path.getsize(p) for p in paths)
                   - int(start_offset))
    except (OSError, TypeError, ValueError):
        return None


def _drive_stream(engine, config: Config, path, state, stage, *,
                  start_step: int, start_offset: int, bases_list: list,
                  checkpoint_path, checkpoint_every: int, fingerprint,
                  resumed_file, logger, progress_every: int, timer,
                  plan, policy, replay: bool, rebuild, sigint: list, tel,
                  data_agg, device, end_offset: Optional[int] = None,
                  host_rows=None, accord=None, overlap=None):
    """The streaming loop, the JAX ``_drive_stream``.  Returns ``(state,
    bytes_done, pipe)``: ``bytes_done`` is the absolute cursor (it starts
    at ``start_offset``) and ``pipe`` the window statistics.

    ``plan`` is the run's fault plan (or None), ``policy`` its failure
    policy; ``replay`` (a budget for any class, without window-boundary
    merges) arms the anchor and the window replay (see the module
    docstring); ``rebuild(config)`` gives the engine of a degraded config.
    ``end_offset`` ends the stream (a host's byte range); ``host_rows``,
    the rows of this process's host on the global driver, add
    ``host_bytes`` to the ``group`` records.  ``cur_config`` is the
    ladder's moving target: the loop's own knobs (superstep, window,
    prefetch) stay the caller's.  ``sigint`` is the record of
    :func:`_sigint_deferred`.  ``accord`` (an :class:`_Accord`, across
    ranks) makes every rank act alike on a local event: each crossing
    where one decides the loop's next move ends in an agreement, and a
    SIGINT is raised on every rank at the same read.  ``overlap`` (an
    :class:`_OverlapMerger`) merges at window, checkpoint, file and
    preemption boundaries.

    ``tel`` (a :class:`...obs.telemetry.Telemetry`, the disabled one when
    the run has none) gets the JAX package's records at its points: a
    ``step`` record per dispatched group (at dispatch, with ``device``'s
    memory), a ``group`` record per retired group (its lifecycle stamps on
    ``time.perf_counter`` and, with ``data_agg``, its data statistics,
    read from pinned memory once its completion event is seen), the
    ``progress`` heartbeat, and the ``fault``, ``retry``, ``degrade``,
    ``checkpoint`` and ``failure`` records, with a flight dump on a
    failure.  Every record is written between the loop's safe points,
    where a SIGINT cannot land (it is deferred), so no line is torn.
    The ``ledger-append`` seam is crossed only when a ledger is attached.
    """
    cur_config = config
    replayable = replay
    bytes_done = int(start_offset)
    step_index = start_step
    last_ckpt = start_step // checkpoint_every if checkpoint_every else 0
    window_cap = config.inflight_groups
    window: collections.deque = collections.deque()
    # Replayable: the state at the last re-anchor, and every (group,
    # cursor before it) dispatched since, which a failure replays.
    anchor = None
    since_anchor: list = []
    # The state that matches the cursor: set where a group is accounted,
    # and what a preemption snapshots.  `interrupted` raises a recorded
    # SIGINT, except while a replay or the preemption drain runs (their
    # state is not the committed one).
    live = state
    quiet = False
    last_file_dispatched = resumed_file or 0
    # step -> when its batch left the reader: a group's `read_at` is its
    # first batch's.
    read_t: dict = {}
    pipe = {"inflight_groups": window_cap,
            "prefetch_depth": config.resolved_prefetch_depth,
            "dispatch_groups": 0, "depth_sum": 0, "depth_max": 0,
            "full_retires": 0, "boundary_drains": 0}
    stream_total = _stream_total_bytes(path, start_offset, end_offset) \
        if tel.enabled else None
    retired_groups = 0

    def interrupted() -> None:
        """Raise a recorded SIGINT (on one rank; across ranks a SIGINT is
        raised only where the ranks agree, in :func:`settle`)."""
        if accord is None and sigint and not quiet:
            sigint.clear()
            raise KeyboardInterrupt

    def settle(err: Optional[BaseException], seam: str,
               safe: bool = False) -> None:
        """The end of a crossing: raise the error every rank acts on.  On
        one rank that is ``err``; across ranks the agreed one, so a rank
        whose peer failed fails alike.  At a ``safe`` point (the stream's
        reads and its end) a recorded SIGINT is raised too, on every rank
        when any rank has one."""
        if accord is None:
            if err is not None:
                raise err
            if safe:
                interrupted()
            return
        pending = safe and bool(sigint) and not quiet
        agreed, any_sigint = accord(err, seam, pending)
        if agreed is not None:
            raise agreed
        if safe and any_sigint:
            sigint.clear()
            raise KeyboardInterrupt

    def overlap_boundary(state):
        """A window-boundary partial merge; the reset local state is the
        committed one."""
        nonlocal live
        with span("retire_wait", timer):
            overlap.retire()
        with span("dispatch", timer):
            state = overlap.boundary(state, step_index, retired_groups)
        live = state
        return state

    def heartbeat() -> None:
        """The ``progress`` record, on its wall-clock cadence (the not-due
        path is one clock read)."""
        tel.progress(step=step_index, cursor_bytes=bytes_done,
                     streamed_bytes=bytes_done - int(start_offset),
                     total_bytes=stream_total,
                     groups_dispatched=pipe["dispatch_groups"],
                     groups_retired=retired_groups,
                     inflight_depth=len(window))

    def cross(seam: str) -> None:
        """One crossing of the fault plan's ``seam`` (callers check ``plan
        is not None``): record and raise the fault it fires.
        ``process-kill`` is the machine going away: ``os._exit``, no
        cleanup (the ledger is flushed per record)."""
        exc = plan.check(seam)
        if exc is None:
            return
        log_event(logger, "fault injected", seam=seam, index=exc.index,
                  fault_class=exc.fault_class, step=step_index)
        _record_fault(tel, exc, seam=seam, injected=True, index=exc.index,
                      step=step_index)
        if seam == "process-kill":
            os._exit(113)
        raise exc

    def backoff(fault_class: str, attempt: int, seam: str) -> None:
        s = policy.backoff_s(fault_class, attempt, seam=seam)
        if s > 0:
            time.sleep(s)

    def observed(e: BaseException, seam: str, step: int) -> None:
        """Log and record a real (not injected) fault with its class."""
        if not (isinstance(e, faults_mod.FaultError) and e.injected):
            seam = getattr(e, "seam", None) or seam
            log_event(logger, "fault", seam=seam,
                      fault_class=faults_mod.classify(e), step=step,
                      error=repr(e))
            _record_fault(tel, e, seam=seam, injected=False, step=step)

    def final_failure(e, step: int, cursor: int, fault_class: str,
                      attempts: int = 1, snapshot=None):
        """Out of retries (or none asked for): dump the flight recorder,
        write the ``failure`` record and surface the failure with its
        resume cursor; checkpoint/resume is the recovery path."""
        tel.event("step_failed", step=step, attempt=attempts - 1,
                  error=repr(e))
        dump = tel.flight_dump(
            context={"step": step, "offset": cursor, "attempts": attempts,
                     "error": repr(e), "fault_class": fault_class,
                     "checkpoint_path": checkpoint_path},
            state=snapshot)
        tel.ledger_write("failure", step=step, cursor_bytes=cursor,
                         error=repr(e), fault_class=fault_class,
                         flight_dump=dump)
        log_event(logger, "step failed", step=step, offset=cursor,
                  error=repr(e), fault_class=fault_class,
                  resume_hint=checkpoint_path
                  or "enable checkpointing to resume")
        raise e

    def retry_record(step: int, attempt: int, e, fault_class: str,
                     seam: Optional[str] = None) -> None:
        tel.registry.counter("executor.retry_attempts").inc()
        tel.registry.counter("executor.retries_by_class",
                             fault_class=fault_class).inc()
        tel.event("retry", step=step, attempt=attempt, error=repr(e))
        rec = {"step": step, "attempt": attempt, "error": repr(e),
               "fault_class": fault_class}
        if seam:
            rec["seam"] = seam
        tel.ledger_write("retry", **rec)
        log_event(logger, "step failed; retrying", step=step,
                  attempt=attempt, fault_class=fault_class, error=repr(e),
                  **({"seam": seam} if seam else {}))

    def dispatch(state, group, restage: bool = False):
        """Stage (a replay stages the group's host buffers again) and
        launch one group: ``(state, completion token, group, stats)``.  A
        telemetered run folds the chunks' data statistics and the table's
        gauges after the group's last combine and starts their copy to the
        host before the completion token, which then covers it."""
        err = None
        try:
            with span("stage", timer):
                if plan is not None:
                    cross("stage-acquire")
                if restage:
                    group = [(b, stage.stage(b, hold=True))
                             for b, _ in group]
                if plan is not None:
                    cross("h2d")
            with span("dispatch", timer):
                if plan is not None:
                    cross("dispatch")
        except Exception as e:
            err = e
        # Before the step, whose map may gather over the ranks: a rank
        # that failed a seam would leave its peers waiting in the gather.
        settle(err, "dispatch")
        with span("dispatch", timer):
            try:
                stage.wait_copies([ev for _, (_, ev) in group])
                stats = None
                for b, (chunk, _) in group:
                    out = engine.step(state, chunk, b.step)
                    if engine.data_stats:
                        state, chunk_stats = out
                        stats = chunk_stats if stats is None \
                            else datastats.add(stats, chunk_stats)
                    else:
                        state = out
                if stats is not None:
                    stats = datastats.StatsFetch(
                        engine.job.state_stats(state, stats), engine.axis)
                done = stage.completion()
            except Exception as e:
                err = e
            settle(err, "dispatch")
        return state, done, group, stats

    def group_data(stats) -> Optional[dict]:
        """A retired group's data dict, folded into the run's totals;
        ``stats`` is ready: its completion event has completed."""
        if stats is None or data_agg is None:
            return None
        data = data_agg.group_data(stats.result())
        tel.note_data(data_agg.snapshot())
        return data

    def split_at_checkpoints(group):
        """Cut a group at checkpoint boundaries, so resume granularity is
        ``checkpoint_every`` even when it is finer than the superstep."""
        if not (checkpoint_every and checkpoint_path):
            return [group]
        subs, cur = [], []
        for item in group:
            cur.append(item)
            if (item[0].step + 1) % checkpoint_every == 0:
                subs.append(cur)
                cur = []
        if cur:
            subs.append(cur)
        return subs

    def serial_dispatch(state, group, attempts_used: int, cursor: int,
                        charged_class: str):
        """Dispatch one group and wait for it, retrying on the per-class
        budgets (the replay's unit): ``(state, stats, attempts)``.  The
        input state is the replay's known-good state: a step never writes
        into it.  ``attempts_used`` charges the attempt the group already
        spent in the window against ``charged_class``; a resource-classed
        exhaustion raises :class:`_DegradeSignal` when the ladder may step
        down."""
        used = {c: 0 for c in faults_mod.FAULT_CLASSES}
        used[charged_class] = attempts_used
        total = attempts_used
        while True:
            try:
                out, done, _, stats = dispatch(state, group, restage=True)
                err = None
                with span("retire_wait", timer):
                    try:
                        _wait_token(stage, done, policy.token_timeout_s)
                    except Exception as e:
                        err = e
                settle(err, "token-wait")
                return out, stats, total
            except Exception as e:
                cls = faults_mod.classify(e)
                if cls == "preemption":
                    raise
                observed(e, "dispatch", group[0][0].step)
                if used[cls] >= policy.budget(cls):
                    if cls == "resource" and policy.degrade:
                        raise _DegradeSignal(e)
                    final_failure(e, group[0][0].step, cursor, cls,
                                  attempts=total + 1, snapshot=state)
                used[cls] += 1
                total += 1
                retry_record(group[0][0].step, total, e, cls)
                backoff(cls, used[cls], "dispatch")

    def reanchor(state) -> None:
        """The state is known good: everything before it is safe, and the
        held buffers of the groups since the last anchor go back to the
        pool."""
        nonlocal anchor
        anchor = state
        for group, _ in since_anchor:
            for b, _ in group:
                stage.release(b)
        del since_anchor[:]

    def recover(state, e, entry=None, sync_group=None, sync_life=None):
        """A group failed: at its completion token (``entry``, the oldest
        in flight: tokens are waited in dispatch order) or in its dispatch
        (``sync_group``, never enrolled).  The class decides: preemption
        re-raises to the stream's drain-and-checkpoint handler, permanent
        fails at once, transient and resource replay every group since the
        anchor serially, and a resource exhaustion steps down the ladder
        until it runs out.  The groups of the doomed window get their
        ``group`` records after the replay, with its serial stamps, and
        their data statistics from it: a group that retired before the
        failure is replayed but keeps its one record."""
        nonlocal engine, cur_config, live, quiet, retired_groups
        cls = faults_mod.classify(e)
        fail_step = (entry.step_first if entry is not None
                     else sync_group[0][0].step)
        observed(e, "token-wait" if entry is not None else "dispatch",
                 fail_step)
        if cls == "preemption":
            raise e
        cursor = entry.cursor_before if entry is not None else bytes_done
        budget = policy.budget(cls)
        can_ladder = cls == "resource" and policy.degrade
        if not replayable or (budget <= 0 and not can_ladder):
            final_failure(e, fail_step, cursor, cls)
        if sync_group is not None:
            since_anchor.append((sync_group, cursor))
        replay = list(since_anchor)
        fail_idx = next(i for i, (g, _) in enumerate(replay)
                        if g[0][0].step == fail_step)
        lost = {en.step_first: en.life for en in window}
        if sync_group is not None and sync_life is not None:
            lost[fail_step] = sync_life
        # Quiesce the doomed window before the replay: the groups run on
        # one compute stream, so the newest token covers them all.  A
        # kernel cannot be cancelled: a hung one is bounded by the
        # timeout, and its error, if any, is the replay's to meet.
        if window:
            try:
                _wait_token(stage, window[-1].done, policy.token_timeout_s)
            except Exception:
                pass
        window.clear()
        # The failure charges one attempt against its class, unless the
        # class has no budget at all (the first resource fault of a pure
        # ladder policy goes straight to a degrade).
        charged = 1 if budget > 0 else 0
        if charged:
            retry_record(fail_step, 1, e, cls)
            backoff(cls, 1, "dispatch")
        was_quiet, quiet = quiet, True
        with span("replay", timer):
            while True:  # the ladder loop: one pass when nothing degrades
                try:
                    state, done = anchor, []
                    for i, (group, group_cursor) in enumerate(replay):
                        t0 = time.perf_counter()
                        state, stats, attempts = serial_dispatch(
                            state, group,
                            charged if i == fail_idx else 0, group_cursor,
                            cls)
                        done.append((i, group, t0, time.perf_counter(),
                                     stats, attempts))
                    break
                except _DegradeSignal as ds:
                    nd = faults_mod.next_degrade(_config_summary(cur_config))
                    if nd is None:
                        final_failure(ds.error, fail_step, cursor,
                                      "resource")
                    step_name, field, degraded = nd
                    was = _config_summary(cur_config)[field]
                    cur_config = _apply_degrade(cur_config, field, degraded)
                    pipe.setdefault("degrade_steps", []).append(step_name)
                    tel.registry.counter("executor.degrade_steps",
                                         ladder_step=step_name).inc()
                    tel.event("degrade", ladder_step=step_name, field=field)
                    tel.ledger_write(
                        "degrade", step=fail_step, ladder_step=step_name,
                        field=field, **{"from": was, "to": degraded},
                        fault_class="resource", error=repr(ds.error))
                    log_event(logger, "degradation ladder step",
                              ladder_step=step_name, field=field,
                              **{"from": was, "to": degraded},
                              error=repr(ds.error))
                    engine = rebuild(cur_config)
        # The owed group records, of the final round only: coarse serial
        # stamps (the replay is when these groups really ran).
        for i, group, t0, t1, stats, attempts in done:
            life = lost.pop(group[0][0].step, None)
            if life is not None:
                life = dict(life, staged_at=round(t0, 6),
                            dispatched_at=round(t0, 6))
                _group_record(tel, life, token_ready_at=t1, retired_at=t1,
                              wait_s=t1 - t0,
                              retries=attempts if i == fail_idx else 0,
                              data=group_data(stats))
                retired_groups += 1
                heartbeat()
        tel.registry.counter("executor.retry_recoveries").inc()
        pipe["recoveries"] = pipe.get("recoveries", 0) + 1
        live = state
        if sync_group is not None:
            # It ran alone, serially: depth 1.
            record_depth(1)
            account([b for b, _ in sync_group], 1,
                    sync_life["group_bytes"])
        reanchor(state)
        quiet = was_quiet
        return state

    def token_wait(entry) -> None:
        """The window's completion wait behind the ``token-wait`` seam,
        bounded by the policy's ``token_timeout_s``."""
        if plan is not None:
            cross("token-wait")
        _wait_token(stage, entry.done, policy.token_timeout_s, interrupted)

    def retire_oldest(state, phase: Optional[str] = "retire_wait"):
        """Wait for the oldest group's completion token; an error that
        surfaces here belongs to that group.  A retired group gets its
        ``group`` record."""
        nonlocal retired_groups
        entry = window[0]
        wait_t0 = time.perf_counter()
        err = None
        try:
            if phase is None:
                token_wait(entry)
            else:
                with span(phase, timer):
                    token_wait(entry)
        except Exception as e:
            err = e
        try:
            settle(err, "token-wait")
        except Exception as e:
            return recover(state, e, entry=entry)
        token_ready_at = time.perf_counter()
        window.popleft()
        _group_record(tel, entry.life, token_ready_at=token_ready_at,
                      retired_at=time.perf_counter(),
                      wait_s=token_ready_at - wait_t0,
                      data=group_data(entry.stats))
        retired_groups += 1
        heartbeat()
        return state

    def drain_window(state, phase: Optional[str] = "retire_wait",
                     do_reanchor: bool = True):
        """Retire every group in flight; with retry, re-anchor on the
        drained state (skipped when nothing was dispatched since the
        anchor)."""
        while window:
            state = retire_oldest(state, phase)
        if replayable and do_reanchor and since_anchor:
            reanchor(state)
        return state

    def record_depth(depth: int) -> None:
        pipe["dispatch_groups"] += 1
        pipe["depth_sum"] += depth
        pipe["depth_max"] = max(pipe["depth_max"], depth)
        tel.registry.observe("executor.inflight_depth", depth)

    def account(batches, depth: int, group_bytes: int) -> None:
        """Advance the cursor and the bases for a dispatched group and
        write its ``step`` record.  The ``ledger-append`` seam is crossed
        here when a ledger is attached: an injected append fault is
        recorded and absorbed (observing must never take the run down),
        and only that record is lost."""
        nonlocal bytes_done, step_index, last_file_dispatched
        last_file_dispatched = batches[-1].file_index
        for b in batches:
            bases_list.append(b.base_offsets)
        bytes_done += group_bytes
        step_index = batches[-1].step + 1
        skip_record = False
        if plan is not None and tel.writing:
            try:
                cross("ledger-append")
            except faults_mod.FaultError as fe:
                if fe.fault_class == "preemption":
                    if accord is None:
                        raise
                    # Only the coordinator writes the ledger: every rank
                    # takes the preemption at the next read, as a SIGINT.
                    sigint.append(signal.SIGINT)
                skip_record = True
                log_event(logger, "ledger append fault absorbed",
                          error=repr(fe))
        if not skip_record:
            tel.step_record(step_first=batches[0].step,
                            step_last=batches[-1].step,
                            group_bytes=group_bytes, cursor_bytes=bytes_done,
                            timer=timer, inflight_depth=depth,
                            device=device)
        heartbeat()
        if progress_every and step_index % progress_every < len(batches):
            log_event(logger, "progress", step=step_index, bytes=bytes_done)

    def enroll(out, done, group, cursor_before: int, life: dict,
               stats) -> None:
        """Window bookkeeping for a dispatched group (outside the recover
        routing: a failure here is host bookkeeping, not a device fault)."""
        nonlocal live
        live = out
        window.append(_Inflight(done, group[-1][1][1], group[0][0].step,
                                cursor_before, life, stats))
        if replayable:
            since_anchor.append((group, cursor_before))
        record_depth(len(window))
        account([b for b, _ in group], len(window), life["group_bytes"])

    def save_snapshot(state) -> bool:
        """The checkpoint write behind the ``checkpoint-save`` seam: a
        failed save retries on its class budget (the write is atomic), and
        an exhausted budget is absorbed: the run goes on without this
        snapshot.  True when it landed.  Every rank gives its state to
        the snapshot (one gather) and crosses the seam; the coordinator
        alone writes; across ranks the ranks agree on the outcome (a
        preemption raised on one rank is raised on every rank)."""
        leaves = engine.replicate_to_host(state)
        if overlap is not None:
            leaves = overlap.host_leaves() + leaves
        writer = engine.axis.coordinator

        def save() -> None:
            try:
                if plan is not None:
                    cross("checkpoint-save")
                if writer:
                    ckpt_mod.save(checkpoint_path, leaves, step_index,
                                  bytes_done, np.stack(bases_list),
                                  fingerprint=fingerprint,
                                  file_index=last_file_dispatched)
            except Exception as ce:
                observed(ce, "checkpoint-save", step_index)
                raise

        err, saved = None, False
        try:
            _with_budget(save, "checkpoint-save", policy,
                         injected_only=False,
                         on_retry=lambda attempt, ce, cls: retry_record(
                             step_index, attempt, ce, cls,
                             seam="checkpoint-save"))
            saved = writer
        except faults_mod.PreemptionFault as pf:
            err = pf
        except Exception as ce:
            log_event(logger, "checkpoint save failed; continuing without "
                      "this snapshot", error=repr(ce),
                      fault_class=faults_mod.classify(ce))
        if accord is not None:
            # The coordinator's outcome is every rank's.
            err, saved = accord(err, "checkpoint-save", saved)
        if err is not None:
            raise err
        return saved

    def checkpoint(state, preempt: bool = False) -> bool:
        """Save a snapshot under the ``checkpoint`` phase and write its
        ledger record when it landed."""
        ck_before = timer["checkpoint"]
        with span("checkpoint", timer):
            saved = save_snapshot(state)
        tel.event("checkpoint", step=step_index, cursor_bytes=bytes_done)
        if saved:
            tel.ledger_write(
                "checkpoint", step=step_index, cursor_bytes=bytes_done,
                save_s=round(timer["checkpoint"] - ck_before, 6),
                path=checkpoint_path, **({"preempt": True} if preempt
                                         else {}))
        return saved

    def flush_one(state, group):
        """Dispatch one group, keeping at most ``window_cap`` in flight.
        With retry the window drains in full and re-anchors when it is
        full; without, it slides (the oldest group retires)."""
        nonlocal last_ckpt
        if replayable:
            if len(window) >= window_cap:
                pipe["full_retires"] += len(window)
                state = drain_window(state)
            if anchor is None:
                reanchor(state)
        else:
            while len(window) >= window_cap:
                pipe["full_retires"] += 1
                state = retire_oldest(state)
            if overlap is not None and overlap.due(retired_groups):
                state = overlap_boundary(state)
        cursor_before = bytes_done
        batches = [b for b, _ in group]
        read_at = read_t.pop(batches[0].step, None)
        for b in batches[1:]:
            read_t.pop(b.step, None)
        life = _group_life(batches, read_at,
                           int(sum(int(b.lengths.sum()) for b in batches)))
        if host_rows is not None:
            life["host_bytes"] = int(sum(int(b.lengths[host_rows].sum())
                                         for b in batches))
        try:
            out, done, group, stats = dispatch(state, group)
        except Exception as e:
            state = recover(state, e, sync_group=group, sync_life=life)
        else:
            life["dispatched_at"] = round(time.perf_counter(), 6)
            enroll(out, done, group, cursor_before, life, stats)
            state = out
        if plan is not None:
            cross("process-kill")  # between groups, where a reclaim lands
        if (checkpoint_every and checkpoint_path
                and step_index // checkpoint_every > last_ckpt):
            state = drain_window(state)
            pipe["boundary_drains"] += 1
            last_ckpt = step_index // checkpoint_every
            if overlap is not None:
                # The snapshot packs the reset local state and the
                # accumulator.
                state = overlap_boundary(state)
            if checkpoint(state):
                log_event(logger, "checkpoint", step=step_index,
                          path=checkpoint_path)
        return state

    def flush(state, group):
        for sub in split_at_checkpoints(group):
            state = flush_one(state, sub)
        return state

    def read_guarded():
        """One read behind the ``reader-read`` seam.  The injected fault
        fires before the read, so retrying it is safe; a real reader error
        is recorded and propagates (the prefetch iterator is dead after
        raising, and reading it again would look like the stream's
        end)."""
        def read():
            cross("reader-read")
            try:
                return next(it, None)
            except Exception as re_:
                _record_fault(tel, re_, seam="reader-read", injected=False,
                              step=step_index)
                raise

        return _with_budget(read, "reader-read", policy, injected_only=True,
                            on_retry=lambda attempt, fe, cls: retry_record(
                                step_index, attempt, fe, cls,
                                seam="reader-read"))

    # A job with cross-chunk state (the n-gram seam carry) resets it at a
    # file boundary: files are independent corpora.  After a resume,
    # ``last_file`` is the member of the snapshot's last batch, so a
    # snapshot taken at a file seam still resets on the next file.
    boundary_hook = getattr(engine.job, "on_input_boundary", None)
    last_file: Optional[int] = resumed_file
    it = reader_mod.prefetch(
        reader_mod.iter_batches_multi(path, engine.n_devices,
                                      config.chunk_bytes,
                                      start_offset=start_offset,
                                      start_step=start_step, out=stage.take,
                                      end_offset=end_offset),
        depth=config.resolved_prefetch_depth)

    def stream(state):
        """Read, stage, group and dispatch to the stream's end, then drain.
        A SIGINT is raised at the top of each read and in the waits."""
        nonlocal last_file
        pending: list = []
        while True:
            interrupted()
            err, batch = None, None
            with span("read_wait", timer):
                try:
                    batch = next(it, None) if plan is None \
                        else read_guarded()
                except Exception as e:
                    err = e
            settle(err, "reader-read", safe=True)
            if batch is None:
                break
            read_t[batch.step] = time.perf_counter()
            with span("stage", timer):
                staged = stage.stage(batch, hold=replayable)
            if (boundary_hook is not None and last_file is not None
                    and batch.file_index != last_file):
                # For a job with a boundary hook, as in the JAX package, a
                # file boundary is a group and window boundary (and a
                # window-boundary merge ships the old file's counts before
                # the hook edits the carry).
                if pending:
                    state = flush(state, pending)
                    pending = []
                state = drain_window(state, do_reanchor=False)
                pipe["boundary_drains"] += 1
                if overlap is not None:
                    state = overlap_boundary(state)
                state = boundary_hook(state)
                if replayable:
                    # The hook's edit is the new anchor (nothing is in
                    # flight), on every rank at the same boundary.
                    reanchor(state)
            last_file = batch.file_index
            pending.append((batch, staged))
            if len(pending) == config.superstep:
                state = flush(state, pending)
                pending = []
        for item in pending:  # the remainder: a chunk at a time
            state = flush(state, [item])
        # The stream's end: the last group's input still in transfer, then
        # the compute queued behind it.  Timed even when empty, so the
        # phase keys always exist.  The last group's record carries when
        # its copy was seen done: the one H2D completion the loop observes.
        with span("h2d_tail", timer):
            if window:
                _wait_token(stage, window[-1].copy_done,
                            interrupted=interrupted)
                window[-1].life["h2d_done_at"] = round(time.perf_counter(), 6)
        with span("compute_tail", timer):
            state = drain_window(state, phase=None, do_reanchor=False)
        settle(None, "stream", safe=True)
        return state

    bounded = contextlib.nullcontext() if policy.token_timeout_s is None \
        else wc.host_read_by(
            lambda flags: stage.read(flags, policy.token_timeout_s))
    with bounded:
        try:
            state = stream(state)
        except BaseException as pe:
            # Preemption, caught by class: an injected or real preemption
            # fault re-raised by recover, or a KeyboardInterrupt (a SIGINT
            # raised at a safe point, or one raised in the reader or a
            # step).  The window's groups are healthy and accounted: drain
            # them, snapshot the committed state, and exit with the resume
            # cursor.  The plan is disarmed first, so no second injected
            # fault interrupts the shutdown.  A preempted run writes no
            # flight dump.  Across ranks every rank gets here at the same
            # crossing (the ranks agreed on it), so they drain the same
            # window and leave with the same cursor.
            if faults_mod.classify(pe) != "preemption":
                raise
            # Mid-replay, the committed state is not the replayed one: exit
            # without a snapshot, so the last one on disk stays consistent.
            in_replay, quiet = quiet, True
            plan = None
            if overlap is not None:
                overlap.disarm()
            state = drain_window(live, do_reanchor=False)
            checkpointed = False
            if in_replay:
                log_event(logger, "preempted during a replay; exiting "
                          "without checkpoint", step=step_index)
            elif checkpoint_path:
                try:
                    if overlap is not None:
                        # Preemption is a boundary too: the packed
                        # snapshot resumes exactly.
                        state = overlap.boundary(state, step_index,
                                                 retired_groups)
                    checkpointed = checkpoint(state, preempt=True)
                except Exception as se:
                    # The device may already be going away: an
                    # unfetchable state is an uncheckpointed, still
                    # orderly, exit.
                    _record_fault(tel, se, seam="checkpoint-save",
                                  injected=False, step=step_index)
                    log_event(logger, "preemption snapshot failed; "
                              "exiting without checkpoint",
                              step=step_index, error=repr(se))
            log_event(logger, "preempted; drained and exiting cleanly",
                      step=step_index, cursor=bytes_done,
                      checkpointed=checkpointed)
            raise faults_mod.Preempted(
                step=step_index, cursor_bytes=bytes_done,
                checkpoint_path=checkpoint_path,
                checkpointed=checkpointed) from pe
        finally:
            it.close()
    n = pipe["dispatch_groups"]
    pipe["depth_mean"] = round(pipe.pop("depth_sum") / n, 2) if n else 0.0
    pipe["window_filled"] = pipe["depth_max"] >= window_cap
    pipe["full_frac"] = round(pipe["full_retires"] / n, 3) if n else 0.0
    if overlap is not None:
        pipe["partial_merges"] = overlap.partials
    pipe.update(stage.summary())
    return state, bytes_done, pipe


def _path_names(path) -> list[str]:
    """The input path(s) as strings, for ``run_start``."""
    if isinstance(path, (str, bytes, os.PathLike)):
        return [os.fsdecode(path)]
    return [os.fsdecode(p) for p in path]


def _collective_call(thunk, plan, policy, tel, logger, accord=None):
    """A collective behind the ``collective-finish`` seam.  Injected
    faults fire before the collective runs, so retrying them on their
    class budget is safe; across ranks (``accord``) the ranks agree on
    the seam's outcome before any of them enters the collective, so a
    fault one rank cannot absorb fails every rank.  A real failure is
    recorded and propagates: the peers of a failed collective are
    blocked mid-call, and checkpoint/resume is the recovery path."""
    attempt = 0
    while True:
        exc = None if plan is None else plan.check("collective-finish")
        if exc is not None:
            log_event(logger, "fault injected", seam="collective-finish",
                      index=exc.index, fault_class=exc.fault_class)
            _record_fault(tel, exc, seam="collective-finish", injected=True,
                          index=exc.index)
        if exc is not None and exc.fault_class != "preemption" \
                and attempt < policy.budget(exc.fault_class):
            attempt += 1
            fe = exc
            tel.registry.counter("executor.retry_attempts").inc()
            tel.registry.counter("executor.retries_by_class",
                                 fault_class=fe.fault_class).inc()
            tel.ledger_write("retry", attempt=attempt, error=repr(fe),
                             fault_class=fe.fault_class,
                             seam="collective-finish")
            log_event(logger, "collective finish fault; retrying",
                      attempt=attempt, fault_class=fe.fault_class,
                      error=repr(fe), seam="collective-finish")
            s = policy.backoff_s(fe.fault_class, attempt,
                                 seam="collective-finish")
            if s > 0:
                time.sleep(s)
            continue
        if accord is not None:
            exc, _ = accord(exc, "collective-finish")
        if exc is not None:
            raise exc
        try:
            return thunk()
        except Exception as e:
            if not isinstance(e, faults_mod.FaultError):
                _record_fault(tel, e, seam="collective-finish",
                              injected=False)
            raise


def _collective_finish(engine, state, plan, policy, tel, logger,
                       accord=None, accum=None):
    """The stream's end through the ``collective-finish`` seam:
    ``engine.finish_residual`` with the window-boundary merges'
    accumulator ``accum`` (None: none, exactly ``engine.finish``).  The
    result is on the device when it returns (a CUDA run synchronises, as
    the JAX package fetches the result inside the ``reduce`` phase)."""
    def finish():
        value = engine.finish_residual(accum, state)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        return value

    return _collective_call(finish, plan, policy, tel, logger, accord)


def _geometry_stamp(config: Config) -> dict:
    """``run_start``'s geometry fields, as the JAX package writes them: the
    label, and on a custom geometry its fields (``geometry_spec``)."""
    label = config.geometry_label
    stamp = {"geometry": label}
    if label == "custom":
        stamp["geometry_spec"] = config.resolved_geometry.as_dict()
    return stamp


def _metrics_word_count(value) -> int:
    """The total words inside any finalized state, for ``RunMetrics``:
    sketch states hold a ``table`` that may itself be a :class:`TopKTable`,
    unwrapped down to the count table.  A state that holds no count table
    (grep, sample) reports 0, as in the JAX package: its numbers are its
    own result's."""
    while isinstance(value, (SketchedState, FreqSketchedState, TopKTable)):
        value = value.table
    return value.total_count() \
        if isinstance(value, table_ops.CountTable) else 0


def _agree(axis, *values: int) -> None:
    """Every rank starts the same run: the values (the stats mode, the
    resume cursor) must agree, or the ranks' collectives would pair up
    wrongly.  One all_gather of a few words."""
    if axis.group is None:
        return
    dev = axis.device if axis.backend == "nccl" else torch.device("cpu")
    got = collectives.all_gather(
        torch.tensor(values, dtype=torch.int64, device=dev), axis).cpu()
    if not bool((got == got[0]).all()):
        raise RuntimeError(
            f"the {axis.size} ranks disagree on the run they start "
            f"(stats mode, resume step, resume offset): {got.tolist()}; "
            "every rank passes telemetry or none, and resumes the same "
            "snapshot")


def run_job(job, path, config: Config = DEFAULT_CONFIG, device=None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            logger=None, progress_every: int = 50,
            retry: int = 0, telemetry=None,
            merge_strategy: Optional[str] = None, mesh=None,
            byte_range: Optional[tuple[int, int]] = None) -> RunResult:
    """Stream ``path`` (a file or a list of files, one corpus) through
    ``job`` on this rank's device; see the module docstring.

    ``mesh`` is the ranks the run spreads over: the initialised
    ``torch.distributed`` world's axis by default (a world of one without
    one), a host's own ranks (``parallel.distributed.local_data_mesh``),
    or a two-level mesh (``parallel.mesh.two_level_mesh``).  Every rank
    of it calls ``run_job`` with the same arguments: each step cuts D
    rows, the JAX reader's cuts, and each rank maps its own; the finish
    merges the D states with ``merge_strategy`` (default ``config``'s:
    'tree', 'gather' or 'keyrange', and on a two-level mesh also
    'hier-tree-tree' and 'hier-kr-tree'), and every rank returns the same
    value.  Snapshots are the mesh's coordinator's (its rank 0) to write
    and every rank's to resume; the run ledger is the coordinator's alone,
    its ``data`` record summed over the ranks.  Window replay (``retry`` >
    0), the degradation ladder and preemption run across ranks as on one:
    the ranks agree on every failure, so a fault on one rank replays every
    rank from its own anchor, and a SIGINT to one rank drains every rank at
    the same step (every rank raises ``Preempted`` with the same cursor).

    ``byte_range``: read only ``[lo, hi)`` of the corpus (virtual offsets
    over a list of files), this host's range
    (``parallel.distributed.host_byte_range`` aligned with
    ``align_range_to_separator``); the value is then the host's *partial*
    state, which the caller merges across hosts (``ops.table.merge``).
    A snapshot of one range refuses to resume another.  This is the JAX
    package's per-host mode (a), over a host-local mesh; for one program
    over every host see :func:`run_job_global`.  In a world of several
    hosts the ledger's records carry the ``host``.

    ``device`` defaults to the job's.  ``config`` sets the chunking, the
    pipeline (``chunk_bytes``, ``superstep``, ``inflight_groups``,
    ``prefetch_depth``), the fault plan and the failure policy.  With
    ``checkpoint_path``, a snapshot there is resumed (the previous good one
    if it is corrupt; a different job, capacity, chunk size, device count,
    byte range or input raises ``CheckpointMismatch``), and with
    ``checkpoint_every`` > 0 one is saved every that many steps.
    ``retry``: the transient and resource budgets when
    ``config.failure_policy`` is None.  A preempted run raises
    :class:`...runtime.faults.Preempted`.  With ``config.merge_overlap``
    the ranks' states are merged at window boundaries (see
    :class:`_OverlapMerger`); a bare ``retry`` > 0 is then a usage error,
    and an explicit failure policy keeps its budgets with window replay
    disarmed, as in the JAX package.

    ``telemetry`` (:class:`...obs.telemetry.Telemetry`, optional): the run
    ledger's records, the flight recorder's dump on a failure and the
    metrics registry's instruments, as the JAX package writes them; a
    job with data-statistics hooks also runs its map in stats mode (the
    same results).  None runs exactly the untelemetered loop.  The caller
    owns the handle (``close`` it).
    """
    if retry < 0:
        raise ValueError(f"retry must be >= 0, got {retry}")
    return _run_streamed(
        job, path, config, device, driver="run_job", mesh=mesh,
        merge_strategy=merge_strategy, byte_range=byte_range, retry=retry,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        logger=logger, progress_every=progress_every, telemetry=telemetry)


def run_job_global(job, path, config: Config = DEFAULT_CONFIG, device=None,
                   mesh=None, merge_strategy: Optional[str] = None,
                   checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 0, logger=None,
                   progress_every: int = 50, telemetry=None) -> RunResult:
    """One streamed program over every rank of every host: the JAX
    package's multi-host mode (b).

    Every process calls it with the same arguments after
    ``parallel.distributed.initialize``.  The mesh is every rank of the
    world (``parallel.distributed.global_data_mesh``) by default, or a
    given ``two_level_mesh`` (hosts x ranks a host).  Every rank reads the
    same batches and stages only its own row, so a host stages only its
    ``host_shards`` rows, as the JAX driver's ``device_put_local`` does,
    with no second stager; the collective finish replicates the result,
    the same on every rank (report on ``is_coordinator``).

    As in the JAX package: no ``retry`` (the failure policy resolves with
    ``retry=0``: a failed collective leaves its peers blocked, so
    checkpoint and resume is the recovery path, with no window replay and
    no degradation ladder), no data-statistics mode and no byte range.
    The coordinator alone writes the main ledger and the snapshot; every
    rank resumes its row of it.  Over several hosts each host's first
    rank writes every record to the host's shard ledger
    ``<ledger>.h<p>.jsonl`` (``Telemetry.attach_host``), its ``run_end``
    with the host's own phase totals, and a host other than 0 dumps its
    flight record to its own path.  A fault plan's ``process-kill`` is
    crossed after each dispatched group, where a plan firing at the same
    crossing on every rank leaves no peer waiting.  Preemption and
    ``config.merge_overlap`` run as in :func:`run_job`.
    """
    dev = job.device if device is None else torch.device(device)
    if mesh is None:
        mesh = distributed.global_data_mesh(device=dev)
    return _run_streamed(
        job, path, config, dev, driver="run_job_global", mesh=mesh,
        merge_strategy=merge_strategy, byte_range=None, retry=0,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        logger=logger, progress_every=progress_every, telemetry=telemetry)


def _host_telemetry(tel, axis, driver: str):
    """The rank's telemetry handle.  Over several hosts it is attached to
    this rank's host (``attach_host``): the global driver's host leaders
    (each host's first rank) open their host's shard, the per-host driver
    stamps only.  The main ledger and the flight dump are the mesh
    coordinator's: another rank's handle is a copy without the main
    ledger (a host leader keeps its shard and its host's flight path) and,
    off the host leaders, without a flight path."""
    if not tel.enabled:
        return tel
    glob = driver == "run_job_global"
    n, local = distributed.process_count(), distributed.local_device_count()
    leader = not glob or axis.rank % local == 0
    if n > 1 and leader:
        tel.attach_host(distributed.process_index(), n, local_devices=local,
                        clock=distributed.run_epoch(), shard=glob)
    if axis.coordinator or (tel.ledger is None and not tel.flight_path):
        return tel
    tel = copy.copy(tel)
    tel.ledger = None
    if not (glob and leader and tel.shard is not None):
        tel.flight_path = None
    return tel


def _run_streamed(job, path, config: Config, device, *, driver: str, mesh,
                  merge_strategy, byte_range, retry: int, checkpoint_path,
                  checkpoint_every: int, logger, progress_every: int,
                  telemetry) -> RunResult:
    """The streamed run of :func:`run_job` (``driver='run_job'``) and
    :func:`run_job_global` (``driver='run_job_global'``)."""
    glob = driver == "run_job_global"
    dev = job.device if device is None else torch.device(device)
    if dev != job.device:
        raise ValueError(f"{driver} on {dev} got a job on {job.device}")
    axis = data_mesh(device=dev) if mesh is None \
        else dataclasses.replace(mesh, device=dev)
    n_dev = axis.size
    merge_strategy = config.resolved_merge_strategy \
        if merge_strategy is None else merge_strategy
    tel = _host_telemetry(obs_telemetry.maybe(telemetry), axis, driver)
    plan = faults_mod.FaultPlan.resolve(config.fault_plan)
    policy = faults_mod.FailurePolicy.resolve(config.failure_policy,
                                              retry=retry)
    if config.merge_overlap and policy.dispatch_budget > 0 \
            and config.failure_policy is None:
        raise ValueError(
            "merge_overlap requires retry=0: the replay anchor snapshots "
            "local state that a window-boundary partial merge has already "
            "shipped into the accumulator — checkpoint/resume is the "
            "recovery path for overlapped runs")
    # An explicit policy keeps its budgets on the seams that never replay
    # shipped state (reader, checkpoint save, collective finish); window
    # replay alone is disarmed under overlap, as in the JAX package.
    replay = policy.dispatch_budget > 0 and not glob \
        and not config.merge_overlap
    accord = _Accord(axis) if n_dev > 1 else None
    # The global driver has no data-statistics mode, as in the JAX package.
    data_stats = tel.enabled and datastats.supports(job) and not glob
    engine = Engine(job, dev, data_stats=data_stats, mesh=axis,
                    merge_strategy=merge_strategy)
    data_agg = datastats.DataAggregator.for_run(config, n_dev) \
        if data_stats else None
    logger = logger or get_logger()
    native.load()  # a failed chunker build fails here, not in the reader
    timer = metrics_mod.PhaseTimer()
    timer.start("total")
    state = engine.init_states()
    range_lo, range_hi = byte_range if byte_range is not None else (0, None)
    start_step, start_offset, resumed_file = 0, range_lo, None
    bases_list: list = []
    fingerprint = ckpt_mod.run_fingerprint(
        path, n_dev, config.chunk_bytes, backend=config.resolved_backend(),
        pallas_max_token=config.pallas_max_token, byte_range=byte_range,
        job_identity=job.identity()) if checkpoint_path else None
    fallback = None
    # With retry, the buffers of every group since the anchor are held
    # (at most a full window, plus the group being filled).
    held = (config.inflight_groups + 1) * config.superstep - 1 \
        if replay else 0
    stage = _PinnedStage(dev, n_dev * config.chunk_bytes,
                         config.resolved_prefetch_depth, held, axis.rank) \
        if dev.type == "cuda" else _HostStage(axis.rank)
    overlap = _OverlapMerger(engine, stage, tel, plan, policy, logger,
                             merge_strategy, config.inflight_groups,
                             accord) if config.merge_overlap else None
    if checkpoint_path and ckpt_mod.exists(checkpoint_path):
        # The snapshot holds every rank's state (leaves [D, ...]); each
        # rank takes its own row.  Under overlap its leading leaves are
        # the replicated accumulator's (the packed structure refuses a
        # snapshot of the other mode).
        template = [np.empty((n_dev,) + leaf.shape[1:], leaf.dtype)
                    for leaf in convert.state_to_leaves(state)]
        n_acc = 0
        if overlap is not None:
            acc_template = overlap.template()
            n_acc = len(acc_template)
            template = acc_template + template
        (leaves, start_step, start_offset, bases, resumed_file), fallback = \
            ckpt_mod.load_resilient(checkpoint_path, template=template,
                                    expect_fingerprint=fingerprint)
        if overlap is not None:
            overlap.restore(leaves[:n_acc], dev)
        state = convert.leaves_to_state(
            [leaf[axis.rank:axis.rank + 1] for leaf in leaves[n_acc:]],
            state, dev)
        bases_list = list(bases)
        log_event(logger, "resumed from checkpoint", step=start_step,
                  offset=start_offset)
        if fallback is not None:
            log_event(logger, "corrupt checkpoint; resumed from previous "
                      "good snapshot", **fallback)
    _agree(axis, int(data_stats), start_step, start_offset)
    host_rows = None
    if glob:
        host_rows = np.asarray(distributed.host_shards(n_dev), np.int64)

    def rebuild(new_config: Config) -> Engine:
        """The ladder's engine: the job rebound to the degraded config."""
        nonlocal job, engine
        job = job_with_config(job, new_config)
        engine = Engine(job, dev, data_stats=data_stats, mesh=axis,
                        merge_strategy=merge_strategy)
        return engine

    # A SIGINT from here to run_end is deferred to the stream's safe
    # points (and, after the stream, to the end of the run), so no ledger
    # line is torn; across ranks the ranks agree on the read where every
    # rank takes it.
    with _sigint_deferred() as sigint:
        tel.registry.counter("executor.runs", driver=driver).inc()
        tel.ledger_write(
            "run_start", driver=driver, job=job.identity(), devices=n_dev,
            chunk_bytes=config.chunk_bytes, superstep=config.superstep,
            backend=config.resolved_backend(), map_impl=config.map_impl,
            combiner=config.resolved_combiner, **_geometry_stamp(config),
            **({"fault_plan": plan.spec} if plan is not None else {}),
            merge_strategy=merge_strategy,
            **({"merge_overlap": True} if config.merge_overlap else {}),
            input=_path_names(path),
            resume_step=start_step, resume_offset=start_offset,
            **({} if glob else
               {"retry": policy.dispatch_budget if replay else 0}))
        if fallback is not None:
            tel.ledger_write("fault", seam="checkpoint-load",
                             fault_class="transient", injected=False,
                             error=fallback["error"],
                             fallback=fallback["loaded"],
                             corrupt=fallback["corrupt"])

        timer.start("stream")
        try:
            with timing_into(timer):
                state, bytes_done, pipe = _drive_stream(
                    engine, config, path, state, stage,
                    start_step=start_step, start_offset=start_offset,
                    bases_list=bases_list, checkpoint_path=checkpoint_path,
                    checkpoint_every=checkpoint_every,
                    fingerprint=fingerprint, resumed_file=resumed_file,
                    logger=logger, progress_every=progress_every,
                    timer=timer, plan=plan, policy=policy, replay=replay,
                    rebuild=rebuild, sigint=sigint, tel=tel,
                    data_agg=data_agg, device=dev, end_offset=range_hi,
                    host_rows=host_rows, accord=accord, overlap=overlap)
            timer.stop("stream")
            with span("reduce", timer):
                if overlap is not None:
                    overlap.retire()
                fin_t0 = time.perf_counter()
                value = _collective_finish(
                    engine, state, plan, policy, tel, logger, accord,
                    accum=None if overlap is None else overlap.accum)
                tel.ledger_write("collective", op="finish",
                                 strategy=merge_strategy,
                                 started_at=round(fin_t0, 6),
                                 ended_at=round(time.perf_counter(), 6))
        except faults_mod.Preempted:
            raise  # an orderly exit with its cursor, not a failure
        except Exception as e:
            # A failure the loop did not dump already (the reader, the
            # finish) leaves forensics too; the first dump wins.
            tel.flight_dump(context={"where": driver, "error": repr(e)})
            raise
        total_s = timer.stop("total")
        if accord is not None:
            pipe["agreements"] = accord.rounds
            pipe["agree_ms"] = round(accord.seconds * 1e3, 4)
        pipe["overlap_fraction"] = _overlap_fraction(timer)
        if pipe["overlap_fraction"] is not None:
            tel.registry.gauge("executor.overlap_fraction").set(
                pipe["overlap_fraction"])
        if data_agg is not None and data_agg.groups:
            data_rec = data_agg.run_record()
            tel.ledger_write("data", **data_rec)
            tel.note_data(data_rec)
        # The bytes this run streamed (a resumed run starts at its cursor).
        m = metrics_mod.RunMetrics(bytes_processed=bytes_done - start_offset,
                                   words_counted=_metrics_word_count(value),
                                   elapsed_s=total_s,
                                   phases=dict(timer.phases))
        tel.ledger_write("run_end", **m.as_dict(), pipeline=pipe)
    log_event(logger, "run complete", driver=driver, **m.as_dict())
    bases = np.stack(bases_list) if bases_list \
        else np.zeros((0, n_dev), np.int64)
    return RunResult(value=value, metrics=m, bases=bases, pipeline=pipe,
                     rank=axis.rank)


def absolute_offsets(chunk_id: np.ndarray, pos: np.ndarray,
                     bases: np.ndarray, n_devices: int) -> np.ndarray:
    """Decode (chunk_id = step * n_devices + device, in-chunk pos) into
    absolute corpus offsets via the recorded row bases."""
    step, dev = chunk_id // n_devices, chunk_id % n_devices
    return bases[step, dev] + pos


def recover_from_file(tbl: table_ops.CountTable, path, bases: np.ndarray,
                      n_devices: int = 1, ngram: int = 1,
                      estimate_distinct: bool = True) -> WordCountResult:
    """Host-side string recovery for a streamed run, words in file order of
    first occurrence.

    An entry of length ``SEAM_GRAM_LENGTH`` is a cross-chunk gram (or a
    span of 127 bytes or more): the device knew its start, not its end,
    so its span is scanned ``ngram`` entries forward from the start, in
    one batch call, with the row bases as the chunker's force-split
    entry ends."""
    count = tbl.count.cpu().numpy()
    count_hi = tbl.count_hi.cpu().numpy()
    valid = (count > 0) | (count_hi > 0)
    chunk_id = tbl.pos_hi.cpu().numpy()[valid]
    pos = tbl.pos_lo.cpu().numpy()[valid]
    length = tbl.length.cpu().numpy()[valid]
    cnt = (count + (count_hi << 32))[valid]
    absolute = absolute_offsets(chunk_id, pos, bases, n_devices)
    seam = np.flatnonzero(length == ngram_ops.SEAM_GRAM_LENGTH)
    if len(seam):
        length[seam] = reader_mod.scan_gram_lengths(
            path, absolute[seam], ngram, cut_offsets=bases.ravel())
    order = np.argsort(absolute, kind="stable")
    spans = [(int(absolute[i]), int(length[i])) for i in order]
    words = reader_mod.read_words_at_multi(path, spans)
    dropped_uniques, dropped_count = tbl.dropped_totals()
    return WordCountResult(
        words=words,
        counts=[int(c) for c in cnt[order]],
        total=tbl.total_count(),
        distinct=_reported_distinct(tbl, len(words), dropped_uniques,
                                    estimate_distinct),
        dropped_uniques=dropped_uniques,
        dropped_count=dropped_count,
    )


def count_file(path, config: Config = DEFAULT_CONFIG, device=None,
               top_k: Optional[int] = None, distinct_sketch: bool = False,
               count_sketch: bool = False, ngram: int = 1,
               **kw) -> WordCountResult:
    """WordCount over one file or a list of files (one corpus) through
    :func:`run_job`; ``kw`` goes to it (checkpoints, logger, progress,
    retry, telemetry).  ``device`` defaults to the card.

    ``top_k`` runs :class:`...models.wordcount.TopKWordCountJob`, as the
    JAX package does: its finalize takes the table's KMV distinct estimate
    before the terminal top-k reorder, and evicted entries fold into
    ``dropped_*``.  ``ngram > 1`` counts n-token grams
    (:class:`...models.wordcount.NGramCountJob`), exactly across chunk
    seams.  ``distinct_sketch`` carries a HyperLogLog and fills
    ``distinct_estimate``; ``count_sketch`` carries a Count-Min sketch and
    fills ``cms`` (``result.estimate_count(word)``); one or the other per
    run.  The result's ``run`` is the run's :class:`RunResult` (its value
    dropped), with the host string recovery as the ``recover`` phase.
    Across the ranks of an initialised world (or of a ``mesh`` given in
    ``kw``) every rank calls it alike; the mesh's coordinator recovers
    and returns the result, the other ranks return None.  With a
    ``byte_range`` the result is the host's partial count.
    """
    if distinct_sketch and count_sketch:
        raise ValueError("distinct_sketch and count_sketch are mutually "
                         "exclusive per run; run twice to get both")
    if ngram > 1:
        job = NGramCountJob(ngram, config, device, top_k=top_k or None)
    else:
        job = TopKWordCountJob(top_k, config, device) if top_k \
            else WordCountJob(config, device)
    if distinct_sketch:
        job = SketchedWordCountJob(job)
    elif count_sketch:
        job = FreqSketchedWordCountJob(job)
    rr = run_job(job, path, config, **kw)
    if rr.rank != 0:
        return None
    timer = metrics_mod.PhaseTimer(phases=rr.metrics.phases)
    with span("recover", timer):
        tbl, kmv_est, registers, cms = rr.value, None, None, None
        if isinstance(tbl, SketchedState):
            tbl, registers = tbl.table, tbl.registers
        elif isinstance(tbl, FreqSketchedState):
            tbl, cms = tbl.table, tbl.cms.cpu().numpy().astype(np.uint32)
        if isinstance(tbl, TopKTable):
            kmv_est = table_ops.kmv_from_snapshot(
                int(tbl.kmv_n_valid), int(tbl.kmv_kth_hi),
                int(tbl.kmv_kth_lo), config.table_capacity)
            tbl = tbl.table
        result = recover_from_file(tbl, path, rr.bases, rr.bases.shape[1],
                                   ngram=ngram, estimate_distinct=not top_k)
        if kmv_est is not None:
            result = dataclasses.replace(
                result, distinct=max(len(result.words), int(round(kmv_est))))
        if registers is not None:
            result = dataclasses.replace(
                result, distinct_estimate=sketch_ops.estimate(registers))
        if cms is not None:
            result = dataclasses.replace(result, cms=cms)
        if top_k:
            result = apply_top_k(result, top_k)
    return dataclasses.replace(result,
                               run=dataclasses.replace(rr, value=None))
