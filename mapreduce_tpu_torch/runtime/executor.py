"""Streamed word count over files, on one device: the pipelined executor.

Counterpart of :mod:`mapreduce_tpu.runtime.executor` (``run_job`` and its
``_drive_stream`` loop, ``count_file``, ``recover_from_file``,
``absolute_offsets``) for one card.  Per run:

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
     ``compute_tail``);
  5. every ``checkpoint_every`` steps the state and the ingest cursor are
     saved (:mod:`...runtime.checkpoint`), and a run with a snapshot at its
     checkpoint path resumes from it;
  6. the finished table's words are read back from the files (``recover``).

What the window can hide is the reader, the H2D copy and host
bookkeeping: the map reads ``(spill, overlong, tokens)`` to the host once
per chunk (``models/wordcount.py:_map_kernel``, timed as ``host_read``
inside ``dispatch``), so compute never runs more than one chunk ahead of
the loop.  On the CPU (``device='cpu'``) the loop
is the same, with no streams, events or pinned memory.

Not ported yet (ROADMAP A8b): retries and the failure policy, fault plans,
preemption, the telemetry ledger, data statistics, window-boundary merges,
the autotuner and byte ranges.  A failing step is logged with its resume
cursor and re-raised; checkpoint/resume is the recovery path.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch

from mapreduce_tpu_torch import convert, native
from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models.wordcount import (WordCountJob,
                                                  WordCountResult,
                                                  _reported_distinct,
                                                  apply_top_k)
from mapreduce_tpu_torch.obs.spans import span, timing_into
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.parallel.mapreduce import Engine
from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod
from mapreduce_tpu_torch.runtime import metrics as metrics_mod
from mapreduce_tpu_torch.runtime.logging import get_logger, log_event

#: Phases in which the loop waits rather than works (see _overlap_fraction).
#: ``host_read`` is the map's one read of a chunk (inside ``dispatch``).
_BLOCKED = ("read_wait", "host_read", "retire_wait", "h2d_tail",
            "compute_tail")


@dataclasses.dataclass
class RunResult:
    """A streamed run's finished job state and its measurements."""

    value: Any  # the finished job state (a CountTable on the run's device)
    metrics: metrics_mod.RunMetrics
    bases: np.ndarray  # int64[steps, 1] row base offsets (string recovery)
    pipeline: Optional[dict] = None  # the window statistics (``pipe``)


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


class _HostStage:
    """Staging of a CPU run: the reader's array is the chunk (no copy, no
    events; work is done when the call returns)."""

    take = None

    def stage(self, batch):
        return torch.from_numpy(batch.data).reshape(-1), None

    def wait_copies(self, events) -> None:
        pass

    def completion(self):
        return None

    @staticmethod
    def wait(event) -> None:
        pass

    def summary(self) -> dict:
        return {"pinned_buffers": 0, "h2d_ms_per_chunk": None}


class _PinnedStage:
    """Staging of a CUDA run: pinned host buffers and a copy stream.

    The reader thread fills a pinned buffer it gets from :meth:`take`; the
    loop copies it to the card on the copy stream and records an event
    after the copy (:meth:`stage`).  The buffer returns to the pool with
    that event and is handed out again only once the event has completed,
    i.e. once the copy has read it; a buffer refilled earlier would corrupt
    a chunk silently.  The device chunk is allocated on the copy stream
    and marked as used by the compute stream (``record_stream``), so the
    caching allocator does not reuse its memory while a kernel reads it.
    """

    def __init__(self, device: torch.device, nbytes: int, depth: int):
        self.nbytes = nbytes
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        # Buffers held at once without a copy event: the prefetch queue's
        # `depth`, and the one the loop took but has not staged yet.  One
        # more is always back in the pool, or can be waited for.
        self.cap = depth + 2
        self._lock = threading.Lock()
        self._returned: collections.deque = collections.deque()
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

    def stage(self, batch):
        """Copy a batch to the card on the copy stream: ``(device chunk,
        copy event)``."""
        host = torch.from_numpy(batch.data).reshape(-1)
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
        with self._lock:
            self._returned.append(
                (self._pinned[batch.data.ctypes.data], done))
        return chunk, done

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
    def wait(event) -> None:
        event.synchronize()

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

    done: Any  # completion token (None on the CPU)
    copy_done: Any  # the event of the group's last H2D copy
    step_first: int
    cursor_before: int  # bytes_done before the group (the failure cursor)


def _drive_stream(engine, config: Config, path, state, stage, *,
                  start_step: int, start_offset: int, bases_list: list,
                  checkpoint_path, checkpoint_every: int, fingerprint,
                  resumed_file, logger, progress_every: int, timer):
    """The streaming loop (the JAX ``_drive_stream`` without retries,
    faults, ledger and merges).  Returns ``(state, bytes_done, pipe)``:
    ``bytes_done`` is the absolute cursor (it starts at ``start_offset``)
    and ``pipe`` the window statistics."""
    bytes_done = int(start_offset)
    step_index = start_step
    last_ckpt = start_step // checkpoint_every if checkpoint_every else 0
    window_cap = config.inflight_groups
    window: collections.deque = collections.deque()
    last_file_dispatched = resumed_file or 0
    pipe = {"inflight_groups": window_cap,
            "prefetch_depth": config.resolved_prefetch_depth,
            "dispatch_groups": 0, "depth_sum": 0, "depth_max": 0,
            "full_retires": 0, "boundary_drains": 0}

    def fail(e: Exception, step: int, cursor: int):
        """Surface a failed step with its resume cursor; checkpoint/resume
        is the recovery path."""
        log_event(logger, "step failed", step=step, offset=cursor,
                  error=repr(e), resume_hint=checkpoint_path
                  or "enable checkpointing to resume")
        raise e

    def retire_oldest(phase: Optional[str] = "retire_wait") -> None:
        """Wait for the oldest group's completion token; an error that
        surfaces here belongs to that group."""
        entry = window[0]
        try:
            if phase is None:
                stage.wait(entry.done)
            else:
                with span(phase, timer):
                    stage.wait(entry.done)
        except Exception as e:
            fail(e, entry.step_first, entry.cursor_before)
        window.popleft()

    def drain(phase: Optional[str] = "retire_wait") -> None:
        while window:
            retire_oldest(phase)

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

    def account(batches) -> None:
        nonlocal bytes_done, step_index, last_file_dispatched
        last_file_dispatched = batches[-1].file_index
        for b in batches:
            bases_list.append(b.base_offsets)
            bytes_done += int(b.lengths.sum())
        step_index = batches[-1].step + 1
        if progress_every and step_index % progress_every < len(batches):
            log_event(logger, "progress", step=step_index, bytes=bytes_done)

    def flush_one(state, group):
        """Dispatch one group, keeping at most ``window_cap`` in flight."""
        nonlocal last_ckpt
        while len(window) >= window_cap:  # make room first
            pipe["full_retires"] += 1
            retire_oldest()
        batches = [b for b, _ in group]
        chunks = [c for _, (c, _) in group]
        copies = [ev for _, (_, ev) in group]
        cursor_before = bytes_done
        try:
            with span("dispatch", timer):
                stage.wait_copies(copies)
                for b, chunk in zip(batches, chunks):
                    state = engine.step(state, chunk, b.step)
                done = stage.completion()
        except Exception as e:
            fail(e, batches[0].step, cursor_before)
        window.append(_Inflight(done, copies[-1], batches[0].step,
                                cursor_before))
        pipe["dispatch_groups"] += 1
        pipe["depth_sum"] += len(window)
        pipe["depth_max"] = max(pipe["depth_max"], len(window))
        account(batches)
        if (checkpoint_every and checkpoint_path
                and step_index // checkpoint_every > last_ckpt):
            drain()
            pipe["boundary_drains"] += 1
            last_ckpt = step_index // checkpoint_every
            with span("checkpoint", timer):
                bases = np.stack(bases_list)
                ckpt_mod.save(checkpoint_path, convert.table_to_leaves(state),
                              step_index, bytes_done, bases,
                              fingerprint=fingerprint,
                              file_index=last_file_dispatched)
            log_event(logger, "checkpoint", step=step_index,
                      path=checkpoint_path)
        return state

    def flush(state, group):
        for sub in split_at_checkpoints(group):
            state = flush_one(state, sub)
        return state

    last_file: Optional[int] = resumed_file
    pending: list = []
    it = reader_mod.prefetch(
        reader_mod.iter_batches_multi(path, 1, config.chunk_bytes,
                                      start_offset=start_offset,
                                      start_step=start_step, out=stage.take),
        depth=config.resolved_prefetch_depth)
    try:
        while True:
            with span("read_wait", timer):
                batch = next(it, None)
            if batch is None:
                break
            with span("stage", timer):
                staged = stage.stage(batch)
            if last_file is not None and batch.file_index != last_file:
                # A file boundary is a group and window boundary.
                if pending:
                    state = flush(state, pending)
                    pending = []
                drain()
                pipe["boundary_drains"] += 1
            last_file = batch.file_index
            pending.append((batch, staged))
            if len(pending) == config.superstep:
                state = flush(state, pending)
                pending = []
        if pending:
            state = flush(state, pending)
        # The stream's end: the last group's input still in transfer, then
        # the compute queued behind it.  Timed even when empty, so the
        # phase keys always exist.
        with span("h2d_tail", timer):
            if window:
                stage.wait(window[-1].copy_done)
        with span("compute_tail", timer):
            drain(phase=None)
    finally:
        it.close()
    n = pipe["dispatch_groups"]
    pipe["depth_mean"] = round(pipe.pop("depth_sum") / n, 2) if n else 0.0
    pipe["window_filled"] = pipe["depth_max"] >= window_cap
    pipe["full_frac"] = round(pipe["full_retires"] / n, 3) if n else 0.0
    pipe.update(stage.summary())
    return state, bytes_done, pipe


def run_job(job, path, config: Config = DEFAULT_CONFIG, device=None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            logger=None, progress_every: int = 50) -> RunResult:
    """Stream ``path`` (a file or a list of files, one corpus) through
    ``job`` on one device; see the module docstring.

    ``device`` defaults to the job's.  ``config`` sets the chunking and the
    pipeline (``chunk_bytes``, ``superstep``, ``inflight_groups``,
    ``prefetch_depth``).  With ``checkpoint_path``, a snapshot there is
    resumed (the previous good one if it is corrupt; a different job,
    capacity, chunk size or input raises ``CheckpointMismatch``), and
    with ``checkpoint_every`` > 0 one is saved every that many steps.
    """
    dev = job.device if device is None else torch.device(device)
    if dev != job.device:
        raise ValueError(f"run_job on {dev} got a job on {job.device}")
    engine = Engine(job, dev)
    logger = logger or get_logger()
    native.load()  # a failed chunker build fails here, not in the reader
    timer = metrics_mod.PhaseTimer()
    timer.start("total")
    state = engine.init_states()
    start_step, start_offset, resumed_file = 0, 0, None
    bases_list: list = []
    fingerprint = ckpt_mod.run_fingerprint(
        path, 1, config.chunk_bytes, backend=config.resolved_backend(),
        pallas_max_token=config.pallas_max_token,
        job_identity=job.identity()) if checkpoint_path else None
    if checkpoint_path and ckpt_mod.exists(checkpoint_path):
        (leaves, start_step, start_offset, bases, resumed_file), fallback = \
            ckpt_mod.load_resilient(
                checkpoint_path, template=convert.table_to_leaves(state),
                expect_fingerprint=fingerprint)
        state = convert.leaves_to_table(leaves, dev)
        bases_list = list(bases)
        log_event(logger, "resumed from checkpoint", step=start_step,
                  offset=start_offset)
        if fallback is not None:
            log_event(logger, "corrupt checkpoint; resumed from previous "
                      "good snapshot", **fallback)
    stage = _PinnedStage(dev, config.chunk_bytes,
                         config.resolved_prefetch_depth) \
        if dev.type == "cuda" else _HostStage()
    timer.start("stream")
    with timing_into(timer):
        state, bytes_done, pipe = _drive_stream(
            engine, config, path, state, stage, start_step=start_step,
            start_offset=start_offset, bases_list=bases_list,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, fingerprint=fingerprint,
            resumed_file=resumed_file, logger=logger,
            progress_every=progress_every, timer=timer)
    timer.stop("stream")
    with span("reduce", timer):
        value = engine.finish(state)
    total_s = timer.stop("total")
    pipe["overlap_fraction"] = _overlap_fraction(timer)
    # The bytes this run streamed (a resumed run starts at its cursor).
    m = metrics_mod.RunMetrics(bytes_processed=bytes_done - start_offset,
                               words_counted=value.total_count(),
                               elapsed_s=total_s, phases=dict(timer.phases))
    log_event(logger, "run complete", **m.as_dict())
    bases = np.stack(bases_list) if bases_list \
        else np.zeros((0, 1), np.int64)
    return RunResult(value=value, metrics=m, bases=bases, pipeline=pipe)


def absolute_offsets(chunk_id: np.ndarray, pos: np.ndarray,
                     bases: np.ndarray, n_devices: int) -> np.ndarray:
    """Decode (chunk_id = step * n_devices + device, in-chunk pos) into
    absolute corpus offsets via the recorded row bases."""
    step, dev = chunk_id // n_devices, chunk_id % n_devices
    return bases[step, dev] + pos


def recover_from_file(tbl: table_ops.CountTable, path, bases: np.ndarray,
                      n_devices: int = 1,
                      estimate_distinct: bool = True) -> WordCountResult:
    """Host-side string recovery for a streamed run, words in file order of
    first occurrence."""
    count = tbl.count.cpu().numpy()
    count_hi = tbl.count_hi.cpu().numpy()
    valid = (count > 0) | (count_hi > 0)
    chunk_id = tbl.pos_hi.cpu().numpy()[valid]
    pos = tbl.pos_lo.cpu().numpy()[valid]
    length = tbl.length.cpu().numpy()[valid]
    cnt = (count + (count_hi << 32))[valid]
    absolute = absolute_offsets(chunk_id, pos, bases, n_devices)
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
               top_k: Optional[int] = None, **kw) -> WordCountResult:
    """WordCount over one file or a list of files (one corpus) through
    :func:`run_job`; ``kw`` goes to it (checkpoints, logger, progress).
    ``device`` defaults to the card.

    ``top_k`` keeps the k most frequent words, as the JAX package's top-k
    job does: the table's KMV distinct estimate is taken before the
    terminal top-k reorder, and evicted entries fold into ``dropped_*``.
    The result's ``run`` is the run's :class:`RunResult` (its value
    dropped), with the host string recovery as the ``recover`` phase.
    """
    rr = run_job(WordCountJob(config, device), path, config, **kw)
    timer = metrics_mod.PhaseTimer(phases=rr.metrics.phases)
    with span("recover", timer):
        tbl = rr.value
        kmv_est = None
        if top_k:
            n_valid, kth_hi, kth_lo = (int(x) for x in
                                       table_ops.kmv_snapshot(tbl))
            kmv_est = table_ops.kmv_from_snapshot(n_valid, kth_hi, kth_lo,
                                                  config.table_capacity)
            tbl = table_ops.top_k(tbl, top_k)
        result = recover_from_file(tbl, path, rr.bases, 1,
                                   estimate_distinct=not top_k)
        if kmv_est is not None:
            result = dataclasses.replace(
                result, distinct=max(len(result.words), int(round(kmv_est))))
        if top_k:
            result = apply_top_k(result, top_k)
    return dataclasses.replace(result,
                               run=dataclasses.replace(rr, value=None))
