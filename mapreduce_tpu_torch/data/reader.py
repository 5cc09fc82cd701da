"""Boundary-aligned ingest: a file as a stream of token-aligned chunks.

Counterpart of :mod:`mapreduce_tpu.data.reader`.  A row may only end at a
separator byte, so no token spans two chunks; a separator-free run longer
than ``max_token_bytes`` is force-split at the ideal cut.  Every batch
carries the absolute (virtual, for a multi-file corpus) offset of its rows,
so device positions map back to exact byte ranges for string recovery.

The batch fill runs in the native chunker (:mod:`...native`), which gives
the JAX reader's batches byte for byte.  ``out`` lets the caller supply
each batch's data buffer, so the executor's pinned staging buffers are
filled in place with no second host copy.  :func:`prefetch` runs the
reader in a thread ahead of the consumer.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from mapreduce_tpu_torch import constants, native
from mapreduce_tpu_torch.obs import registry as obs_registry


@dataclasses.dataclass(frozen=True)
class Batch:
    """One streaming step's input."""

    data: np.ndarray  # uint8[n_shards, chunk_bytes], zero-padded rows
    base_offsets: np.ndarray  # int64[n_shards], absolute offset of each row
    lengths: np.ndarray  # int64[n_shards], valid bytes per row
    step: int
    file_index: int = 0  # corpus member the batch came from (never spans two)
    fill_s: float = 0.0  # seconds in the native fill, not the buffer's take


def iter_batches(path, n_shards: int, chunk_bytes: int,
                 max_token_bytes: int = 4096, start_offset: int = 0,
                 start_step: int = 0,
                 out: Optional[Callable[[], np.ndarray]] = None,
                 end_offset: Optional[int] = None) -> Iterator[Batch]:
    """Stream a file as boundary-aligned ``[n_shards, chunk_bytes]``
    batches.

    ``start_offset``/``start_step`` continue from a reported cursor
    (checkpoint resume).  ``end_offset`` bounds the stream to the
    half-open range ``[start_offset, end_offset)``: a host's byte range
    of a corpus read by several hosts
    (:func:`...parallel.distributed.host_byte_range`, aligned with
    ``align_range_to_separator``, so the range's end is a token boundary
    and the end-of-file rule applies there).  ``out()``, when given,
    returns the uint8 buffer (``n_shards * chunk_bytes`` bytes,
    C-contiguous) each batch is filled into."""
    size = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r") if size else None
    total = size if end_offset is None else min(size, end_offset)
    offset = start_offset
    step = start_step
    stride = n_shards * chunk_bytes
    while offset < total:
        raw = mm[offset: min(offset + stride, total)]
        at_eof = offset + raw.shape[0] >= total
        data = np.empty((n_shards, chunk_bytes), np.uint8) if out is None \
            else out().reshape(n_shards, chunk_bytes)
        bases = np.empty((n_shards,), dtype=np.int64)
        lengths = np.empty((n_shards,), dtype=np.int64)
        t0 = time.perf_counter()
        consumed = native.fill_batch(raw, at_eof, n_shards, chunk_bytes,
                                     max_token_bytes, data, bases, lengths)
        fill_s = time.perf_counter() - t0
        if consumed <= 0:  # cannot happen: a first cut takes >= 1 byte
            raise RuntimeError("ingest made no progress")
        bases += offset
        yield Batch(data=data, base_offsets=bases, lengths=lengths, step=step,
                    fill_s=fill_s)
        offset += consumed
        step += 1


def iter_batches_multi(paths, n_shards: int, chunk_bytes: int,
                       max_token_bytes: int = 4096, start_offset: int = 0,
                       start_step: int = 0,
                       out: Optional[Callable[[], np.ndarray]] = None,
                       end_offset: Optional[int] = None) -> Iterator[Batch]:
    """Stream several files as one corpus.  Offsets (``start_offset``,
    ``end_offset``, ``Batch.base_offsets``) are virtual: positions in the
    concatenation of the files, so a byte range may start and end inside
    any member.  A file's end is a hard token boundary; step numbering
    continues across files."""
    if isinstance(paths, (str, bytes, os.PathLike)):
        paths = [paths]
    step = start_step
    file_start = 0
    for fi, path in enumerate(paths):
        size = os.path.getsize(path)
        local_lo = max(0, start_offset - file_start)
        local_hi = size if end_offset is None \
            else min(size, max(0, end_offset - file_start))
        if local_lo < local_hi:
            for b in iter_batches(path, n_shards, chunk_bytes,
                                  max_token_bytes=max_token_bytes,
                                  start_offset=local_lo, start_step=step,
                                  out=out, end_offset=local_hi):
                yield dataclasses.replace(
                    b, base_offsets=b.base_offsets + file_start,
                    file_index=fi)
                step = b.step + 1
        file_start += size


def prefetch(batches: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run an iterator in a daemon thread, up to ``depth`` items ahead.

    The queue is bounded, so an abandoned consumer holds at most ``depth``
    batches; a producer exception is re-raised at the consumer's next pull;
    closing the generator (or an error in the consumer, a
    ``KeyboardInterrupt`` in its wait included) stops the producer at its
    next put and waits for it, so no fill is left running into a buffer
    its owner may free.

    The metrics registry gets the JAX reader's instruments: the depth
    (``reader.prefetch_depth``), each batch's production time
    (``reader.produce_seconds``, ``reader.batches_prefetched``: the
    buffer's take and the fill together) and the producer's time blocked
    on a full queue (``reader.stall_full_queue_seconds``).  The thread
    opens no profiler region: a profile's idle gaps are labelled by the
    innermost region open on any thread, and the consumer's spans own
    them.  Its fill time travels with each batch (``Batch.fill_s``)."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    reg = obs_registry.get_registry()
    reg.gauge("reader.prefetch_depth").set(depth)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            t_prev = time.perf_counter()
            for b in batches:
                t_ready = time.perf_counter()
                reg.observe("reader.produce_seconds", t_ready - t_prev)
                reg.counter("reader.batches_prefetched").inc()
                if not put(b):
                    return
                t_prev = time.perf_counter()
                reg.counter("reader.stall_full_queue_seconds").inc(
                    t_prev - t_ready)
            put(end)
        except BaseException as e:  # re-raised on the consumer side
            put(_ProducerError(e))

    t = threading.Thread(target=produce, daemon=True, name="ingest-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _ProducerError):
                raise item.error
            yield item
    finally:
        stop.set()
        t.join()


class _ProducerError:
    def __init__(self, error: BaseException):
        self.error = error


def read_words_at_multi(paths, offsets, lengths) -> list[bytes]:
    """Exact bytes of the spans at virtual corpus ``offsets`` (``int64``
    arrays, in any order) of ``lengths`` bytes, over one file or a list of
    files (one corpus): the host's string recovery, words in the order of
    the spans.

    Spans go to files by one ``searchsorted`` over the files' starts;
    each touched file is mapped once (``mmap``, read-only) and its words
    are sliced from the map by plain Python ints (``tolist``), with no
    numpy scalar or array view per word.  A file with no span (an empty
    one among them, which cannot be mapped) is never opened."""
    plist = [paths] if isinstance(paths, (str, bytes, os.PathLike)) \
        else list(paths)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if offsets.shape[0] == 0:
        return []
    starts = np.cumsum([0] + [os.path.getsize(p) for p in plist])
    file_idx = np.searchsorted(starts, offsets, side="right") - 1
    # Group the spans by file; spans in file order (recovery's) are
    # grouped already, and no permutation is made or undone.
    by_file = None if np.all(file_idx[1:] >= file_idx[:-1]) \
        else np.argsort(file_idx, kind="stable")
    if by_file is not None:
        file_idx, offsets, lengths = (file_idx[by_file], offsets[by_file],
                                      lengths[by_file])
    local = offsets - starts[file_idx]
    ends = local + lengths
    cuts = np.flatnonzero(file_idx[1:] != file_idx[:-1]) + 1
    words: list[bytes] = []
    for lo, hi in zip([0, *cuts.tolist()], [*cuts.tolist(), len(local)]):
        with open(plist[int(file_idx[lo])], "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            words += [mm[o:e] for o, e in zip(local[lo:hi].tolist(),
                                              ends[lo:hi].tolist())]
    if by_file is None:
        return words
    out: list[bytes] = [b""] * len(words)
    for i, word in zip(by_file.tolist(), words):
        out[i] = word
    return out


def line_bounds_at_multi(paths, offsets) -> tuple[np.ndarray, np.ndarray]:
    """The LF-delimited line around each virtual corpus offset (``int64``,
    in any order), over one file or a list of files (one corpus): its
    start and its end (the LF, or the end of its file), both virtual.  A
    line never crosses a file.  Each touched file is mapped once and each
    bound is one ``rfind`` or ``find`` of the map."""
    plist = [paths] if isinstance(paths, (str, bytes, os.PathLike)) \
        else list(paths)
    offsets = np.asarray(offsets, dtype=np.int64)
    lo, hi = np.empty_like(offsets), np.empty_like(offsets)
    if offsets.shape[0] == 0:
        return lo, hi
    starts = np.cumsum([0] + [os.path.getsize(p) for p in plist])
    file_idx = np.searchsorted(starts, offsets, side="right") - 1
    for k in np.unique(file_idx).tolist():
        at = np.flatnonzero(file_idx == k)
        base = int(starts[k])
        with open(plist[k], "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            size = len(mm)
            first, last = [], []
            for o in (offsets[at] - base).tolist():
                first.append(mm.rfind(b"\n", 0, o) + 1)
                e = mm.find(b"\n", o)
                last.append(size if e < 0 else e)
        lo[at] = np.asarray(first, np.int64) + base
        hi[at] = np.asarray(last, np.int64) + base
    return lo, hi


_SEP_LUT = np.zeros(256, dtype=bool)
_SEP_LUT[list(constants.SEPARATOR_BYTES)] = True


def scan_gram_lengths_bytes(source, offsets, n: int) -> list[int]:
    """:func:`scan_gram_lengths` over one in-memory buffer (no chunk cuts:
    a single-buffer run never force-splits): the spans of the n-entry
    grams starting at ``offsets``, in one vectorised pass however many
    offsets.  A gram whose n-th entry end lies past the buffer spans to
    its end."""
    arr = np.frombuffer(source, dtype=np.uint8) \
        if isinstance(source, (bytes, bytearray)) \
        else np.asarray(source, dtype=np.uint8)
    offs = np.asarray(list(offsets), dtype=np.int64)
    if arr.shape[0] == 0:
        return [0 for _ in offs]
    sep = _SEP_LUT[arr]
    nxt = np.concatenate([sep[1:], np.array([True])])
    epos = np.flatnonzero(~sep & nxt)  # entry ends (inclusive)
    if len(epos) == 0:
        return [int(arr.shape[0] - o) for o in offs]
    j = np.searchsorted(epos, offs) + n - 1
    ends = np.where(j < len(epos), epos[np.minimum(j, len(epos) - 1)] + 1,
                    arr.shape[0])
    return [int(e - o) for e, o in zip(ends, offs)]


def scan_gram_lengths(paths, offsets, n: int, cut_offsets=None) -> list[int]:
    """Byte spans of the n-entry grams starting at virtual corpus
    ``offsets``: the host's recovery of cross-chunk gram entries (length
    ``SEAM_GRAM_LENGTH``), whose end lies in a later chunk.  Each scan
    reads forward from its start (an entry start) to the end of the n-th
    stream entry, doubling its window as separator runs are unbounded; a
    file that ends first gives the rest of the file.  Grams never cross
    files (the executor resets the seam carry there).

    ``cut_offsets``: the run's row base offsets.  The chunker force-splits
    a separator-free run longer than a row at a row cut, and both halves
    are stream entries, so a cut inside a run ends an entry too (the
    native chunker cuts where the JAX reader does).  Batch API: one
    memmap per touched file, however many offsets.
    """
    plist = [paths] if isinstance(paths, (str, bytes, os.PathLike)) \
        else list(paths)
    starts = np.cumsum([0] + [os.path.getsize(p) for p in plist])
    cuts = np.sort(np.asarray(cut_offsets, dtype=np.int64)) \
        if cut_offsets is not None else np.empty(0, np.int64)
    offs = np.asarray(list(offsets), dtype=np.int64)
    file_idx = np.searchsorted(starts, offs, side="right") - 1
    mms: dict = {}
    out: list[int] = []
    for j, off in enumerate(offs):
        k = int(file_idx[j])
        if k not in mms:
            mms[k] = np.memmap(plist[k], dtype=np.uint8, mode="r")
        mm = mms[k]
        base, local, size = int(starts[k]), int(off - starts[k]), mm.shape[0]
        win = 4096
        while True:
            end = min(local + win, size)
            sep = _SEP_LUT[np.asarray(mm[local:end])]
            at_eof = end >= size
            nxt = np.concatenate([sep[1:], np.array([True])]) if at_eof \
                else sep[1:]
            ends = ~sep[: len(nxt)] & nxt
            # A row cut at absolute c ends the entry at byte c-1 when that
            # byte is a token byte.
            lo_v = base + local
            ci = cuts[(cuts > lo_v) & (cuts <= lo_v + len(nxt))] - lo_v - 1
            if len(ci):
                ends[ci[~sep[ci]]] = True
            epos = np.flatnonzero(ends)
            if len(epos) >= n:
                out.append(int(epos[n - 1]) + 1)
                break
            if at_eof:
                out.append(int(len(sep)))
                break
            win *= 2
    return out
