"""WordCount: the flagship model, on the card, and its family.

Counterpart of :mod:`mapreduce_tpu.models.wordcount`: the word-count main
path, the n-gram job (:class:`NGramCountJob`, :func:`count_ngrams`) and
the sketch wrappers (:class:`SketchedWordCountJob`,
:class:`FreqSketchedWordCountJob`).  The word count: tokenize + hash (the
hand-written CUDA kernels, or the plain tokenizer on the ``xla`` backend;
under ``combiner='hot-cache'`` the kernel's flushed hot-key cache folds
back in as one small table merge), a sort (torch's, or the CUDA radix
partition under ``sort_impl``) + segment reduce into a fixed-capacity
:class:`...ops.table.CountTable`, the overlong rescue, and host-side
string recovery from first-occurrence positions.  The n-gram map reads
the host once a chunk too (the token and overlong counts, for the cut).

Control flow.  The JAX package wraps the spill fallback and the overlong
rescue in ``lax.cond``.  Eager PyTorch has no device-side cond, so each
becomes a host ``if``: :func:`_map_kernel` reads the chunk's ``spill``,
``overlong`` and token scalars in ONE device-to-host copy (one sync per
chunk) and branches on them.  The same copy gives the live count that cuts
the kernel's dense stream to its rows before the sort, so the sort sees
``live + 1`` rows.  Only the combiner's windowed stream can spill.  The
radix sort seam reads nothing back (``ops/cuda/radix.py``).

No seam table.  The JAX split map emits a column stream plus a seam stream
(the 128-lane seams of its TPU layout) and folds the seam table in a
separate or three-way merge (``SeamedUpdate``).  The port's kernel reads
its own halo, so it emits ONE stream and there is no seam table to defer:
the job's combine is the plain two-way merge.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
from collections import Counter
from typing import Any, NamedTuple

import numpy as np
import torch

from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.obs.spans import span
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops import ngram as ngram_ops
from mapreduce_tpu_torch.ops import rescue as rescue_ops
from mapreduce_tpu_torch.ops import sketch as sketch_ops
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
from mapreduce_tpu_torch.ops.ngram import ChunkSummary
from mapreduce_tpu_torch.runtime.platform import resolve_device

#: Host-side branch counts of the kernel path: "chunks", "spill_fallbacks"
#: (combiner spill -> combiner-free rerun), "rescue_passes" (overlong > 0),
#: "rescue_escalations" (overlong > rescue_slots: the R_max tier), and under
#: the combiner "combiner_hits" (occurrences the cache absorbed) and
#: "combiner_flushes" (cache rows folded back), read in the chunk's one sync.
BRANCHES: Counter = Counter()

#: How the map reads its flags to the host (see :func:`host_read_by`);
#: None is a blocking ``tolist``.
_HOST_READ: contextvars.ContextVar = contextvars.ContextVar("host_read",
                                                           default=None)


@contextlib.contextmanager
def host_read_by(read):
    """Within, the map's one host read of a chunk is ``read(flags)`` (a
    list) instead of a blocking ``flags.tolist()``.  On the card that read
    waits for every kernel queued before it, a hung one included: the
    streamed driver puts it under its completion deadline this way."""
    token = _HOST_READ.set(read)
    try:
        yield
    finally:
        _HOST_READ.reset(token)


@dataclasses.dataclass(frozen=True)
class WordCountResult:
    """Host-side result with recovered strings, insertion-ordered (the JAX
    package's fields that this path fills)."""

    words: list[bytes]  # reported words, by first occurrence
    counts: list[int]  # parallel to words
    total: int  # total tokens, dropped ones included (exact)
    distinct: int  # exact unless keys spilled (then a KMV estimate)
    dropped_uniques: int  # upper bound on distinct words spilled or overlong
    dropped_count: int  # tokens of spilled/dropped words (exact)
    # A distinct-sketched run's HLL estimate (~0.8% error at p=14): unlike
    # ``distinct`` it stays accurate past table capacity.
    distinct_estimate: float | None = None
    # A count-sketched run's Count-Min sketch (host numpy): estimate_count()
    # answers for ANY word, spilled ones included.  Not compared.
    cms: np.ndarray | None = dataclasses.field(default=None, compare=False)
    # A streamed run's ``RunResult`` (metrics, bases, window statistics;
    # ``runtime/executor.py:count_file``), None otherwise.  Not compared.
    run: Any = dataclasses.field(default=None, compare=False, repr=False)

    def as_dict(self) -> dict[bytes, int]:
        return dict(zip(self.words, self.counts))

    def estimate_count(self, word: bytes) -> int | None:
        """The Count-Min estimate of ``word``'s count (None without a
        sketch): never below the count of a word the run saw (within the
        batch tables' envelope), above it by ~total/width per row w.h.p."""
        if self.cms is None:
            return None
        return sketch_ops.cms_query(self.cms, word)


def apply_top_k(result: WordCountResult, k: int) -> WordCountResult:
    """Restrict a result to its k most frequent words (host-side, stable);
    ``total`` keeps counting every token."""
    order = sorted(range(len(result.words)),
                   key=lambda i: -result.counts[i])[:k]
    return dataclasses.replace(
        result,
        words=[result.words[i] for i in order],
        counts=[result.counts[i] for i in order],
    )


def _accounted(t: table_ops.CountTable, n_over) -> table_ops.CountTable:
    """Fold unrescued overlong occurrences into ``dropped_*`` (for
    dropped_uniques an upper bound: unhashed tokens cannot be deduped)."""
    return t._replace(dropped_uniques=t.dropped_uniques + n_over,
                      dropped_count=t.dropped_count + n_over)


def _combiner_table(cache: kernel_tok.CombinerCache,
                    pos_hi) -> table_ops.CountTable:
    """One chunk's flushed hot-key cache as an exact small table: one row
    per resident entry, with its count and first in-segment occurrence.  A
    key resident in several segments coalesces in the generic build
    (counts add, the smallest position wins), so merging this table with
    the thinned stream's gives the uncombined build.  Capacity is the
    plane size, so the build cannot spill."""
    khi, klo, cnt, packed = (x.reshape(-1) for x in cache)
    live = cnt > 0
    stream = tok_ops.TokenStream(
        key_hi=torch.where(live, khi, tok_ops.SENT),
        key_lo=torch.where(live, klo, tok_ops.SENT),
        count=torch.where(live, cnt, 0),
        pos=torch.where(live, packed >> 6, tok_ops.POS_INF),
        length=torch.where(live, packed & 63, 0))
    return table_ops.from_stream(stream, khi.shape[0], pos_hi=pos_hi)


def _tokenize(chunk: torch.Tensor, config: Config):
    """The configured kernel mode: ``(stream, overlong, spill, cache)``,
    ``cache`` None unless the hot-key combiner runs."""
    w = config.pallas_max_token
    cslots = config.resolved_combiner_slots
    if cslots:
        return kernel_tok.tokenize_fused(chunk, max_token_bytes=w,
                                         combiner_slots=cslots)
    if config.map_impl == "fused":
        return (*kernel_tok.tokenize_fused(chunk, max_token_bytes=w), None)
    if config.compact:
        return (*kernel_tok.tokenize_split_compact(chunk, w), None)
    stream, overlong = kernel_tok.tokenize_split(chunk, w)
    return stream, overlong, torch.zeros_like(overlong), None


def _read_flags(flags: torch.Tensor) -> list:
    """The map's one host read of a chunk: ``flags`` as a list, under the
    ``host_read`` span, through :func:`host_read_by`'s reader when one is
    set.  It waits for the card (the streamed loop's too)."""
    read = _HOST_READ.get()
    with span("host_read"):
        return flags.tolist() if read is None else read(flags)


def _map_kernel(chunk: torch.Tensor, config: Config, capacity: int, pos_hi,
                with_stats: bool = False):
    """The kernel branch of the JAX ``_map_stream``: compact (or fused, or
    combiner) tokenize, the exact combiner-free rerun when a combiner
    window spilled, the packed aggregation sort, the tiered overlong rescue
    and, under the combiner, the fold of the flushed cache.  With
    ``with_stats``, ``(table, DataStats)`` (see :func:`_map_stream`)."""
    w = config.pallas_max_token
    stream, overlong, spill, cache = _tokenize(chunk, config)
    # The one host sync of the chunk: both branch predicates, the token
    # count (a dense stream's live rows are its tokens and its overlong
    # runs) and the combiner's hit and flush counts (and, for the data
    # statistics, its cold entries), in one copy.
    flags = [spill, overlong, stream.total]
    if cache is not None:
        flags += [cache.count.sum(), (cache.count > 0).sum()]
        if with_stats:
            flags.append((cache.count == 1).sum())
    spill_h, over_h, tokens_h, *cached = _read_flags(torch.stack(flags))
    BRANCHES["chunks"] += 1
    used = cache is not None and not spill_h
    if spill_h:
        # A combiner window overflowed its slots, so the thinned stream is
        # incomplete: rerun as the dense stream, which cannot spill.  The
        # rerun is combiner-free, so the aborted pass's cache goes too:
        # exactness never depends on it.  Its tokens are the ones left in
        # the thinned stream and the ones the cache took; both passes see
        # the same overlong runs, so over_h stands.
        BRANCHES["spill_fallbacks"] += 1
        stream, overlong = kernel_tok.tokenize_split(chunk, w)
        tokens_h += cached[0]
        cache = None
    elif cache is not None:
        BRANCHES["combiner_hits"] += cached[0]
        BRANCHES["combiner_flushes"] += cached[1]
    stream = stream.cut(tokens_h + over_h)
    t, rescued = _aggregate(chunk, stream, overlong, over_h, config,
                            capacity, pos_hi)
    if cache is not None:
        t = table_ops.merge(t, _combiner_table(cache, pos_hi),
                            capacity=capacity)
    if not with_stats:
        return t
    r1 = config.rescue_slots
    return t, datastats.map_stats(
        overlong=over_h, rescued=rescued, spill_rows=spill_h,
        fallback_chunks=int(bool(spill_h)),
        rescue_invocations=int(bool(r1) and over_h > 0),
        rescue_escalations=int(config.rescue_slots_max > r1 > 0
                               and over_h > r1),
        dropped_tokens=t.dropped_count, dropped_uniques=t.dropped_uniques,
        combiner_hits=cached[0] if used else 0,
        combiner_flushes=cached[1] if used else 0,
        combiner_evicted=cached[2] if used else 0)


def _aggregate(chunk, stream, overlong, over_h: int, config: Config,
               capacity: int, pos_hi):
    """One packed build of a complete stream and the tiered rescue:
    ``(table, rescued)``, ``rescued`` the overlong occurrences the rescue
    recovered (0 when it did not run)."""
    w = config.pallas_max_token
    # The poison rows sort just before the dense stream's one dead row and
    # its end, so the rescue slice takes at most over_h + 1 rows: a longer
    # one would be clamped back into real rows (``from_packed_rows``) and
    # the first tier's cut would miss the poisons.  Fewer slots change no
    # table: rows past the poisons are masked off by the rescue.
    rescue_slots = min(config.rescue_slots_max, over_h + 1)
    # Every mode emits in global byte order, so stable2 holds for each.
    built = table_ops.from_stream(
        stream, capacity, pos_hi=pos_hi, max_token_bytes=w,
        max_pos=int(chunk.shape[0]), sort_mode=config.sort_mode,
        rescue_slots=rescue_slots, sort_impl=config.sort_impl,
        radix_bits=config.resolved_geometry.radix_bits,
        salt_bits=config.resolved_salt_bits)
    if not config.rescue_slots:
        return _accounted(built, overlong), 0
    t, rescue_packed = built
    if not over_h:
        return t, 0
    BRANCHES["rescue_passes"] += 1
    r1 = config.rescue_slots
    if rescue_packed.shape[0] > r1:
        if over_h > r1:
            BRANCHES["rescue_escalations"] += 1
        else:
            rescue_packed = rescue_packed[:r1]
    rt, rescued = rescue_ops.rescue_table(chunk, rescue_packed, w,
                                          config.rescue_window, pos_hi)
    # rescued <= overlong by construction (one poison per overlong run).
    ok = torch.minimum(rescued, overlong)
    return _accounted(table_ops.merge(t, rt, capacity=capacity),
                      overlong - ok), ok


def _map_stream(chunk: torch.Tensor, config: Config, capacity: int,
                pos_hi=0, with_stats: bool = False):
    """Tokenize one buffer with the configured backend and build its table
    (``pos_hi`` is the chunk id, so first occurrence is global).

    With ``with_stats`` (a telemetered streamed run) the result is
    ``(table, ops.datastats.DataStats)``: the chunk's data-plane counters,
    from the chunk's one host read and the table's own ``dropped_*``.
    The table is the same; without it nothing extra runs."""
    if config.resolved_backend() == "pallas":
        return _map_kernel(chunk, config, capacity, pos_hi, with_stats)
    built = table_ops.from_stream(tok_ops.tokenize(chunk), capacity,
                                  pos_hi=pos_hi)
    if not with_stats:
        return built
    # The plain tokenizer has no window and no rescue: only the table's
    # own accounting of keys past its capacity.
    return built, datastats.map_stats(dropped_tokens=built.dropped_count,
                                      dropped_uniques=built.dropped_uniques)


def _pad_for_backend(data, config: Config) -> np.ndarray:
    """Pad a buffer to a multiple of 128 bytes and at least the kernel
    path's minimum chunk, the JAX package's rule (padding is separator
    bytes, so it changes no token)."""
    buf = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) else data
    min_len = config.pallas_min_chunk \
        if config.resolved_backend() == "pallas" else 128
    return tok_ops.pad_to(buf, max(min_len, -(-buf.shape[0] // 128) * 128))


def count_table(data, config: Config = DEFAULT_CONFIG,
                device=None) -> table_ops.CountTable:
    """Run the device pipeline over one in-memory buffer; return the table.
    ``device`` defaults to the card (see :func:`resolve_device`)."""
    dev = resolve_device(device)
    chunk = torch.from_numpy(_pad_for_backend(data, config)).to(dev)
    return _map_stream(chunk, config, config.table_capacity)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _reported_distinct(tbl: table_ops.CountTable, n_words: int,
                       dropped_uniques: int, estimate: bool) -> int:
    """Exact when nothing spilled; the table's KMV estimate when it did."""
    if estimate and dropped_uniques > 0:
        est = table_ops.kmv_distinct(tbl)
        if est is not None:
            return max(n_words, int(round(est)))
    return n_words + dropped_uniques


def recover_result(tbl: table_ops.CountTable, source: bytes,
                   estimate_distinct: bool = True,
                   ngram: int = 1) -> WordCountResult:
    """Host-side string recovery from a single-buffer table (pos_hi 0).

    ``ngram`` is the table's gram order: an entry of length
    ``SEAM_GRAM_LENGTH`` is a span of 127 bytes or more (the packed gram
    build stores 7 bits), recovered by scanning ``ngram`` entries forward
    from its start, in one batch call."""
    count = _host(tbl.count)
    count_hi = _host(tbl.count_hi)
    valid = (count > 0) | (count_hi > 0)
    pos = _host(tbl.pos_lo)[valid]
    length = _host(tbl.length)[valid]
    cnt = (count + (count_hi << 32))[valid]
    seam = np.flatnonzero(length == ngram_ops.SEAM_GRAM_LENGTH)
    if len(seam):
        length[seam] = reader_mod.scan_gram_lengths_bytes(source, pos[seam],
                                                          ngram)
    order = np.argsort(pos, kind="stable")
    words = [bytes(source[int(p): int(p) + int(n)])
             for p, n in zip(pos[order], length[order])]
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


def count_words(data: bytes, config: Config = DEFAULT_CONFIG,
                device=None) -> WordCountResult:
    """The one-call API: exact word counts for an in-memory buffer."""
    return recover_result(count_table(data, config, device), data)


def _ngram_map(chunk: torch.Tensor, n: int, capacity: int, pos_hi,
               config: Config, summary: bool):
    """One chunk's in-chunk gram table and, with ``summary``, its seam
    :class:`...ops.ngram.ChunkSummary` (else None).  On the kernel path:
    one ``tokenize_stream`` launch and the chunk's one host read
    (:func:`...ops.ngram.ngram_map_with_summary`); on the plain path the
    per-byte stream's scan pairing."""
    if config.resolved_backend() == "pallas":
        out = ngram_ops.ngram_map_with_summary(
            chunk, n, capacity, pos_hi, config, read=_read_flags) if summary \
            else (ngram_ops.ngram_table(chunk, n, capacity, pos_hi, config,
                                        read=_read_flags), None)
        BRANCHES["chunks"] += 1
        return out
    stream = tok_ops.tokenize(chunk)
    gs = ngram_ops.mark_long_spans(tok_ops.ngrams(stream, n))
    t = ngram_ops.gram_table(gs, capacity, pos_hi,
                             max_pos=int(chunk.shape[0]),
                             sort_mode=config.sort_mode,
                             sort_impl=config.sort_impl,
                             radix_bits=config.resolved_geometry.radix_bits,
                             salt_bits=config.resolved_salt_bits)
    return t, (ngram_ops.summary_from_stream(stream, pos_hi, n) if summary
               else None)


def count_ngrams(data: bytes, n: int, config: Config = DEFAULT_CONFIG,
                 device=None) -> WordCountResult:
    """Exact n-gram counts for an in-memory buffer (see
    :class:`NGramCountJob`).  The reported "words" are the grams' source
    spans (separators between tokens included); ``total`` is the number of
    grams, ``max(tokens - n + 1, 0)``."""
    if n < 1:
        raise ValueError(f"ngram order must be >= 1, got {n}")
    dev = resolve_device(device)
    chunk = torch.from_numpy(_pad_for_backend(data, config)).to(dev)
    tbl, _ = _ngram_map(chunk, n, config.table_capacity, 0, config,
                        summary=False)
    return recover_result(tbl, data, ngram=n)


class BufferedTableState(NamedTuple):
    """The running table and up to K staged batch tables
    (``Config.merge_every`` = K > 1).  ``cursor`` counts the batches
    staged since the last flush; flushed slots carry the sentinel key and
    count 0, which the K-way build ignores.  The JAX package keeps the
    cursor on the device and flushes under a ``lax.cond``; it is a
    deterministic count, so the port keeps it on the host (an int), and
    the flush is a host ``if`` with no read of the card.  A checkpoint
    writes it as the JAX state's uint32 leaf."""

    table: table_ops.CountTable
    pend_key_hi: torch.Tensor  # [K * batch_capacity]
    pend_key_lo: torch.Tensor
    pend_count: torch.Tensor
    pend_pos_hi: torch.Tensor
    pend_pos_lo: torch.Tensor
    pend_length: torch.Tensor
    cursor: int


class WordCountJob:
    """WordCount as a MapReduce job: a running CountTable, each chunk's
    table folded in by :func:`merge`.  ``chunk_id`` becomes ``pos_hi``,
    so first occurrence is file order.  With ``config.merge_every`` = K >
    1 the batch tables stage into a :class:`BufferedTableState` and one
    K-way build (:func:`...ops.table.merge_batched`) replaces K merges."""

    def __init__(self, config: Config = DEFAULT_CONFIG, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.capacity = config.table_capacity
        self.batch_capacity = config.batch_uniques
        self.merge_every = config.merge_every

    def _with_empty_pending(self, table: table_ops.CountTable,
                            n: int) -> BufferedTableState:
        """The table with an empty pending buffer of ``n`` rows."""
        def full(v):
            return torch.full((n,), v, dtype=torch.int64, device=self.device)

        return BufferedTableState(table, full(table_ops.SENT),
                                  full(table_ops.SENT), full(0),
                                  full(table_ops.INF), full(table_ops.INF),
                                  full(0), 0)

    def init_state(self):
        table = table_ops.empty(self.capacity, self.device)
        if self.merge_every == 1:
            return table
        return self._with_empty_pending(
            table, self.merge_every * self.batch_capacity)

    def map_chunk(self, chunk: torch.Tensor, chunk_id) -> table_ops.CountTable:
        return _map_stream(chunk, self.config, self.batch_capacity,
                           pos_hi=chunk_id)

    def map_chunk_stats(self, chunk: torch.Tensor, chunk_id, axis=None,
                        device_index: int = 0):
        """The stats-mode map: the same table and the chunk's
        :class:`...ops.datastats.DataStats` (the engine calls this in
        place of :meth:`map_chunk` only for a telemetered run)."""
        return _map_stream(chunk, self.config, self.batch_capacity,
                           pos_hi=chunk_id, with_stats=True)

    def _stats_table(self, state) -> table_ops.CountTable:
        """The running table the data statistics' gauges read: under
        ``merge_every`` the unflushed one (at most K batches behind), as
        in the JAX package, so observing costs no K-way build."""
        return state.table if isinstance(state, BufferedTableState) \
            else state

    def state_stats(self, state, stats):
        """Fill the running table's gauges after a group's last combine."""
        return datastats.with_table_gauges(stats, self._stats_table(state))

    def _flushed(self, st: BufferedTableState) -> BufferedTableState:
        """Fold every staged batch into the table (no staged rows: the
        same table)."""
        table = table_ops.merge_batched(
            st.table, st.pend_key_hi, st.pend_key_lo, st.pend_count,
            st.pend_pos_hi, st.pend_pos_lo, st.pend_length, self.capacity)
        return self._with_empty_pending(table, st.pend_key_hi.shape[0])

    def combine(self, state, update):
        if self.merge_every == 1:
            return table_ops.merge(state, update, capacity=self.capacity)
        b = self.batch_capacity
        off = (state.cursor % self.merge_every) * b
        # Out of place: the input state may be a replay's anchor.
        pend = [torch.slice_scatter(p, x, 0, off, off + b) for p, x in (
            (state.pend_key_hi, update.key_hi),
            (state.pend_key_lo, update.key_lo),
            (state.pend_count, update.count),
            (state.pend_pos_hi, update.pos_hi),
            (state.pend_pos_lo, update.pos_lo),
            (state.pend_length, update.length))]
        # The batch's spill accounting folds in now: the flush carries only
        # the running table's scalars.
        t = state.table
        du_lo, du_hi = table_ops.add64(t.dropped_uniques,
                                       t.dropped_uniques_hi,
                                       update.dropped_uniques,
                                       update.dropped_uniques_hi)
        dc_lo, dc_hi = table_ops.add64(t.dropped_count, t.dropped_count_hi,
                                       update.dropped_count,
                                       update.dropped_count_hi)
        st = BufferedTableState(
            t._replace(dropped_uniques=du_lo, dropped_uniques_hi=du_hi,
                       dropped_count=dc_lo, dropped_count_hi=dc_hi),
            *pend, state.cursor + 1)
        return self._flushed(st) if st.cursor >= self.merge_every else st

    def merge(self, a, b):
        if self.merge_every == 1:
            return table_ops.merge(a, b, capacity=self.capacity)
        fa, fb = self._flushed(a), self._flushed(b)
        return fa._replace(table=table_ops.merge(fa.table, fb.table,
                                                 capacity=self.capacity))

    def _plain_table(self, state) -> table_ops.CountTable:
        """The folded CountTable behind either state shape."""
        if isinstance(state, BufferedTableState):
            return self._flushed(state).table
        return state

    def keyrange_merge(self, state, axis) -> table_ops.CountTable:
        """The ``merge_strategy='keyrange'`` hook: the staged batches
        folded in, then the key-range reduce of every rank's table
        (:func:`...parallel.collectives.key_range_merge`), the same plain
        table on every rank."""
        from mapreduce_tpu_torch.parallel import collectives

        return collectives.key_range_merge(self._plain_table(state), axis)

    def keyrange_result_merge(self, a, b) -> table_ops.CountTable:
        """Merge two keyrange results (plain tables)."""
        return table_ops.merge(a, b, capacity=self.capacity)

    def finalize(self, state) -> table_ops.CountTable:
        return self._plain_table(state)

    def identity(self) -> str:
        """What the state's numbers mean, for the checkpoint fingerprint
        (the JAX package's name for the same job)."""
        return "wordcount"


class TopKTable(NamedTuple):
    """A top-k finalized table and the KMV scalars taken before the reorder
    (``top_k`` reorders by count, which destroys the key-sorted KMV
    property the distinct estimate reads)."""

    table: table_ops.CountTable
    kmv_n_valid: torch.Tensor  # occupancy before the reorder
    kmv_kth_hi: torch.Tensor  # largest kept key, hi lane
    kmv_kth_lo: torch.Tensor  # largest kept key, lo lane

    def total_count(self) -> int:
        return self.table.total_count()


def topk_with_snapshot(tbl: table_ops.CountTable, k: int) -> TopKTable:
    """Snapshot the KMV scalars, then apply the terminal top-k reorder."""
    n_valid, kth_hi, kth_lo = table_ops.kmv_snapshot(tbl)
    return TopKTable(table_ops.top_k(tbl, k), n_valid, kth_hi, kth_lo)


class TopKWordCountJob(WordCountJob):
    """WordCount whose finalize keeps only the k most frequent words, with
    the KMV snapshot taken first (:class:`TopKTable`).  Its running state
    is a plain job's, but its identity names k, so its snapshot resumes
    only into a top-k run of the same k, and a plain one never into it."""

    def __init__(self, k: int, config: Config = DEFAULT_CONFIG, device=None):
        super().__init__(config, device)
        self.k = k

    def finalize(self, state) -> TopKTable:
        return topk_with_snapshot(self._plain_table(state), self.k)

    def identity(self) -> str:
        return f"wordcount-top{self.k}"


class NGramState(NamedTuple):
    """Streamed n-gram state: the running table and the seam carry (the
    last n-1 stream entries seen, an :class:`...ops.ngram.GramCarry`)."""

    table: table_ops.CountTable
    carry: Any


class NGramUpdate(NamedTuple):
    """One streamed step's update: the chunk's in-chunk gram table, the
    step's D chunk summaries gathered over the data axis (leaves with a
    leading axis of D, rank order) and this rank's index in it."""

    batch: table_ops.CountTable
    summaries: Any
    device_index: int


class NGramCountJob(WordCountJob):
    """Count n-token grams (bigrams, trigrams, ...) instead of words.

    The grams ride the word count's table, merge and string recovery; each
    reported "word" is the gram's exact source span, separators between
    its tokens included.  Streamed runs are exact across chunk seams: each
    chunk's map also emits its first and last n-1 stream entries
    (:class:`...ops.ngram.ChunkSummary`), and :meth:`combine` composes the
    carry in chunk order and forms every window crossing a join once.
    Cross-chunk entries carry ``SEAM_GRAM_LENGTH``; the host scans their
    spans forward from the start.

    Backends: the plain path pairs tokens over the per-byte stream and
    counts any token length; the kernel path pairs the kernel's dense
    stream row by row (:mod:`...ops.ngram`), where a gram holding a token
    longer than W invalidates itself at a poison row and lands in
    ``dropped_*``.  On overlong-free data the two give identical tables.
    ``combiner='hot-cache'`` is a no-op for grams (no cache can leave
    tokens out of a stream that grams are paired from).
    """

    def __init__(self, n: int, config: Config = DEFAULT_CONFIG,
                 device=None, top_k: int | None = None):
        if n < 1:
            raise ValueError(f"ngram order must be >= 1, got {n}")
        if n > 1 and config.merge_every > 1:
            raise ValueError("merge_every > 1 applies to the wordcount "
                             "family only (n-gram combine is pairwise)")
        super().__init__(config, device)
        self.n = n
        self.k = top_k

    def map_chunk(self, chunk: torch.Tensor, chunk_id) -> table_ops.CountTable:
        """The chunk's in-chunk gram table (the streamed seam machinery is
        :meth:`map_chunk_sharded` and :meth:`combine`)."""
        return _ngram_map(chunk, self.n, self.batch_capacity, chunk_id,
                          self.config, summary=False)[0]

    def init_state(self):
        if self.n == 1:
            return super().init_state()
        return NGramState(table=table_ops.empty(self.capacity, self.device),
                          carry=ngram_ops.empty_carry(self.n, self.device))

    def map_chunk_sharded(self, chunk: torch.Tensor, chunk_id, axis=None,
                          device_index: int = 0):
        """The streamed map: the chunk's table and its seam summary, with
        one small all_gather so every rank sees the step's D summaries
        (without an axis, a leading axis of 1).  A summary is 10 words of
        n-1 entries: noise next to the chunk."""
        from mapreduce_tpu_torch.parallel import collectives

        if self.n == 1:
            return self.map_chunk(chunk, chunk_id)
        t, summ = _ngram_map(chunk, self.n, self.batch_capacity, chunk_id,
                             self.config, summary=True)
        g = collectives.all_gather(
            torch.stack([x for c in summ for x in c]), axis)  # [D, 10, n-1]
        k = len(ngram_ops.GramCarry._fields)
        gathered = ChunkSummary(
            ngram_ops.GramCarry(*(g[:, i] for i in range(k))),
            ngram_ops.GramCarry(*(g[:, k + i] for i in range(k))))
        return NGramUpdate(batch=t, summaries=gathered,
                           device_index=device_index)

    def map_chunk_stats(self, chunk: torch.Tensor, chunk_id, axis=None,
                        device_index: int = 0):
        """The stats-mode map of the gram family: the gram build takes no
        spill or rescue branch, so the chunk's counters carry only the
        batch table's dropped accounting (poisoned grams); the gauges come
        off the running table as for the word count."""
        upd = self.map_chunk_sharded(chunk, chunk_id, axis, device_index)
        tbl = upd.batch if isinstance(upd, NGramUpdate) else upd
        return upd, datastats.map_stats(dropped_tokens=tbl.dropped_count,
                                        dropped_uniques=tbl.dropped_uniques)

    def _stats_table(self, state) -> table_ops.CountTable:
        return state.table if isinstance(state, NGramState) \
            else super()._stats_table(state)

    def combine(self, state, update):
        if self.n == 1:
            return super().combine(state, update)
        # Prefix carries in chunk order: prefix[i] is everything before the
        # step's chunk i; the last is the next step's carry.
        prefix = state.carry
        prefixes = [prefix]
        for i in range(update.summaries.first.kind.shape[0]):
            prefix = ngram_ops.compose_carry(
                prefix, ngram_ops.GramCarry(*(x[i] for x in
                                              update.summaries.last)))
            prefixes.append(prefix)
        d = update.device_index
        first = ngram_ops.GramCarry(*(x[d] for x in update.summaries.first))
        seam = ngram_ops.seam_gram_table(prefixes[d], first, self.n)
        batch = table_ops.merge(update.batch, seam,
                                capacity=update.batch.capacity)
        return NGramState(table=table_ops.merge(state.table, batch,
                                                capacity=self.capacity),
                          carry=prefixes[-1])

    def merge(self, a, b):
        if self.n == 1:
            return super().merge(a, b)
        # The carries agree after a combine; either operand's will do.
        return NGramState(table=table_ops.merge(a.table, b.table,
                                                capacity=self.capacity),
                          carry=a.carry)

    def keyrange_merge(self, state, axis) -> table_ops.CountTable:
        """The key-range reduce of the gram table (the carry is spent once
        every chunk's combine ran: only the table crosses ranks)."""
        from mapreduce_tpu_torch.parallel import collectives

        if self.n == 1:
            return super().keyrange_merge(state, axis)
        return collectives.key_range_merge(state.table, axis)

    def partial_reset(self, local):
        """An empty table that keeps the seam carry: the carry is the
        cross-step context the next combine still needs."""
        init = self.init_state()
        if self.n == 1 or not isinstance(local, NGramState):
            return init
        return NGramState(table=init.table, carry=local.carry)

    def on_input_boundary(self, state):
        """Files are independent corpora: grams never span a file seam, so
        the carry resets at each new corpus member."""
        if self.n == 1:
            return state
        return NGramState(table=state.table,
                          carry=ngram_ops.GramCarry(*(torch.zeros_like(x)
                                                      for x in state.carry)))

    def finalize(self, state):
        tbl = state.table if isinstance(state, NGramState) \
            else self._plain_table(state)
        return topk_with_snapshot(tbl, self.k) if self.k else tbl

    def identity(self) -> str:
        # A bigram snapshot has a trigram run's shapes: n is part of it.
        return f"ngram{self.n}" + (f"-top{self.k}" if self.k else "")


class SketchedState(NamedTuple):
    """The base job's state and HyperLogLog registers."""

    table: Any
    registers: torch.Tensor  # 2**p cells


class FreqSketchedState(NamedTuple):
    """The base job's state and a Count-Min sketch."""

    table: Any
    cms: torch.Tensor  # [depth, width]


class BatchedSketchState(NamedTuple):
    """A sketch state with staged updates (``sketch_flush_every`` K > 1).

    Each combine stages its batch table's keys into ``pend_*`` at slot
    ``cursor``; the K-th updates the sketch from all K and zeroes
    ``pend_cnt``, which doubles as the mask, so a flush of flushed slots
    changes nothing.  ``cursor`` counts the combines since the last flush.
    The JAX package keeps it on the device and flushes under a
    ``lax.cond``; it is a deterministic count, so the port keeps it on the
    host (an int), and the flush is a host ``if`` with no read of the
    card.  A checkpoint writes it as the JAX state's uint32 leaf."""

    table: Any
    sketch: torch.Tensor
    pend_hi: torch.Tensor  # [K * batch_capacity]
    pend_lo: torch.Tensor
    pend_cnt: torch.Tensor
    cursor: int


class _SketchComposedJob:
    """Compose a word-count-family job with a mergeable sketch.

    The sketch updates from the deduplicated per-chunk batch table, never
    from the token stream, and merges with its own monoid.  Envelope:
    tokens spilled past a chunk's batch table miss the sketch too
    (accounted in ``dropped_count``), as do an n-gram run's cross-chunk
    seam grams (fewer than n a join).  The JAX wrapper folds a deferred
    seam table into the batch first (``_folded``); the port's map emits
    one stream and no seam table, so there is nothing to fold.

    With ``config.sketch_flush_every`` K > 1 the updates stage through
    :class:`BatchedSketchState` (flushed at merges and in finalize, so the
    results equal K = 1's); ``finalize`` returns the plain ``state_cls``.
    The base job's streamed map, file-boundary hook, data statistics and
    ``state_stats`` are forwarded.  Subclasses set ``state_cls`` and the
    three sketch ops.
    """

    state_cls: type

    def __init__(self, base: WordCountJob):
        self.base = base
        self.config = base.config
        self.device = base.device
        self.flush_every = base.config.sketch_flush_every

    def _empty(self) -> torch.Tensor:
        raise NotImplementedError

    def _update_arrays(self, sk, key_hi, key_lo, counts) -> torch.Tensor:
        raise NotImplementedError

    def _merge(self, a, b) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self):
        if self.flush_every == 1:
            return self.state_cls(self.base.init_state(), self._empty())
        z = torch.zeros((self.flush_every * self.base.batch_capacity,),
                        dtype=torch.int64, device=self.device)
        return BatchedSketchState(self.base.init_state(), self._empty(), z,
                                  z.clone(), z.clone(), 0)

    def map_chunk(self, chunk, chunk_id):
        return self.base.map_chunk(chunk, chunk_id)

    def map_chunk_sharded(self, chunk, chunk_id, axis=None,
                          device_index: int = 0):
        """The base job's streamed map (the n-gram seam machinery)."""
        fn = getattr(self.base, "map_chunk_sharded", None)
        if fn is not None:
            return fn(chunk, chunk_id, axis, device_index)
        return self.base.map_chunk(chunk, chunk_id)

    def map_chunk_stats(self, chunk, chunk_id, axis=None,
                        device_index: int = 0):
        return self.base.map_chunk_stats(chunk, chunk_id, axis, device_index)

    def state_stats(self, state, stats):
        base_state = state.table if isinstance(state, BatchedSketchState) \
            else state[0]
        return self.base.state_stats(base_state, stats)

    def on_input_boundary(self, state):
        """The base job's file-boundary hook (the n-gram carry reset)."""
        hook = getattr(self.base, "on_input_boundary", None)
        if hook is None:
            return state
        return state._replace(table=hook(state.table))

    @staticmethod
    def _batch_of(update) -> table_ops.CountTable:
        """The batch table inside an update (an n-gram update bundles it
        with the seam summaries)."""
        return update if isinstance(update, table_ops.CountTable) \
            else update.batch

    def combine(self, state, update):
        batch = self._batch_of(update)
        if self.flush_every == 1:
            return self.state_cls(
                self.base.combine(state[0], update),
                self._update_arrays(state[1], batch.key_hi, batch.key_lo,
                                    batch.count))
        table = self.base.combine(state.table, update)
        b = batch.key_hi.shape[0]
        off = (state.cursor % self.flush_every) * b
        # Out of place: the input state may be a replay's anchor.
        pend = [torch.slice_scatter(p, x, 0, off, off + b) for p, x in
                ((state.pend_hi, batch.key_hi), (state.pend_lo, batch.key_lo),
                 (state.pend_cnt, batch.count))]
        cursor = state.cursor + 1
        sk = state.sketch
        if cursor >= self.flush_every:
            sk = self._update_arrays(sk, *pend)
            pend[2] = torch.zeros_like(pend[2])
            cursor = 0
        return BatchedSketchState(table, sk, *pend, cursor)

    def _flushed(self, st: BatchedSketchState) -> BatchedSketchState:
        """Fold the staged rows into the sketch (a masked no-op when none
        are staged)."""
        sk = self._update_arrays(st.sketch, st.pend_hi, st.pend_lo,
                                 st.pend_cnt)
        return BatchedSketchState(st.table, sk, st.pend_hi, st.pend_lo,
                                  torch.zeros_like(st.pend_cnt), 0)

    def merge(self, a, b):
        if self.flush_every == 1:
            return self.state_cls(self.base.merge(a[0], b[0]),
                                  self._merge(a[1], b[1]))
        fa, fb = self._flushed(a), self._flushed(b)
        return BatchedSketchState(self.base.merge(fa.table, fb.table),
                                  self._merge(fa.sketch, fb.sketch),
                                  fa.pend_hi, fa.pend_lo, fa.pend_cnt,
                                  fa.cursor)

    def keyrange_merge(self, state, axis):
        """The base job's key-range table reduce, with the sketch's own
        monoid tree-merged over the axis (small next to the table)."""
        from mapreduce_tpu_torch.parallel import collectives

        if isinstance(state, BatchedSketchState):
            st = self._flushed(state)
            table_state, sketch = st.table, st.sketch
        else:
            table_state, sketch = state[0], state[1]
        return self.state_cls(
            self.base.keyrange_merge(table_state, axis),
            collectives.tree_merge(sketch, self._merge, axis))

    def keyrange_result_merge(self, a, b):
        """Merge two keyrange results (``state_cls(table, sketch)``)."""
        return self.state_cls(self.base.keyrange_result_merge(a[0], b[0]),
                              self._merge(a[1], b[1]))

    def finalize(self, state):
        if isinstance(state, BatchedSketchState):
            state = self._flushed(state)
            return self.state_cls(self.base.finalize(state.table),
                                  state.sketch)
        return self.state_cls(self.base.finalize(state[0]), state[1])

    def identity(self) -> str:
        # K changes the state's shapes, not its results; the shapes are
        # checked against a snapshot's leaves.
        return f"{type(self).__name__.lower()}({self.base.identity()})"


class FreqSketchedWordCountJob(_SketchComposedJob):
    """A word-count-family job with a Count-Min frequency sketch: any
    word's (or n-gram span's) count stays queryable past the table's
    capacity (:func:`...ops.sketch.cms_query`), as an upper bound."""

    state_cls = FreqSketchedState

    def __init__(self, base: WordCountJob, depth: int = sketch_ops.CMS_DEPTH,
                 width_log2: int = sketch_ops.CMS_WIDTH_LOG2):
        super().__init__(base)
        self.depth = depth
        self.width_log2 = width_log2

    def _empty(self):
        return sketch_ops.cms_empty(self.depth, self.width_log2, self.device)

    def _update_arrays(self, sk, key_hi, key_lo, counts):
        return sketch_ops.cms_update(sk, key_hi, key_lo, counts)

    def _merge(self, a, b):
        return sketch_ops.cms_merge(a, b)


class SketchedWordCountJob(_SketchComposedJob):
    """A word-count-family job with a HyperLogLog: the distinct count
    stays accurate at any scale, where the table's turns into an estimate
    once keys spill.  Register updates are idempotent, so keys seen in
    several chunks are harmless."""

    state_cls = SketchedState

    def __init__(self, base: WordCountJob,
                 precision: int = sketch_ops.DEFAULT_PRECISION):
        super().__init__(base)
        self.precision = precision

    def _empty(self):
        return sketch_ops.empty(self.precision, self.device)

    def _update_arrays(self, sk, key_hi, key_lo, counts):
        return sketch_ops.update_from_keys(sk, key_hi, key_lo, counts > 0)

    def _merge(self, a, b):
        return sketch_ops.merge(a, b)


def job_with_config(job, config: Config):
    """A copy of ``job`` that runs ``config``: the degradation ladder's
    rebind.  The ladder moves only which kernels run (combiner, map, sort),
    never the state's shapes, so the copy carries the same state on.  A
    sketch wrapper's base job is rebound too, or it would go on running
    the old rung's kernels."""
    j = copy.copy(job)
    base = getattr(j, "base", None)
    if base is not None:
        j.base = job_with_config(base, config)
    j.config = config
    return j
