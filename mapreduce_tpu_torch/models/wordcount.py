"""WordCount: the flagship model, on the card.

Counterpart of :mod:`mapreduce_tpu.models.wordcount` for the word-count main
path: tokenize + hash (the hand-written CUDA kernels, or the plain tokenizer
on the ``xla`` backend; under ``combiner='hot-cache'`` the kernel's flushed
hot-key cache folds back in as one small table merge), a sort (torch's, or
the CUDA radix partition under ``sort_impl``) + segment reduce into a
fixed-capacity :class:`...ops.table.CountTable`, the overlong rescue, and
host-side string recovery from first-occurrence positions.

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
from mapreduce_tpu_torch.obs.spans import span
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops import rescue as rescue_ops
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
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
    # A streamed run's ``RunResult`` (metrics, bases, window statistics;
    # ``runtime/executor.py:count_file``), None otherwise.  Not compared.
    run: Any = dataclasses.field(default=None, compare=False, repr=False)

    def as_dict(self) -> dict[bytes, int]:
        return dict(zip(self.words, self.counts))


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
    flags = torch.stack(flags)
    read = _HOST_READ.get()
    with span("host_read"):  # waits for the card (the streamed loop's too)
        spill_h, over_h, tokens_h, *cached = \
            flags.tolist() if read is None else read(flags)
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
        radix_bits=config.radix_bits)
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
                   estimate_distinct: bool = True) -> WordCountResult:
    """Host-side string recovery from a single-buffer table (pos_hi 0)."""
    count = _host(tbl.count)
    count_hi = _host(tbl.count_hi)
    valid = (count > 0) | (count_hi > 0)
    pos = _host(tbl.pos_lo)[valid]
    length = _host(tbl.length)[valid]
    cnt = (count + (count_hi << 32))[valid]
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


class WordCountJob:
    """WordCount as a one-device MapReduce job (``merge_every == 1``): a
    running CountTable, the chunk's table folded in by :func:`merge`.
    ``chunk_id`` becomes ``pos_hi``, so first occurrence is file order."""

    def __init__(self, config: Config = DEFAULT_CONFIG, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.capacity = config.table_capacity
        self.batch_capacity = config.batch_uniques

    def init_state(self) -> table_ops.CountTable:
        return table_ops.empty(self.capacity, self.device)

    def map_chunk(self, chunk: torch.Tensor, chunk_id) -> table_ops.CountTable:
        return _map_stream(chunk, self.config, self.batch_capacity,
                           pos_hi=chunk_id)

    def map_chunk_stats(self, chunk: torch.Tensor, chunk_id):
        """The stats-mode map: the same table and the chunk's
        :class:`...ops.datastats.DataStats` (the engine calls this in
        place of :meth:`map_chunk` only for a telemetered run)."""
        return _map_stream(chunk, self.config, self.batch_capacity,
                           pos_hi=chunk_id, with_stats=True)

    def state_stats(self, state, stats):
        """Fill the running table's gauges after a group's last combine."""
        return datastats.with_table_gauges(stats, state)

    def combine(self, state, update) -> table_ops.CountTable:
        return table_ops.merge(state, update, capacity=self.capacity)

    def merge(self, a, b) -> table_ops.CountTable:
        return table_ops.merge(a, b, capacity=self.capacity)

    def finalize(self, state) -> table_ops.CountTable:
        return state

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
        return topk_with_snapshot(state, self.k)

    def identity(self) -> str:
        return f"wordcount-top{self.k}"


def job_with_config(job: WordCountJob, config: Config) -> WordCountJob:
    """A copy of ``job`` that runs ``config``: the degradation ladder's
    rebind.  The ladder moves only which kernels run (combiner, map, sort),
    never the state's shapes, so the copy carries the same state on."""
    j = copy.copy(job)
    j.config = config
    return j
