"""WordCount: the flagship model, on the card.

Counterpart of :mod:`mapreduce_tpu.models.wordcount` for the word-count main
path: tokenize + hash (the hand-written CUDA kernel, or the plain tokenizer
on the ``xla`` backend), a sort + segment reduce into a fixed-capacity
:class:`...ops.table.CountTable`, the overlong rescue, and host-side string
recovery from first-occurrence positions.

Control flow.  The JAX package wraps the spill fallback and the overlong
rescue in ``lax.cond``.  Eager PyTorch has no device-side cond, so each
becomes a host ``if``: :func:`_map_kernel` reads the chunk's ``spill`` and
``overlong`` scalars in ONE device-to-host copy (one sync per chunk) and
branches on them.

No seam table.  The JAX split map emits a column stream plus a seam stream
(the 128-lane seams of its TPU layout) and folds the seam table in a
separate or three-way merge (``SeamedUpdate``).  The port's kernel reads
its own halo, so it emits ONE stream and there is no seam table to defer:
the job's combine is the plain two-way merge.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch

from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.ops import rescue as rescue_ops
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
from mapreduce_tpu_torch.runtime.platform import resolve_device

#: Host-side branch counts of the kernel path: "chunks", "spill_fallbacks"
#: (compact spill -> pair rerun), "rescue_passes" (overlong > 0) and
#: "rescue_escalations" (overlong > rescue_slots: the R_max tier).
BRANCHES: Counter = Counter()


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


def _map_kernel(chunk: torch.Tensor, config: Config, capacity: int, pos_hi):
    """The kernel branch of the JAX ``_map_stream``: compact tokenize, the
    exact pair-mode rerun when a window spilled, the packed aggregation
    sort and the tiered overlong rescue."""
    w = config.pallas_max_token
    if config.resolved_compact_slots:
        stream, overlong, spill = kernel_tok.tokenize_split_compact(chunk, w)
    else:
        stream, overlong = kernel_tok.tokenize_split(chunk, w)
        spill = torch.zeros_like(overlong)
    # The one host sync of the chunk: both branch predicates in one copy.
    spill_h, over_h = torch.stack([spill, overlong]).tolist()
    BRANCHES["chunks"] += 1
    if spill_h:
        # Some window overflowed its slots, so the compact stream is
        # incomplete: rerun at full resolution, which cannot spill.  Both
        # modes see the same overlong runs, so over_h stands.
        BRANCHES["spill_fallbacks"] += 1
        stream, overlong = kernel_tok.tokenize_split(chunk, w)
    # Both modes emit in global byte order, so stable2 holds for either.
    built = table_ops.from_stream(
        stream, capacity, pos_hi=pos_hi, max_token_bytes=w,
        max_pos=int(chunk.shape[0]), sort_mode=config.sort_mode,
        rescue_slots=config.rescue_slots_max)
    if not config.rescue_slots:
        return _accounted(built, overlong)
    t, rescue_packed = built
    if not over_h:
        return t
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
                      overlong - ok)


def _map_stream(chunk: torch.Tensor, config: Config, capacity: int,
                pos_hi=0) -> table_ops.CountTable:
    """Tokenize one buffer with the configured backend and build its table
    (``pos_hi`` is the chunk id, so first occurrence is global)."""
    if config.resolved_backend() == "pallas":
        return _map_kernel(chunk, config, capacity, pos_hi)
    return table_ops.from_stream(tok_ops.tokenize(chunk), capacity,
                                 pos_hi=pos_hi)


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

    def combine(self, state, update) -> table_ops.CountTable:
        return table_ops.merge(state, update, capacity=self.capacity)

    def merge(self, a, b) -> table_ops.CountTable:
        return table_ops.merge(a, b, capacity=self.capacity)

    def finalize(self, state) -> table_ops.CountTable:
        return state
