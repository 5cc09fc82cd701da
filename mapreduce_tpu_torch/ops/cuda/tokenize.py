"""K1: the tokenize + hash kernels, hand-written in CUDA for Hopper.

Counterpart of :mod:`mapreduce_tpu.ops.pallas.tokenize` in its compact
lane-major mode (:func:`tokenize_split_compact`), its pair mode
(:func:`tokenize_split`, the exact spill fallback), its fused mode
(:func:`tokenize_fused`) and its hot-key combiner mode (``tokenize_fused``
with ``combiner_slots``).  The kernels are in
``mapreduce_tpu_torch/csrc/tokenize.cu``; its note says what bounds them.

What is kept from the TPU kernel is the stream contract, not the layout:
the same multiset of ``(key_hi, key_lo, packed = start << 6 | len)`` rows,
poison rows ``(sent, sent-1, last_byte << 6)`` at the ends of runs longer
than W included, the same ``overlong`` and token totals, and a stream in
global byte order.  The TPU kernel's 128-lane column view, its
sequential-grid carry, its XLA seam pass and its slots per window do not
exist here.

Compact, pair and fused mode are one kernel, ``tokenize_stream``, and one
DENSE stream: every live row in ascending position, then one dead row at
index ``live``, in planes of ``ceil(n / 2) + 1`` rows (two token ends are
never adjacent, so it cannot overflow, and ``spill`` is always 0).  Rows
past the dead row are never written.  The stream therefore carries its
device-side live count (:attr:`PackedTokenStream.live`) and the CALLER cuts
it with :meth:`PackedTokenStream.cut`, with the count it read in its own
host sync: the wrappers never read back.  The modes differ only in the
name their launches count under.

Limits from the packed row word stay: chunks of at most 2**26 bytes and
``1 <= W <= 63``.  The TPU layout's limits (``n % 128``, ``block_rows``,
even rows) are gone, except under the combiner: its cache belongs to one
of :data:`SEGMENTS` contiguous segments (the TPU kernel's lanes), so the
chunk length must be a multiple of 128 for its flushed planes to equal the
JAX package's.  The rows the combiner leaves form the same dense stream
(every kept row in ascending position, then one dead row, cut by the
caller); a window of :data:`WINDOW` bytes that keeps more than
:data:`COMBINER_SLOTS` rows (the JAX package's 128 per 512 bytes there)
counts the excess as ``spill``, so the caller's combiner-free rerun fires
on the chunks where the JAX package's does.  The combiner is one launch,
a block a window (:func:`tokenize_combiner_kernel`), held to the one-pass
plain version :func:`tokenize_combiner_plain`.  The flushed cache folds
into the chunk's table in two more launches (:func:`combiner_fold`), whose
plain version is the JAX package's merge of the table with the cache's own
table.

Dispatch: a CPU tensor goes to the plain PyTorch version of the same
function (:func:`tokenize_stream_plain`, :func:`tokenize_combiner_plain`);
a CUDA tensor launches the kernel or raises.  There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.ops.cuda import _build, plans
from mapreduce_tpu_torch.ops.table import _key64, _lexsort

TILE = 8192  # bytes per block of the dense stream; csrc/tokenize.cu kTile
WINDOW = 3072  # bytes per combiner block; csrc/tokenize.cu kWindow
COMBINER_SLOTS = 768  # kept rows a combiner window holds before it spills
SEGMENTS = 128  # combiner cache segments per chunk; csrc kSegments
DEFAULT_MAX_TOKEN = 32  # W
MAX_CHUNK = 1 << 26  # positions are packed into 26 bits

_SENT = tok_ops.SENT
_ALL_ONES = 0xFFFFFFFF

#: Kernel launches on the card, by wrapper ("tokenize_compact",
#: "tokenize_pair", "tokenize_fused", "tokenize_combiner",
#: "combiner_fold").  CPU calls run
#: the plain version and count nothing.
LAUNCHES: Counter = Counter()


class CombinerCache(NamedTuple):
    """Flushed hot-key cache of one chunk: four ``(C, 128)`` int64 planes
    holding uint32, the JAX package's ``CombinerCache``.  Column j is
    segment j; slot c holds the segment's (c+1)-th distinct key, ``count``
    its occurrences in the segment and ``packed`` its first occurrence
    (``start << 6 | len``, in-chunk positions).  An empty slot holds the
    sentinel keys, count 0 and all-ones ``packed``."""

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    count: torch.Tensor
    packed: torch.Tensor


class PackedTokenStream(NamedTuple):
    """The kernel's rows as one stream (int64 tensors holding uint32).

    ``packed`` is ``start << 6 | len`` for a token, ``last_byte << 6`` for
    a poison row and all-ones for a dead row; ``total`` is the exact token
    count.  The TokenStream view (``count``, ``pos``, ``length``) derives
    from ``packed`` on demand, so the aggregation path, which sorts
    ``packed`` directly, never materializes it.

    ``live`` is set on the dense stream (the compact, pair, fused and
    combiner kernels'): the int64 device count of its token and poison
    rows.  Its planes hold those rows, the dead row at index ``live`` and,
    from the kernel, unwritten rows after it: read its rows through
    :meth:`cut`.  It is None on a stream already cut.
    """

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    packed: torch.Tensor
    total: torch.Tensor
    live: torch.Tensor | None = None

    def cut(self, live: int | None = None) -> "PackedTokenStream":
        """The stream's first ``live + 1`` rows (views, no copy).  ``live``
        is the host value of :attr:`live` the caller has read in its own
        sync; without it, it is read here, which waits for the card."""
        if self.live is None:
            return self
        if live is None:
            live = int(self.live)
        elif self.live.device.type == "cpu" \
                and live != self.live.tolist():  # (no aten op: not traced)
            raise ValueError(f"the caller's live count {live} is not the "
                             f"stream's {self.live.tolist()}")
        return PackedTokenStream(self.key_hi[:live + 1],
                                 self.key_lo[:live + 1],
                                 self.packed[:live + 1], self.total)

    def _has_tok(self) -> torch.Tensor:
        return (self.packed != _ALL_ONES) & ((self.packed & 63) != 0)

    @property
    def count(self) -> torch.Tensor:
        return self._has_tok().to(torch.int64)

    @property
    def pos(self) -> torch.Tensor:
        return torch.where(self._has_tok(), self.packed >> 6, tok_ops.POS_INF)

    @property
    def length(self) -> torch.Tensor:
        return torch.where(self._has_tok(), self.packed & 63, 0)


def _resolve_args(data: torch.Tensor, max_token_bytes: int) -> int:
    """Check what the kernel takes; returns W."""
    if data.dtype != torch.uint8:
        raise TypeError(f"tokenize kernel expects uint8, got {data.dtype}")
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError("tokenize kernel expects a flat contiguous buffer, "
                         f"got shape {tuple(data.shape)}")
    n = data.shape[0]
    if not 1 <= n <= MAX_CHUNK:
        raise ValueError(
            f"input of {n} bytes is outside the kernel's [1, 2**26] chunk "
            "envelope (positions are packed into 26 bits of the sort "
            "payload); lower chunk_bytes or use the xla backend")
    w = max_token_bytes
    if not 1 <= w <= 63:
        raise ValueError(f"max_token_bytes must be in [1, 63] (length is "
                         f"packed into 6 bits), got {w}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return w


def _token_ends(data: torch.Tensor, w: int):
    """Every live row of the chunk, in ascending position: a vectorised
    k = 0..W lookback at each token end.  Returns ``(p, key_hi, key_lo,
    packed, over)``, ``over`` marking the poison rows."""
    n = data.shape[0]
    dev = data.device
    # W+1 separator bytes before the chunk and one after: the lookback and
    # the next-byte test never leave the buffer.
    buf = torch.zeros(w + 2 + n, dtype=torch.uint8, device=dev)
    buf[w + 1: w + 1 + n] = data
    sep = tok_ops.separator_mask(buf)
    live = ~sep[w + 1: w + 1 + n] & sep[w + 2: w + 2 + n]
    p = torch.nonzero(live).squeeze(1)  # ascending positions
    q = p + (w + 1)
    c = buf.to(torch.int64) + 1
    intok = torch.ones_like(p, dtype=torch.bool)
    h1 = torch.zeros_like(p)
    h2 = torch.zeros_like(p)
    ln = torch.zeros_like(p)
    b1, b2 = int(constants.HASH_BASE_1), int(constants.HASH_BASE_2)
    for k in range(w):
        if k:
            intok &= ~sep[q - k]
        ck = c[q - k]
        h1 = h1 + torch.where(intok, tok_ops.mul32(ck, pow(b1, k, 1 << 32)), 0)
        h2 = h2 + torch.where(intok, tok_ops.mul32(ck, pow(b2, k, 1 << 32)), 0)
        ln += intok
    over = intok & ~sep[q - w]
    key_hi, key_lo = tok_ops.finalize_keys(h1 & tok_ops.MASK32,
                                           h2 & tok_ops.MASK32, ln)
    key_hi = torch.where(over, _SENT, key_hi)
    key_lo = torch.where(over, _SENT - 1, key_lo)
    packed = torch.where(over, p << 6, ((p + 1 - ln) << 6) | ln)
    return p, key_hi, key_lo, packed, over


def tokenize_stream_plain(data: torch.Tensor, w: int):
    """Plain PyTorch version of ``tokenize_stream``: :func:`_token_ends`
    and the one dead row after them.

    Returns ``(stream, overlong, spill)``: a :class:`PackedTokenStream` of
    exactly ``live + 1`` rows with its ``live`` count, and two int64
    scalars (``spill`` is 0)."""
    p, key_hi, key_lo, packed, over = _token_ends(data, w)
    n_over = over.sum()
    planes = (torch.cat([x, x.new_full((1,), fill)]) for x, fill in (
        (key_hi, _SENT), (key_lo, _SENT), (packed, _ALL_ONES)))
    live = torch.tensor(p.shape[0], dtype=torch.int64, device=data.device)
    return (PackedTokenStream(*planes, live - n_over, live), n_over,
            torch.zeros_like(n_over))


def _first_distinct(group, key, order, n_groups: int):
    """Rows ``(group, key)`` with a unique ``order`` each: every row's
    (group, key) class, each class's first row (smallest ``order``) and each
    class's rank among its group's classes by that first ``order``."""
    srt = _lexsort(group, key, order)
    g, k = group[srt], key[srt]
    head = torch.ones_like(srt, dtype=torch.bool)
    head[1:] = (k[1:] != k[:-1]) | (g[1:] != g[:-1])
    cls = torch.empty_like(srt)
    cls[srt] = torch.cumsum(head, 0) - 1
    first = srt[head]
    by_first = torch.argsort(order[first])
    g_first = group[first][by_first]
    per = torch.bincount(g_first, minlength=n_groups)
    start = torch.cumsum(per, 0) - per
    rank = torch.empty_like(by_first)
    rank[by_first] = torch.arange(by_first.shape[0], device=srt.device) \
        - start[g_first]
    return cls, first, rank


def _slot_planes(at, planes_fills, rows: int):
    """Planes of ``rows`` rows, each its fill, with ``vals`` at ``at``."""
    out = []
    for vals, fill in planes_fills:
        plane = torch.full((rows,), fill, dtype=torch.int64, device=at.device)
        plane[at] = vals
        out.append(plane)
    return out


def _combiner_geometry(n: int) -> tuple[int, int]:
    """(segment length, windows per segment) of an n-byte chunk."""
    seg_len = n // SEGMENTS
    return seg_len, -(-seg_len // WINDOW)


def _leftover_stream(p, key_hi, key_lo, packed, over, left, seg_len: int,
                     wps: int, slots: int):
    """The rows in ``left`` as one dense stream (ascending position, then
    one dead row) with its token count and live count, and the spill:
    each window's kept rows past ``slots``."""
    pl = p[left]
    win = (pl // seg_len) * wps + (pl % seg_len) // WINDOW
    spill = (torch.bincount(win, minlength=SEGMENTS * wps) - slots) \
        .clamp(min=0).sum()
    planes = (torch.cat([x[left], x.new_full((1,), fill)]) for x, fill in (
        (key_hi, _SENT), (key_lo, _SENT), (packed, _ALL_ONES)))
    return PackedTokenStream(*planes, (left & ~over).sum(), left.sum()), \
        spill


def tokenize_combiner_plain(data: torch.Tensor, w: int, slots: int,
                            cslots: int):
    """Plain PyTorch version of the combiner, in one pass and vectorised.

    :func:`_token_ends`; a stable sort of the emissions by (segment, key)
    gives each key's first position and count in each segment; ranking
    those by first position keeps each segment's first ``cslots`` distinct
    keys; their rows leave the stream and the rest form the dense stream.
    Returns ``(stream, overlong, spill, cache)``: a
    :class:`PackedTokenStream` of exactly ``live + 1`` rows whose ``total``
    counts the emissions left, and two int64 scalars.
    """
    seg_len, wps = _combiner_geometry(data.shape[0])
    p, key_hi, key_lo, packed, over = _token_ends(data, w)
    seg = p // seg_len
    emit = torch.nonzero(~over).squeeze(1)
    cls, first, rank = _first_distinct(
        seg[emit], _key64(key_hi[emit], key_lo[emit]), p[emit], SEGMENTS)
    heads = emit[first]  # each (segment, key)'s first row
    hits = torch.bincount(cls, minlength=first.shape[0])
    cached = rank < cslots
    cache = _slot_planes((rank * SEGMENTS + seg[heads])[cached], (
        (key_hi[heads][cached], _SENT), (key_lo[heads][cached], _SENT),
        (hits[cached], 0), (packed[heads][cached], _ALL_ONES)),
        cslots * SEGMENTS)
    gone = torch.zeros_like(p, dtype=torch.bool)
    gone[emit] = cached[cls]
    stream, spill = _leftover_stream(p, key_hi, key_lo, packed, over, ~gone,
                                     seg_len, wps, slots)
    return (stream, over.sum(), spill,
            CombinerCache(*(c.reshape(cslots, SEGMENTS) for c in cache)))


_P = ctypes.c_void_p
_ARGTYPES = {
    "mr_tokenize_stream": [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                           _P, ctypes.c_longlong, _P],
    "mr_combiner_work_words": [ctypes.c_longlong],
    "mr_combiner_stream": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                           ctypes.c_longlong, _P],
    "mr_combiner_fold_words": [ctypes.c_int],
    "mr_combiner_fold": [_P, _P, _P, _P, ctypes.c_int, _P, _P,
                         ctypes.c_longlong, _P, ctypes.c_longlong, _P,
                         ctypes.c_longlong, _P, _P, _P],
}


def _kernel_fn(name: str):
    """A kernel's C entry point, built and bound on first use."""
    lib = _build.load("tokenize")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        if (lib.mr_tokenize_window_bytes(), lib.mr_tokenize_tile_bytes()) \
                != (WINDOW, TILE):
            raise RuntimeError("csrc/tokenize.cu and ops/cuda/tokenize.py "
                               "disagree on WINDOW or TILE")
        fn.restype = ctypes.c_longlong if name.endswith("_words") \
            else ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _check_cuda(data: torch.Tensor) -> None:
    if data.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{data.device}")


def _planes(rows: int, dev, k: int = 3):
    return [torch.empty(rows, dtype=torch.int64, device=dev) for _ in range(k)]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def tokenize_stream_kernel(data: torch.Tensor, w: int):
    """Launch ``tokenize_stream`` on ``data``'s device and current stream.

    Returns what :func:`tokenize_stream_plain` returns, except that the
    stream's planes have ``ceil(n / 2) + 1`` rows, of which only the first
    ``live + 1`` are written (:meth:`PackedTokenStream.cut`).  Does not
    synchronise."""
    _check_cuda(data)
    n = data.shape[0]
    dev = data.device
    tiles = -(-(n + data.data_ptr() % 16) // TILE)  # tiles sit on 16 B
    # Counters (overlong, tokens, spill, live), then the uint32 ticket and
    # look-back status words, zeroed by the launcher.
    work = torch.empty(4 + (tiles + 2) // 2, dtype=torch.int64, device=dev)
    khi, klo, packed = _planes(-(-n // 2) + 1, dev)
    _launched(_kernel_fn("mr_tokenize_stream")(
        data.data_ptr(), n, w, khi.data_ptr(), klo.data_ptr(),
        packed.data_ptr(), work.data_ptr(), work.shape[0], _stream(data)),
        "tokenize_stream")
    return (PackedTokenStream(khi, klo, packed, work[1], work[3]), work[0],
            work[2])


def tokenize_combiner_kernel(data: torch.Tensor, w: int, slots: int,
                             cslots: int):
    """Launch ``combiner_stream`` on ``data``'s device and current stream:
    what :func:`tokenize_combiner_plain` returns, except that the stream's
    planes have ``ceil(n / 2) + 1`` rows, of which only the first ``live +
    1`` are written (:meth:`PackedTokenStream.cut`).  Does not
    synchronise."""
    _check_cuda(data)
    n = data.shape[0]
    dev = data.device
    cache = _planes(cslots * SEGMENTS, dev, 4)
    khi, klo, packed = _planes(-(-n // 2) + 1, dev)
    # Counters (overlong, tokens, spill, live), then the uint32 ticket,
    # look-back status, head-list words and full flags, zeroed by the
    # launcher (as is the count plane).
    work = torch.empty(_kernel_fn("mr_combiner_work_words")(n),
                       dtype=torch.int64, device=dev)
    _launched(_kernel_fn("mr_combiner_stream")(
        data.data_ptr(), n, w, slots, cslots, *(c.data_ptr() for c in cache),
        khi.data_ptr(), klo.data_ptr(), packed.data_ptr(), work.data_ptr(),
        work.shape[0], _stream(data)), "combiner_stream")
    return (PackedTokenStream(khi, klo, packed, work[1], work[3]), work[0],
            work[2],
            CombinerCache(*(c.reshape(cslots, SEGMENTS) for c in cache)))


def cache_table(cache: CombinerCache, pos_hi) -> table_ops.CountTable:
    """One chunk's flushed hot-key cache as an exact small table: one row
    per resident entry, with its count and first in-segment occurrence.  A
    key resident in several segments coalesces in the generic build
    (counts add, the smallest position wins), so merging this table with
    the thinned stream's gives the uncombined build.  Capacity is the
    plane size, so the build cannot spill."""
    khi, klo, cnt, packed = (x.reshape(-1) for x in cache)
    live = cnt > 0
    stream = tok_ops.TokenStream(
        key_hi=torch.where(live, khi, _SENT),
        key_lo=torch.where(live, klo, _SENT),
        count=torch.where(live, cnt, 0),
        pos=torch.where(live, packed >> 6, tok_ops.POS_INF),
        length=torch.where(live, packed & 63, 0))
    return table_ops.from_stream(stream, khi.shape[0], pos_hi=pos_hi)


def combiner_fold_plain(t: table_ops.CountTable, cache: CombinerCache,
                        pos_hi) -> table_ops.CountTable:
    """Plain version of the fold: the JAX package's merge of the chunk's
    table with :func:`cache_table`, at the table's capacity."""
    return table_ops.merge(t, cache_table(cache, pos_hi),
                           capacity=t.capacity)


def combiner_fold_kernel(t: table_ops.CountTable, cache: CombinerCache,
                         pos_hi) -> table_ops.CountTable:
    """``combiner_fold_keys`` and ``combiner_fold_merge`` on the card: what
    :func:`combiner_fold_plain` returns.  ``t`` is a built table (its live
    rows first, ascending by key, then holes); ``pos_hi`` the chunk id, a
    host int or a device scalar.  Does not synchronise."""
    _check_cuda(t.key_hi)
    dev = t.key_hi.device
    cap = t.capacity
    planes = [c.reshape(-1).contiguous() for c in cache]
    entries = planes[0].shape[0]
    fold = torch.empty(_kernel_fn("mr_combiner_fold_words")(entries),
                       dtype=torch.int64, device=dev)
    t_in = [x.contiguous() for x in t[:7]]
    t_drop = torch.stack(list(t[7:])).contiguous()
    out = _planes(cap, dev, 7)
    out_drop = torch.empty(4, dtype=torch.int64, device=dev)
    chunk = pos_hi.reshape(()).to(device=dev, dtype=torch.int64) \
        if isinstance(pos_hi, torch.Tensor) else None
    ptrs = ctypes.c_void_p * 7
    _launched(_kernel_fn("mr_combiner_fold")(
        *(c.data_ptr() for c in planes), entries,
        ptrs(*(x.data_ptr() for x in t_in)), t_drop.data_ptr(), cap,
        None if chunk is None else chunk.data_ptr(),
        0 if chunk is not None else int(pos_hi), fold.data_ptr(),
        fold.shape[0], ptrs(*(x.data_ptr() for x in out)),
        out_drop.data_ptr(), _stream(t.key_hi)), "combiner_fold")
    return table_ops.CountTable(*out, *out_drop.unbind())


def combiner_fold(t: table_ops.CountTable, cache: CombinerCache,
                  pos_hi) -> table_ops.CountTable:
    """Fold a chunk's flushed cache into the table built from its thinned
    stream: the uncombined chunk's table (every key's count, its first
    occurrence, the dropped totals), as the JAX package's merge gives it.
    A CPU tensor runs :func:`combiner_fold_plain`; a CUDA tensor launches
    the two fold kernels.  Launches count under ``"combiner_fold"``."""
    entries = cache.key_hi.numel()
    with tracepoints.kernel_scope(
            "combiner_fold",
            lambda: plans.combiner_fold(entries, t.capacity),
            t, cache, pos_hi) as k:
        if t.key_hi.device.type == "cpu":
            out = combiner_fold_plain(t, cache, pos_hi)
        else:
            out = combiner_fold_kernel(t, cache, pos_hi)
            LAUNCHES["combiner_fold"] += 1
        return k.result(out)


def _as_allocated(stream: PackedTokenStream, n: int) -> PackedTokenStream:
    """The plain version's stream in the kernel's planes: ``ceil(n / 2) +
    1`` rows, the rows after the dead row dead too (the kernel leaves them
    unwritten; every reader cuts them off).  Used while a recorder traces
    the CPU, so the traced program's shapes are the card's."""
    rows = -(-n // 2) + 1
    planes = (torch.cat([p, p.new_full((rows - p.shape[0],), fill)])
              for p, fill in zip(stream[:3], (_SENT, _SENT, _ALL_ONES)))
    return PackedTokenStream(*planes, stream.total, stream.live)


def _tokenize_stream(data: torch.Tensor, w: int, mode: str):
    n = data.shape[0]
    with tracepoints.kernel_scope(
            mode, lambda: plans.tokenize_stream(n, w, mode), data) as k:
        if data.device.type == "cpu":
            out = tokenize_stream_plain(data, w)
            if k.recording:
                out = (_as_allocated(out[0], n), *out[1:])
        else:
            out = tokenize_stream_kernel(data, w)
            LAUNCHES[mode] += 1
        return k.result(out)


def tokenize_split_compact(data: torch.Tensor,
                           max_token_bytes: int = DEFAULT_MAX_TOKEN):
    """Compact mode: ``(stream, overlong, spill)``, the dense stream.

    ``spill`` is always 0 (kept for the callers of the TPU kernel's API,
    whose compact windows could overflow); cut ``stream`` to its live rows
    before reading them.
    """
    w = _resolve_args(data, max_token_bytes)
    return _tokenize_stream(data, w, "tokenize_compact")


def tokenize_split(data: torch.Tensor,
                   max_token_bytes: int = DEFAULT_MAX_TOKEN):
    """Pair mode: ``(stream, overlong)``, the same dense stream.

    Every token of at most ``max_token_bytes`` bytes is emitted once; longer
    runs are tallied in ``overlong`` and leave a poison row at their end.
    It is the combiner's exact fallback, launched under its own name.
    """
    w = _resolve_args(data, max_token_bytes)
    stream, over, _ = _tokenize_stream(data, w, "tokenize_pair")
    return stream, over


def tokenize_fused(data: torch.Tensor, *, compact: bool = True,
                   max_token_bytes: int = DEFAULT_MAX_TOKEN,
                   combiner_slots: int = 0):
    """The fused map path: ``(stream, overlong, spill)``, plus the flushed
    :class:`CombinerCache` when ``combiner_slots`` > 0.

    Without a combiner this is the dense stream of compact mode (``compact``
    makes no difference to it): the port's halo kernel already resolves
    every seam, so its one stream is the TPU fused mode's.  Launches count
    under ``"tokenize_fused"``.

    ``combiner_slots`` = C (needs ``compact``; a multiple of 8 in [8, 32];
    ``len(data) % 128 == 0``) runs the hot-key combiner: each of the
    chunk's 128 segments counts every occurrence of its first C distinct
    keys in the cache instead of the stream, so ``stream.total`` counts only
    the rows left in the stream.  The cache's ``packed`` records in-chunk
    positions (the caller applies the chunk id as ``pos_hi``).  The rows
    left are the dense stream (cut it, as the compact one); a nonzero
    ``spill`` (a :data:`WINDOW`-byte window kept more than
    :data:`COMBINER_SLOTS` rows) means the chunk takes the JAX package's
    exact fallback: discard the stream AND the cache, and rerun with
    :func:`tokenize_split` (combiner-free).
    """
    w = _resolve_args(data, max_token_bytes)
    if not combiner_slots:
        return _tokenize_stream(data, w, "tokenize_fused")
    if not compact:
        raise ValueError("combiner_slots requires the compact path (the pair "
                         "fallback is the combiner-free exactness escape)")
    if combiner_slots % 8 or not 8 <= combiner_slots <= 32:
        raise ValueError(f"combiner_slots must be a multiple of 8 in [8, 32], "
                         f"got {combiner_slots}")
    if data.shape[0] % SEGMENTS:
        raise ValueError(f"the combiner needs a chunk of a multiple of "
                         f"{SEGMENTS} bytes (its cache is per segment), got "
                         f"{data.shape[0]}")
    n = data.shape[0]
    with tracepoints.kernel_scope(
            "tokenize_combiner",
            lambda: plans.combiner(n, w, combiner_slots), data) as k:
        if data.device.type == "cpu":
            out = tokenize_combiner_plain(data, w, COMBINER_SLOTS,
                                          combiner_slots)
            if k.recording:
                out = (_as_allocated(out[0], n), *out[1:])
        else:
            out = tokenize_combiner_kernel(data, w, COMBINER_SLOTS,
                                           combiner_slots)
            LAUNCHES["tokenize_combiner"] += 1
        return k.result(out)
