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
JAX package's.  Under the combiner a window of :data:`WINDOW` bytes holds
:data:`COMBINER_SLOTS` rows (the JAX package's 128 per 512 bytes there),
dead filler after its live rows, and a window that overflows spills.
The combiner runs in three launches whose grids scale with the windows
(heads, merge, thin: :func:`tokenize_combiner_kernel`), each with its own
plain version; :func:`tokenize_combiner_plain` is the one-pass definition
they are held to.

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
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.ops.cuda import _build, plans
from mapreduce_tpu_torch.ops.table import _key64, _lexsort

TILE = 8192  # bytes per block of the dense stream; csrc/tokenize.cu kTile
WINDOW = 3072  # bytes per combiner block; csrc/tokenize.cu kWindow
COMBINER_SLOTS = 768  # rows per window under the hot-key combiner
SEGMENTS = 128  # combiner cache segments per chunk; csrc kSegments
DEFAULT_MAX_TOKEN = 32  # W
MAX_CHUNK = 1 << 26  # positions are packed into 26 bits

_SENT = tok_ops.SENT
_ALL_ONES = 0xFFFFFFFF

#: Kernel launches on the card, by wrapper ("tokenize_compact",
#: "tokenize_pair", "tokenize_fused", "tokenize_combiner").  CPU calls run
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

    ``live`` is set on the dense stream: the int64 device count of its
    token and poison rows.  Its planes hold those rows, the dead row at
    index ``live`` and, from the kernel, unwritten rows after it: read its
    rows through :meth:`cut`.  It is None on a stream whose planes are
    whole (the combiner's windows, or a stream already cut).
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


def _compact(win: torch.Tensor, windows: int, slots: int, rows):
    """Rows (ascending in ``win``, the window of each) into ``slots`` rows
    per window, dead filler after them.  Returns the three planes and the
    spill (rows beyond a window's budget)."""
    per_win = torch.bincount(win, minlength=windows)
    first = torch.cumsum(per_win, 0) - per_win
    rank = torch.arange(win.shape[0], device=win.device) - first[win]
    keep = rank < slots
    slot = (win * slots + rank)[keep]
    out = []
    for vals, fill in zip(rows, (_SENT, _SENT, _ALL_ONES)):
        plane = torch.full((windows * slots,), fill, dtype=torch.int64,
                           device=win.device)
        plane[slot] = vals[keep]
        out.append(plane)
    return (*out, (per_win - slots).clamp(min=0).sum())


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


def _leftover_stream(p, key_hi, key_lo, packed, left, seg_len: int,
                     wps: int, slots: int):
    """The rows in ``left`` compacted ``[segment][window][slot]``."""
    pl = p[left]
    win = (pl // seg_len) * wps + (pl % seg_len) // WINDOW
    return _compact(win, SEGMENTS * wps, slots,
                    (key_hi[left], key_lo[left], packed[left]))


def tokenize_combiner_plain(data: torch.Tensor, w: int, slots: int,
                            cslots: int):
    """Plain PyTorch version of the combiner, in one pass and vectorised.

    :func:`_token_ends`; a stable sort of the emissions by (segment, key)
    gives each key's first position and count in each segment; ranking
    those by first position keeps each segment's first ``cslots`` distinct
    keys; their rows leave the stream and the rest are compacted
    ``[segment][window][slot]``.  Returns ``(key_hi, key_lo, packed,
    overlong, ntok, spill, cache)`` in the kernels' layout.
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
    left = ~gone
    khi, klo, pck, spill = _leftover_stream(p, key_hi, key_lo, packed, left,
                                            seg_len, wps, slots)
    return (khi, klo, pck, over.sum(), (left & ~over).sum(), spill,
            CombinerCache(*(c.reshape(cslots, SEGMENTS) for c in cache)))


def combiner_heads_plain(data: torch.Tensor, w: int, cslots: int):
    """Plain version of ``combiner_heads``: each window's first ``cslots``
    distinct emission keys in position order, with their first ``packed``.
    Returns three int64 planes of ``windows * cslots`` rows (window-major,
    empty slots ``(sent, sent, all-ones)``) and each window's int32 count."""
    seg_len, wps = _combiner_geometry(data.shape[0])
    p, key_hi, key_lo, packed, over = _token_ends(data, w)
    win = (p // seg_len) * wps + (p % seg_len) // WINDOW
    emit = torch.nonzero(~over).squeeze(1)
    _, first, rank = _first_distinct(
        win[emit], _key64(key_hi[emit], key_lo[emit]), p[emit],
        SEGMENTS * wps)
    heads = emit[first][rank < cslots]
    at = win[heads] * cslots + rank[rank < cslots]
    planes = _slot_planes(at, ((key_hi[heads], _SENT), (key_lo[heads], _SENT),
                               (packed[heads], _ALL_ONES)),
                          SEGMENTS * wps * cslots)
    count = torch.bincount(win[heads], minlength=SEGMENTS * wps)
    return (*planes, count.to(torch.int32))


def combiner_merge_plain(heads, cslots: int) -> CombinerCache:
    """Plain version of ``combiner_merge``: each segment's first ``cslots``
    distinct keys over its windows' head lists in window order; counts 0."""
    h_hi, h_lo, h_pk, h_n = heads
    wps = h_n.shape[0] // SEGMENTS
    idx = torch.arange(h_hi.shape[0], device=h_hi.device)
    rows = idx[(idx % cslots) < h_n.to(torch.int64)[idx // cslots]]
    seg = rows // (wps * cslots)
    _, first, rank = _first_distinct(seg, _key64(h_hi[rows], h_lo[rows]),
                                     rows, SEGMENTS)
    keep = rank < cslots
    hr = rows[first][keep]
    at = rank[keep] * SEGMENTS + seg[first][keep]
    planes = _slot_planes(at, ((h_hi[hr], _SENT), (h_lo[hr], _SENT),
                               (torch.zeros_like(hr), 0),
                               (h_pk[hr], _ALL_ONES)), cslots * SEGMENTS)
    return CombinerCache(*(c.reshape(cslots, SEGMENTS) for c in planes))


def combiner_thin_plain(data: torch.Tensor, w: int, slots: int,
                        cache: CombinerCache):
    """Plain version of ``combiner_thin``: every emission whose key is in
    its segment's cache leaves the stream and counts in that slot.  Returns
    ``(key_hi, key_lo, packed, overlong, ntok, spill, counts)``, ``counts``
    the (C, 128) hits."""
    seg_len, wps = _combiner_geometry(data.shape[0])
    p, key_hi, key_lo, packed, over = _token_ends(data, w)
    seg = p // seg_len
    cached = _key64(cache.key_hi, cache.key_lo)[:, seg].T \
        == _key64(key_hi, key_lo)[:, None]
    cached &= ~over[:, None]  # empty slots hold (sent, sent): no emission
    hit = cached.any(1)
    slot = cached.to(torch.int8).argmax(1)
    cslots = cache.key_hi.shape[0]
    counts = torch.bincount((slot * SEGMENTS + seg)[hit],
                            minlength=cslots * SEGMENTS)
    left = ~hit
    khi, klo, pck, spill = _leftover_stream(p, key_hi, key_lo, packed, left,
                                            seg_len, wps, slots)
    return (khi, klo, pck, over.sum(), (left & ~over).sum(), spill,
            counts.reshape(cslots, SEGMENTS))


def tokenize_combiner_phases_plain(data: torch.Tensor, w: int, slots: int,
                                   cslots: int):
    """The three plain phases in a row, the kernels' way: what
    :func:`tokenize_combiner_plain` returns."""
    cache = combiner_merge_plain(combiner_heads_plain(data, w, cslots),
                                 cslots)
    *out, counts = combiner_thin_plain(data, w, slots, cache)
    return (*out, cache._replace(count=counts))


_P = ctypes.c_void_p
_ARGTYPES = {
    "mr_tokenize_stream": [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                           _P, ctypes.c_longlong, _P],
    "mr_combiner_heads": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          _P, _P, _P, _P, _P, _P, _P],
    "mr_combiner_window_rows": [],
    "mr_combiner_merge": [ctypes.c_longlong, ctypes.c_int, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P],
    "mr_combiner_thin": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P],
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
        fn.restype = ctypes.c_int
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
    # look-back status words, zeroed in one fill.
    work = torch.zeros(4 + (tiles + 2) // 2, dtype=torch.int64, device=dev)
    khi, klo, packed = _planes(-(-n // 2) + 1, dev)
    _launched(_kernel_fn("mr_tokenize_stream")(
        data.data_ptr(), n, w, khi.data_ptr(), klo.data_ptr(),
        packed.data_ptr(), work.data_ptr(), work.shape[0], _stream(data)),
        "tokenize_stream")
    return (PackedTokenStream(khi, klo, packed, work[1], work[3]), work[0],
            work[2])


class RowScratch(NamedTuple):
    """Each combiner window's hashed rows, kept by phase 1 for phase 3:
    uint32 ``[window][key_hi, key_lo, packed][rank]`` (in an int32 tensor)
    and each window's row count."""

    rows: torch.Tensor
    count: torch.Tensor


def combiner_heads_kernel(data: torch.Tensor, w: int, cslots: int):
    """Phase 1 of the combiner on the card: what
    :func:`combiner_heads_plain` returns, and the :class:`RowScratch` for
    phase 3.  Does not synchronise."""
    _check_cuda(data)
    n = data.shape[0]
    dev = data.device
    windows = SEGMENTS * _combiner_geometry(n)[1]
    heads = _planes(windows * cslots, dev)
    count = torch.empty(windows, dtype=torch.int32, device=dev)
    per = _kernel_fn("mr_combiner_window_rows")()
    scratch = RowScratch(
        torch.empty(windows * 3 * per, dtype=torch.int32, device=dev),
        torch.empty(windows, dtype=torch.int32, device=dev))
    _launched(_kernel_fn("mr_combiner_heads")(
        data.data_ptr(), n, w, cslots, *(h.data_ptr() for h in heads),
        count.data_ptr(), scratch.rows.data_ptr(), scratch.count.data_ptr(),
        _stream(data)), "combiner_heads")
    return (*heads, count), scratch


def combiner_merge_kernel(heads, n: int, cslots: int) -> CombinerCache:
    """Phase 2 on the card, for a chunk of ``n`` bytes: what
    :func:`combiner_merge_plain` returns."""
    _check_cuda(heads[0])
    cache = _planes(cslots * SEGMENTS, heads[0].device, 4)
    _launched(_kernel_fn("mr_combiner_merge")(
        n, cslots, *(h.data_ptr() for h in heads),
        *(c.data_ptr() for c in cache), _stream(heads[0])), "combiner_merge")
    return CombinerCache(*(c.reshape(cslots, SEGMENTS) for c in cache))


def combiner_thin_kernel(n: int, slots: int, cache: CombinerCache,
                         scratch: RowScratch):
    """Phase 3 on the card, for a chunk of ``n`` bytes, from phase 1's
    rows: what :func:`combiner_thin_plain` returns.  The hits are added to
    ``cache.count`` in place (phase 2 zeroes it), which is returned as
    ``counts``."""
    _check_cuda(scratch.rows)
    dev = scratch.rows.device
    khi, klo, packed = _planes(
        SEGMENTS * _combiner_geometry(n)[1] * slots, dev)
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    _launched(_kernel_fn("mr_combiner_thin")(
        n, slots, cache.key_hi.shape[0], scratch.rows.data_ptr(),
        scratch.count.data_ptr(), cache.key_hi.data_ptr(),
        cache.key_lo.data_ptr(), cache.count.data_ptr(), khi.data_ptr(),
        klo.data_ptr(), packed.data_ptr(), counters.data_ptr(),
        _stream(scratch.rows)), "combiner_thin")
    return (khi, klo, packed, counters[0], counters[1], counters[2],
            cache.count)


def tokenize_combiner_kernel(data: torch.Tensor, w: int, slots: int,
                             cslots: int, timer=None):
    """The three combiner launches on ``data``'s device and current stream:
    what :func:`tokenize_combiner_plain` returns.  ``timer(label)``, when
    given, is called after each launch is enqueued.  Does not
    synchronise."""
    heads, scratch = combiner_heads_kernel(data, w, cslots)
    if timer:
        timer("heads")
    cache = combiner_merge_kernel(heads, data.shape[0], cslots)
    if timer:
        timer("merge")
    out = combiner_thin_kernel(data.shape[0], slots, cache, scratch)
    if timer:
        timer("thin")
    return (*out[:6], cache)


def _as_allocated(out, n: int):
    """The plain version's stream in the kernel's planes: ``ceil(n / 2) +
    1`` rows, the rows after the dead row dead too (the kernel leaves them
    unwritten; every reader cuts them off).  Used while a recorder traces
    the CPU, so the traced program's shapes are the card's."""
    stream, over, spill = out
    rows = -(-n // 2) + 1
    planes = (torch.cat([p, p.new_full((rows - p.shape[0],), fill)])
              for p, fill in zip(stream[:3], (_SENT, _SENT, _ALL_ONES)))
    return PackedTokenStream(*planes, stream.total, stream.live), over, spill


def _tokenize_stream(data: torch.Tensor, w: int, mode: str):
    n = data.shape[0]
    with tracepoints.kernel_scope(
            mode, lambda: plans.tokenize_stream(n, w, mode), data) as k:
        if data.device.type == "cpu":
            out = tokenize_stream_plain(data, w)
            if k.recording:
                out = _as_allocated(out, n)
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
    the rows left in the stream, and the window holds
    :data:`COMBINER_SLOTS` rows.  The cache's ``packed`` records in-chunk
    positions (the caller applies the chunk id as ``pos_hi``).  A nonzero
    ``spill`` means the thinned stream is incomplete: discard it AND the
    cache, and rerun with :func:`tokenize_split` (combiner-free).  The
    thinned stream keeps its windows: its planes are whole.
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
    with tracepoints.kernel_scope(
            "tokenize_combiner",
            lambda: plans.combiner(data.shape[0], w, combiner_slots),
            data) as k:
        if data.device.type == "cpu":
            out = tokenize_combiner_plain(data, w, COMBINER_SLOTS,
                                          combiner_slots)
        else:
            out = tokenize_combiner_kernel(data, w, COMBINER_SLOTS,
                                           combiner_slots)
            LAUNCHES["tokenize_combiner"] += 1
        khi, klo, packed, over, ntok, spill, cache = k.result(out)
    return PackedTokenStream(khi, klo, packed, ntok), over, spill, cache
