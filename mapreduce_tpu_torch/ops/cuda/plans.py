"""Each hand-written kernel's launch plan, for the static analysis.

Counterpart of :mod:`mapreduce_tpu.ops.pallas.meta` (each TPU kernel's
declared VMEM/SMEM footprint at a geometry), in CUDA terms: every
``__global__`` function of ``csrc/*.cu`` with its block size, its
``__launch_bounds__`` minimum blocks an SM and its static shared bytes
(:data:`KERNELS`), and each wrapper's launches at a given chunk and
geometry (:class:`KernelPlan`: which kernels, on which grids).  The
numbers are copied from the constants of the sources (``tokenize.cu``
``kTile``, ``kThreads``, ``kTileBlocks``, ...; ``radix.cu`` ``kTile``,
``kRadix``, ``kMaxPasses``, ...), and the shared bytes are the sources'
``__shared__`` arrays laid out in declaration order at their alignment.
The card holds each against ``cudaFuncGetAttributes``
(:mod:`...analysis.kernel_info`); the ``smem-budget`` pass holds each
against the Hopper limits below.

A plan is a function of sizes alone (a chunk's bytes, a stream's rows,
the geometry), never of data or of an address: a grid that depends on
the data is its bound (``tokenize_stream`` starts its tiles at the
chunk's 16-byte alignment, so its plan counts one tile more than an
aligned chunk needs; the radix passes size their grids by rows plus
segments, as ``mr_sort_grid`` does).
"""

from __future__ import annotations

import dataclasses

# Hopper limits (the hopper-kernels guide): static shared memory a block
# (more only as opt-in dynamic memory), threads a block and an SM,
# registers an SM, and shared memory an SM.
STATIC_SMEM_LIMIT = 48 * 1024
MAX_THREADS_PER_BLOCK = 1024
MAX_THREADS_PER_SM = 2048
REGISTERS_PER_SM = 65536
MAX_REGISTERS_PER_THREAD = 255
SMEM_PER_SM = 228 * 1024

# csrc/tokenize.cu
TOK_THREADS = 256  # kThreads
TOK_WARPS = TOK_THREADS // 32
TILE = 8192  # kTile
TILE_BLOCKS = 8  # kTileBlocks, __launch_bounds__(kThreads, kTileBlocks)
MAX_W = 63  # kMaxW
TILE_GROUPS = (MAX_W + 1 + TILE + 16) // 16  # kTileGroups
TILE_ROWS = TILE // 2  # kTileRows
WINDOW = 3072  # kWindow
BUF = MAX_W + 1 + WINDOW + 1  # kBuf
MAX_ROWS = WINDOW // 2  # kMaxRows
MAX_CACHE = 32  # kMaxCache
SEGMENTS = 128  # kSegments
FOLD_ENTRIES = MAX_CACHE * SEGMENTS  # kFoldEntries
FOLD_COUNTERS = 8  # kFoldCounters
COMBINER_SLOTS = 768  # kept rows a combiner window holds before it spills

# csrc/radix.cu
RADIX_THREADS = 256  # kThreads
RADIX_WARPS = RADIX_THREADS // 32
RADIX_TILE = 2048  # kTile
RADIX = 256  # kRadix
MAX_PASSES = 12  # kMaxPasses
MAX_SEGMENTS = 1024  # kMaxSegments


def _layout(arrays) -> int:
    """Bytes of ``__shared__`` arrays ``[(bytes, alignment), ...]`` laid
    out in order, each at its alignment."""
    at = 0
    for size, align in arrays:
        at = -(-at // align) * align + size
    return at


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ``__global__`` function: where it is, its block size, the
    minimum blocks an SM its ``__launch_bounds__`` asks for (0: none) and
    its static shared bytes."""

    name: str
    source: str
    threads: int
    min_blocks: int
    static_smem: int

    @property
    def register_cap(self) -> int:
        """Registers a thread may use: what ``min_blocks`` blocks of
        ``threads`` leave of an SM's file (255 without a minimum)."""
        if not self.min_blocks:
            return MAX_REGISTERS_PER_THREAD
        return min(MAX_REGISTERS_PER_THREAD,
                   REGISTERS_PER_SM // (self.threads * self.min_blocks))


KERNELS = {k.name: k for k in (
    KernelSpec("tokenize_stream", "mapreduce_tpu_torch/csrc/tokenize.cu:310",
               TOK_THREADS, TILE_BLOCKS, _layout(
                   [(16 * TILE_GROUPS, 16), (2 * TILE_ROWS, 2),
                    (4 * TOK_WARPS, 4), (4, 4), (4, 4), (4, 4)])),
    KernelSpec("combiner_stream", "mapreduce_tpu_torch/csrc/tokenize.cu:456",
               TOK_THREADS, 0, _layout(
                   [(BUF, 1), (4 * TOK_WARPS, 4), (4, 4), (4 * TOK_WARPS, 4)]
                   + [(4 * MAX_ROWS, 4)] * 3 + [(4 * MAX_CACHE, 4)] * 3
                   + [(4, 4)] * 3)),
    KernelSpec("combiner_fold_keys",
               "mapreduce_tpu_torch/csrc/tokenize.cu:700", TOK_THREADS, 0,
               _layout([(8 * FOLD_ENTRIES, 8), (2 * FOLD_ENTRIES, 2),
                        (4 * TOK_WARPS, 4), (4, 4), (8, 8)])),
    KernelSpec("combiner_fold_merge",
               "mapreduce_tpu_torch/csrc/tokenize.cu:809", TOK_THREADS, 0,
               _layout([(8, 8), (1, 1)])),
    KernelSpec("sort_tiles", "mapreduce_tpu_torch/csrc/radix.cu:139",
               MAX_SEGMENTS, 0, _layout([(4 * 32, 4), (4, 4)])),
    KernelSpec("sort_hist", "mapreduce_tpu_torch/csrc/radix.cu:170",
               RADIX_THREADS, 0, _layout(
                   [(4 * MAX_PASSES * RADIX, 4)] + [(4 * MAX_PASSES, 4)] * 3)),
    # sort_scan's block_scan writes its ``total`` and nothing reads it:
    # the compiler drops the array (the card reports 128 B).
    KernelSpec("sort_scan", "mapreduce_tpu_torch/csrc/radix.cu:225",
               RADIX, 0, _layout([(4 * 32, 4)])),
    KernelSpec("sort_scatter", "mapreduce_tpu_torch/csrc/radix.cu:251",
               RADIX_THREADS, 0, _layout(
                   [(2 * RADIX_WARPS * RADIX, 2), (4 * RADIX, 4),
                    (4 * RADIX, 4)] + [(4 * RADIX_TILE, 4)] * 3
                   + [(RADIX_TILE, 1), (4 * 32, 4), (4, 4), (4, 4)])),
)}


# -- each kernel's cross-block protocol (the kernel-race pass) -------------

#: How the blocks of one launch share a global buffer the kernel writes:
#: ``disjoint`` -- plain stores, each element by one block (its rows, or
#: the cache slots its window adopts);
#: ``shared`` -- one target every block reaches: atomics only, except the
#: plain stores the protocol's ``one_block`` declares;
#: ``status`` -- status words, one a block, polled by later blocks (a
#: decoupled look-back, the combiner's head-list words and full flags):
#: zeroed, or tagged with an epoch, once a call;
#: ``ticket`` -- an atomic counter that hands blocks their work in start
#: order, zeroed once a call;
#: ``one-cta`` -- written by the launch's only block (a grid of one).
BUFFER_KINDS = ("disjoint", "shared", "status", "ticket", "one-cta")


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One ``__global__`` function's declared cross-block protocol: each
    global buffer (kernel parameter) it writes and its kind
    (:data:`BUFFER_KINDS`), the ``mr_*`` launcher that launches it, and
    how its status words start each call: ``zeroed`` names the launcher
    parameter it clears with ``cudaMemsetAsync`` before the launch,
    ``epoch`` the launcher parameter whose value tags them.

    ``one_block`` declares the plain stores to a ``shared`` buffer, as
    ``(buffer, subscript)`` pairs (``""``: any subscript): each is made by
    the one block the kernel picks for it (the chunk's last tile or window
    writes the live count, the last CTA to finish writes the totals).
    Which block a condition picks is the kernel's design, declared here;
    the certificate holds every other plain store to a shared buffer to be
    a blind write."""

    kernel: str
    buffers: tuple  # ((param, kind), ...)
    launcher: str
    zeroed: str = ""
    epoch: str = ""
    one_block: tuple = ()  # ((param, subscript), ...)

    def kind(self, param: str) -> str | None:
        return dict(self.buffers).get(param)

    def stored_by_one_block(self, param: str, subscript: str) -> bool:
        return any(b == param and s in ("", subscript)
                   for b, s in self.one_block)


_ROWS = (("khi", "disjoint"), ("klo", "disjoint"), ("packed", "disjoint"))

PROTOCOLS = {p.kernel: p for p in (
    Protocol("tokenize_stream", _ROWS + (
        ("counters", "shared"), ("ticket", "ticket"), ("status", "status")),
        "mr_tokenize_stream", zeroed="work",
        one_block=(("counters", "3"),)),
    Protocol("combiner_stream", _ROWS + (
        ("c_khi", "disjoint"), ("c_klo", "disjoint"), ("c_pk", "disjoint"),
        ("c_cnt", "shared"), ("counters", "shared"), ("ticket", "ticket"),
        ("status", "status"), ("heads", "status"), ("full", "status")),
        "mr_combiner_stream", zeroed="work",
        one_block=(("counters", "3"),)),
    Protocol("combiner_fold_keys", (("fold", "one-cta"),),
             "mr_combiner_fold", zeroed="fold"),
    Protocol("combiner_fold_merge", (
        ("t_out", "disjoint"), ("fold", "shared"), ("out_drop", "shared")),
        "mr_combiner_fold", zeroed="fold", one_block=(("out_drop", ""),)),
    Protocol("sort_tiles", (("tile_start", "one-cta"),), "mr_sort_tiles"),
    Protocol("sort_hist", (("hist", "shared"),), "mr_sort_hist"),
    Protocol("sort_scan", (("digit_start", "disjoint"),
                           ("bucket_ends", "disjoint")), "mr_sort_scan"),
    Protocol("sort_scatter", (
        ("status", "status"), ("next_tile", "ticket"), ("ohi", "disjoint"),
        ("olo", "disjoint"), ("opk", "disjoint")), "mr_sort_scatter",
        epoch="epoch"),
)}


def spec_of(attr_name: str) -> KernelSpec:
    """The spec of a kernel as its library names it: a template instance
    (``sort_hist<int64,drop>``) has its template's spec."""
    return KERNELS[attr_name.split("<", 1)[0]]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: the ``__global__`` function and its grid."""

    kernel: str
    grid: tuple

    @property
    def spec(self) -> KernelSpec:
        return KERNELS[self.kernel]

    def as_dict(self) -> dict:
        s = self.spec
        return {"kernel": self.kernel, "grid": list(self.grid),
                "threads": s.threads, "min_blocks": s.min_blocks,
                "static_smem": s.static_smem}


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One wrapper call's launches, in order, at its sizes, and the
    device-memory bytes they move besides reading the wrapper's operands
    and writing its results once (``scratch``: ``(what, read, written)``
    triples -- work words cleared and polled, planes a pass writes and the
    next reads back, a list later blocks read again).  The cost model
    charges both."""

    wrapper: str
    launches: tuple
    sizes: tuple = ()  # (name, value) pairs the plan was built from
    geometry: str = "default"
    scratch: tuple = ()  # ((what, bytes read, bytes written), ...)

    @property
    def scratch_bytes(self) -> tuple[int, int]:
        """(bytes read, bytes written) of :attr:`scratch`."""
        return (sum(r for _, r, _ in self.scratch),
                sum(w for _, _, w in self.scratch))

    def as_dict(self) -> dict:
        return {"wrapper": self.wrapper, "geometry": self.geometry,
                "sizes": dict(self.sizes),
                "launches": [x.as_dict() for x in self.launches],
                "scratch": [list(x) for x in self.scratch]}


def _work(words: int, status_words: int) -> tuple:
    """A launcher's work buffer: ``words`` int64 words cleared once a
    call, of which ``status_words`` uint32 status words are each written
    by their block and read by the blocks that poll them."""
    return ("work", 4 * status_words, 8 * words + 4 * status_words)


def tokenize_stream(n: int, w: int, wrapper: str) -> KernelPlan:
    """K1a–c: one ``tokenize_stream`` launch over an n-byte chunk
    (``wrapper``: tokenize_compact, tokenize_pair or tokenize_fused)."""
    tiles = -(-(n + 15) // TILE)
    return KernelPlan(wrapper, (Launch("tokenize_stream", (tiles,)),),
                      (("bytes", n), ("w", w)),
                      scratch=(_work(4 + (tiles + 2) // 2, tiles),))


def combiner_windows(n: int) -> int:
    """Windows a segment of an n-byte chunk (``combiner_windows``)."""
    return -(-(n // SEGMENTS) // WINDOW)


def combiner_work_words(n: int) -> int:
    """``mr_combiner_work_words``: the counters, then the ticket, each
    window's look-back and head-list words and each segment's full flag
    as uint32."""
    windows = SEGMENTS * combiner_windows(n)
    return 4 + (1 + 2 * windows + SEGMENTS + 1) // 2


def stream_rows(n: int) -> int:
    """Rows of a dense stream's planes over an n-byte chunk: every token
    end (``ceil(n / 2)`` at most) and the dead row."""
    return -(-n // 2) + 1


def combiner(n: int, w: int, cslots: int,
             geometry: str = "default") -> KernelPlan:
    """K1d: ``combiner_stream`` over an n-byte chunk at cache depth
    ``cslots``, one block a window; it writes the rows it keeps as the
    dense stream.  Besides its operand and results it clears its work
    words and the count plane (which its hits then add to), and each
    window after its segment's first reads the segment's key list back
    (``key_hi`` and ``key_lo``, 16 B a slot)."""
    wps = combiner_windows(n)
    windows = SEGMENTS * wps
    plane = 8 * cslots * SEGMENTS
    return KernelPlan("tokenize_combiner", (
        Launch("combiner_stream", (windows,)),),
        (("bytes", n), ("w", w), ("cslots", cslots),
         ("stream_rows", stream_rows(n))), geometry,
        scratch=(_work(combiner_work_words(n), 2 * windows + SEGMENTS),
                 ("counts", plane, plane),
                 ("list", 16 * cslots * SEGMENTS * (wps - 1), 0)))


def fold_words(entries: int) -> int:
    """``mr_combiner_fold_words``: the counters, then each unique key's
    key, packed and count, and two int32 words."""
    return FOLD_COUNTERS + 3 * (entries + 1)


def combiner_fold(entries: int, cap: int) -> KernelPlan:
    """K1d's fold: the cache's ``entries`` rows into a table of ``cap``
    rows (one CTA for the keys, one thread a table row or cache key for
    the merge).  Its scratch: the counters, cleared, and the unique keys'
    words, written by the first launch and read by the second."""
    words = 8 * (fold_words(entries) - FOLD_COUNTERS)
    return KernelPlan("combiner_fold", (
        Launch("combiner_fold_keys", (1,)),
        Launch("combiner_fold_merge", (-(-(cap + entries) // TOK_THREADS),))),
        (("entries", entries), ("capacity", cap)),
        scratch=(("counters", 8 * FOLD_COUNTERS, 8 * FOLD_COUNTERS),
                 ("unique keys", words, words)))


def sort_grid(rows: int, segs: int) -> int:
    """CTAs of a histogram or scatter launch (``mr_sort_grid``)."""
    return -(-rows // RADIX_TILE) + segs


def _passes(rows: int, segs: int, npass: int, scatters: int) -> tuple:
    """One counting stage over ``segs`` segments: tiles, the histogram of
    ``npass`` digits, their scan and ``scatters`` scatter passes."""
    return (Launch("sort_tiles", (1,)),
            Launch("sort_hist", (sort_grid(rows, segs),)),
            Launch("sort_scan", (segs, npass)),
            *[Launch("sort_scatter", (sort_grid(rows, segs),))] * scatters)


def sort_pass_count(digit_bits: int, with_packed: bool) -> int:
    """8-bit LSD passes of the segmented sort (``radix.sort_passes``)."""
    return (4 if with_packed else 0) + 4 + -(-(32 - digit_bits) // 8)


def _counting(rows: int, stages: list) -> tuple:
    """The scratch of counting stages ``[(segments, digits, scatter
    passes), ...]`` over ``rows`` rows: each stage's histogram (cleared,
    counted, scanned into digit starts that its scatters read) and each
    scatter pass's look-back words (one per tile and digit), cleared once a
    call in one buffer the passes share through their epochs."""
    hist = sum(4 * RADIX * segs * digits for segs, digits, _ in stages)
    grid = max(sort_grid(rows, segs) for segs, _, _ in stages)
    status = sum(4 * RADIX * sort_grid(rows, segs) * scatters
                 for segs, _, scatters in stages)
    return (("histograms", 2 * hist, 3 * hist),
            ("status", status, 4 * (RADIX * grid + 16) + status))


def partition_level(rows: int, bits: int, groups: int) -> KernelPlan:
    """K2: one partition level of ``groups`` groups: its histogram reads
    the int64 planes once more than its scatter."""
    return KernelPlan("radix_partition", _passes(rows, groups, 1, 1),
                      (("rows", rows), ("bits", bits), ("groups", groups)),
                      scratch=(("planes", 24 * rows, 0),
                               *_counting(rows, [(groups, 1, 1)])))


def segmented_sort(rows: int, segs: int, digit_bits: int,
                   with_packed: bool) -> KernelPlan:
    """K2s: the segmented LSD sort of ``segs`` buckets: its histogram
    reads the int64 planes once more, and each pass but the first reads,
    each but the last writes, the uint32 planes between them (12 B a
    row)."""
    npass = sort_pass_count(digit_bits, with_packed)
    mid = 12 * rows * (npass - 1)
    return KernelPlan("radix_sort", _passes(rows, segs, npass, npass),
                      (("rows", rows), ("segments", segs),
                       ("digit_bits", digit_bits), ("passes", npass)),
                      scratch=(("planes", 24 * rows + mid, mid),
                               *_counting(rows, [(segs, npass, npass)])))


def radix_sort3(rows: int, impl: str, bits: int, packed_ordered: bool,
                geometry: str = "default") -> KernelPlan:
    """K2 + K2s: the radix seam over ``rows`` rows (one partition level
    under 'radix_partition', two under 'radix', then the segmented sort).
    Besides one read of the int64 input and one write of the int64
    output: the first level's histogram reads the input again and its
    scatter writes uint32 planes (12 B a row); every later stage's
    histogram and scatters read uint32 planes, and every scatter but the
    last writes them."""
    levels = 2 if impl == "radix" else 1
    launches = _passes(rows, 1, 1, 1)
    stages = [(1, 1, 1)]
    if levels == 2:
        launches += _passes(rows, 1 << bits, 1, 1)
        stages.append((1 << bits, 1, 1))
    npass = sort_pass_count(levels * bits, not packed_ordered)
    launches += _passes(rows, 1 << (levels * bits), npass, npass)
    stages.append((1 << (levels * bits), npass, npass))
    u32 = 12 * rows
    read = 24 * rows + u32 * (2 * (levels - 1) + 1 + npass)
    written = u32 * (levels + npass - 1)
    return KernelPlan(f"radix_sort3[{impl}]", launches,
                      (("rows", rows), ("bits", bits), ("levels", levels),
                       ("passes", npass)), geometry,
                      scratch=(("planes", read, written),
                               *_counting(rows, stages)))


#: The chunk the production plans are certified at (``Config()``).
PRODUCTION_CHUNK = 32 << 20


def geometry_plans(geo, label: str = "default",
                   n: int = PRODUCTION_CHUNK, w: int = 32) -> list:
    """Every wrapper's plan at an n-byte chunk under one ``Geometry``: the
    compact, pair and fused stream, the combiner and its fold at the
    geometry's cache depth, and the radix seam of both impls (stable2's
    key-only sort) over the dense stream's allocation (``ceil(n / 2) + 1``
    rows, the most a chunk can give).  Only ``combiner_slots`` and
    ``radix_bits`` move a launch; the TPU layout's fields do not."""
    rows = stream_rows(n)
    out = [dataclasses.replace(tokenize_stream(n, w, f"tokenize_{mode}"),
                               geometry=label)
           for mode in ("compact", "pair", "fused")]
    out.append(combiner(n, w, geo.combiner_slots, label))
    out.append(dataclasses.replace(combiner_fold(
        geo.combiner_slots * SEGMENTS, min(rows, 1 << 18)), geometry=label))
    for impl in ("radix_partition", "radix"):
        out.append(radix_sort3(rows, impl, geo.radix_bits, True, label))
    return out


def production_plans() -> list:
    """Every wrapper's plan at ``Config()``'s 32 MB chunk (W = 32) under
    each ``GEOMETRY_PRESETS`` entry (:func:`geometry_plans`)."""
    from mapreduce_tpu_torch.config import GEOMETRY_PRESETS

    return [plan for label, geo in GEOMETRY_PRESETS.items()
            for plan in geometry_plans(geo, label)]
