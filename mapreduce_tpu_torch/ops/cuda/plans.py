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
MERGE_WARPS = 4  # kMergeWarps
COMBINER_SLOTS = 768  # rows a combiner window (ops/cuda/tokenize.py)

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
    KernelSpec("tokenize_stream", "mapreduce_tpu_torch/csrc/tokenize.cu:297",
               TOK_THREADS, TILE_BLOCKS, _layout(
                   [(16 * TILE_GROUPS, 16), (2 * TILE_ROWS, 2),
                    (4 * TOK_WARPS, 4), (4, 4), (4, 4), (4, 4)])),
    KernelSpec("combiner_heads", "mapreduce_tpu_torch/csrc/tokenize.cu:435",
               TOK_THREADS, 0, _layout(
                   [(BUF, 1), (4 * TOK_WARPS, 4), (4, 4)]
                   + [(4 * MAX_ROWS, 4)] * 3 + [(4 * MAX_CACHE, 4)] * 3)),
    KernelSpec("combiner_merge", "mapreduce_tpu_torch/csrc/tokenize.cu:520",
               MERGE_WARPS * 32, 0,
               _layout([(4 * MERGE_WARPS * MAX_CACHE, 4)] * 3)),
    KernelSpec("combiner_thin", "mapreduce_tpu_torch/csrc/tokenize.cu:566",
               TOK_THREADS, 0, _layout(
                   [(4 * TOK_WARPS, 4), (4, 4), (4 * TOK_WARPS, 4)]
                   + [(4 * MAX_CACHE, 4)] * 3)),
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
    """One wrapper call's launches, in order, at its sizes."""

    wrapper: str
    launches: tuple
    sizes: tuple = ()  # (name, value) pairs the plan was built from
    geometry: str = "default"

    def as_dict(self) -> dict:
        return {"wrapper": self.wrapper, "geometry": self.geometry,
                "sizes": dict(self.sizes),
                "launches": [x.as_dict() for x in self.launches]}


def tokenize_stream(n: int, w: int, wrapper: str) -> KernelPlan:
    """K1a–c: one ``tokenize_stream`` launch over an n-byte chunk
    (``wrapper``: tokenize_compact, tokenize_pair or tokenize_fused)."""
    return KernelPlan(wrapper, (
        Launch("tokenize_stream", (-(-(n + 15) // TILE),)),),
        (("bytes", n), ("w", w)))


def combiner_windows(n: int) -> int:
    """Windows a segment of an n-byte chunk (``combiner_windows``)."""
    return -(-(n // SEGMENTS) // WINDOW)


def combiner(n: int, w: int, cslots: int,
             geometry: str = "default") -> KernelPlan:
    """K1d: heads, merge and thin over an n-byte chunk at cache depth
    ``cslots``."""
    windows = SEGMENTS * combiner_windows(n)
    return KernelPlan("tokenize_combiner", (
        Launch("combiner_heads", (windows,)),
        Launch("combiner_merge", (SEGMENTS // MERGE_WARPS,)),
        Launch("combiner_thin", (windows,))),
        (("bytes", n), ("w", w), ("cslots", cslots)), geometry)


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


def partition_level(rows: int, bits: int, groups: int) -> KernelPlan:
    """K2: one partition level of ``groups`` groups."""
    return KernelPlan("radix_partition", _passes(rows, groups, 1, 1),
                      (("rows", rows), ("bits", bits), ("groups", groups)))


def segmented_sort(rows: int, segs: int, digit_bits: int,
                   with_packed: bool) -> KernelPlan:
    """K2s: the segmented LSD sort of ``segs`` buckets."""
    npass = sort_pass_count(digit_bits, with_packed)
    return KernelPlan("radix_sort", _passes(rows, segs, npass, npass),
                      (("rows", rows), ("segments", segs),
                       ("digit_bits", digit_bits), ("passes", npass)))


def radix_sort3(rows: int, impl: str, bits: int, packed_ordered: bool,
                geometry: str = "default") -> KernelPlan:
    """K2 + K2s: the radix seam over ``rows`` rows (one partition level
    under 'radix_partition', two under 'radix', then the segmented
    sort)."""
    levels = 2 if impl == "radix" else 1
    launches = _passes(rows, 1, 1, 1)
    if levels == 2:
        launches += _passes(rows, 1 << bits, 1, 1)
    npass = sort_pass_count(levels * bits, not packed_ordered)
    launches += _passes(rows, 1 << (levels * bits), npass, npass)
    return KernelPlan(f"radix_sort3[{impl}]", launches,
                      (("rows", rows), ("bits", bits), ("levels", levels),
                       ("passes", npass)), geometry)


#: The chunk the production plans are certified at (``Config()``).
PRODUCTION_CHUNK = 32 << 20


def production_plans() -> list:
    """Every wrapper's plan at ``Config()``'s 32 MB chunk (W = 32) under
    each ``GEOMETRY_PRESETS`` entry: the compact, pair and fused stream,
    the combiner at the preset's cache depth, and the radix seam of both
    impls (stable2's key-only sort) over the dense stream's allocation
    (``ceil(n / 2) + 1`` rows, the most a chunk can give)."""
    from mapreduce_tpu_torch.config import GEOMETRY_PRESETS

    n, w = PRODUCTION_CHUNK, 32
    rows = -(-n // 2) + 1
    out = []
    for label, geo in GEOMETRY_PRESETS.items():
        for mode in ("compact", "pair", "fused"):
            out.append(dataclasses.replace(
                tokenize_stream(n, w, f"tokenize_{mode}"), geometry=label))
        out.append(combiner(n, w, geo.combiner_slots, label))
        for impl in ("radix_partition", "radix"):
            out.append(radix_sort3(rows, impl, geo.radix_bits, True, label))
    return out
