"""K2: the radix sort seam of the aggregation stream, hand-written in CUDA.

Counterpart of :mod:`mapreduce_tpu.ops.pallas.radix`: :func:`radix_sort3`
returns exactly the 3-key sort of ``(key_hi, key_lo, packed)`` read as
uint32 — dead ``(sent, sent)`` rows last with all-ones ``packed``, the
poison segment ``(sent, sent-1)`` just before them in ascending ``packed``,
ties resolved by ``packed`` — which serves ``sort_mode`` 'sort3' outright
and 'stable2' under its position-ordered input.  The kernels are in
``mapreduce_tpu_torch/csrc/radix.cu``; its note says what bounds them.

The seam is a chain of stable counting passes.  Each partition level
(:func:`partition_level`) splits each bucket of the previous level (one
segment at the first) by ``bits`` more of ``key_hi`` and drops the dead
rows, so the dead rows leave the stream at the first level.
``impl='radix_partition'`` runs one level on the top ``bits``;
``impl='radix'`` runs a second one on the next ``bits``.  Then
:func:`segmented_sort` sorts each bucket on its own, as the JAX package's
finishing ``lax.sort`` sorts each group's slab: an LSD radix sort on the
key bits below the digits the levels decided (and first on ``packed``,
unless the caller says its input is already in ``packed`` order), inside
buckets taken from the row's position, so a misplaced row shows in the
result.  Hopper scatters, so there are no static slabs, nothing spills and
no fallback exists: the TPU version's spill branch has no counterpart.

Nothing is read back to the host: the live count and the bucket ends stay
on the card, every output keeps all ``n`` rows with the dead fill at
``[live, n)``, and every grid is sized from ``n``.  Dispatch: CPU tensors
take the plain versions (:func:`radix_sort3_plain`,
:func:`partition_level_plain`, :func:`segmented_sort_plain`); CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.ops.cuda import _build, plans
from mapreduce_tpu_torch.ops.table import _key64, _lexsort
from mapreduce_tpu_torch.ops.tokenize import SENT

DEFAULT_BITS = 3  # 8 buckets per level
IMPLS = ("radix_partition", "radix")
MAX_ROWS = (1 << 26) - 1  # counts in the look-back status word
_ALL_ONES = 0xFFFFFFFF
_KEY, _LO, _PACKED = 0, 1, 2  # the word a pass reads

#: Kernel launches on the card, by kernel: "radix_partition" (one per
#: partition level) and "radix_sort" (one per segmented sort).  CPU calls
#: run the plain versions and count nothing.
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "mr_sort_grid": ([_LL, _I], _LL),
    "mr_sort_tiles": ([_P, _I, _LL, _P, _P], _I),
    "mr_sort_hist": ([_P, _P, _P, _I, _I, _P, _I, _LL, _P, _P, _I, _P, _P],
                     _I),
    "mr_sort_scan": ([_P, _P, _I, _LL, _P, _I, _P, _P, _P], _I),
    "mr_sort_scatter": ([_P, _P, _P, _I, _I, _P, _I, _LL, _P, _I, _P, _I, _P,
                         _I, _P, _P, _P, _P, _I, _P, _P], _I),
}


def _fn(name: str):
    fn = getattr(_build.load("radix"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name]
    return fn


def _call(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err:
        raise RuntimeError(f"radix kernel {name} failed: CUDA error {err}")


def _check(key_hi, key_lo, packed, impl: str, bits: int) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown radix impl {impl!r}; known: {IMPLS}")
    if not 1 <= bits <= 5:
        raise ValueError(f"bits must be in [1, 5], got {bits}")
    planes = (key_hi, key_lo, packed)
    if any(p.dtype != torch.int64 for p in planes):
        raise TypeError("radix_sort3 expects three int64 planes holding "
                        "uint32")
    if key_hi.dim() != 1 or not key_hi.shape == key_lo.shape == packed.shape:
        raise ValueError("radix_sort3 expects equal-length 1-D planes")
    if len({p.device for p in planes}) != 1:
        raise ValueError("radix_sort3 planes must share one device")


def _check_cuda(planes) -> None:
    if planes[0].device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{planes[0].device}")
    if planes[0].shape[0] > MAX_ROWS:
        raise ValueError(f"the radix kernels take at most {MAX_ROWS} rows, "
                         f"got {planes[0].shape[0]}")


def _with_dead_tail(planes, n: int):
    """``planes`` followed by dead ``(sent, sent, all-ones)`` rows up to
    ``n`` rows."""
    tail = n - planes[0].shape[0]
    return tuple(torch.cat([p, p.new_full((tail,), fill)])
                 for p, fill in zip(planes, (SENT, SENT, _ALL_ONES)))


def radix_sort3_plain(key_hi, key_lo, packed):
    """Plain PyTorch version: the 3-key sort itself, over the sign-flipped
    64-bit key and ``packed``."""
    order = _lexsort(_key64(key_hi, key_lo), packed)
    return key_hi[order], key_lo[order], packed[order]


def partition_level_plain(key_hi, key_lo, packed, shift: int, bits: int,
                          group_ends=None):
    """Plain version of :func:`partition_level`: the live rows stably
    sorted by bucket, then the dead fill."""
    n = key_hi.shape[0]
    live = ~((key_hi == SENT) & (key_lo == SENT))
    groups = 1 if group_ends is None else group_ends.shape[0]
    if group_ends is None:
        group = torch.zeros_like(key_hi)
    else:
        rows = torch.arange(n, dtype=torch.int64, device=key_hi.device)
        group = torch.searchsorted(group_ends, rows, right=True) \
            .clamp(max=groups - 1)
    bucket = ((group << bits) | ((key_hi >> shift) & ((1 << bits) - 1)))[live]
    idx = live.nonzero()[:, 0][torch.argsort(bucket, stable=True)]
    ends = torch.cumsum(torch.bincount(bucket, minlength=groups << bits), 0)
    return _with_dead_tail((key_hi[idx], key_lo[idx], packed[idx]), n), ends


def segmented_sort_plain(key_hi, key_lo, packed, ends, digit_bits: int,
                         with_packed: bool = True):
    """Plain version of :func:`segmented_sort`: the rows before ``ends[-1]``
    sorted stably within each bucket (from the row's position) on the
    ``key_hi`` bits below the top ``digit_bits``, then ``key_lo``, then
    ``packed`` when ``with_packed``; the dead fill after them."""
    n = key_hi.shape[0]
    live = int(ends[-1])
    rows = torch.arange(live, dtype=torch.int64, device=key_hi.device)
    keys = [torch.searchsorted(ends, rows, right=True),
            key_hi[:live] & ((1 << (32 - digit_bits)) - 1), key_lo[:live]]
    if with_packed:
        keys.append(packed[:live])
    order = _lexsort(*keys)
    return _with_dead_tail(tuple(p[:live][order]
                                 for p in (key_hi, key_lo, packed)), n)


def _spec(word: int, shift: int, width: int) -> int:
    return word << 16 | shift << 8 | width


def sort_passes(digit_bits: int, with_packed: bool) -> list[int]:
    """The 8-bit LSD passes of :func:`segmented_sort`, least significant
    first: ``packed`` (when asked), ``key_lo``, then ``key_hi`` below its top
    ``digit_bits``."""
    specs = [_spec(_PACKED, s, 8) for s in range(0, 32, 8)] \
        if with_packed else []
    specs += [_spec(_LO, s, 8) for s in range(0, 32, 8)]
    top = 32 - digit_bits
    return specs + [_spec(_KEY, s, min(8, top - s)) for s in range(0, top, 8)]


class _Call:
    """Device scratch of one seam call: the zeroed look-back status, shared
    by every pass through its epoch, and one tile counter per pass."""

    def __init__(self, n: int, max_segs: int, dev):
        self.n, self.dev = n, dev
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        grid = _fn("mr_sort_grid")(n, max_segs)
        self.status = torch.zeros(grid * 256 + 16, dtype=torch.int32,
                                  device=dev)
        self.epoch = 0

    def next_pass(self) -> tuple[int, int]:
        """(epoch, address of the pass's zeroed tile counter)."""
        self.epoch += 1
        return self.epoch, self.status[-16 + self.epoch].data_ptr()

    def u32(self):
        return tuple(torch.empty(self.n, dtype=torch.int32, device=self.dev)
                     for _ in range(3))

    def i64(self):
        return tuple(torch.empty(self.n, dtype=torch.int64, device=self.dev)
                     for _ in range(3))


def _ptrs(planes):
    return tuple(p.data_ptr() for p in planes)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _is64(planes) -> int:
    return int(planes[0].dtype == torch.int64)


def _tiles(call: _Call, ends, segs: int):
    tile_start = torch.empty(segs + 1, dtype=torch.int32, device=call.dev)
    _call("mr_sort_tiles", _ptr(ends), segs, call.n, tile_start.data_ptr(),
          call.stream)
    return tile_start


def _digit_starts(call: _Call, src, drop_dead: bool, ends, segs: int,
                  tile_start, specs, bucket_ends=None):
    """Every pass's digit counts per segment in one read of ``src``, then
    each digit's first output row."""
    arr = (ctypes.c_int * len(specs))(*specs)
    hist = torch.zeros(segs * len(specs) * 256, dtype=torch.int32,
                       device=call.dev)
    _call("mr_sort_hist", *_ptrs(src), _is64(src), int(drop_dead), _ptr(ends),
          segs, call.n, tile_start.data_ptr(), arr, len(specs),
          hist.data_ptr(), call.stream)
    starts = torch.empty_like(hist)
    _call("mr_sort_scan", hist.data_ptr(), _ptr(ends), segs, call.n, arr,
          len(specs), starts.data_ptr(), _ptr(bucket_ends), call.stream)
    return starts


def _scatter(call: _Call, src, drop_dead: bool, ends, segs: int, tile_start,
             spec: int, starts, dstride: int, dst, fill_from=None) -> None:
    epoch, counter = call.next_pass()
    _call("mr_sort_scatter", *_ptrs(src), _is64(src), int(drop_dead),
          _ptr(ends), segs, call.n, tile_start.data_ptr(), spec,
          starts.data_ptr(), dstride, call.status.data_ptr(), epoch, counter,
          *_ptrs(dst), _is64(dst), _ptr(fill_from), call.stream)


def _level(call: _Call, src, shift: int, bits: int, group_ends, dst,
           fill: bool):
    """One partition level of ``src`` into ``dst``; returns the bucket
    ends (on the card)."""
    groups = 1 if group_ends is None else group_ends.shape[0]
    tile_start = _tiles(call, group_ends, groups)
    spec = _spec(_KEY, shift, bits)
    ends = torch.empty(groups << bits, dtype=torch.int64, device=call.dev)
    starts = _digit_starts(call, src, True, group_ends, groups, tile_start,
                           [spec], ends)
    _scatter(call, src, True, group_ends, groups, tile_start, spec, starts,
             256, dst, ends[-1:] if fill else None)
    LAUNCHES["radix_partition"] += 1
    return ends


def _sort(call: _Call, src, ends, digit_bits: int, with_packed: bool, spare,
          out, timer=None) -> None:
    """The segmented LSD sort of ``src``'s buckets into the int64 ``out``,
    ping-ponging through the uint32 buffers ``spare`` (two, neither
    ``src``)."""
    segs = ends.shape[0]
    specs = sort_passes(digit_bits, with_packed)
    tile_start = _tiles(call, ends, segs)
    starts = _digit_starts(call, src, False, ends, segs, tile_start, specs)
    if timer:
        timer("sort_hist")
    cur = src
    for q, spec in enumerate(specs):
        last = q == len(specs) - 1
        dst = out if last else (spare[0] if cur is not spare[0] else spare[1])
        _scatter(call, cur, False, ends, segs, tile_start, spec,
                 starts[q * 256:], len(specs) * 256, dst,
                 ends[-1:] if last else None)
        cur = dst
        if timer:
            timer(f"sort_pass_{q}")
    LAUNCHES["radix_sort"] += 1


def partition_level_kernel(key_hi, key_lo, packed, shift: int, bits: int,
                           group_ends=None):
    """:func:`partition_level` on the card."""
    planes = (key_hi, key_lo, packed)
    _check_cuda(planes)
    call = _Call(key_hi.shape[0], 1 if group_ends is None
                 else group_ends.shape[0], key_hi.device)
    out = call.i64()
    ends = _level(call, planes, shift, bits, group_ends, out, fill=True)
    return out, ends


def partition_level(key_hi, key_lo, packed, shift: int, bits: int,
                    group_ends=None):
    """One partition level: the live rows of the three planes stably
    grouped by ascending bucket ``g * 2**bits + ((key_hi >> shift) &
    (2**bits - 1))``, where ``g`` is the group that holds the row's input
    position (``group_ends``: each group's end row, the previous level's
    bucket ends; None for one group), then the dead fill: all ``n`` rows.
    Returns the planes and each bucket's end row (int64, on the planes'
    device; the last is the live count).  A later level's input holds its
    dead rows at ``[group_ends[-1], n)``, as a level writes them."""
    groups = 1 if group_ends is None else group_ends.shape[0]
    with tracepoints.kernel_scope(
            "radix_partition",
            lambda: plans.partition_level(key_hi.shape[0], bits, groups),
            key_hi, key_lo, packed, group_ends) as k:
        if key_hi.device.type == "cpu":
            return k.result(partition_level_plain(
                key_hi, key_lo, packed, shift, bits, group_ends))
        return k.result(partition_level_kernel(
            key_hi, key_lo, packed, shift, bits, group_ends))


def segmented_sort_kernel(key_hi, key_lo, packed, ends, digit_bits: int,
                          with_packed: bool = True):
    """:func:`segmented_sort` on the card."""
    planes = (key_hi, key_lo, packed)
    _check_cuda(planes)
    call = _Call(key_hi.shape[0], ends.shape[0], key_hi.device)
    out = call.i64()
    _sort(call, planes, ends, digit_bits, with_packed,
          (call.u32(), call.u32()), out)
    return out


def segmented_sort(key_hi, key_lo, packed, ends, digit_bits: int,
                   with_packed: bool = True):
    """Sort the rows of each bucket (``ends``: bucket end rows, the last
    the live count; later rows are dead) on its own, stably, on the
    ``key_hi`` bits below its top ``digit_bits`` (which the partition
    decided), ``key_lo``, and ``packed`` when ``with_packed``.  All ``n``
    rows come back, the dead fill after the live ones."""
    with tracepoints.kernel_scope(
            "radix_sort",
            lambda: plans.segmented_sort(key_hi.shape[0], ends.shape[0],
                                         digit_bits, with_packed),
            key_hi, key_lo, packed, ends) as k:
        if key_hi.device.type == "cpu":
            return k.result(segmented_sort_plain(
                key_hi, key_lo, packed, ends, digit_bits, with_packed))
        return k.result(segmented_sort_kernel(
            key_hi, key_lo, packed, ends, digit_bits, with_packed))


def radix_sort3_kernel(key_hi, key_lo, packed, impl: str, bits: int,
                       packed_ordered: bool = False, timer=None):
    """The seam on the card: the levels into uint32 scratch, then the
    segmented sort into int64 planes.  ``timer(label)``, when given, is
    called after each stage is enqueued."""
    planes = (key_hi, key_lo, packed)
    _check_cuda(planes)
    levels = 2 if impl == "radix" else 1
    call = _Call(key_hi.shape[0], 1 << (bits * levels), key_hi.device)
    a, b = call.u32(), call.u32()
    ends = _level(call, planes, 32 - bits, bits, None, a, fill=False)
    if timer:
        timer("level_1")
    if levels == 2:
        ends = _level(call, a, 32 - 2 * bits, bits, ends, b, fill=False)
        a, b = b, a
        if timer:
            timer("level_2")
    out = call.i64()
    _sort(call, a, ends, levels * bits, not packed_ordered, (b, call.u32()),
          out, timer)
    return out


def radix_sort3_seam(key_hi, key_lo, packed, impl: str, bits: int,
                     packed_ordered: bool = False):
    """The partition levels, then the segmented sort of each bucket.  On
    CPU tensors every stage is its plain version."""
    if key_hi.device.type != "cpu":
        return radix_sort3_kernel(key_hi, key_lo, packed, impl, bits,
                                  packed_ordered)
    planes, ends = partition_level_plain(key_hi, key_lo, packed, 32 - bits,
                                         bits)
    digit_bits = bits
    if impl == "radix":
        planes, ends = partition_level_plain(*planes, 32 - 2 * bits, bits,
                                             group_ends=ends)
        digit_bits = 2 * bits
    return segmented_sort_plain(*planes, ends, digit_bits,
                                with_packed=not packed_ordered)


def radix_sort3(key_hi, key_lo, packed, *, impl: str = "radix_partition",
                bits: int = DEFAULT_BITS, packed_ordered: bool = False):
    """Radix-partitioned equivalent of the 3-key sort of ``(key_hi,
    key_lo, packed)`` (int64 planes holding uint32), bit-identical with
    ties.  Relies on the packed-stream contract that a ``(sent, sent)`` row
    carries all-ones ``packed``.  ``packed_ordered=True`` promises rows of
    equal key in ascending ``packed`` order (stable2's position-ordered
    stream): every pass is stable, so the sort then skips the passes over
    ``packed``."""
    _check(key_hi, key_lo, packed, impl, bits)
    if key_hi.shape[0] == 0:
        return key_hi, key_lo, packed
    with tracepoints.kernel_scope(
            f"radix_sort3[{impl}]",
            lambda: plans.radix_sort3(key_hi.shape[0], impl, bits,
                                      packed_ordered),
            key_hi, key_lo, packed) as k:
        if key_hi.device.type == "cpu":
            return k.result(radix_sort3_plain(key_hi, key_lo, packed))
        return k.result(radix_sort3_kernel(
            key_hi.contiguous(), key_lo.contiguous(), packed.contiguous(),
            impl, bits, packed_ordered))
