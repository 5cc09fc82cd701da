"""K2: the radix partition of the aggregation stream, hand-written in CUDA.

Counterpart of :mod:`mapreduce_tpu.ops.pallas.radix`: :func:`radix_sort3`
returns exactly the 3-key sort of ``(key_hi, key_lo, packed)`` read as
uint32 — dead ``(sent, sent)`` rows last with all-ones ``packed``, the
poison segment ``(sent, sent-1)`` just before them in ascending ``packed``,
ties resolved by ``packed`` — which serves ``sort_mode`` 'sort3' outright
and 'stable2' under its position-ordered input.  The kernels are in
``mapreduce_tpu_torch/csrc/radix.cu``.

Each partition level (:func:`partition_level`) is a histogram kernel, an
exclusive ``cumsum`` of the (bucket, CTA) counts (the JAX package leaves
its scans to XLA) and a scatter kernel that moves every live row to its
bucket's region, so the dead rows leave the stream at the first level.
``impl='radix_partition'`` runs one level on the top ``bits`` of
``key_hi``; ``impl='radix'`` runs a second one that splits each
first-level bucket, where the first level put its rows, by the next
``bits``.  Then each bucket is sorted on its own (:func:`_sort_buckets`),
as the JAX package's finishing ``lax.sort`` sorts each group's slab: a row
sorts inside the bucket the partition wrote it to, so a misplaced row
shows in the result.  Hopper scatters, so there are no static slabs,
nothing spills and no fallback exists: the TPU version's spill branch has
no counterpart.

The first level reads its live-row count back to the host to size its
output: one sync per call, which keeps the dead rows (half of a compact
stream) out of the finishing sort.  Dispatch: CPU tensors take the plain
versions (:func:`radix_sort3_plain`, :func:`partition_level_plain`); CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from mapreduce_tpu_torch.ops.cuda import _build
from mapreduce_tpu_torch.ops.table import _key64, _lexsort
from mapreduce_tpu_torch.ops.tokenize import SENT

DEFAULT_BITS = 3  # 8 buckets per level
IMPLS = ("radix_partition", "radix")
_ALL_ONES = 0xFFFFFFFF

#: Partition levels launched on the card ("radix_partition"), one per level.
#: CPU calls run the plain version and count nothing.
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "mr_radix_grid": ([_LL], _LL),
    "mr_radix_histogram": ([_P, _P, _LL, _I, _I, _I, _P, _P, _P], _I),
    "mr_radix_scatter": ([_P, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P], _I),
}


def _fn(name: str):
    fn = getattr(_build.load("radix"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name]
    return fn


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


def radix_sort3_plain(key_hi, key_lo, packed):
    """Plain PyTorch version: the 3-key sort itself, over the sign-flipped
    64-bit key and ``packed``."""
    order = _lexsort(_key64(key_hi, key_lo), packed)
    return key_hi[order], key_lo[order], packed[order]


def partition_level_plain(key_hi, key_lo, packed, shift: int, bits: int,
                          group_ends=None):
    """Plain version of :func:`partition_level`: the live rows, stably
    sorted by bucket."""
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
    return (key_hi[idx], key_lo[idx], packed[idx]), ends


def canonical_partition(planes, ends):
    """Each row's bucket, then the planes, with the rows of each bucket
    sorted by (key, ``packed``).  Two partitions with equal ``ends`` put the
    same multiset of rows in every bucket exactly when these are equal:
    how the tests and the smoke hold :func:`partition_level` to
    :func:`partition_level_plain`."""
    key_hi, key_lo, packed = planes
    rows = torch.arange(key_hi.shape[0], dtype=torch.int64,
                        device=key_hi.device)
    bucket = torch.searchsorted(ends, rows, right=True)
    order = _lexsort(bucket, _key64(key_hi, key_lo), packed)
    return bucket[order], key_hi[order], key_lo[order], packed[order]


def partition_level(key_hi, key_lo, packed, shift: int, bits: int,
                    group_ends=None):
    """One partition level: the live rows of the three planes grouped by
    ascending bucket ``g * 2**bits + ((key_hi >> shift) & (2**bits - 1))``,
    where ``g`` is the group that holds the row's input position
    (``group_ends``: each group's end row, the previous level's bucket ends;
    None for one group).  Returns the grouped planes and each bucket's end
    row (int64, on the planes' device).  Within a bucket rows keep no set
    order.

    Only the first level's input holds dead rows: there the live count is
    read back to size the output.  A later level's input is all live."""
    if key_hi.device.type == "cpu":
        return partition_level_plain(key_hi, key_lo, packed, shift, bits,
                                     group_ends)
    n = key_hi.shape[0]
    dev = key_hi.device
    groups = 1 if group_ends is None else group_ends.shape[0]
    ends_ptr = None if group_ends is None else group_ends.data_ptr()
    grid = _fn("mr_radix_grid")(n)
    hist = torch.empty((groups << bits, grid), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("mr_radix_histogram")(key_hi.data_ptr(), key_lo.data_ptr(), n,
                                    shift, bits, groups, ends_ptr,
                                    hist.data_ptr(), stream)
    if err:
        raise RuntimeError(f"radix histogram launch failed: CUDA error {err}")
    counts = hist.to(torch.int64)
    flat = counts.reshape(-1)
    offsets = torch.cumsum(flat, 0) - flat
    ends = torch.cumsum(counts.sum(1), 0)
    n_out = n if group_ends is not None else int(ends[-1])
    out = [torch.empty(n_out, dtype=torch.int64, device=dev)
           for _ in range(3)]
    err = _fn("mr_radix_scatter")(
        key_hi.data_ptr(), key_lo.data_ptr(), packed.data_ptr(), n, shift,
        bits, groups, ends_ptr, offsets.data_ptr(),
        *(o.data_ptr() for o in out), stream)
    if err:
        raise RuntimeError(f"radix scatter launch failed: CUDA error {err}")
    LAUNCHES["radix_partition"] += 1
    return out, ends


def _sort_buckets(key_hi, key_lo, packed, ends, digit_bits: int):
    """The finishing 3-key sort of each bucket on its own.  A row's bucket
    comes from its position (``ends``) and takes the place of the top
    ``digit_bits`` of its key, which every row of a right bucket shares:
    the rows then sort on (bucket, the key's other bits, ``packed``) in one
    2-key sort, and a row the partition misplaced sorts among its bucket's
    rows, not at its key."""
    rows = torch.arange(key_hi.shape[0], dtype=torch.int64,
                        device=key_hi.device)
    bucket = torch.searchsorted(ends, rows, right=True)
    low = _key64(key_hi, key_lo) & ((1 << (64 - digit_bits)) - 1)
    # (bucket - half) * 2**(64 - digit_bits) + low, in int64 range: for a
    # right bucket this is _key64 itself.
    half = 1 << (digit_bits - 1)
    key = (bucket - half) * (1 << (63 - digit_bits)) * 2 + low
    order = _lexsort(key, packed)
    return key_hi[order], key_lo[order], packed[order]


def radix_sort3_seam(key_hi, key_lo, packed, impl: str, bits: int):
    """The partition levels, then the finishing sort of each bucket; dead
    rows fill the tail.  On CPU tensors the levels are the plain
    partitions."""
    n = key_hi.shape[0]
    planes, ends = partition_level(key_hi, key_lo, packed, 32 - bits, bits)
    digit_bits = bits
    if impl == "radix" and planes[0].shape[0]:
        planes, ends = partition_level(*planes, 32 - 2 * bits, bits,
                                       group_ends=ends)
        digit_bits = 2 * bits
    sorted_ = _sort_buckets(*planes, ends, digit_bits)
    tail = n - sorted_[0].shape[0]
    return tuple(torch.cat([p, p.new_full((tail,), fill)])
                 for p, fill in zip(sorted_, (SENT, SENT, _ALL_ONES)))


def radix_sort3(key_hi, key_lo, packed, *, impl: str = "radix_partition",
                bits: int = DEFAULT_BITS):
    """Radix-partitioned equivalent of the 3-key sort of ``(key_hi,
    key_lo, packed)`` (int64 planes holding uint32), bit-identical with
    ties.  Relies on the packed-stream contract that a ``(sent, sent)`` row
    carries all-ones ``packed``."""
    _check(key_hi, key_lo, packed, impl, bits)
    if key_hi.shape[0] == 0:
        return key_hi, key_lo, packed
    if key_hi.device.type == "cpu":
        return radix_sort3_plain(key_hi, key_lo, packed)
    return radix_sort3_seam(key_hi.contiguous(), key_lo.contiguous(),
                            packed.contiguous(), impl, bits)
