"""Sorted fixed-capacity count tables: the reduce data plane of the port.

Counterpart of :mod:`mapreduce_tpu.ops.table`.  Group-by-key-and-sum is a
sort + segment reduce, and :func:`merge` is associative, as in the JAX
package; the sorts are ``torch.sort(stable=True)`` (the JAX package left
its sorts to XLA), except that ``sort_impl`` can route the packed build's
sort through the CUDA radix partition (:mod:`...ops.cuda.radix`), as the
JAX package's can through its Pallas one.

Invariants of a well-formed table (established by every constructor here):
  * entries are sorted ascending by 64-bit key;
  * occupied slots (``(count | count_hi) > 0``) form a prefix; empty slots
    carry the sentinel key, count 0, pos = +inf, length 0;
  * ``(pos_hi, pos_lo)`` is the first occurrence of the key;
  * overflow past capacity is accounted (``dropped_count`` exact,
    ``dropped_uniques`` an upper bound).

Representation: every field is an int64 tensor holding a uint32 value, and
counts and ``dropped_*`` keep the JAX package's lo/hi 32-bit pairs, so a
table compares field by field with a JAX ``CountTable``.  Inside, 64-bit
quantities are plain int64: counts are exact while below 2**63.  A 64-bit
key or position sorts as :func:`_key64`, which maps the unsigned
``(hi, lo)`` order onto signed int64 order without overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.ops.tokenize import MASK32

SENT = int(constants.SENTINEL_KEY)
INF = int(constants.POS_INF)
_ALL_ONES = 0xFFFFFFFF


class CountTable(NamedTuple):
    """Keyed count state; every field is an int64 tensor holding uint32."""

    key_hi: torch.Tensor  # [V], sorted (with key_lo) ascending
    key_lo: torch.Tensor  # [V]
    count: torch.Tensor  # [V] occurrence count, low word
    count_hi: torch.Tensor  # [V] occurrence count, high word
    pos_hi: torch.Tensor  # [V] chunk id of the first occurrence
    pos_lo: torch.Tensor  # [V] byte offset within that chunk
    length: torch.Tensor  # [V] token length in bytes
    dropped_uniques: torch.Tensor  # scalar, >= true number of spilled keys
    dropped_count: torch.Tensor  # scalar, exact tokens spilled (low word)
    dropped_uniques_hi: torch.Tensor  # scalar, high word
    dropped_count_hi: torch.Tensor  # scalar, high word

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    def occupied(self) -> torch.Tensor:
        """bool[V]: slots holding a live key (the single occupancy rule)."""
        return (self.count | self.count_hi) > 0

    def n_valid(self) -> torch.Tensor:
        return self.occupied().sum()

    def dropped_totals(self) -> tuple[int, int]:
        """Host-side exact ``(dropped_uniques, dropped_count)`` ints."""
        return (int(self.dropped_uniques) + (int(self.dropped_uniques_hi) << 32),
                int(self.dropped_count) + (int(self.dropped_count_hi) << 32))

    def total_count64(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact 64-bit total (per-key counts plus ``dropped_count``) as
        ``(lo, hi)`` lanes."""
        lo, hi = sum64(self.count, self.count_hi)
        return add64(lo, hi, self.dropped_count, self.dropped_count_hi)

    def total_count(self) -> int:
        """Total tokens represented, including spilled ones (exact int)."""
        lo, hi = self.total_count64()
        return int(lo) + (int(hi) << 32)


def _join64(lo, hi):
    return lo + (hi << 32)


def _split64(x):
    return x & MASK32, x >> 32


def add64(a_lo, a_hi, b_lo, b_hi):
    """(lo, hi) + (lo, hi): exact 64-bit add of two lane pairs."""
    return _split64(_join64(a_lo, a_hi) + _join64(b_lo, b_hi))


def sum64(lo: torch.Tensor, hi: torch.Tensor | None = None):
    """Exact 64-bit (lo, hi) sum of lane arrays."""
    total = lo.sum() if hi is None else _join64(lo, hi).sum()
    return _split64(total)


def _key64(hi, lo):
    """Signed int64 whose order is the unsigned ``(hi, lo)`` order: the high
    word shifted down by 2**31 (the sign-bit flip) times 2**32, plus the
    low word.  (0, 0) maps to -2**63 and (sent, sent) to 2**63 - 1: no
    overflow, and the sentinel sorts last."""
    return (hi - 0x80000000) * (1 << 32) + lo


def _unkey64(k: torch.Tensor):
    """Inverse of :func:`_key64`: ``(hi, lo)``."""
    return (k >> 32) + 0x80000000, k & MASK32


_K_SENT = _key64(SENT, SENT)


def empty(capacity: int, device=None) -> CountTable:
    def full(v):
        return torch.full((capacity,), v, dtype=torch.int64, device=device)

    def zero():
        return torch.zeros((), dtype=torch.int64, device=device)

    return CountTable(key_hi=full(SENT), key_lo=full(SENT), count=full(0),
                      count_hi=full(0), pos_hi=full(INF), pos_lo=full(INF),
                      length=full(0), dropped_uniques=zero(),
                      dropped_count=zero(), dropped_uniques_hi=zero(),
                      dropped_count_hi=zero())


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by ``keys`` (first key primary), stable:
    one stable sort per key, least significant first."""
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _segment_heads(seg: torch.Tensor, capacity: int) -> torch.Tensor:
    """First sorted-row index of each of the first capacity+1 segments."""
    q = torch.arange(capacity + 1, dtype=torch.int64, device=seg.device)
    return torch.searchsorted(seg, q)


def _on_device(pos_hi, device) -> torch.Tensor:
    """A chunk id (a host int, or a tensor) as an int64 tensor on
    ``device``; a host int crosses as a declared host-scalar copy."""
    if isinstance(pos_hi, torch.Tensor):
        return torch.as_tensor(pos_hi, dtype=torch.int64, device=device)
    return tracepoints.host_scalars(int(pos_hi), device)


def _first_key_geq(k64: torch.Tensor, q_hi: int, q_lo: int) -> torch.Tensor:
    """Index of the first sorted row with 64-bit key >= (q_hi, q_lo)
    (``n`` if none)."""
    q = tracepoints.host_scalars([_key64(q_hi, q_lo)], k64.device)
    return torch.searchsorted(k64, q)[0]


def _segment_boundaries(k64: torch.Tensor):
    """Boundary mask + segment ranks of key-sorted rows."""
    boundary = torch.ones_like(k64, dtype=torch.bool)
    boundary[1:] = k64[1:] != k64[:-1]
    return boundary, torch.cumsum(boundary, 0) - 1


def _overflow_accounting(k64: torch.Tensor, seg: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """dropped_uniques for real segments past capacity.  The two reserved
    pseudo-segments — overlong poison (sent, sent-1), then dead filler
    (sent, sent) — sort last and are excluded."""
    n = k64.shape[0]
    s_poison = _first_key_geq(k64, SENT, SENT - 1)
    s_filler = _first_key_geq(k64, SENT, SENT)
    has_poison = (s_poison < s_filler).to(torch.int64)
    has_filler = (s_filler < n).to(torch.int64)
    n_real = seg[-1] + 1 - has_filler - has_poison
    return (n_real - capacity).clamp(min=0)


def _reserved(key_hi, key_lo):
    return (key_hi == SENT) & (key_lo >= SENT - 1)


def _build(key_hi, key_lo, pos_hi, pos_lo, count, count_hi, length,
           capacity: int, carry_du, carry_du_hi, carry_dc,
           carry_dc_hi) -> CountTable:
    """Sort rows by (key, first occurrence) and segment-reduce into a table."""
    k = _key64(key_hi, key_lo)
    p = _key64(pos_hi, pos_lo)
    order = _lexsort(k, p)
    k, p = k[order], p[order]
    c = _join64(count, count_hi)[order]
    length = length[order]
    n = k.shape[0]

    _, seg = _segment_boundaries(k)
    head = _segment_heads(seg, capacity)
    fi = head[:capacity].clamp(max=n - 1)
    csum = torch.cumsum(c, 0)

    def prefix(h):  # count sum over sorted rows [0, h)
        return torch.where(h > 0, csum[(h - 1).clamp(min=0)], 0)

    count_u = prefix(head[1:]) - prefix(head[:capacity])
    key_hi_u, key_lo_u = _unkey64(k[fi])
    occupied = (head[:capacity] < n) & (count_u > 0) \
        & ~_reserved(key_hi_u, key_lo_u)
    pos_hi_u, pos_lo_u = _unkey64(p[fi])
    count_u = torch.where(occupied, count_u, 0)
    du = _overflow_accounting(k, seg, capacity) \
        + _join64(carry_du, carry_du_hi)
    dc = csum[-1] - count_u.sum() + _join64(carry_dc, carry_dc_hi)
    du_lo, du_hi = _split64(du)
    dc_lo, dc_hi = _split64(dc)
    c_lo, c_hi = _split64(count_u)
    return CountTable(
        key_hi=torch.where(occupied, key_hi_u, SENT),
        key_lo=torch.where(occupied, key_lo_u, SENT),
        count=c_lo, count_hi=c_hi,
        pos_hi=torch.where(occupied, pos_hi_u, INF),
        pos_lo=torch.where(occupied, pos_lo_u, INF),
        length=torch.where(occupied, length[fi], 0),
        dropped_uniques=du_lo, dropped_count=dc_lo,
        dropped_uniques_hi=du_hi, dropped_count_hi=dc_hi)


def from_packed_rows(key_hi, key_lo, packed, total, capacity: int,
                     pos_hi, len_bits: int = 6, sort_mode: str = "sort3",
                     rescue_slots: int = 0, sort_impl: str = "xla",
                     radix_bits: int = 3, salt_bits: int = 0):
    """Aggregate pre-packed single-occurrence rows (the sort-lean path).

    ``packed`` = ``pos << len_bits | length`` per live row (all-ones for
    dead rows, which sort last).  ``sort_mode='sort3'`` sorts on
    ``(key, packed)``, so the smallest position leads each key's segment.
    ``'stable2'`` sorts on the key alone, stably: its precondition is that
    rows arrive in ascending position order (the kernel's flattened
    stream), so each segment's head row is the first occurrence.
    ``'segmin'`` sorts on the key alone (any order of ties) and takes the
    smallest ``packed`` of each segment with one ``scatter_reduce`` over
    the segment ranks; it has no rescue extraction and no radix seam.

    With ``rescue_slots = R > 0`` also returns the first R ``packed``
    values of the poison segment (reserved key (sent, sent-1), which sorts
    just before the dead filler): the overlong-end positions, smallest
    first, for :func:`mapreduce_tpu_torch.ops.rescue.rescue_table`.

    ``sort_impl`` 'radix_partition' / 'radix' sorts through
    :func:`mapreduce_tpu_torch.ops.cuda.radix.radix_sort3` (``radix_bits``
    per level), the 3-key sort with ties by ``packed``: sort3 outright, and
    the order stability gives under stable2's position-ordered input, so
    one branch serves both modes; under stable2 it is told so and skips its
    passes over ``packed``.

    With ``salt_bits`` = B > 0 (``combiner='salt'``) the low B position
    bits are XORed into ``key_lo`` before the sort, on every row whose
    ``key_hi`` is not the sentinel (filler and poison rows stay as they
    are, so the rescue extraction is unchanged): one hot key spreads over
    2**B segments.  Every row of a salted segment shares those position
    bits, so each kept row's own ``pos_lo`` undoes the XOR, and a
    capacity-sized :func:`_build` coalesces the salted entries of a key
    (counts add, the smallest position wins, ``dropped_*`` carried).  As
    in the JAX package, two distinct keys that differ by a salt XOR would
    coalesce (the 64-bit collision envelope, 2**B times wider), and under
    batch spill the capacity cutoff falls on the salted key order.
    """
    if sort_mode not in ("sort3", "stable2", "segmin"):
        raise ValueError(f"unknown sort_mode {sort_mode!r}")
    if salt_bits and sort_mode == "segmin":
        raise ValueError("salt_bits requires sort_mode='sort3' or 'stable2'")
    if not 0 <= salt_bits <= 6:
        raise ValueError(f"salt_bits must be in [0, 6], got {salt_bits}")
    if sort_impl not in ("xla", "radix", "radix_partition"):
        raise ValueError(f"unknown sort_impl {sort_impl!r}")
    if sort_impl != "xla" and sort_mode == "segmin":
        raise ValueError("sort_impl='radix'/'radix_partition' requires "
                         "sort_mode='sort3' or 'stable2' (segmin keeps "
                         "packed as an unordered payload)")
    if rescue_slots and sort_mode == "segmin":
        raise ValueError("rescue_slots requires sort_mode='sort3' or "
                         "'stable2' (poison extraction needs the poison "
                         "segment position-ordered)")
    n = key_hi.shape[0]
    if salt_bits:
        smask = (1 << salt_bits) - 1
        key_lo = torch.where(key_hi != SENT,
                             key_lo ^ ((packed >> len_bits) & smask), key_lo)
    if sort_impl != "xla":
        from mapreduce_tpu_torch.ops.cuda import radix as radix_ops

        key_hi, key_lo, packed = radix_ops.radix_sort3(
            key_hi, key_lo, packed, impl=sort_impl, bits=radix_bits,
            packed_ordered=sort_mode == "stable2")
        k = _key64(key_hi, key_lo)
    else:
        k = _key64(key_hi, key_lo)
        if sort_mode == "sort3":
            order = _lexsort(k, packed)
        else:
            order = torch.argsort(k, stable=sort_mode == "stable2")
        k, packed = k[order], packed[order]

    _, rank = _segment_boundaries(k)
    head = _segment_heads(rank, capacity)
    fi = head[:capacity].clamp(max=n - 1)
    count_u = head[1:] - head[:capacity]
    key_hi_u, key_lo_u = _unkey64(k[fi])
    if sort_mode == "segmin":
        # Segments past the capacity share one spare bucket.
        packed_u = packed.new_full((capacity + 1,), _ALL_ONES).scatter_reduce(
            0, rank.clamp(max=capacity), packed, "amin",
            include_self=False)[:capacity]
    else:
        packed_u = packed[fi]
    occupied = (head[:capacity] < n) & (count_u > 0) \
        & ~_reserved(key_hi_u, key_lo_u)
    count_u = torch.where(occupied, count_u, 0)
    pos_hi = _on_device(pos_hi, k.device)
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    table = CountTable(
        key_hi=torch.where(occupied, key_hi_u, SENT),
        key_lo=torch.where(occupied, key_lo_u, SENT),
        count=count_u, count_hi=torch.zeros_like(count_u),
        pos_hi=torch.where(occupied, pos_hi, INF),
        pos_lo=torch.where(occupied, packed_u >> len_bits, INF),
        length=torch.where(occupied, packed_u & ((1 << len_bits) - 1), 0),
        dropped_uniques=_overflow_accounting(k, rank, capacity),
        # Single-occurrence rows, <= 2**26 of them: the hi words are zero.
        dropped_count=total - count_u.sum(),
        dropped_uniques_hi=zero, dropped_count_hi=zero)
    if salt_bits:
        live = table.key_hi != SENT
        table = _build(
            table.key_hi,
            torch.where(live, table.key_lo ^ (table.pos_lo & smask),
                        table.key_lo),
            table.pos_hi, table.pos_lo, table.count, table.count_hi,
            table.length, capacity, table.dropped_uniques,
            table.dropped_uniques_hi, table.dropped_count,
            table.dropped_count_hi)
    if not rescue_slots:
        return table
    # The poison segment is position-ordered (third key under sort3, input
    # order under stable2).  A slice that runs past it picks up filler or,
    # clamped at the array end, real rows: both carry nonzero length bits,
    # which the rescue masks off.
    r = min(rescue_slots, n)
    start = torch.clamp(_first_key_geq(k, SENT, SENT - 1), max=n - r)
    idx = start + torch.arange(r, dtype=torch.int64, device=k.device)
    return table, packed[idx]


def from_stream(stream, capacity: int, pos_hi=0,
                max_token_bytes: int | None = None,
                max_pos: int | None = None, sort_mode: str = "sort3",
                rescue_slots: int = 0, sort_impl: str = "xla",
                radix_bits: int = 3, salt_bits: int = 0):
    """Aggregate a token stream into a fresh table.

    When ``max_token_bytes <= 63`` and ``max_pos <= 2**26`` the packed fast
    path (:func:`from_packed_rows`) runs; a stream that carries ``packed``
    and ``total`` (the kernel's) feeds them straight in.  Otherwise the
    generic 4-key build runs, which has no poison rows (``rescue_slots``
    must be 0) and where ``sort_impl``, ``sort_mode`` and ``salt_bits`` do
    not apply, as in the JAX package.
    """
    if (max_token_bytes is not None and max_token_bytes <= 63
            and max_pos is not None and max_pos <= (1 << 26)):
        return _from_stream_packed(stream, capacity, pos_hi, sort_mode,
                                   rescue_slots, sort_impl, radix_bits,
                                   salt_bits)
    if rescue_slots:
        raise ValueError("rescue_slots requires the packed fast path "
                         "(bounded max_token_bytes/max_pos)")
    ph = torch.where(stream.count > 0,
                     _on_device(pos_hi, stream.count.device), INF)
    z = torch.zeros((), dtype=torch.int64, device=stream.count.device)
    return _build(stream.key_hi, stream.key_lo, ph, stream.pos, stream.count,
                  torch.zeros_like(stream.count), stream.length, capacity,
                  z, z, z, z)


def _from_stream_packed(stream, capacity: int, pos_hi, sort_mode: str,
                        rescue_slots: int, sort_impl: str, radix_bits: int,
                        salt_bits: int):
    packed = getattr(stream, "packed", None)
    if packed is None:
        packed = torch.where(stream.count > 0,
                             (stream.pos << 6) | stream.length, _ALL_ONES)
    total = getattr(stream, "total", None)
    if total is None:
        total = stream.count.sum()
    return from_packed_rows(stream.key_hi, stream.key_lo, packed, total,
                            capacity, pos_hi, len_bits=6, sort_mode=sort_mode,
                            rescue_slots=rescue_slots, sort_impl=sort_impl,
                            radix_bits=radix_bits, salt_bits=salt_bits)


def merge(a: CountTable, b: CountTable, capacity: int | None = None,
          c: CountTable | None = None) -> CountTable:
    """Associative, commutative merge of two (or three) tables.

    Keys are unique within each input, so after one (key, position) sort a
    key's run holds at most two rows (three with ``c``): the head row
    absorbs its followers' counts and keeps the first occurrence, the
    followers turn into holes, and a second sort on the key moves the holes
    to the tail.  The first ``capacity`` rows are the result; spill drops
    the largest keys and is accounted in ``dropped_*``.
    """
    tables = [a, b] + ([c] if c is not None else [])
    cap = capacity if capacity is not None else max(t.capacity for t in tables)

    def cat(f):
        return torch.cat([getattr(t, f) for t in tables])

    k = _key64(cat("key_hi"), cat("key_lo"))
    p = _key64(cat("pos_hi"), cat("pos_lo"))
    order = _lexsort(k, p)
    k, p = k[order], p[order]
    cnt = _join64(cat("count"), cat("count_hi"))[order]
    length = cat("length")[order]

    eq_next = k[1:] == k[:-1]
    no = eq_next.new_zeros(1)
    follower = torch.cat([no, eq_next])  # same key as the previous row
    has_next = torch.cat([eq_next, no])  # the next row is my follower
    head = ~follower & (k != _K_SENT) & (cnt > 0)
    folded = cnt + torch.where(has_next, torch.cat([cnt[1:], cnt.new_zeros(1)]), 0)
    if c is not None:
        # A key can run three rows: the head also absorbs row head+2.
        has_next2 = torch.cat([eq_next[1:] & eq_next[:-1], eq_next.new_zeros(2)])
        folded = folded + torch.where(
            has_next2, torch.cat([cnt[2:], cnt.new_zeros(2)]), 0)
    k_m = torch.where(head, k, _K_SENT)
    order = torch.argsort(k_m, stable=True)
    k_s = k_m[order]
    count_s = torch.where(head, folded, 0)[order]
    p_s = torch.where(head, p, _K_SENT)[order]
    len_s = torch.where(head, length, 0)[order]
    n = k_s.shape[0]
    if n < cap:  # explicit capacity above the inputs' sum: pad with holes
        pad = cap - n
        k_s = torch.cat([k_s, k_s.new_full((pad,), _K_SENT)])
        count_s = torch.cat([count_s, count_s.new_zeros(pad)])
        p_s = torch.cat([p_s, p_s.new_full((pad,), _K_SENT)])
        len_s = torch.cat([len_s, len_s.new_zeros(pad)])
    kept = count_s[:cap]
    spilled_uniques = (head.sum() - cap).clamp(min=0)
    du = spilled_uniques
    dc = cnt.sum() - kept.sum()
    for t in tables:  # every input's carried accounting folds in
        du = du + _join64(t.dropped_uniques, t.dropped_uniques_hi)
        dc = dc + _join64(t.dropped_count, t.dropped_count_hi)
    key_hi, key_lo = _unkey64(k_s[:cap])
    pos_hi, pos_lo = _unkey64(p_s[:cap])
    c_lo, c_hi = _split64(kept)
    du_lo, du_hi = _split64(du)
    dc_lo, dc_hi = _split64(dc)
    return CountTable(key_hi=key_hi, key_lo=key_lo, count=c_lo, count_hi=c_hi,
                      pos_hi=pos_hi, pos_lo=pos_lo, length=len_s[:cap],
                      dropped_uniques=du_lo, dropped_count=dc_lo,
                      dropped_uniques_hi=du_hi, dropped_count_hi=dc_hi)


def merge_batched(table: CountTable, pend_key_hi, pend_key_lo, pend_count,
                  pend_pos_hi, pend_pos_lo, pend_length,
                  capacity: int) -> CountTable:
    """Fold up to K staged batch tables (``Config.merge_every``) and the
    running table in one build: the staged rows (flushed slots carry the
    sentinel key and count 0, which the build ignores) go through one
    (key, position) sort and segment reduce with the table's.  The kept
    keys, counts, first occurrences and ``dropped_count`` equal K pairwise
    merges'; ``dropped_uniques`` can be tighter (a key that spilled in
    several batches counts once a flush), as in the JAX package.  The
    staged rows are batch-table rows, whose high count words are zero."""
    def cat(a, b):
        return torch.cat([a, b])

    return _build(cat(table.key_hi, pend_key_hi),
                  cat(table.key_lo, pend_key_lo),
                  cat(table.pos_hi, pend_pos_hi),
                  cat(table.pos_lo, pend_pos_lo),
                  cat(table.count, pend_count),
                  cat(table.count_hi, torch.zeros_like(pend_count)),
                  cat(table.length, pend_length),
                  capacity, table.dropped_uniques, table.dropped_uniques_hi,
                  table.dropped_count, table.dropped_count_hi)


def top_k(table: CountTable, k: int) -> CountTable:
    """The k most frequent keys, as a count-descending table of capacity
    ``min(k, capacity)``; ties break by first occurrence.  A terminal op:
    evicted entries fold into ``dropped_*`` so ``total_count()`` stays
    exact."""
    cnt = _join64(table.count, table.count_hi)
    order = _lexsort(-cnt, _key64(table.pos_hi, table.pos_lo))[:k]
    kept = cnt[order]
    evicted_uniques = table.n_valid() - (kept > 0).sum()
    du = _join64(table.dropped_uniques, table.dropped_uniques_hi) \
        + evicted_uniques
    dc = _join64(table.dropped_count, table.dropped_count_hi) \
        + cnt.sum() - kept.sum()
    c_lo, c_hi = _split64(kept)
    du_lo, du_hi = _split64(du)
    dc_lo, dc_hi = _split64(dc)
    return CountTable(
        key_hi=table.key_hi[order], key_lo=table.key_lo[order],
        count=c_lo, count_hi=c_hi,
        pos_hi=table.pos_hi[order], pos_lo=table.pos_lo[order],
        length=table.length[order],
        dropped_uniques=du_lo, dropped_count=dc_lo,
        dropped_uniques_hi=du_hi, dropped_count_hi=dc_hi)


def kmv_snapshot(table: CountTable):
    """``(n_valid, kth_key_hi, kth_key_lo)`` of a key-sorted table, taken
    before a terminal :func:`top_k` reorder destroys the KMV property."""
    n_valid = table.n_valid()
    last = (n_valid - 1).clamp(min=0)
    return n_valid, table.key_hi[last], table.key_lo[last]


def kmv_from_snapshot(n_valid: int, kth_hi: int, kth_lo: int,
                      capacity: int) -> float | None:
    """Host-side k-minimum-values distinct estimate (None when the table
    was not full — distinct is exact then)."""
    if n_valid < capacity or n_valid < 2:
        return None
    kth = (int(kth_hi) << 32) | int(kth_lo)
    if kth <= 0:
        return None
    return (n_valid - 1) * float(1 << 64) / float(kth)


def kmv_distinct(table: CountTable) -> float | None:
    """Distinct-count estimate for a FULL table: spill drops the largest
    keys first, so a full table's keys are the ``capacity`` smallest key
    hashes ever seen — a k-minimum-values sketch with k = capacity."""
    n_valid, kth_hi, kth_lo = (int(x) for x in kmv_snapshot(table))
    if n_valid < 1:
        return None
    return kmv_from_snapshot(n_valid, kth_hi, kth_lo, table.capacity)
