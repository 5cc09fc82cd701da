"""N-gram formation over the kernel's token stream, and the seam carry.

Counterpart of :mod:`mapreduce_tpu.ops.ngram`.  The JAX package makes its
Pallas stream pairable with one sort of the ``packed`` plane (position in
the high bits), because its kernel emits in lane-column order.  The port's
kernel already emits ONE dense stream in global byte order
(:mod:`...ops.cuda.tokenize`): live rows ascending by the byte they end at,
then the one dead row.  For a token ``packed >> 6`` is its start and for a
poison row (a run longer than W) its last byte; runs never overlap, so end
order is start order and the cut stream IS the position-sorted one
(:func:`position_sorted`).  Gram formation is then an elementwise
shift-by-one over adjacent rows, iterated n-1 times.

Tokens longer than W are suppressed by the kernel, which leaves a poison
row at the end of each such run: the row sits between the suppressed
token's neighbours, so the pairing chain crosses a non-live row and the
phantom gram invalidates itself.  Grams containing a >W token are dropped
and accounted (``dropped_count`` exact through the closed-form gram total
``max(all_tokens - (n-1), 0)``, ``dropped_uniques`` an upper bound), as
the word count accounts overlong tokens.  The plain path
(:func:`...ops.tokenize.ngrams`) counts any token length.

Hashing is :func:`...ops.tokenize.mix_gram`, the composition of the plain
path and of the JAX package, so tables from every path merge
interchangeably.  The gram family takes no hot-key cache: deleting
duplicate tokens from the stream would break the adjacency grams are
formed from, so ``combiner='hot-cache'`` is a no-op here, as it is in the
JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
from mapreduce_tpu_torch.ops.tokenize import POS_INF, SENT, TokenStream

_ALL_ONES = 0xFFFFFFFF
SEAM_GRAM_LENGTH = int(constants.SEAM_GRAM_LENGTH)


def position_sorted(stream: kernel_tok.PackedTokenStream):
    """The kernel's stream in global token order: ``(key_hi, key_lo,
    packed)``, live rows (tokens and poison rows) first, ascending by
    position, then dead rows.

    The JAX package sorts its lane-ordered stream by ``packed`` to get
    this.  The port's dense stream is emitted in that order already (see
    the module docstring), so the stream cut to its ``live + 1`` rows is
    returned as it is; ``tests/test_torch_ngram.py`` holds it to the sort
    on overlong-adjacent cases."""
    if stream.live is not None:
        raise ValueError("cut the dense stream to its live rows first "
                         "(PackedTokenStream.cut)")
    return stream.key_hi, stream.key_lo, stream.packed


def grams_from_sorted(key_hi, key_lo, packed, n: int) -> TokenStream:
    """The n-gram stream of position-sorted token rows: adjacent rows are
    adjacent stream entries, so each extension step is an elementwise
    shift-by-one and :func:`...ops.tokenize.mix_gram`.  A poison row (zero
    length bits) holds its position slot but never starts or extends a
    gram."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    live = (packed != _ALL_ONES) & ((packed & 63) != 0)
    start = torch.where(live, packed >> 6, POS_INF)
    end = (packed >> 6) + (packed & 63)  # exclusive token end

    def shift(x, fill):
        return torch.cat([x.new_full((1,), fill), x[:-1]])

    g_hi, g_lo, g_pos, g_valid = key_hi, key_lo, start, live
    for _ in range(n - 1):
        p_valid = shift(g_valid, False)
        g_hi, g_lo = tok_ops.mix_gram(shift(g_hi, 0), shift(g_lo, 0),
                                      key_hi, key_lo)
        g_pos = shift(g_pos, POS_INF)
        g_valid = live & p_valid
    return TokenStream(
        key_hi=torch.where(g_valid, g_hi, SENT),
        key_lo=torch.where(g_valid, g_lo, SENT),
        count=g_valid.to(torch.int64),
        pos=torch.where(g_valid, g_pos, POS_INF),
        length=torch.where(g_valid, (end - g_pos) & tok_ops.MASK32, 0))


def mark_long_spans(stream: TokenStream) -> TokenStream:
    """The gram tables' length policy, the same on every path: spans
    under 127 bytes are stored exactly; longer ones (and exactly 127) store
    ``SEAM_GRAM_LENGTH`` and the host recovers the span by scanning n
    entries forward from its start (:func:`...data.reader.
    scan_gram_lengths`).  Separator runs between tokens are unbounded, so
    no span bound exists; the 7-bit cap is what lets :func:`gram_table` use
    the packed build."""
    long = (stream.count > 0) & (stream.length >= 127)
    return stream._replace(length=torch.where(long, SEAM_GRAM_LENGTH,
                                              stream.length))


def gram_table(gs: TokenStream, capacity: int, pos_hi, max_pos: int,
               sort_mode: str = "stable2", sort_impl: str = "xla",
               radix_bits: int = 3,
               salt_bits: int = 0) -> table_ops.CountTable:
    """Aggregate a position-ordered gram stream into a count table.

    Every path's gram stream arrives in ascending start order, the stable2
    precondition, so when every position fits 25 bits (chunks of at most
    32 MB) the build is the packed one with ``pos << 7 | min(span, 127)``
    (``len_bits=7``; 127 unpacks to ``SEAM_GRAM_LENGTH``), and
    ``sort_impl`` routes its sort as it does the word count's.  ``max_pos``
    is the padded chunk length, the bound on positions.  Past 2**25 the
    generic build runs, where ``sort_impl`` does not apply.  A live row
    cannot pack to all-ones: ``len7 == 127`` means a span of at least 127
    bytes, so its position is at most ``max_pos - 127``.  ``salt_bits``
    (``combiner='salt'``) salts the packed build as the word count's,
    with the position above the 7 length bits.
    """
    if max_pos > (1 << 25):
        return table_ops.from_stream(gs, capacity, pos_hi=pos_hi)
    live = gs.count > 0
    len7 = torch.clamp(gs.length, max=127)
    packed = torch.where(live, (gs.pos << 7) | len7, _ALL_ONES)
    t = table_ops.from_packed_rows(
        gs.key_hi, gs.key_lo, packed, gs.count.sum(), capacity, pos_hi,
        len_bits=7, sort_mode=sort_mode, sort_impl=sort_impl,
        radix_bits=radix_bits, salt_bits=salt_bits)
    return t._replace(length=torch.where(t.occupied() & (t.length == 127),
                                         SEAM_GRAM_LENGTH, t.length))


def _tokenize(chunk: torch.Tensor, config):
    """The configured kernel mode for grams: ``(stream, overlong)``.  The
    fused mode carries no cache for grams (module docstring); both modes
    are the one dense stream, launched under their own names."""
    w = config.pallas_max_token
    if config.map_impl == "fused":
        stream, overlong, _ = kernel_tok.tokenize_fused(chunk,
                                                        max_token_bytes=w)
        return stream, overlong
    return kernel_tok.tokenize_split(chunk, w)


def ngram_table(chunk: torch.Tensor, n: int, capacity: int, pos_hi, config,
                read=None) -> table_ops.CountTable:
    """One chunk's n-gram table on the kernel path (in-chunk grams only):
    see :func:`ngram_map_with_summary`."""
    return ngram_map_with_summary(chunk, n, capacity, pos_hi, config,
                                  read)[0]


def ngram_map_with_summary(chunk: torch.Tensor, n: int, capacity: int,
                           pos_hi, config, read=None):
    """``(table, ChunkSummary)`` of one chunk on the kernel path: one
    ``tokenize_stream`` launch, the live cut, the pairing, the packed gram
    build and the seam summary, sharing one stream.

    ``read(flags)`` is the chunk's one host read (a list; default a
    blocking ``tolist``): the token and overlong counts, which the cut
    needs.  The gram total, the grams the poison rows killed and the
    summary stay on the device.
    """
    stream, overlong = _tokenize(chunk, config)
    flags = torch.stack([stream.total, overlong])
    tokens_h, over_h = flags.tolist() if read is None else read(flags)
    all_tokens = tokens_h + over_h  # live rows: tokens and poison rows
    key_hi, key_lo, packed = position_sorted(stream.cut(all_tokens))
    gs = mark_long_spans(grams_from_sorted(key_hi, key_lo, packed, n))
    t = gram_table(gs, capacity, pos_hi, max_pos=int(chunk.shape[0]),
                   sort_mode=config.sort_mode, sort_impl=config.sort_impl,
                   radix_bits=config.resolved_geometry.radix_bits,
                   salt_bits=config.resolved_salt_bits)
    # The closed-form gram total counts overlong tokens too: whatever the
    # pairing did not form, a poison row killed.  Occurrences are exact;
    # distinct ones are unknowable (overlong tokens are never hashed), so
    # uniques get the word count's upper-bound treatment.
    missing = max(all_tokens - (n - 1), 0) - gs.count.sum()
    t = t._replace(dropped_uniques=t.dropped_uniques + missing,
                   dropped_count=t.dropped_count + missing)
    return t, summary_from_packed(key_hi, key_lo, packed, all_tokens, pos_hi,
                                  n)


# --- Exact cross-chunk grams: carry summaries + seam windows -----------------
#
# Grams whose tokens straddle a chunk join have no single chunk to form in.
# Each chunk's map also emits a tiny summary (its first and last up-to-(n-1)
# position-ordered stream entries, tokens and poison rows alike), and the
# job's combine composes them in chunk order, forming every window that
# crosses a join exactly once, at the join where its last token's chunk
# lands.  `compose_carry` keeps the last n-1 entries of a concatenation, so
# chunks with fewer than n-1 entries (even none) chain, and windows spanning
# three or more chunks complete at the right join.

KIND_EMPTY = 0  # unoccupied slot
KIND_TOKEN = 1  # real token entry
KIND_POISON = 2  # suppressed >W token: holds its slot, poisons windows


class GramCarry(NamedTuple):
    """Up to n-1 consecutive stream entries, int64 tensors of ``(n-1,)``
    holding uint32.  LEFT-aligned (a chunk's first entries, slot 0 the
    oldest) or RIGHT-aligned (the running carry, a chunk's last entries,
    slot n-2 the newest); empty slots have kind 0 and zeroed fields."""

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    chunk_id: torch.Tensor
    pos: torch.Tensor
    kind: torch.Tensor


class ChunkSummary(NamedTuple):
    """One chunk's seam view: its first entries (left-aligned) and its
    last entries (right-aligned)."""

    first: GramCarry
    last: GramCarry


def empty_carry(n: int, device=None) -> GramCarry:
    return GramCarry(*(torch.zeros((n - 1,), dtype=torch.int64,
                                   device=device) for _ in range(5)))


def chunk_summary(key_hi, key_lo, pos, poison, n_entries, chunk_id,
                  n: int) -> ChunkSummary:
    """The summary of a position-sorted stream whose first ``n_entries``
    rows are live (tokens and poison rows).  ``n_entries`` and
    ``chunk_id`` are host ints or 0-dim tensors; an int costs no copy to
    the card.  Poison rows are kept: an overlong token at a chunk edge
    must poison the cross-chunk windows as it does the in-chunk ones."""
    m = n - 1
    cap = key_hi.shape[0]
    k = torch.arange(m, dtype=torch.int64, device=key_hi.device)

    def mk(idx, valid):
        idx_c = idx.clamp(0, cap - 1)
        kind = torch.where(valid, torch.where(poison[idx_c], KIND_POISON,
                                              KIND_TOKEN), KIND_EMPTY)
        live = kind != KIND_EMPTY
        return GramCarry(key_hi=torch.where(live, key_hi[idx_c], 0),
                         key_lo=torch.where(live, key_lo[idx_c], 0),
                         chunk_id=torch.where(live, chunk_id, 0)
                         .to(torch.int64),
                         pos=torch.where(live, pos[idx_c], 0),
                         kind=kind)

    idx_l = k + (n_entries - m)
    return ChunkSummary(first=mk(k, k < n_entries),
                        last=mk(idx_l, idx_l >= 0))


def summary_from_packed(key_hi, key_lo, packed, n_entries, chunk_id,
                        n: int) -> ChunkSummary:
    """Kernel-path summary: the position-sorted packed rows in."""
    return chunk_summary(key_hi, key_lo, packed >> 6, (packed & 63) == 0,
                         n_entries, chunk_id, n)


def summary_from_stream(stream: TokenStream, chunk_id, n: int) -> ChunkSummary:
    """Plain-path summary: one single-key sort of the per-byte stream by
    position (non-tokens carry ``POS_INF`` and sink); no poison (the plain
    tokenizer hashes any token length)."""
    pos_key = torch.where(stream.count > 0, stream.pos, POS_INF)
    pos_s, order = torch.sort(pos_key, stable=True)
    return chunk_summary(stream.key_hi[order], stream.key_lo[order], pos_s,
                         torch.zeros_like(pos_s, dtype=torch.bool),
                         stream.count.sum(), chunk_id, n)


def compose_carry(carry: GramCarry, last: GramCarry) -> GramCarry:
    """Append a chunk's last entries to the running carry, keeping the n-1
    newest (right-aligned): ``sv`` new entries shift the old carry left by
    ``sv``, the sliding-window monoid's fold."""
    m = carry.kind.shape[0]
    sv = (last.kind != KIND_EMPTY).sum()
    k = torch.arange(m, dtype=torch.int64, device=carry.kind.device)
    take_new = k >= m - sv
    idx_old = (k + sv).clamp(0, m - 1)
    return GramCarry(*(torch.where(take_new, new, old[idx_old])
                       for old, new in zip(carry, last)))


def seam_gram_rows(prefix: GramCarry, first: GramCarry, n: int):
    """The windows crossing the join between ``prefix`` (right-aligned:
    every entry before this chunk) and this chunk's ``first`` entries.

    Returns ``(key_hi, key_lo, chunk_id, pos, count, dropped)``: n-1 rows,
    row j-1 the window that takes j entries from the left, and the count
    of windows dropped.  A window exists when all n slots are occupied
    (else it completes at a later join, or the corpus ends); it is counted
    when every entry is a token, else dropped.  Window j is slots
    ``m-j .. m-j+n-1`` of the concatenation ``prefix ++ first``, so all
    n-1 windows are formed at once, one gather and n-1 mixing steps."""
    m = n - 1
    dev = prefix.kind.device
    j = torch.arange(1, n, dtype=torch.int64, device=dev)
    idx = (m - j)[:, None] + torch.arange(n, dtype=torch.int64,
                                          device=dev)[None, :]
    cat = GramCarry(*(torch.cat([p, f])[idx] for p, f in zip(prefix, first)))
    occupied = (cat.kind != KIND_EMPTY).all(1)
    all_tok = (cat.kind == KIND_TOKEN).all(1)
    g_hi, g_lo = cat.key_hi[:, 0], cat.key_lo[:, 0]
    for t in range(1, n):
        g_hi, g_lo = tok_ops.mix_gram(g_hi, g_lo, cat.key_hi[:, t],
                                      cat.key_lo[:, t])
    counted = occupied & all_tok
    dropped = (occupied & ~all_tok).sum()
    return (torch.where(counted, g_hi, SENT),
            torch.where(counted, g_lo, SENT),
            torch.where(counted, cat.chunk_id[:, 0], POS_INF),
            torch.where(counted, cat.pos[:, 0], POS_INF),
            counted.to(torch.int64), dropped)


def seam_gram_table(prefix: GramCarry, first: GramCarry,
                    n: int) -> table_ops.CountTable:
    """The join's cross-chunk windows as a tiny mergeable table.  Entries
    carry ``SEAM_GRAM_LENGTH``: the span ends in a later chunk whose row
    base the device does not know, so the host scans it forward.  Dropped
    (poisoned) windows land in ``dropped_*``."""
    k_hi, k_lo, cid, pos, cnt, dropped = seam_gram_rows(prefix, first, n)
    length = torch.where(cnt > 0, SEAM_GRAM_LENGTH, 0)
    z = torch.zeros((), dtype=torch.int64, device=cnt.device)
    return table_ops._build(k_hi, k_lo, cid, pos, cnt, torch.zeros_like(cnt),
                            length, capacity=max(n - 1, 2),
                            carry_du=dropped, carry_du_hi=z,
                            carry_dc=dropped, carry_dc_hi=z)
