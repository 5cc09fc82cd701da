"""Overlong-token rescue: exact counts for >W-byte tokens on the kernel path.

Counterpart of :mod:`mapreduce_tpu.ops.rescue`.  The kernel bounds its
lookback at W bytes; a longer run leaves a POISON row at its last byte, and
the aggregation sort hands the poison positions over pre-sorted
(``rescue_slots`` in :func:`...ops.table.from_packed_rows`).  Re-hashing one
bounded window ending at each poison position with the xla-backend
tokenizer (:func:`...ops.tokenize.segment_hashes`) recovers each token's
exact key, length and start; a tiny table of those rows merges into the
chunk's table.

Envelope, as in the JAX package: tokens longer than ``window - 1`` bytes
cannot be verified complete in the window and stay dropped-but-accounted,
and at most R poison rows per chunk are rescued, smallest positions first.
"""

from __future__ import annotations

import torch

from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops


def rescue_table(chunk: torch.Tensor, rescue_packed: torch.Tensor, w: int,
                 window: int, pos_hi) -> tuple[table_ops.CountTable,
                                               torch.Tensor]:
    """Build a count table of the rescued overlong tokens.

    Args:
      chunk: the uint8 chunk the poison positions index into.
      rescue_packed: int64[R] from the aggregation sort — poison rows
        (``last_byte << 6``, zero length bits) first, then any filler or
        real-token rows, which carry nonzero length bits and are masked off.
      w: the kernel's W — every true poison marks a run longer than w.
      window: lookback bound (tokens of length in (w, window-1] are
        rescued; longer ones stay accounted).
      pos_hi: the chunk id, so first-occurrence order stays global.

    Returns:
      ``(table, rescued)``: a capacity-R table of the rescued tokens and the
      number of occurrences rescued (int64 scalar).
    """
    n = chunk.shape[0]
    is_poison = (rescue_packed != 0xFFFFFFFF) & ((rescue_packed & 63) == 0)
    p = rescue_packed >> 6  # last byte of each run

    # Window i = chunk[p_i - window + 1 .. p_i], read from a front-padded
    # copy (PAD is a separator, so the synthetic prefix never extends a
    # run).  Dead slots index past the end; the clamp keeps the gather in
    # range and is_poison discards them.
    padded = torch.cat([chunk.new_zeros(window), chunk])
    offs = torch.arange(window, dtype=torch.int64, device=chunk.device)
    idx = (p[:, None] + 1 + offs).clamp(max=n + window - 1)
    windows = padded[idx]  # (R, window) uint8

    h1, h2, length, sep = tok_ops.segment_hashes(windows)
    h1, h2, length = h1[:, -1], h2[:, -1], length[:, -1]
    key_hi, key_lo = tok_ops.finalize_keys(h1, h2, length)
    # The last byte must end a token (a non-separator; the byte after it in
    # the chunk is the run's terminator).  length == window means the run
    # reaches the window start: possibly truncated, so it stays accounted.
    valid = is_poison & ~sep[:, -1] & (length < window) & (length > w)
    rescued = valid.sum()

    stream = tok_ops.TokenStream(
        key_hi=torch.where(valid, key_hi, table_ops.SENT),
        key_lo=torch.where(valid, key_lo, table_ops.SENT),
        count=valid.to(torch.int64),
        pos=torch.where(valid, p + 1 - length, table_ops.INF),
        length=torch.where(valid, length, 0),
    )
    # Generic build (lengths exceed the 6-bit packed bound); capacity R: at
    # most R distinct keys, so nothing can drop.
    return table_ops.from_stream(stream, rescue_packed.shape[0],
                                 pos_hi=pos_hi), rescued
