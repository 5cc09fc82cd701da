"""Boundary-aligned ingest: a file as a stream of token-aligned chunks.

Counterpart of the numpy path of :mod:`mapreduce_tpu.data.reader` (the JAX
package's native chunker is not used).  A row may only end at a separator
byte, so no token spans two chunks; a separator-free run longer than
``max_token_bytes`` is force-split at the ideal cut.  Every batch carries
the absolute file offset of its rows, so device positions map back to exact
byte ranges for string recovery.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from mapreduce_tpu_torch import constants

_SEP_LUT = np.zeros(256, dtype=bool)
_SEP_LUT[list(constants.SEPARATOR_BYTES)] = True


@dataclasses.dataclass(frozen=True)
class Batch:
    """One streaming step's input."""

    data: np.ndarray  # uint8[n_shards, chunk_bytes], zero-padded rows
    base_offsets: np.ndarray  # int64[n_shards], absolute offset of each row
    lengths: np.ndarray  # int64[n_shards], valid bytes per row
    step: int


def _aligned_cuts(buf: np.ndarray, n_shards: int, chunk_bytes: int,
                  max_token_bytes: int, at_eof: bool) -> list[int]:
    """Cut points (ascending, one per shard) so every row ends just after a
    separator, or at a force-split after ``max_token_bytes`` of unbroken
    token bytes.  Only the file's true end may cut unaligned."""
    is_sep = _SEP_LUT[buf]
    cuts = []
    prev = 0
    n = buf.shape[0]
    for _ in range(n_shards):
        ideal = min(prev + chunk_bytes, n)
        if ideal >= n and at_eof:
            cuts.append(n)
            prev = n
            continue
        lo = max(prev, ideal - max_token_bytes)
        hits = np.flatnonzero(is_sep[lo:ideal])
        cut = lo + int(hits[-1]) + 1 if hits.size else ideal
        cuts.append(cut)
        prev = cut
    return cuts


def iter_batches(path, n_shards: int, chunk_bytes: int,
                 max_token_bytes: int = 4096,
                 start_step: int = 0) -> Iterator[Batch]:
    """Stream a file as boundary-aligned ``[n_shards, chunk_bytes]``
    batches, numbering steps from ``start_step``."""
    total = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r") if total else None
    offset = 0
    step = start_step
    stride = n_shards * chunk_bytes
    while offset < total:
        raw = np.asarray(mm[offset: min(offset + stride, total)])
        cuts = _aligned_cuts(raw, n_shards, chunk_bytes, max_token_bytes,
                             at_eof=offset + raw.shape[0] >= total)
        data = np.zeros((n_shards, chunk_bytes), dtype=np.uint8)
        bases = np.empty((n_shards,), dtype=np.int64)
        lengths = np.empty((n_shards,), dtype=np.int64)
        prev = 0
        for i, cut in enumerate(cuts):
            data[i, : cut - prev] = raw[prev:cut]
            bases[i] = offset + prev
            lengths[i] = cut - prev
            prev = cut
        yield Batch(data=data, base_offsets=bases, lengths=lengths, step=step)
        offset += cuts[-1]
        step += 1


def iter_batches_multi(paths, n_shards: int, chunk_bytes: int,
                       max_token_bytes: int = 4096) -> Iterator[Batch]:
    """Stream several files as one corpus.  Offsets are virtual (positions
    in the concatenation of the files); a file's end is a hard token
    boundary; step numbering continues across files."""
    if isinstance(paths, (str, bytes, os.PathLike)):
        paths = [paths]
    step = 0
    file_start = 0
    for path in paths:
        for b in iter_batches(path, n_shards, chunk_bytes,
                              max_token_bytes=max_token_bytes,
                              start_step=step):
            yield dataclasses.replace(b, base_offsets=b.base_offsets
                                      + file_start)
            step = b.step + 1
        file_start += os.path.getsize(path)


def read_words_at(path, spans: list[tuple[int, int]]) -> list[bytes]:
    """Exact bytes for ``(absolute_offset, length)`` spans of one file."""
    if not spans:
        return []
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return [bytes(mm[off: off + ln]) for off, ln in spans]


def read_words_at_multi(paths, spans: list[tuple[int, int]]) -> list[bytes]:
    """:func:`read_words_at` over a multi-file corpus (virtual offsets)."""
    if isinstance(paths, (str, bytes, os.PathLike)):
        return read_words_at(paths, spans)
    if not spans:
        return []
    starts = np.cumsum([0] + [os.path.getsize(p) for p in paths])
    offs = np.asarray([s[0] for s in spans], dtype=np.int64)
    file_idx = np.searchsorted(starts, offs, side="right") - 1
    out: list[bytes] = [b""] * len(spans)
    for k in np.unique(file_idx):
        group = np.flatnonzero(file_idx == k)
        local = [(int(offs[g] - starts[k]), spans[g][1]) for g in group]
        for g, word in zip(group, read_words_at(paths[k], local)):
            out[g] = word
    return out
