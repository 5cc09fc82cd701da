"""The Pavlo et al. grep task's records (SIGMOD 2009, section 4.2.1): a
unique 10-byte key and a 90-byte random value a record,
``key<TAB>value<LF>``, with the pattern planted in one record in
``one_in``.  The spec's ``bytes`` states the part's size, which the
records and their widths must give.

Record ``i``'s key is ``i`` as ``key_bytes`` zero-padded digits, so keys
are unique and hold no letter.  A value is ``value_bytes`` uniform draws
from the 62 letters and digits less the pattern's first byte, so no
occurrence appears by chance.  In each block of ``one_in`` records one
record, drawn from the seed, gets the pattern at a seeded offset of its
value: exactly ``records // one_in`` records match, each once.
Vectorised numpy, ``BLOCK_ROWS`` records at a time; a value's bytes are
drawn two at a time from one table lookup.
"""

from __future__ import annotations

import numpy as np

from portbench.corpus import rng_for

ALNUM = b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

#: Records made at once.
BLOCK_ROWS = 1 << 18

#: Every 4-digit group, ``[10000, 4]`` ASCII digits.
_GROUPS = np.frombuffer(b"".join(b"%04d" % i for i in range(10000)),
                        np.uint8).reshape(10000, 4)


def alphabet(pattern: bytes) -> np.ndarray:
    """The values' bytes: the letters and digits without ``pattern[0]``."""
    return np.frombuffer(ALNUM.replace(pattern[:1], b""), np.uint8)


def pair_table(alpha: np.ndarray) -> np.ndarray:
    """uint16 ``r`` -> two bytes of ``alpha`` (as one little-endian
    uint16), uniform over the pairs for every ``r`` below the table's
    length, the largest multiple of ``len(alpha) ** 2`` in 2**16."""
    k = alpha.shape[0]
    r = np.arange(2**16 - 2**16 % (k * k))
    return (alpha[r % k].astype(np.uint16)
            | (alpha[r // k % k].astype(np.uint16) << 8))


def uniform_pairs(rng: np.random.Generator, m: int,
                  table: np.ndarray) -> np.ndarray:
    """``2 m`` uniform draws of the table's alphabet as uint8: random
    uint16 words below the table's length, looked up two bytes at once."""
    parts, have = [], 0
    while have < m:
        words = (m - have) * 53 // 100 + 64  # ~1.04 words a pair needed
        r = rng.integers(0, 2**32, size=words, dtype=np.uint32) \
            .view(np.uint16)
        r = r[r < table.shape[0]]
        parts.append(r)
        have += r.shape[0]
    return table[np.concatenate(parts)[:m]].view(np.uint8)


def keys(lo: int, hi: int, width: int) -> np.ndarray:
    """``[hi - lo, width]`` ASCII digits of the record indices, zero-padded,
    four digits a gather."""
    out = np.empty((hi - lo, -(-width // 4) * 4), np.uint8)
    index = np.arange(lo, hi, dtype=np.int64)
    for g in range(out.shape[1] // 4 - 1, -1, -1):
        out[:, 4 * g:4 * g + 4] = _GROUPS[index % 10000]
        index //= 10000
    if np.any(index):
        raise ValueError(f"record index {hi - 1} has more than {width} "
                         "digits")
    return out[:, out.shape[1] - width:]


def generate(spec: dict, seed: int) -> bytes:
    n, one_in = spec["records"], spec["one_in"]
    kb, vb = spec["key_bytes"], spec["value_bytes"]
    pattern = spec["pattern"].encode()
    if n % one_in or len(pattern) > vb:
        raise ValueError("records must be a multiple of one_in, and the "
                         "pattern must fit a value")
    if spec["bytes"] != n * (kb + vb + 2):
        raise ValueError(f"bytes must be records x {kb + vb + 2} (a key, "
                         "TAB, a value and LF a record)")
    if vb % 2:
        raise ValueError("value_bytes must be even (values are drawn two "
                         "bytes at a time)")
    rng = rng_for(seed)
    table = pair_table(alphabet(pattern))
    out = np.empty((n, kb + vb + 2), np.uint8)
    out[:, kb] = ord("\t")
    out[:, -1] = ord("\n")
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(n, lo + BLOCK_ROWS)
        out[lo:hi, :kb] = keys(lo, hi, kb)
        out[lo:hi, kb + 1:kb + 1 + vb] = uniform_pairs(
            rng, (hi - lo) * vb // 2, table).reshape(hi - lo, vb)
    blocks = n // one_in
    rows = np.arange(blocks, dtype=np.int64) * one_in \
        + rng.integers(0, one_in, blocks)
    at = kb + 1 + rng.integers(0, vb - len(pattern) + 1, blocks)
    out[rows[:, None], at[:, None] + np.arange(len(pattern))] = \
        np.frombuffer(pattern, np.uint8)
    return out.tobytes()
