"""``zipf_vocabulary``: a text8-like stream on one line.

Every ``--seed`` gets the same work: exactly ``tokens`` tokens over
exactly ``distinct`` words, the count of rank r being
``1 + floor(K (r + q) ** -a)`` (K sets the total; the remainder goes to
the top ranks), and word lengths by rank that give exactly ``bytes``
bytes.  The seed picks the letters of each word and the order of the
tokens.  The stream is built in numpy: the words side by side in one
byte array, gathered in the shuffled order a block of tokens at a time.
"""

from __future__ import annotations

import numpy as np

from portbench.corpus import LETTERS, rng_for

#: Tokens gathered at once (bounds the index array to some 25 MB).
BLOCK_TOKENS = 1 << 20


def zipf_counts(spec: dict) -> np.ndarray:
    """Occurrences of each rank (int64[distinct]), summing to ``tokens``."""
    n, v = spec["tokens"], spec["distinct"]
    w = (np.arange(1, v + 1, dtype=np.float64) + spec["zipf_q"]) \
        ** -spec["zipf_a"]
    lo, hi = 0.0, float(n)
    for _ in range(100):  # the largest K whose counts fit the total
        k = (lo + hi) / 2
        if v + np.floor(k * w).sum() > n:
            hi = k
        else:
            lo = k
    c = 1 + np.floor(lo * w).astype(np.int64)
    c[: n - int(c.sum())] += 1
    return c


def zipf_lengths(spec: dict, counts: np.ndarray) -> np.ndarray:
    """Letters of each rank (int64[distinct]): ``len_a + len_b ln r`` with
    a fixed jitter, ``long_words`` of the rarest ranks from 33 to 64
    letters (past the kernel's 32-byte window), then the rarest ranks
    moved a letter at a time until the corpus is exactly ``bytes``."""
    v = len(counts)
    rng = rng_for(spec["layout_seed"])
    r = np.arange(1, v + 1, dtype=np.float64)
    length = np.rint(spec["len_a"] + spec["len_b"] * np.log(r)
                     + rng.integers(-1, 2, v)).astype(np.int64)
    np.clip(length, 1, spec["max_letters"], out=length)
    # A length class holds at most 26**L distinct words: the overflow of a
    # short class moves up by a letter.
    for n_letters in range(1, 5):
        members = np.flatnonzero(length == n_letters)
        length[members[26 ** n_letters:]] += 1
    rare = np.flatnonzero(counts == 1)
    long_ranks = rare[rng.choice(len(rare), spec["long_words"],
                                 replace=False)]
    length[long_ranks] = rng.integers(33, 65, spec["long_words"])
    excess = int((counts * (length + 1)).sum()) - spec["bytes"]
    adjustable = np.setdiff1d(rare, long_ranks)[::-1]  # rarest first
    adjustable = adjustable[length[adjustable] > 5]
    if abs(excess) > len(adjustable):
        raise ValueError(f"lengths miss the size by {excess} bytes")
    length[adjustable[:abs(excess)]] -= np.sign(excess)
    return length


def zipf_words(length: np.ndarray,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Distinct words of the given lengths, each followed by a space, side
    by side: ``(uint8 bytes, int64 offset of each word)``.  Within a length
    class, word i spells ``(perm[i] * 7919 + off) mod 26**L`` in base 26
    over its first 13 letters (a bijection, so no two collide) and random
    letters after them."""
    width = length + 1
    offset = np.cumsum(width) - width
    flat = np.full(int(width.sum()), ord(" "), np.uint8)
    for n_letters in np.unique(length):
        members = np.flatnonzero(length == n_letters)
        head = min(int(n_letters), 13)
        space = 26 ** head
        x = (rng.permutation(len(members)).astype(np.int64) * 7919
             + int(rng.integers(0, space))) % space
        digits = np.empty((len(members), int(n_letters)), np.uint8)
        for j in range(head):
            digits[:, j] = LETTERS[x % 26]
            x //= 26
        if n_letters > head:
            digits[:, head:] = LETTERS[rng.integers(
                0, 26, (len(members), int(n_letters) - head))]
        flat[offset[members][:, None] + np.arange(int(n_letters))] = digits
    return flat, offset


def generate(spec: dict, seed: int) -> bytes:
    counts = zipf_counts(spec)
    length = zipf_lengths(spec, counts)
    rng = rng_for(seed)
    flat, offset = zipf_words(length, rng)
    width = (length + 1).astype(np.int32)
    offset = offset.astype(np.int32)
    order = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    rng.shuffle(order)
    out = np.empty(spec["bytes"], np.uint8)
    at = 0
    for lo in range(0, len(order), BLOCK_TOKENS):
        ranks = order[lo:lo + BLOCK_TOKENS]
        n = width[ranks]
        starts = np.cumsum(n, dtype=np.int32) - n
        # Byte k of the block comes from flat[offset[rank] + k - start].
        src = np.repeat(offset[ranks] - starts, n)
        src += np.arange(len(src), dtype=np.int32)
        out[at:at + len(src)] = flat[src]
        at += len(src)
    if at != spec["bytes"]:
        raise AssertionError(f"{at} bytes, not {spec['bytes']}")
    return out.tobytes()
