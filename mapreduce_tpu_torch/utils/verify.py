"""Host-side exact recount verification: the hash-collision detection path.

Counterpart of :mod:`mapreduce_tpu.utils.verify` (the port's own copy: the
port imports nothing of the JAX package).

The device pipeline never materializes token strings: words are keyed by a
64-bit hash (two independent fmix32 lanes, length mixed — the by-construction
fix for the reference comparator's prefix-match defect, ``main.cu:57-67``).
Exactness therefore carries a quantified envelope: two DISTINCT words
colliding on all 64 key bits would be silently merged into one reported
entry (the identity reported is the first occurrence's; the count is the
sum).  The birthday bound puts the probability of ANY collision among n
distinct words at ~n^2 / 2^65:

  ======================  ========================
  distinct words n        P(any 64-bit collision)
  ======================  ========================
  1e6  (enwik8-scale)     ~3e-8
  1e8  (100 GB Zipf)      ~3e-4
  1e9  (Common-Crawl WET) ~3e-2
  ======================  ========================

At 100 GB scale the risk is real enough to want a detection path, not
just arithmetic.  This module is that path: recount a sample of reported words EXACTLY on the host — byte-string
keyed, no hashing anywhere — and compare.  A collision is visible as a
reported count exceeding the true count (the victim word's occurrences were
absorbed); a word whose identity was absorbed shows as a missing report,
caught when its absorber mismatches.  One streaming host pass over the
corpus per verification (chunked; memory is O(sample)).

CLI: ``--verify-sample K`` runs this after any word-count run and fails
loudly on mismatch.  Cost: one host-side pass over the corpus in Python:
a verification tool, not a hot path.
"""

from __future__ import annotations

import numpy as np

from mapreduce_tpu_torch import constants

_SEP_TABLE = np.zeros(256, dtype=np.bool_)
for _b in constants.SEPARATOR_BYTES:
    _SEP_TABLE[_b] = True


def recount_exact(paths, words: list[bytes],
                  chunk_bytes: int = 1 << 24) -> dict[bytes, int]:
    """Exact occurrence counts of ``words`` across ``paths``, host-side.

    Byte-string comparison only (dict keyed on the exact bytes): immune to
    any hashing the device pipeline does, which is the point.  Streams the
    files in ``chunk_bytes`` pieces with a carry for tokens spanning chunk
    boundaries; files are independent corpora (no token spans a file seam),
    matching the reader's semantics.
    """
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    targets = {w: 0 for w in words}
    for path in paths:
        carry = b""
        with open(path, "rb") as f:
            while True:
                block = f.read(chunk_bytes)
                if not block:
                    break
                buf = carry + block
                arr = np.frombuffer(buf, dtype=np.uint8)
                is_sep = _SEP_TABLE[arr]
                # Hold back the trailing unterminated token for the carry.
                last_sep = int(np.flatnonzero(is_sep)[-1]) + 1 \
                    if is_sep.any() else 0
                carry = buf[last_sep:]
                d = np.diff(np.concatenate(
                    [[True], is_sep[:last_sep], [True]]).astype(np.int8))
                starts = np.flatnonzero(d == -1)
                ends = np.flatnonzero(d == 1)
                for s, e in zip(starts, ends):
                    w = buf[s:e]
                    if w in targets:
                        targets[w] += 1
        if carry:
            w = bytes(carry)
            if w in targets:
                targets[w] += 1
    return targets


def verify_result(words: list[bytes], counts: list[int], paths,
                  sample: int = 64, seed: int = 0) -> list[tuple]:
    """Compare a run's reported (word, count) pairs against an exact host
    recount of a sample; return the mismatches as
    ``[(word, reported, true), ...]`` (empty = verified).

    The sample takes the highest-count words first (a collision's absorber
    carries the summed count, so heavy hitters are where absorbed mass is
    most visible) plus a uniform draw from the tail.

    Only ``reported > exact`` is flagged: that is the collision signature
    (absorbed occurrences inflate the absorber).  ``reported < exact`` is
    a legitimate documented envelope — rescue-budget overflow or
    table-capacity spill report partial counts with the remainder in
    ``dropped_*`` — and must not masquerade as corruption.
    """
    n = len(words)
    if n == 0:
        return []
    k = min(sample, n)
    by_count = sorted(range(n), key=lambda i: -counts[i])
    head = by_count[: k // 2]
    rng = np.random.default_rng(seed)
    tail_pool = by_count[k // 2:]
    tail = list(rng.choice(len(tail_pool), size=min(k - len(head),
                                                    len(tail_pool)),
                           replace=False)) if tail_pool else []
    idx = head + [tail_pool[int(i)] for i in tail]
    chosen = [words[i] for i in idx]
    true = recount_exact(paths, chosen)
    return [(words[i], counts[i], true[words[i]])
            for i in idx if counts[i] > true[words[i]]]
