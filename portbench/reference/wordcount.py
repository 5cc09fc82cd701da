"""The plain word count: what every word-count cell is held to.

Plain Python, with its own copy of the port's separator set: a token is a
maximal run of bytes outside ``SEPARATOR_BYTES``; the result is every
distinct token with its count, in the order of first occurrence, and the
total.  It imports nothing of the program, so nothing the program made
reaches it: it reads the corpus bytes the benchmark generated.

A reference file gives the harness (``cell.py``, ``control.py``):

- ``expected(part, listed)``: the answer for one job;
- ``readings(result, expected)``: the numbers compared, one job's;
- ``LIMITS``: each number's limit (0 is exact);
- ``CONTROLS``: ``name -> control(expected, run)``, each a result that
  breaks one guarantee the configuration states, where ``run(overrides)``
  runs the program's job with ``Config`` keys replaced.

The numbers, each the worst over the jobs compared:

  word_mismatch   positions whose word differs (a missing or extra word
                  counts once)
  count_mismatch  positions whose count differs, likewise
  total_gap       tokens counted minus the reference's total, absolute
  distinct_gap    distinct words reported minus the reference's, absolute
  dropped         tokens and distinct words reported as dropped (the
                  configuration guarantees exact counts: none may drop)
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple

#: NUL, TAB, LF, VT, FF, CR and space (``constants.SEPARATOR_BYTES``).
SEPARATOR_BYTES = (0x00, 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)

# bytes.split() with no argument splits on runs of ASCII whitespace (TAB,
# LF, VT, FF, CR, space); NUL is mapped onto a space first.
_TO_SPACE = bytes.maketrans(bytes(SEPARATOR_BYTES), b" " * len(SEPARATOR_BYTES))

#: Bytes the reference splits at once; a block ends at a separator.
BLOCK = 1 << 24

LIMITS = {"word_mismatch": 0, "count_mismatch": 0, "total_gap": 0,
          "distinct_gap": 0, "dropped": 0}


class Expected(NamedTuple):
    words: list  # bytes, in first-occurrence order
    counts: list
    total: int


def count(data: bytes) -> Counter:
    """Every token of ``data`` with its count, in first-occurrence order
    (a ``Counter`` keeps its keys in insertion order)."""
    counts: Counter = Counter()
    start = 0
    while start < len(data):
        end = min(start + BLOCK, len(data))
        while end < len(data) and data[end] not in SEPARATOR_BYTES:
            end += 1  # never cut a token between two blocks
        counts.update(data[start:end].translate(_TO_SPACE).split())
        start = end
    return counts


def expected(part: bytes, listed: int) -> Expected:
    """The result of counting ``part`` listed ``listed`` times as one
    corpus (``part`` ends at a separator, so no token spans two listings)."""
    c = count(part)
    words = list(c)
    counts = [c[w] * listed for w in words]
    return Expected(words, counts, sum(counts))


def _mismatch(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def readings(result, exp: Expected) -> dict:
    """One job's numbers against the reference's answer."""
    return {
        "word_mismatch": _mismatch(list(result.words), exp.words),
        "count_mismatch": _mismatch(list(result.counts), exp.counts),
        "total_gap": abs(int(result.total) - exp.total),
        "distinct_gap": abs(int(result.distinct) - len(exp.words)),
        "dropped": int(result.dropped_count) + int(result.dropped_uniques),
    }


@dataclasses.dataclass
class Counted:
    """A control's result, as :func:`readings` reads it."""

    words: list
    counts: list
    total: int
    distinct: int
    dropped_count: int = 0
    dropped_uniques: int = 0


def unordered(exp: Expected, run) -> Counted:
    """The reference's own count with the words in byte order instead of
    first-occurrence order: a recovery that skips its ordering sort."""
    by_word = sorted(zip(exp.words, exp.counts))
    return Counted(words=[w for w, _ in by_word],
                   counts=[c for _, c in by_word], total=exp.total,
                   distinct=len(exp.words))


def rescue_off(exp: Expected, run):
    """The program with its overlong rescue switched off: words longer
    than the kernel's W = 32 bytes are dropped instead of counted."""
    return run({"rescue_overlong": 0})


CONTROLS = {"unordered": unordered, "rescue_off": rescue_off}
