"""Pure-Python reference implementations ("oracles") for tests.

The reference repo has no tests (SURVEY §4); its implied methodology is one
manual golden run over ``test.txt``.  We instead check every device path
against these host oracles, which implement the *intended* semantics of the
reference (whitespace-split word count, insertion-ordered report,
``main.cu:187-218``) without its defects (prefix compare, capacity overflows).
"""

from __future__ import annotations

from mapreduce_tpu_torch import constants

_SEPARATORS = bytes(constants.SEPARATOR_BYTES)


def split_words(data: bytes) -> list[bytes]:
    """All tokens in order, splitting on the framework's separator set."""
    out = []
    word = bytearray()
    for b in data:
        if b in _SEPARATORS:
            if word:
                out.append(bytes(word))
                word = bytearray()
        else:
            word.append(b)
    if word:
        out.append(bytes(word))
    return out


def word_counts(data: bytes) -> dict[bytes, int]:
    """Insertion-ordered {word: count} — the golden semantics (SURVEY §2)."""
    counts: dict[bytes, int] = {}
    for w in split_words(data):
        counts[w] = counts.get(w, 0) + 1
    return counts


def total_count(data: bytes) -> int:
    return len(split_words(data))
