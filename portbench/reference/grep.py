"""The plain grep task: what every grep cell is held to.

Plain Python, a ``bytes.find`` loop over the part: every overlapping
occurrence of the pattern, and each line that holds one (its bounds from
``rfind`` and ``find`` of LF) as a record without its LF, in file order.
It imports nothing of the program; see ``wordcount.py`` for what a
reference file gives the harness.

The numbers, each the worst over the jobs compared:

  record_mismatch  positions whose record differs (a missing or extra
                   record counts once)
  match_gap        occurrences reported minus the reference's, absolute
  line_gap         matching lines reported minus the reference's, absolute
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

#: The pattern of the Pavlo et al. grep task.
PATTERN = b"XYZ"

LIMITS = {"record_mismatch": 0, "match_gap": 0, "line_gap": 0}


class Expected(NamedTuple):
    records: list  # bytes: each matching line without its LF, file order
    matches: int  # overlapping occurrences
    lines: int  # matching lines


def scan(data: bytes, pattern: bytes = PATTERN) -> Expected:
    """The records and counts of one file's bytes."""
    records, matches = [], 0
    line_end = -1  # the end of the last record's line
    i = data.find(pattern)
    while i >= 0:
        matches += 1
        if i > line_end:  # the first occurrence in its line
            start = data.rfind(b"\n", 0, i) + 1
            line_end = data.find(b"\n", i)
            if line_end < 0:
                line_end = len(data)
            records.append(data[start:line_end])
        i = data.find(pattern, i + 1)
    return Expected(records, matches, len(records))


def expected(part: bytes, listed: int, pattern: bytes = PATTERN) -> Expected:
    """The answer for ``part`` listed ``listed`` times as one corpus (each
    listing a file: no line spans two)."""
    one = scan(part, pattern)
    return Expected(one.records * listed, one.matches * listed,
                    one.lines * listed)


def _mismatch(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def readings(result, exp: Expected) -> dict:
    """One job's numbers against the reference's answer."""
    return {
        "record_mismatch": _mismatch(list(result.records), exp.records),
        "match_gap": abs(int(result.matches) - exp.matches),
        "line_gap": abs(int(result.lines) - exp.lines),
    }


@dataclasses.dataclass
class Found:
    """A control's result, as :func:`readings` reads it."""

    records: list
    matches: int
    lines: int


def reordered(exp: Expected, run) -> Found:
    """The reference's own records in reverse: an answer out of file
    order."""
    return Found(exp.records[::-1], exp.matches, exp.lines)


def one_dropped(exp: Expected, run) -> Found:
    """The reference's own records with the last left out: a record lost
    at the stream's end."""
    return Found(exp.records[:-1], exp.matches, exp.lines)


CONTROLS = {"reordered": reordered, "one_dropped": one_dropped}
