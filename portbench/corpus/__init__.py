"""The benchmark's corpus generators, one file a kind.

A configuration's ``corpus`` object names a ``kind``; :func:`generate`
makes that corpus's part from ``--seed`` with ``corpus/<kind>.py``'s
``generate(spec, seed) -> bytes``.  A generator imports numpy alone and
nothing of the program: the program only ever sees the bytes.
"""

from __future__ import annotations

import importlib

import numpy as np

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole number (negative ones wrap to 64 bits)."""
    return np.random.default_rng(int(seed) & (2**64 - 1))


def generate(spec: dict, seed: int) -> bytes:
    """The part that ``spec`` (a configuration's ``corpus``) describes.
    It ends at a separator, so no token spans two listings of it."""
    kind = importlib.import_module(f"portbench.corpus.{spec['kind']}")
    data = kind.generate(spec, seed)
    if data[-1:] not in (b" ", b"\n"):
        raise AssertionError("a part must end at a separator")
    return data
