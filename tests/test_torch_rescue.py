"""The port's overlong rescue against the JAX package's, on the CPU.

``rescue_table`` re-hashes a bounded window ending at each poison position
(the last byte of a run longer than the kernel's W).  The same chunk and
the same ``rescue_packed`` slice go to both packages; the rescue tables and
the rescued counts must be equal field by field.  Integer hashing and
counting only: exact comparisons, tolerance zero.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mapreduce_tpu.ops import rescue as jrescue
from mapreduce_tpu_torch.ops import rescue as rescue_ops
from mapreduce_tpu_torch.ops import table as tbl

W = 8
WINDOW = 48
SENT = 0xFFFFFFFF

_jax_rescue = jax.jit(jrescue.rescue_table, static_argnames=("w", "window"))


@functools.lru_cache(maxsize=None)
def _chunk(seed: int) -> bytes:
    """Words of every length class: <= W, in (W, WINDOW-1], >= WINDOW, a
    run at the chunk start and one running to the chunk end."""
    rng = np.random.default_rng(seed)
    words = [b"ab", b"x" * W, b"y" * (W + 1), b"long%05d" % 7 * 3,
             b"z" * (WINDOW - 1), b"q" * WINDOW, b"r" * (3 * WINDOW)]
    body = b" ".join(words[int(i)] for i in rng.integers(0, len(words), 300))
    return b"s" * (W + 5) + b" " + body + b" " + b"t" * (W + 3)


def _poison_positions(data: bytes) -> list[int]:
    """Last byte of every run longer than W (what the kernel poisons)."""
    out, run = [], 0
    for i, b in enumerate(data + b" "):
        if b in b" \t\n\r\x0b\x0c\x00":
            if run > W:
                out.append(i - 1)
            run = 0
        else:
            run += 1
    return out


def _rescue_packed(data: bytes, r: int, seed: int) -> np.ndarray:
    """The aggregation sort's slice: poisons (smallest first), then filler
    and a real-token row, which carry nonzero length bits."""
    rng = np.random.default_rng(seed)
    poison = [p << 6 for p in _poison_positions(data)][:r]
    rest = [SENT] * (r - len(poison))
    if rest:
        rest[-1] = (int(rng.integers(0, len(data))) << 6) | 3
    return np.array(poison + rest, dtype=np.uint32)


@pytest.mark.parametrize("r", [16, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_rescue_table_matches_jax(r, seed):
    data = _chunk(seed)
    packed = _rescue_packed(data, r, seed)
    assert (packed & 63 == 0).sum() == min(r, len(_poison_positions(data)))
    chunk = np.frombuffer(data, np.uint8)
    want, want_n = _jax_rescue(chunk, packed, w=W, window=WINDOW, pos_hi=5)
    got, got_n = rescue_ops.rescue_table(
        torch.from_numpy(chunk.copy()), torch.from_numpy(packed.astype(np.int64)),
        W, WINDOW, 5)
    assert int(want_n) == int(got_n) > 0
    for f in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).astype(np.uint32),
            getattr(got, f).numpy().astype(np.uint32), err_msg=f)


def test_rescued_lengths_stay_in_the_window():
    data = _chunk(0)
    packed = _rescue_packed(data, 512, 0)
    got, rescued = rescue_ops.rescue_table(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
        torch.from_numpy(packed.astype(np.int64)), W, WINDOW, 0)
    occ = got.occupied()
    lengths = got.length[occ]
    assert torch.all((lengths > W) & (lengths < WINDOW))
    # Runs of WINDOW bytes or more cannot be verified complete: not rescued.
    n_long = sum(1 for p in _poison_positions(data)
                 if data[max(0, p - WINDOW + 1):p + 1].count(b" ") == 0
                 and p >= WINDOW - 1)
    assert int(rescued) == len(_poison_positions(data)) - n_long
    assert int(tbl.sum64(got.count)[0]) == int(rescued)
