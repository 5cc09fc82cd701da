"""The port's tokenizers against the JAX package's, on the CPU.

* ``mapreduce_tpu_torch.ops.tokenize.tokenize`` (the ``xla`` backend and
  the rescue's re-hasher) against ``mapreduce_tpu.ops.tokenize.tokenize``,
  field by field.
* The port's K1 (``ops/cuda/tokenize.py``; on a CPU tensor its plain
  PyTorch version runs) against the Pallas ``_tokenize_kernel`` in interpret
  mode.  The two layouts differ, so the contract is the stream's: the same
  multiset of ``(key_hi, key_lo, packed)`` rows, poison rows included (the
  JAX column stream plus its seam stream), the same ``overlong`` and token
  totals, the port's single dense stream in global byte order with one dead
  row at index ``live`` and no spill.

Everything here is integer hashing and counting: every comparison is exact,
as uint32 or int64, with tolerance zero.  Inputs come from a seeded numpy
generator.
"""

import ast
import functools

import jax
import numpy as np
import pytest
import torch

from mapreduce_tpu.ops import tokenize as jtok
from mapreduce_tpu.ops.pallas import tokenize as ptok
from mapreduce_tpu_torch.ops import tokenize as tok
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok

W = 8  # small lookback: overlong cases stay cheap
N = 16384  # one buffer size, so the interpreted JAX kernel compiles once
ONES = 0xFFFFFFFF


def _zipf_text(seed: int, n: int = N) -> bytes:
    rng = np.random.default_rng(seed)
    words = [f"w{i:x}" for i in range(300)] + ["abcdefg", "abcdefgh"]
    seps = [" ", "\n", "\t", "  ", " \r\n"]
    parts = []
    while sum(map(len, parts)) < n:
        parts.append(words[int(rng.zipf(1.3)) % len(words)])
        parts.append(seps[int(rng.integers(0, len(seps)))])
    return "".join(parts).encode()[:n]


_RUNS = [W - 1, W, W + 1, 3 * W]
# Where a run sits against a window edge e of the port's kernel: its last
# byte just before e, its last byte at e, its first byte at e, across e.
_PLACES = [lambda e, r: e - r, lambda e, r: e - r + 1, lambda e, r: e,
           lambda e, r: e - r // 2]
_COMBOS = [(r, p) for r in _RUNS for p in _PLACES]


def _edge_runs(part: int) -> bytes:
    """Runs of W-1, W, W+1 and 3W bytes at the chunk start, at the chunk
    end and across the port kernel's window edges (five edges per buffer,
    so ``part`` picks which run/placement pairs this buffer holds)."""
    buf = bytearray((b"ab cd " * (N // 6 + 1))[:N])
    start_run = _RUNS[part % len(_RUNS)]
    buf[0:start_run] = b"s" * start_run
    buf[start_run] = 0x20
    edges = range(ktok.WINDOW, N - 64, ktok.WINDOW)
    for edge, (run, place) in zip(edges, _COMBOS[5 * part:]):
        start = place(edge, run)
        buf[start - 1] = 0x20
        buf[start:start + run] = b"x" * run
        buf[start + run] = 0x20
    end_run = _RUNS[-1 - part % len(_RUNS)]
    buf[N - end_run - 1] = 0x20
    buf[N - end_run:] = b"e" * end_run
    return bytes(buf)


CASES = {
    "zipf": lambda: _zipf_text(1),
    "edges0": lambda: _edge_runs(0),
    "edges1": lambda: _edge_runs(1),
    "edges2": lambda: _edge_runs(2),
    "dense": lambda: b"a " * (N // 2),  # one-letter tokens: the most rows
    "separators": lambda: b" \n\t\r" * (N // 4),  # no row at all
    # Overlong runs close the buffer: its last live rows are poisons.
    "poison_end": lambda: (b"ab cd " * N)[:N - 3 * W - 2] + b" "
    + b"p" * (W + 1) + b" " + b"q" * (2 * W - 1),
}
EDGES = ["edges0", "edges1", "edges2"]


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).reshape(-1)


def _rows(khi, klo, packed) -> list:
    """Sorted live rows of a stream (dead filler has all-ones packed)."""
    khi, klo, packed = _u32(khi), _u32(klo), _u32(packed)
    live = packed != ONES
    return sorted(zip(khi[live].tolist(), klo[live].tolist(),
                      packed[live].tolist()))


def _seam_rows(seam) -> list:
    """The JAX seam stream's rows, packed as ``concat_streams`` packs them."""
    count, pos, length = _u32(seam.count), _u32(seam.pos), _u32(seam.length)
    tok_row = count > 0
    poison = ~tok_row & (pos != ONES)
    packed = np.where(tok_row, (pos << 6) | length,
                      np.where(poison, pos << 6, ONES))
    return _rows(seam.key_hi, seam.key_lo, packed)


# One jitted program for every case: eager dispatch of the seam pass
# costs seconds per call on the CPU.
_jax_compact = jax.jit(functools.partial(
    ptok.tokenize_split_compact, compact_slots=128, max_token_bytes=W,
    block_rows=384, interpret=True, lane_major=True))


@functools.lru_cache(maxsize=None)
def _jax_streams(case: str):
    """(rows, overlong, ntok, spill) of the Pallas kernel's compact
    lane-major mode in interpret mode, seam stream included.  At this
    buffer size a lane segment is shorter than one kernel window, so it
    never spills and its rows are the complete stream."""
    buf = np.frombuffer(CASES[case](), np.uint8)
    col, seam, over, spill = _jax_compact(buf)
    rows = _rows(col.key_hi, col.key_lo, col.packed) + _seam_rows(seam)
    ntok = int(col.total) + int(np.asarray(seam.count).sum())
    return sorted(rows), int(over), ntok, int(spill)


def _port(case: str, mode: str):
    """The port's stream of a case, cut to its live rows and dead row."""
    data = torch.from_numpy(np.frombuffer(CASES[case](), np.uint8).copy())
    if mode == "compact":
        stream, over, spill = ktok.tokenize_split_compact(data, W)
    elif mode == "fused":
        stream, over, spill = ktok.tokenize_fused(data, max_token_bytes=W)
    else:
        (stream, over), spill = ktok.tokenize_split(data, W), 0
    return stream.cut(), int(over), int(spill)


@pytest.mark.parametrize("case", ["zipf", *EDGES, "dense", "separators",
                                  "poison_end"])
@pytest.mark.parametrize("mode", ["compact", "pair"])
def test_kernel_rows_match_pallas(case, mode):
    j_rows, j_over, j_ntok, j_spill = _jax_streams(case)
    assert j_spill == 0
    stream, over, spill = _port(case, mode)
    assert (over, spill) == (j_over, 0)
    assert int(stream.total) == j_ntok
    assert _rows(stream.key_hi, stream.key_lo, stream.packed) == j_rows


@pytest.mark.parametrize("case", ["zipf", *EDGES, "poison_end"])
def test_overlong_runs_present(case):
    """The edge corpora do hold overlong runs (poison rows) and W-byte
    tokens; the Zipf corpus holds tokens of exactly W bytes; the last
    buffer ends in two overlong runs."""
    rows, over, _, _ = _jax_streams(case)
    lengths = [p & 63 for _, _, p in rows]
    if case != "poison_end":
        assert W in lengths
    if case != "zipf":
        assert over > 0 and lengths.count(0) == over


def test_dense_text_spills():
    """One-letter tokens fill half the bytes, the most rows a buffer can
    give, where the TPU layout's compact windows overflow.  The dense
    stream holds every row: spill 0, one row per token, equal to JAX."""
    stream, over, spill = _port("dense", "compact")
    assert (spill, over) == (0, 0)
    assert int(stream.total) == N // 2 == _jax_streams("dense")[2]
    assert stream.packed.shape[0] == N // 2 + 1


@pytest.mark.parametrize("case", [*EDGES, "zipf", "dense", "poison_end"])
@pytest.mark.parametrize("mode", ["compact", "pair"])
def test_stream_in_global_byte_order(case, mode):
    stream, _, spill = _port(case, mode)
    assert spill == 0
    packed = stream.packed.numpy()
    pos = packed[packed != ONES] >> 6
    assert np.all(np.diff(pos) > 0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["compact", "pair", "fused"])
def test_one_dead_row_at_live(case, mode):
    """Every live row, then exactly one dead row, at index ``live``."""
    data = torch.from_numpy(np.frombuffer(CASES[case](), np.uint8).copy())
    stream = ktok.tokenize_fused(data, max_token_bytes=W)[0] \
        if mode == "fused" else _port(case, mode)[0]
    live = _jax_streams(case)[1] + _jax_streams(case)[2]  # poisons + tokens
    if mode == "fused":
        assert int(stream.live) == live
        stream = stream.cut(live)
    assert stream.live is None and stream.packed.shape[0] == live + 1
    dead = (stream.packed == ONES).nonzero().reshape(-1).tolist()
    assert dead == [live]
    assert int(stream.key_hi[live]) == int(stream.key_lo[live]) == ONES


def test_cut_checks_the_callers_count():
    """``cut`` takes the count the caller read (here checked against the
    stream's own, which a CPU tensor holds without a sync)."""
    data = torch.from_numpy(np.frombuffer(CASES["zipf"](), np.uint8).copy())
    stream, over, _ = ktok.tokenize_split_compact(data, W)
    live = int(stream.total) + int(over)
    assert int(stream.live) == live
    assert torch.equal(stream.cut(live).packed, stream.cut().packed)
    with pytest.raises(ValueError, match="live count"):
        stream.cut(live + 1)


def test_stream_views_and_filler():
    stream, _, _ = _port("zipf", "compact")
    rows = stream.packed.shape[0]
    assert rows == int(stream.total) + _jax_streams("zipf")[1] + 1
    dead = stream.packed == ONES
    assert torch.all(stream.key_hi[dead] == ONES)
    assert torch.all(stream.key_lo[dead] == ONES)
    assert int(stream.count.sum()) == int(stream.total)
    tok_rows = stream.count > 0
    assert torch.all(stream.length[tok_rows] >= 1)
    assert torch.all(stream.pos[~tok_rows] == tok.POS_INF)


def test_cpu_calls_count_no_launch():
    before = dict(ktok.LAUNCHES)
    _port("zipf", "compact")
    _port("zipf", "pair")
    assert dict(ktok.LAUNCHES) == before


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(256, dtype=torch.int32), TypeError),
    (torch.zeros(2, 128, dtype=torch.uint8), ValueError),
    (torch.zeros(512, dtype=torch.uint8)[::2], ValueError),
    (torch.zeros(0, dtype=torch.uint8), ValueError),
])
def test_kernel_envelope_refused(bad, err):
    with pytest.raises(err):
        ktok.tokenize_split_compact(bad, W)


@pytest.mark.parametrize("w", [0, 64])
def test_kernel_w_envelope(w):
    with pytest.raises(ValueError, match="max_token_bytes"):
        ktok.tokenize_split(torch.zeros(256, dtype=torch.uint8), w)


def test_kernel_has_no_layout_limits():
    """The TPU layout's n % 128 rule is gone: any length in [1, 2**26]."""
    data = torch.from_numpy(np.frombuffer(b"ab cd ef", np.uint8).copy())
    stream, over, spill = ktok.tokenize_split_compact(data, W)
    assert (int(stream.total), int(over), int(spill)) == (3, 0, 0)
    assert stream.packed.shape[0] == 4  # three rows and the dead one


# The kernel itself against this plain version: tests/test_torch_cuda.py,
# on the card.


# --- ops.tokenize: the xla-backend tokenizer -------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenize_matches_jax_field_by_field(seed):
    rng = np.random.default_rng(seed)
    data = bytearray(_zipf_text(seed, 4096))
    # Tokens longer than any kernel window: this path has no length bound.
    for start in rng.integers(0, 3900, 6):
        data[start:start + int(rng.integers(40, 150))] = \
            b"L" * 150
    data = bytes(data[:4096])
    want = jax.jit(jtok.tokenize)(np.frombuffer(data, np.uint8), 7)
    got = tok.tokenize(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                       base_offset=7)
    for f in want._fields:
        np.testing.assert_array_equal(_u32(getattr(want, f)),
                                      _u32(getattr(got, f)), err_msg=f)
    assert (_u32(got.key_hi)[_u32(got.count) > 0] >= 1 << 31).any()
    assert int(tok.token_count(torch.from_numpy(
        np.frombuffer(data, np.uint8).copy()))) == int(_u32(want.count).sum())


def test_mul32_at_the_largest_values():
    vals = np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                     0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint64)
    a, b = np.meshgrid(vals, vals)
    want = (a * b) & np.uint64(0xFFFFFFFF)  # uint64 wraps mod 2**64: exact
    got = tok.mul32(torch.from_numpy(a.astype(np.int64)),
                    torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def test_fmix32_matches_jax():
    x = np.random.default_rng(3).integers(0, 1 << 32, 4096, dtype=np.uint64)
    want = np.asarray(jtok._fmix32(x.astype(np.uint32)))
    got = tok._fmix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_pad_to_matches_jax():
    data = b"hello world"
    np.testing.assert_array_equal(tok.pad_to(data, 128),
                                  jtok.pad_to(data, 128))
    with pytest.raises(ValueError):
        tok.pad_to(data, 4)


def test_separator_mask():
    data = torch.arange(256, dtype=torch.int64).to(torch.uint8)
    got = tok.separator_mask(data).nonzero().reshape(-1).tolist()
    assert got == [0, 9, 10, 11, 12, 13, 32]


def test_cuda_source_names_the_tpu_kernel():
    src = (ktok._build.CSRC_DIR / "tokenize.cu").read_text()
    assert "mapreduce_tpu/ops/pallas/tokenize.py:_tokenize_kernel" in src
    assert f"kWindow = {ktok.WINDOW};" in src
    assert f"kTile = {ktok.TILE};" in src
    # The wrapper module builds nothing at import time.
    tree = ast.parse(open(ktok.__file__).read())
    top_calls = [n for n in tree.body if isinstance(n, ast.Expr)
                 and isinstance(n.value, ast.Call)]
    assert not top_calls
