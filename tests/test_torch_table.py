"""The port's count tables against the JAX package's, on the CPU.

``from_packed_rows`` (stable2 and sort3, with the rescue slice; and on the
kernel's dense stream, whose one dead row follows the poison rows, against
the same rows padded with filler as the TPU layout leaves them), the generic
``from_stream`` build, ``merge`` (two-way and three-way), ``top_k``, the KMV
estimate and the 64-bit totals, each fed the same seeded numpy rows as the
JAX function and compared field by field.  Integer counting only: every
comparison is exact (uint32 per field, tolerance zero).  Keys span the whole
uint32 range, so ``key_hi >= 2**31`` (the sign-flip case of the int64 sort
key) is always present, and capacity-spill cases are included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.ops import table as jtbl
from mapreduce_tpu.ops import tokenize as jtok
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.ops import table as tbl
from mapreduce_tpu_torch.ops import tokenize as tok

SENT = 0xFFFFFFFF

# Jitted JAX references: eager dispatch of the scan and sorts costs
# seconds per call on the CPU, one compile per shape costs less.
_jax_packed = jax.jit(jtbl.from_packed_rows, static_argnames=(
    "capacity", "sort_mode", "rescue_slots"))
_jax_tokenize = jax.jit(jtok.tokenize)
_jax_from_stream = jax.jit(jtbl.from_stream, static_argnames=(
    "capacity", "max_token_bytes", "max_pos"))
_jax_merge = jax.jit(jtbl.merge, static_argnames=("capacity",))
_jax_top_k = jax.jit(jtbl.top_k, static_argnames=("k",))


def _packed_rows(seed: int, n: int = 2048, n_keys: int = 300):
    """Single-occurrence rows in ascending position order: repeated keys
    (high words above and below 2**31), poison rows (sent, sent-1) with
    zero length bits, and dead filler (sent, sent, all-ones)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, (n_keys, 2), dtype=np.uint64)
    keys[:10, 0] = SENT  # real keys that share the sentinel high word
    keys[:10, 1] = rng.integers(0, SENT - 1, 10)
    pick = keys[rng.zipf(1.4, n) % n_keys]
    pos = np.sort(rng.choice(1 << 20, n, replace=False)).astype(np.uint64)
    length = rng.integers(1, 64, n).astype(np.uint64)
    packed = (pos << 6) | length
    kind = rng.random(n)
    poison, dead = kind < 0.05, kind > 0.9
    key_hi, key_lo = pick[:, 0].copy(), pick[:, 1].copy()
    key_hi[poison | dead] = SENT
    key_lo[poison] = SENT - 1
    key_lo[dead] = SENT
    packed[poison] = pos[poison] << 6
    packed[dead] = SENT
    total = int((~poison & ~dead).sum())
    return [a.astype(np.uint32) for a in (key_hi, key_lo, packed)], total


def _port(*arrays):
    return [torch.from_numpy(a.astype(np.int64)) for a in arrays]


def _np(t) -> dict:
    """A JAX or port table as {field: uint32 array}."""
    if isinstance(t, tbl.CountTable):
        return convert.table_to_numpy(t)
    if isinstance(t, dict):
        return t
    return {f: np.asarray(getattr(t, f)).astype(np.uint32) for f in t._fields}


def _assert_equal(want, got):
    want, got = _np(want), _np(got)
    assert want.keys() == got.keys()
    for f in want:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)


@pytest.mark.parametrize("sort_mode", ["stable2", "sort3"])
@pytest.mark.parametrize("capacity", [512, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_packed_rows_matches_jax(sort_mode, capacity, seed):
    (khi, klo, packed), total = _packed_rows(seed)
    assert (khi >= 1 << 31).any() and (khi < 1 << 31).any()
    want, want_r = _jax_packed(khi, klo, packed, jnp.uint32(total),
                               capacity=capacity, pos_hi=3,
                               sort_mode=sort_mode, rescue_slots=200)
    got, got_r = tbl.from_packed_rows(
        *_port(khi, klo, packed), torch.tensor(total), capacity, 3,
        sort_mode=sort_mode, rescue_slots=200)
    _assert_equal(want, got)
    np.testing.assert_array_equal(np.asarray(want_r).astype(np.uint32),
                                  got_r.numpy().astype(np.uint32))
    if capacity == 64:
        assert int(got.dropped_uniques) > 0


def test_rescue_slice_clamps_at_the_array_end():
    """More rescue slots than rows after the poison segment's start: the
    slice clamps and pulls in real rows, as the JAX one does."""
    (khi, klo, packed), total = _packed_rows(2, n=256)
    want = _jax_packed(khi, klo, packed, jnp.uint32(total), capacity=64,
                       pos_hi=0, sort_mode="stable2", rescue_slots=200)[1]
    got = tbl.from_packed_rows(*_port(khi, klo, packed), torch.tensor(total),
                               64, 0, sort_mode="stable2",
                               rescue_slots=200)[1]
    np.testing.assert_array_equal(np.asarray(want).astype(np.uint32),
                                  got.numpy().astype(np.uint32))


def _dense_stream(seed: int):
    """A dense stream: the live rows of :func:`_packed_rows` in position
    order, its last three turned into poison rows, then one dead row."""
    (khi, klo, packed), _ = _packed_rows(seed, n=1500)
    live = packed != SENT
    khi, klo, packed = khi[live], klo[live], packed[live]
    poison = (khi == SENT) & (klo == SENT - 1)
    poison[-3:] = True
    khi[poison], klo[poison] = SENT, SENT - 1
    packed[poison] = packed[poison] >> 6 << 6
    total = int((~poison).sum())
    dead = np.array([SENT], np.uint32)
    return [np.concatenate([a, dead]) for a in (khi, klo, packed)], total, \
        int(poison.sum())


@pytest.mark.parametrize("sort_mode", ["stable2", "sort3"])
@pytest.mark.parametrize("seed", [3, 4, "empty"])
def test_dense_stream_table_matches_filler_stream(sort_mode, seed):
    """The dense stream builds the table that JAX builds from the same rows
    followed by filler, and its rescue slice of ``overlong + 1`` rows holds
    the poison positions that JAX's longer slice starts with; the empty
    stream is its dead row alone."""
    if seed == "empty":
        rows, total, over = [np.array([SENT], np.uint32)] * 3, 0, 0
    else:
        rows, total, over = _dense_stream(seed)
    filler = [np.concatenate([a, np.full(300, SENT, np.uint32)])
              for a in rows]
    want, want_r = _jax_packed(*filler, jnp.uint32(total), capacity=256,
                               pos_hi=1, sort_mode=sort_mode,
                               rescue_slots=200)
    got, got_r = tbl.from_packed_rows(
        *_port(*rows), torch.tensor(total), 256, 1, sort_mode=sort_mode,
        rescue_slots=over + 1)
    _assert_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(want_r)[:over + 1].astype(np.uint32),
        got_r.numpy().astype(np.uint32))
    assert (got_r.numpy()[:over] & 63 == 0).all()  # the poison rows


@functools.lru_cache(maxsize=None)
def _stream_table(seed: int, capacity: int, pos_hi: int, packed: bool):
    """A JAX table and the port's, built from one seeded text buffer."""
    rng = np.random.default_rng(seed)
    words = [b"w%x" % i for i in range(120)]
    data = b" ".join(words[int(i) % 120] for i in rng.zipf(1.3, 700))
    buf = jtok.pad_to(data, -(-len(data) // 128) * 128)
    kw = dict(max_token_bytes=63, max_pos=buf.shape[0]) if packed else {}
    want = _jax_from_stream(_jax_tokenize(buf), capacity=capacity,
                            pos_hi=pos_hi, **kw)
    got = tbl.from_stream(tok.tokenize(torch.from_numpy(buf.copy())),
                          capacity, pos_hi=pos_hi, **kw)
    _assert_equal(want, got)
    return want, got


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("capacity", [256, 32])
def test_from_stream_matches_jax(packed, capacity):
    _stream_table(5, capacity, 2, packed)


@pytest.mark.parametrize("capacity", [None, 300, 48])
@pytest.mark.parametrize("three_way", [False, True])
def test_merge_matches_jax(capacity, three_way):
    a = _stream_table(10, 256, 0, True)
    b = _stream_table(11, 128, 1, False)
    c = _stream_table(12, 64, 2, True) if three_way else (None, None)
    want = _jax_merge(a[0], b[0], capacity=capacity, c=c[0])
    got = tbl.merge(a[1], b[1], capacity=capacity, c=c[1])
    _assert_equal(want, got)
    assert got.total_count() == a[1].total_count() + b[1].total_count() \
        + (c[1].total_count() if three_way else 0)


@pytest.mark.parametrize("k", [1, 7, 500])
def test_top_k_matches_jax(k):
    want_t, got_t = _stream_table(20, 128, 0, True)
    _assert_equal(_jax_top_k(want_t, k=k), tbl.top_k(got_t, k))


def test_kmv_and_totals_match_jax():
    want, got = _stream_table(30, 24, 0, True)  # full: the estimate applies
    assert jtbl.kmv_distinct(want) == tbl.kmv_distinct(got)
    assert tbl.kmv_distinct(got) is not None
    assert [int(x) for x in jtbl.kmv_snapshot(want)] == \
        [int(x) for x in tbl.kmv_snapshot(got)]
    assert [int(x) for x in want.total_count64()] == \
        [int(x) for x in got.total_count64()]
    assert want.dropped_totals() == got.dropped_totals()
    assert int(want.n_valid()) == int(got.n_valid())


def test_empty_matches_jax():
    _assert_equal(jtbl.empty(16), tbl.empty(16))


def test_sixty_four_bit_counts():
    """Counts past 2**32 carry into count_hi, as the JAX lane pairs do."""
    lo, hi = tbl.add64(torch.tensor(SENT), torch.tensor(1), torch.tensor(5),
                       torch.tensor(0))
    want = jtbl.add64(jnp.uint32(SENT), jnp.uint32(1), jnp.uint32(5),
                      jnp.uint32(0))
    assert (int(lo), int(hi)) == tuple(int(x) for x in want)
    lo, hi = tbl.sum64(torch.tensor([SENT, SENT, 2]))
    assert (int(lo), int(hi)) == (0, 2)


def test_convert_round_trip():
    want, got = _stream_table(40, 64, 9, True)
    fields = _np(want)
    back = convert.table_from_numpy(fields, device="cpu")
    _assert_equal(want, back)
    _assert_equal(fields, convert.table_to_numpy(back))
    # A state carried across merges like a native one.
    _assert_equal(_jax_merge(want, want), tbl.merge(back, got))
    with pytest.raises(ValueError, match="missing"):
        convert.table_from_numpy({"key_hi": fields["key_hi"]}, device="cpu")
