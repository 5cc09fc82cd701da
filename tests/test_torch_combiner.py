"""The port's hot-key combiner against the JAX package's, on the CPU.

The port's ``tokenize_fused(..., combiner_slots=8)`` (on a CPU tensor, the
combiner kernel's plain PyTorch version) and the JAX package's Pallas
``tokenize_fused`` in interpret mode see the same corpora: the four
flushed ``CombinerCache`` planes must be equal, and the thinned stream
plus the cache must hold exactly the combiner-free stream's occurrences
and first positions.  ``count_words`` under ``combiner='hot-cache'`` must
equal the JAX package's in every ``WordCountResult`` field, the dense
(spill -> combiner-free pair rerun) and overlong (rescue, then the cache
fold) corpora included.  Integer hashing and counting: tolerance zero.
"""

import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
from mapreduce_tpu_torch.utils import oracle

N = 128 * 132  # the JAX package's own combiner probe shape (segments of 132)
NW = 1 << 18  # count_words corpora: 2 KB segments, so a dense window spills
W = 8  # count_words lookback
WORDS = [b"aa", b"bb", b"c", b"ddd", b"ee", b"f", b"gg", b"hh", b"iii",
         b"jj", b"kk", b"lll", b"mm", b"n", b"oo", b"pp"]


def _corpus(kind: str) -> bytes:
    """N bytes of ``WORDS`` (as tests/test_combiner.py draws them), plus an
    overlong variant whose 40-byte runs are poison rows at W = 32."""
    rng = np.random.default_rng(7)
    if kind in ("zipf", "overlong"):
        p = np.array([1 / (i + 1) ** 1.3 for i in range(len(WORDS))])
        toks = rng.choice(len(WORDS), 3000, p=p / p.sum())
    elif kind == "uniform":
        toks = rng.integers(0, len(WORDS), 3000)
    else:
        toks = np.zeros(3000, np.int64)
    words = [WORDS[t] for t in toks]
    if kind == "overlong":
        words[::37] = [b"L" * 40] * len(words[::37])
    return (b" ".join(words) + b" " * N)[:N]


CACHE_KINDS = ["zipf", "uniform", "single", "overlong"]


def _u8(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


@functools.lru_cache(maxsize=None)
def _jax_kernel():
    from mapreduce_tpu.ops.pallas import tokenize as pallas_tok

    return jax.jit(lambda arr: pallas_tok.tokenize_fused(
        arr, compact_slots=128, lane_major=True, block_rows=512,
        combiner_slots=8))


@functools.lru_cache(maxsize=None)
def _jax_combined(kind: str):
    """One jitted JAX combiner pass per corpus (one compile for all)."""
    stream, overlong, spill, cache = _jax_kernel()(
        jnp.asarray(np.frombuffer(_corpus(kind), np.uint8)))
    return (jax.tree.map(np.asarray, stream), int(overlong), int(spill),
            jax.tree.map(np.asarray, cache))


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_flushed_cache_planes_match_jax(kind):
    stream, over, spill, cache = ktok.tokenize_fused(
        _u8(_corpus(kind)), max_token_bytes=32, combiner_slots=8)
    want_stream, want_over, want_spill, want_cache = _jax_combined(kind)
    got = convert.combiner_cache_to_numpy(cache)
    for f in want_cache._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want_cache, f)),
                                      got[f], err_msg=f)
    assert int(over) == want_over
    assert int(spill) == want_spill == 0
    # Both count only the rows left in the stream.
    assert int(stream.total) == int(want_stream.total)
    if kind == "single":
        assert int(stream.total) == 0  # every segment caches the one key


def _first_distinct(keys, c):
    out = []
    for k in keys:
        if k not in out and len(out) < c:
            out.append(k)
    return out


@settings(max_examples=200, deadline=None)
@given(keys=st.lists(st.integers(0, 7), max_size=48),
       window=st.integers(1, 9), c=st.integers(1, 5))
def test_window_heads_lemma(keys, window, c):
    """A segment's first C distinct keys are the first C distinct keys of
    its windows' own first-C lists taken in window order: what lets each
    window find its heads alone."""
    merged = []
    for i in range(0, len(keys), window):
        for k in _first_distinct(keys[i:i + window], c):
            if k not in merged and len(merged) < c:
                merged.append(k)
    assert merged == _first_distinct(keys, c)


@settings(max_examples=200, deadline=None)
@given(keys=st.lists(st.integers(0, 7), max_size=48),
       window=st.integers(1, 9), c=st.integers(1, 5))
def test_a_window_needs_only_the_list_up_to_itself(keys, window, c):
    """The one-launch combiner: each window extends its segment's list
    with its own first new keys, in window order, and drops the keys on
    the list as it stands after that.  Every key of a window that the
    whole segment caches is already on that list (a key cached later
    first appears later), so the windows drop exactly the segment's
    cached occurrences."""
    final = _first_distinct(keys, c)
    listed, dropped = [], []
    for i in range(0, len(keys), window):
        part = keys[i:i + window]
        for k in part:
            if k not in listed and len(listed) < c:
                listed.append(k)
        dropped += [k for k in part if k in listed]
    assert listed == final
    assert dropped == [k for k in keys if k in final]


def _occurrences(stream, cache=None):
    """(key -> count) and (key -> first position) of a stream plus a cache;
    poison rows as a sorted list of positions."""
    live = stream.count.numpy() > 0
    keys = list(zip(stream.key_hi.numpy()[live].tolist(),
                    stream.key_lo.numpy()[live].tolist()))
    count = Counter(keys)
    first: dict = {}
    for key, p in zip(keys, stream.pos.numpy()[live].tolist()):
        first[key] = min(first.get(key, 1 << 40), p)
    if cache is not None:
        for hi, lo, c, pk in zip(*(x.reshape(-1).tolist() for x in cache)):
            if c:
                count[(hi, lo)] += c
                first[(hi, lo)] = min(first.get((hi, lo), 1 << 40), pk >> 6)
    pk = stream.packed.numpy()
    poison = sorted((pk[(pk != 0xFFFFFFFF) & ((pk & 63) == 0)] >> 6).tolist())
    return count, first, poison


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_stream_plus_cache_is_the_uncombined_stream(kind):
    data = _u8(_corpus(kind))
    thin, over, spill, cache = ktok.tokenize_fused(data, max_token_bytes=32,
                                                   combiner_slots=8)
    # The combiner-free reference: pair mode, which cannot spill (these
    # short words overflow the combiner-free compact windows).
    full, over0, _ = ktok.tokenize_fused(data, compact=False,
                                         max_token_bytes=32)
    assert int(spill) == 0 and int(over) == int(over0)
    assert _occurrences(thin, cache) == _occurrences(full)
    assert int(thin.total) + int(cache.count.sum()) == int(full.total)
    # The thinned stream stays in global byte order (stable2's contract)
    # and is dense: its live rows, then one dead row.
    pk = thin.packed.numpy()
    pos = pk[pk != 0xFFFFFFFF] >> 6
    assert (np.diff(pos) > 0).all()
    assert pk.shape[0] == int(thin.live) + 1 == int(thin.total) + int(over) + 1
    assert pk[-1] == 0xFFFFFFFF and (pk[:-1] != 0xFFFFFFFF).all()
    if kind == "overlong":
        assert int(over) > 0  # poison rows stay in the stream, uncached


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_dense_thinned_stream_is_the_dense_stream_less_the_cached_rows(kind):
    """The thinned stream is the combiner-free dense stream with every
    cached emission taken out, row for row in the same order, and cutting
    it at the host count the map reads keeps every row."""
    data = _u8(_corpus(kind))
    thin, over, spill, cache = ktok.tokenize_combiner_plain(
        data, 32, ktok.COMBINER_SLOTS, 8)
    full = ktok.tokenize_stream_plain(data, 32)[0]
    rows = [x[:-1] for x in full[:3]]  # its live rows, without the dead row
    # A row belongs to the segment of its last byte.
    end = (rows[2] >> 6) + torch.where((rows[2] & 63) > 0,
                                        (rows[2] & 63) - 1, 0)
    seg = end // (N // ktok.SEGMENTS)
    k = ktok._key64(rows[0], rows[1])
    ck = ktok._key64(cache.key_hi, cache.key_lo)[:, seg].T
    cached = ((ck == k[:, None]) & (cache.count[:, seg].T > 0)).any(1) \
        & ((rows[2] & 63) != 0)
    keep = torch.cat([~cached, torch.ones(1, dtype=torch.bool)])
    for a, b in ((thin.key_hi, full.key_hi[keep]),
                 (thin.key_lo, full.key_lo[keep]),
                 (thin.packed, full.packed[keep])):
        assert torch.equal(a, b)
    assert int(thin.live) == int(keep.sum()) - 1
    assert int(cache.count.sum()) == int(cached.sum())
    cut = thin.cut(int(thin.total) + int(over))
    assert torch.equal(cut.packed, thin.packed)


@pytest.mark.parametrize("kind", ["zipf", "overlong"])
def test_combiner_fold_matches_jax_merge(kind):
    """The fold's plain version (the path a CPU tensor takes) against the
    JAX package's merge of the thinned stream's table with its cache
    table, every field, at a capacity that spills and one that does
    not."""
    from mapreduce_tpu.ops import table as jtable

    data = _u8(_corpus(kind))
    thin, over, _, cache = ktok.tokenize_combiner_plain(
        data, 32, ktok.COMBINER_SLOTS, 8)
    for cap in (16, 4096):
        t = wc.table_ops.from_stream(thin, cap, pos_hi=5, max_token_bytes=32,
                                     max_pos=N, sort_mode="stable2")
        got = convert.table_to_numpy(ktok.combiner_fold(t, cache, 5))
        jt = jax.tree.map(jnp.asarray, convert.table_to_numpy(t))
        jcache = jax.tree.map(jnp.asarray, convert.combiner_cache_to_numpy(
            cache))
        want = jtable.merge(jtable.CountTable(**jt), jwc._combiner_table(
            type(_jax_combined(kind)[3])(**jcache), 5), capacity=cap)
        for f in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                          got[f], err_msg=(cap, f))


def test_combiner_table_matches_jax():
    """The cache fold's table, from JAX's flushed planes, field by field."""
    _, _, _, want_cache = _jax_combined("zipf")
    fields = {f: getattr(want_cache, f) for f in want_cache._fields}
    want = jwc._combiner_table(jax.tree.map(jnp.asarray, want_cache), 3)
    got = ktok.cache_table(convert.combiner_cache_from_numpy(fields, "cpu"),
                           3)
    got = convert.table_to_numpy(got)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), got[f],
                                      err_msg=f)


def test_tokenize_fused_checks_its_arguments():
    data = _u8(_corpus("zipf"))
    with pytest.raises(ValueError, match="compact"):
        ktok.tokenize_fused(data, compact=False, combiner_slots=8)
    for bad in (4, 12, 40):
        with pytest.raises(ValueError, match="multiple of 8"):
            ktok.tokenize_fused(data, combiner_slots=bad)
    with pytest.raises(ValueError, match="multiple of 128"):
        ktok.tokenize_fused(data[:N - 1], combiner_slots=8)
    # Without a combiner the fused mode is the compact stream itself.
    got = ktok.tokenize_fused(data, max_token_bytes=32)
    want = ktok.tokenize_split_compact(data, 32)
    for a, b in zip(got[0][:4], want[0][:4]):
        assert torch.equal(a, b)


def _zipf_words(rng, n: int) -> list[bytes]:
    vocab = [b"w%x" % i for i in range(300)] + [b"abcdefgh"]
    return [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n)]


def _wc_corpus(kind: str) -> bytes:
    """NW bytes: Zipf words; ``dense`` adds 16 KB of one-character tokens
    over 62 characters (more distinct keys than the cache holds, so the
    window spills even when thinned); ``overlong`` adds tokens longer than
    W, fewer than the second rescue tier and one beyond the rescue
    window."""
    rng = np.random.default_rng({"zipf": 0, "dense": 1, "overlong": 2}[kind])
    words = _zipf_words(rng, NW // 4)
    if kind == "overlong":
        longs = [b"over%03d" % i * 3 for i in range(5)] + [b"L" * 300]
        for i in rng.choice(len(words) // 2, 40, replace=False):
            words[i] = longs[int(rng.integers(0, len(longs)))]
    data = bytearray(b" ".join(words)[:NW].ljust(NW, b" "))
    if kind == "dense":
        chars = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
        dense = b" ".join(bytes([chars[i]])
                          for i in rng.integers(0, len(chars), 8192)) + b" "
        data[40000:40000 + len(dense)] = dense
    return bytes(data)


def _jax_config(**kw) -> JConfig:
    return JConfig(backend="pallas", map_impl="fused", combiner="hot-cache",
                   pallas_max_token=W, chunk_bytes=NW, table_capacity=4096,
                   rescue_overlong=4, **kw)


@functools.lru_cache(maxsize=None)
def _jax_words(kind: str):
    return jwc.count_words(_wc_corpus(kind), _jax_config())


@pytest.mark.parametrize("kind", ["zipf", "dense", "overlong"])
def test_count_words_matches_jax(kind):
    data = _wc_corpus(kind)
    cfg = convert.config_from_dict(dataclasses.asdict(_jax_config()))
    assert cfg.resolved_combiner_slots == 8
    wc.BRANCHES.clear()
    got = wc.count_words(data, cfg, device="cpu")
    want = _jax_words(kind)
    for f in ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count"):
        assert getattr(want, f) == getattr(got, f), f
    assert len(got.words) < 4096  # no batch-capacity spill
    if kind == "dense":
        assert wc.BRANCHES["spill_fallbacks"] == 1
        assert "combiner_hits" not in wc.BRANCHES  # the cache was discarded
        assert got.as_dict() == oracle.word_counts(data)
    else:
        assert not wc.BRANCHES["spill_fallbacks"]
        # The cache took a good share of the occurrences; one flush row
        # per resident key.
        assert wc.BRANCHES["combiner_hits"] > got.total // 4
        assert 0 < wc.BRANCHES["combiner_flushes"] <= 8 * ktok.SEGMENTS
    if kind == "overlong":
        assert wc.BRANCHES["rescue_escalations"] == 1
        assert got.dropped_count > 0  # the 300-byte tokens stay accounted


def test_config_and_the_no_op_rule():
    fused = Config(map_impl="fused", combiner="hot-cache")
    assert fused.resolved_combiner_slots == 8
    assert dataclasses.replace(fused, combiner_slots=16) \
        .resolved_combiner_slots == 16
    for kw in ({"map_impl": "split"}, {"compact_slots": 0},
               {"backend": "xla"}):
        assert dataclasses.replace(fused, **kw).resolved_combiner_slots == 0
    for bad in (0, 12, 40):
        with pytest.raises(ValueError, match="multiple of 8"):
            Config(combiner="hot-cache", combiner_slots=bad)
    with pytest.raises(ValueError, match="hot-cache"):
        Config(combiner_slots=8)
    # 'salt' runs (tests/test_torch_knobs.py); an unresolved 'auto' runs
    # as 'off', as in the JAX package (the command line resolves it).
    assert Config(combiner="salt").resolved_salt_bits == 3
    auto = Config(map_impl="fused", combiner="auto", combiner_slots=16)
    assert (auto.resolved_combiner, auto.resolved_combiner_slots) == (
        "off", 0) == (JConfig(map_impl="fused", combiner="auto",
                              combiner_slots=16).resolved_combiner, 0)
    # 'hot-cache' off the fused path is a no-op: the same table as 'off'.
    data = _wc_corpus("zipf")
    off = Config(chunk_bytes=NW, table_capacity=4096, pallas_max_token=W)
    want = convert.table_to_numpy(wc.count_table(data, off, device="cpu"))
    got = convert.table_to_numpy(wc.count_table(
        data, dataclasses.replace(off, combiner="hot-cache"), device="cpu"))
    for f, v in want.items():
        np.testing.assert_array_equal(v, got[f], err_msg=f)
