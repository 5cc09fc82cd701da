"""The port's radix sort seam against the JAX package's, on the CPU.

``radix_sort3`` (on CPU tensors, its plain version: the 3-key sort the
CUDA partition must reproduce) must equal the JAX package's Pallas
``radix_sort3`` in interpret mode and ``jax.lax.sort(num_keys=3)`` bit for
bit: ties by ``packed``, the poison segment, dead rows last and keys with
``key_hi >= 2**31``.  ``count_words`` under ``sort_impl`` 'radix_partition'
and 'radix', with sort3 and stable2, must equal JAX ``count_words`` at
``sort_impl='xla'``, which the JAX package holds bit-identical to its radix
path.  The seam the card runs (stable partition levels, then the
segmented sort of each bucket) is held here through its plain versions.
Tolerance zero.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops.cuda import radix

SENT = 0xFFFFFFFF
N_ROWS = 3000  # one JAX compile per impl for every case


def _triples(case: str):
    """uint32 (key_hi, key_lo, packed) of N_ROWS rows.  ``hot_key``: one
    key holds over half the live rows; ``shuffled_ties``: three keys, so
    nearly every row ties, in shuffled ``packed`` order."""
    rng = np.random.default_rng({"mixed": 0, "single_key": 1,
                                 "high_keys": 2, "all_dead": 3, "hot_key": 4,
                                 "shuffled_ties": 5}[case])
    n = N_ROWS
    if case == "high_keys":  # random triples, every key_hi >= 2**31
        khi = rng.integers(1 << 31, SENT, n, dtype=np.uint64)
        klo = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        pck = rng.permutation(n).astype(np.uint64) << 6 | 7
        return tuple(x.astype(np.uint32) for x in (khi, klo, pck))
    n_keys = {"single_key": 1, "shuffled_ties": 3}.get(case, 60)
    keys = rng.integers(0, SENT - 2, size=(n_keys, 2), dtype=np.uint64)
    keys[0, 0] = 0x9000_0000  # one key above 2**31 in every case
    idx = rng.integers(0, keys.shape[0], n)
    if case == "hot_key":
        idx[rng.random(n) < 0.6] = 0
    khi, klo = keys[idx, 0], keys[idx, 1]
    pck = (np.arange(n, dtype=np.uint64) << 6) | 5
    dead = rng.random(n) < (1.0 if case == "all_dead" else 0.3)
    pois = ~dead & (rng.random(n) < 0.02)
    khi = np.where(dead | pois, SENT, khi)
    klo = np.where(dead, SENT, np.where(pois, SENT - 1, klo))
    pck = np.where(dead, SENT, np.where(pois, np.arange(n) << 6, pck))
    # Shuffle: the seam sorts any row order (sort3 has no order contract).
    perm = rng.permutation(n)
    return tuple(x[perm].astype(np.uint32) for x in (khi, klo, pck))


CASES = ["mixed", "single_key", "high_keys", "all_dead"]
SEAM_CASES = CASES + ["hot_key", "shuffled_ties"]


@functools.lru_cache(maxsize=None)
def _jax_radix(impl: str):
    from mapreduce_tpu.ops.pallas import radix as jradix

    return jax.jit(functools.partial(jradix.radix_sort3, impl=impl, bits=2,
                                     block_rows=32))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("impl", radix.IMPLS)
def test_radix_sort3_matches_jax(impl, case):
    planes = _triples(case)
    want = jax.lax.sort(tuple(jnp.asarray(p) for p in planes), num_keys=3)
    jax_radix = _jax_radix(impl)(*(jnp.asarray(p) for p in planes))
    for bits in (1, 3):
        got = radix.radix_sort3(*(_t(p) for p in planes), impl=impl,
                                bits=bits)
        for g, w, j in zip(got, want, jax_radix):
            g = g.numpy().astype(np.uint32)
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("case", SEAM_CASES)
@pytest.mark.parametrize("impl", radix.IMPLS)
def test_radix_seam_sorts_each_bucket(impl, case):
    """The seam the card runs (levels, then the segmented sort of each
    bucket), here over the plain partitions and the plain segmented sort,
    is the 3-key sort."""
    planes = _triples(case)
    want = radix.radix_sort3_plain(*(_t(p) for p in planes))
    for bits in (1, 3, 5):
        got = radix.radix_sort3_seam(*(_t(p) for p in planes), impl, bits)
        for g, w in zip(got, want):
            assert torch.equal(g, w), bits


@pytest.mark.parametrize("case", ["mixed", "hot_key", "shuffled_ties"])
@pytest.mark.parametrize("impl", radix.IMPLS)
def test_key_only_sort_under_stable2_input(impl, case):
    """Rows in ``packed`` order (stable2's position-ordered stream): the
    stable key-only sort, which skips the passes over ``packed``, is the
    3-key sort.  On shuffled ties it is not, so those passes are needed
    there."""
    planes = tuple(_t(p) for p in _triples(case))
    order = torch.argsort(planes[2], stable=True)
    ordered = tuple(p[order] for p in planes)
    want = radix.radix_sort3_plain(*ordered)
    for bits in (1, 3):
        got = radix.radix_sort3_seam(*ordered, impl, bits,
                                     packed_ordered=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w), bits
    if case == "shuffled_ties":
        got = radix.radix_sort3_seam(*planes, impl, 3, packed_ordered=True)
        want = radix.radix_sort3_plain(*planes)
        assert not torch.equal(got[2], want[2])
    assert radix.sort_passes(3, with_packed=False) == \
        radix.sort_passes(3, with_packed=True)[4:]
    assert len(radix.sort_passes(6, with_packed=True)) == 12


@functools.lru_cache(maxsize=None)
def _jax_histograms():
    """JAX ``_partition_level`` twice (2 bits, interpret mode): each
    level's per-(group, bucket) row counts and spill."""
    from mapreduce_tpu.config import radix_slab_cap
    from mapreduce_tpu.ops.pallas import radix as jradix

    bits, block_rows = 2, 32
    cap = radix_slab_cap(bits, block_rows, jradix.DEFAULT_SLAB_SLACK)
    unit = (1 << bits) * block_rows * 128
    m = -(-N_ROWS // unit) * unit

    def run(*planes):
        planes = [jnp.concatenate([p, jnp.full((m - N_ROWS,), SENT,
                                               jnp.uint32)]).reshape(-1, 128)
                  for p in planes]
        out, groups = [], 1
        for level in (1, 2):
            *planes, hist, spill = jradix._partition_level(
                *planes, shift=32 - level * bits, bits=bits,
                block_rows=block_rows, cap=cap, n_groups=groups,
                interpret=True)
            out.append((hist.reshape(-1), spill))
            groups <<= bits
        return out

    return jax.jit(run)


@pytest.mark.parametrize("case", ["mixed", "high_keys"])
def test_partition_level_plain_matches_jax(case):
    """The plain partition, the reference the card's levels are held to,
    counts the JAX kernel's buckets, and its second level splits the first
    level's buckets: every row lies in the bucket of its top digits."""
    planes = _triples(case)
    jax_levels = _jax_histograms()(*(jnp.asarray(p) for p in planes))
    got, ends = tuple(_t(p) for p in planes), None
    for level, (hist, spill) in enumerate(jax_levels, 1):
        got, ends = radix.partition_level_plain(*got, 32 - 2 * level, 2,
                                                group_ends=ends)
        assert int(spill) == 0
        counts = torch.diff(ends, prepend=ends.new_zeros(1))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(hist))
        live = int(ends[-1])
        bucket = torch.searchsorted(ends, torch.arange(live), right=True)
        assert torch.equal(bucket, got[0][:live] >> (32 - 2 * level))
        # All N_ROWS rows come back: the dead fill after the live ones.
        assert all(p.shape[0] == N_ROWS for p in got)
        assert all(bool((p[live:] == SENT).all()) for p in got)


def test_radix_sort3_checks_its_arguments():
    z = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="impl"):
        radix.radix_sort3(z, z, z, impl="bogus")
    for bits in (0, 6):
        with pytest.raises(ValueError, match="bits"):
            radix.radix_sort3(z, z, z, bits=bits)
    with pytest.raises(TypeError, match="int64"):
        radix.radix_sort3(z, z, z.to(torch.int32))
    with pytest.raises(ValueError, match="equal-length"):
        radix.radix_sort3(z, z, z[:4])
    empty = torch.zeros(0, dtype=torch.int64)
    assert all(x.shape == (0,) for x in radix.radix_sort3(empty, empty,
                                                          empty))
    with pytest.raises(ValueError, match="sort_impl"):
        table_ops.from_packed_rows(z, z, z, torch.tensor(0), 4, 0,
                                   sort_impl="bogus")
    with pytest.raises(ValueError, match="sort_impl"):
        Config(sort_impl="bogus")
    # The digit width lives in the geometry, as in the JAX package.
    with pytest.raises(ValueError, match="radix_bits"):
        Config(geometry={"radix_bits": 6})


N = 1 << 14  # the shape of tests/test_torch_wordcount.py
W = 8


def _corpus(case: str) -> bytes:
    rng = np.random.default_rng({"zipf": 0, "overlong": 2}[case])
    vocab = [b"w%x" % i for i in range(200)] + [b"abcdefgh"]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, 2600)]
    if case == "overlong":
        longs = [b"over%03d" % i * 3 for i in range(5)] + [b"L" * 200]
        for i in rng.choice(len(words) // 2, 10, replace=False):
            words[i] = longs[int(rng.integers(0, len(longs)))]
    return b" ".join(words)[:N].ljust(N, b" ")


def _jax_config(sort_mode: str) -> JConfig:
    return JConfig(backend="pallas", map_impl="fused", combiner="off",
                   pallas_max_token=W, chunk_bytes=N, table_capacity=4096,
                   rescue_overlong=4, sort_mode=sort_mode)


@functools.lru_cache(maxsize=None)
def _jax_words(case: str, sort_mode: str):
    return jwc.count_words(_corpus(case), _jax_config(sort_mode))


@pytest.mark.parametrize("case", ["zipf", "overlong"])
@pytest.mark.parametrize("sort_mode", ["stable2", "sort3"])
@pytest.mark.parametrize("impl", radix.IMPLS)
def test_count_words_radix_matches_jax(impl, sort_mode, case):
    cfg = dataclasses.replace(
        convert.config_from_dict(dataclasses.asdict(_jax_config(sort_mode))),
        sort_impl=impl)
    wc.BRANCHES.clear()
    got = wc.count_words(_corpus(case), cfg, device="cpu")
    want = _jax_words(case, sort_mode)
    for f in ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count"):
        assert getattr(want, f) == getattr(got, f), f
    if case == "overlong":  # the rescue reads the radix-sorted poison run
        assert wc.BRANCHES["rescue_passes"] == 1
