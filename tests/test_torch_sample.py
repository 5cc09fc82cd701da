"""The port's reservoir sample against the JAX package's, on the CPU.

The same seeded inputs go through both packages and every field is
compared exactly as uint32: the priorities; the bottom-k of hand-built
rows with ties at the k-th place; the map on ``backend='xla'`` against the
JAX plain map; the map on ``backend='pallas'`` (the pair-mode kernel's
plain version, masked past its live rows) against the JAX kernel map in
interpret mode, overlong tokens included; ``combine`` associative and
commutative; ``sample_bytes`` and streamed ``sample_file`` over a 3-file
corpus at 4 KB chunks, superstep 2 and window 2 against the JAX package
(the JAX executor on one device: priorities hash the chunk id, so the mesh
must be the port's).  Tolerance zero.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import sample as jsample
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import sample
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
from tests.conftest import make_corpus

MAXU = 0xFFFFFFFF


def _np(state) -> list:
    return [np.asarray(x).astype(np.uint32) for x in state]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.uint32).astype(np.int64))


def _corpus(seed: int, n_words: int = 1500) -> bytes:
    """Zipf words, with tokens longer than W = 8 (and than 32) in it."""
    rng = np.random.default_rng(seed)
    data = make_corpus(rng, n_words, 150)
    long = [b"x" * 12, b"https://example.org/" + b"p" * 40]
    parts = data.split(b" ")
    for i in range(0, len(parts), 97):
        parts[i] = long[i % 2]
    return b" ".join(parts)


@pytest.mark.parametrize("chunk_id", [0, 7, 0xFFFFFFFE])
def test_priorities_equal_jax(chunk_id):
    rng = np.random.default_rng(chunk_id & 0xFF)
    pos = rng.integers(0, 1 << 26, 4096).astype(np.uint32)
    is_tok = rng.random(4096) < 0.6
    want = jsample.ReservoirSampleJob._priorities(
        None, jnp.asarray(pos), jnp.asarray(is_tok), jnp.uint32(chunk_id))
    got = sample.ReservoirSampleJob._priorities(
        _t(pos), torch.from_numpy(is_tok), chunk_id)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


def _tied_rows(k: int, seed: int):
    """Rows whose priorities tie in runs across the k-th place, whose
    positions tie within a priority run, plus empty rows."""
    rng = np.random.default_rng(seed)
    n = 3 * k
    hi = rng.integers(0, 4, n).astype(np.uint32)
    lo = rng.integers(0, 3, n).astype(np.uint32)
    pos_hi = rng.integers(0, 3, n).astype(np.uint32)
    pos_lo = rng.permutation(n).astype(np.uint32)
    length = rng.integers(1, 30, n).astype(np.uint32)
    empty = rng.random(n) < 0.2
    for a in (hi, lo, pos_hi, pos_lo):
        a[empty] = MAXU
    length[empty] = 0
    return hi, lo, pos_hi, pos_lo, length


@pytest.mark.parametrize("k,seed", [(1, 0), (5, 1), (16, 2), (40, 3)])
def test_bottom_k_with_ties_equals_jax(k, seed):
    parts = _tied_rows(k, seed)
    want = jsample._bottom_k(tuple(jnp.asarray(a) for a in parts), k)
    got = sample._bottom_k(tuple(_t(a) for a in parts), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("k", [1, 3, 17, 200, 1000])
def test_select_k_is_the_sorted_first_k_ties_included(k):
    """The two-``topk`` selection of the map equals a full 2-key sort
    sliced to k, with ties at the k-th priority resolved by the
    tie-break; k beyond the row count gives every row."""
    rng = np.random.default_rng(k)
    n = 300
    hi = rng.integers(0, 3, n).astype(np.uint32)
    lo = rng.integers(0, 2, n).astype(np.uint32)
    tie = rng.permutation(n).astype(np.uint32)
    key = sample._key64(_t(hi), _t(lo))
    got = sample._select_k(key, _t(tie), k)
    want = np.lexsort((tie, lo, hi))[:k]
    np.testing.assert_array_equal(got.numpy(), want)


JKW = dict(chunk_bytes=1 << 15, table_capacity=1 << 10,
           pallas_max_token=8)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("k", [1, 16, 4096])
def test_map_equals_jax(backend, k):
    """One buffer's map (chunk id 5) on each backend against the JAX map
    of the same backend; overlong tokens are in the data, so the kernel
    path's exclusion from sample and population is compared too."""
    data = _corpus(1)
    jcfg = JConfig(backend=backend, **JKW)
    cfg = Config(backend=backend, **JKW)
    padded = wc._pad_for_backend(data, cfg)
    want = jsample.ReservoirSampleJob(k, jcfg).map_chunk(
        jnp.asarray(padded), jnp.uint32(5))
    got = sample.ReservoirSampleJob(k, cfg, "cpu").map_chunk(
        torch.from_numpy(padded), 5)
    w, g = _np(want), _np(got)
    live = w[0] != MAXU
    # Each map keeps min(k, rows) slots; past the population both are
    # empty, and the two backends' row counts differ.
    for wf, gf in zip(w[:5], g[:5]):
        np.testing.assert_array_equal(gf[: live.sum()], wf[live])
        assert (gf[live.sum():] == (0 if gf is g[4] else MAXU)).all()
    assert w[5:] == g[5:]
    if backend == "pallas":
        assert int(g[5]) < len(data.split())  # overlong ones left out


def test_kernel_map_masks_the_unwritten_rows(monkeypatch):
    """Rows past the dense stream's live count are garbage on the card:
    the map must give the same sample whatever they hold."""
    data = _corpus(2)
    cfg = Config(backend="pallas", **JKW)
    chunk = torch.from_numpy(wc._pad_for_backend(data, cfg))
    job = sample.ReservoirSampleJob(64, cfg, "cpu")
    want = job.map_chunk(chunk, 3)
    real = kernel_tok.tokenize_stream_plain

    def garbage_tail(data, w):
        stream, over, spill = real(data, w)
        rng = torch.Generator().manual_seed(0)
        pad = lambda x: torch.cat([x, torch.randint(  # noqa: E731
            0, 1 << 32, (5000,), generator=rng)])
        return stream._replace(key_hi=pad(stream.key_hi),
                               key_lo=pad(stream.key_lo),
                               packed=pad(stream.packed)), over, spill

    monkeypatch.setattr(kernel_tok, "tokenize_stream_plain", garbage_tail)
    kernel_tok.LAUNCHES.clear()
    got = job.map_chunk(chunk, 3)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_combine_associative_and_commutative():
    cfg = Config(backend="pallas", **JKW)
    job = sample.ReservoirSampleJob(16, cfg, "cpu")
    data = _corpus(3)
    thirds = [data[i::3] for i in range(3)]
    a, b, c = (job.map_chunk(torch.from_numpy(wc._pad_for_backend(t, cfg)),
                             i) for i, t in enumerate(thirds))
    left = job.merge(job.merge(a, b), c)
    right = job.merge(a, job.merge(b, c))
    swapped = job.merge(c, job.merge(b, a))
    for x, y, z in zip(left, right, swapped):
        assert torch.equal(x, y) and torch.equal(x, z)
    # The 64-bit population carries across the low word.
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    big = a._replace(total_lo=t(0xFFFFFFF0), total_hi=t(0))
    s = job.combine(big, b._replace(total_lo=t(0x20)))
    assert (int(s.total_lo), int(s.total_hi)) == (0x10, 1)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sample_bytes_equals_jax(backend):
    data = _corpus(4)
    jcfg = JConfig(backend=backend, **JKW)
    cfg = Config(backend=backend, **JKW)
    for k in (1, 50, 100_000):
        want = jsample.sample_bytes(data, k, jcfg)
        got = sample.sample_bytes(data, k, cfg, "cpu")
        assert got == want, k
    assert len(got.tokens) == got.total  # k past the population
    with pytest.raises(ValueError) as w:
        jsample.ReservoirSampleJob(0)
    with pytest.raises(ValueError) as g:
        sample.ReservoirSampleJob(0, device="cpu")
    assert str(g.value) == str(w.value)


JSTREAM = JConfig(backend="pallas", map_impl="split", combiner="off",
                  pallas_max_token=8, chunk_bytes=4096, table_capacity=1024,
                  superstep=2, inflight_groups=2)
STREAM = convert.config_from_dict(dataclasses.asdict(JSTREAM))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("sample")
    paths = []
    for name, data in (("a", _corpus(5, 3000)), ("b", b"single"),
                       ("c", _corpus(6, 1200) + b" " + b"q" * 20)):
        p = d / f"{name}.txt"
        p.write_bytes(data)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_streamed_sample_file_equals_jax(corpus, backend):
    """Tokens in priority order and the population, against the JAX
    executor on one device."""
    jcfg = dataclasses.replace(JSTREAM, backend=backend)
    cfg = dataclasses.replace(STREAM, backend=backend)
    for k in (16, 300):
        want = jsample.sample_file(corpus, k, jcfg, mesh=data_mesh(1))
        got = sample.sample_file(corpus, k, cfg, device="cpu")
        assert got == want, k
    words = {w for p in corpus for w in open(p, "rb").read().split()}
    assert set(got.tokens) <= words and len(got.tokens) == 300


def test_streamed_sample_reads_the_host_never(corpus, monkeypatch):
    """The kernel map masks the stream on the device: no ``host_read``
    span in a streamed sample (at most one a chunk is allowed)."""
    reads = collections.Counter()
    real = wc.span

    def counting(name, timer=None):
        reads[name] += 1
        return real(name, timer)

    monkeypatch.setattr(wc, "span", counting)
    r = sample.sample_file(corpus, 16, STREAM, device="cpu")
    assert r.total > 0 and reads["host_read"] == 0
