"""The port's reader against the JAX package's, on the CPU.

``iter_batches`` / ``iter_batches_multi`` (the native chunker) cut the
same seeded corpora into the same batches as the JAX reader, batch by
batch: data, row bases, lengths, step and ``file_index`` are equal
exactly, from the start and from resume cursors in every member of the
corpus.  The JAX side runs its numpy path (its own tests hold its native
chunker to it).  ``prefetch`` re-raises a producer error and stops on early exit.
``read_words_at_multi`` cuts the words the JAX reader cuts, in the order
of the spans, over one file and over a corpus with an empty member.
"""

import os
import threading

import numpy as np
import pytest

from mapreduce_tpu.data import reader as jreader
from mapreduce_tpu_torch import native
from mapreduce_tpu_torch.data import reader
from mapreduce_tpu_torch.utils import oracle

CHUNK = 512


def _text(seed: int, n: int) -> bytes:
    """Zipf words with separator runs, and separator-free runs longer than
    the alignment window (force-split)."""
    rng = np.random.default_rng(seed)
    words = [b"w%x" % i for i in range(300)] + [b"x" * 700, b"y" * 90]
    seps = [b" ", b"\n", b"\t", b"   ", b" \r\n"]
    ids = rng.zipf(1.3, n // 3) % len(words)
    out = b"".join(words[i] + seps[int(rng.integers(0, len(seps)))]
                   for i in ids)
    return out[:n]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("reader")
    sizes = (5000, 1, 3333)  # one file of a single byte
    paths = []
    for i, n in enumerate(sizes):
        p = d / f"part{i}.txt"
        p.write_bytes(_text(i, n) if n > 1 else b"z")
        paths.append(str(p))
    return paths


def _fields(batches):
    return [(b.data.tobytes(), b.base_offsets.tolist(), b.lengths.tolist(),
             b.step, b.file_index) for b in batches]


# Virtual offsets: part0 is [0, 5000), part1 (one byte) 5000, part2
# [5001, 8334).
CURSORS = {
    "whole": {},
    "resume": {"start_offset": 1500, "start_step": 7},
    "second_file": {"start_offset": 5000, "start_step": 3},
    "third_file": {"start_offset": 5001, "start_step": 4},
    "mid_third_file": {"start_offset": 6500, "start_step": 9},
}


@pytest.mark.parametrize("cursor", list(CURSORS))
@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_iter_batches_multi_matches_jax(corpus, cursor, n_shards):
    kw = {"max_token_bytes": 64, **CURSORS[cursor]}
    want = _fields(jreader.iter_batches_multi(corpus, n_shards, CHUNK,
                                              use_native=False, **kw))
    got = _fields(reader.iter_batches_multi(corpus, n_shards, CHUNK, **kw))
    assert got == want
    assert len(want) >= 2


@pytest.mark.parametrize("start_offset", [0, 100, 4999])
def test_iter_batches_one_file_matches_jax(corpus, start_offset):
    kw = {"max_token_bytes": 64, "start_offset": start_offset,
          "start_step": 2}
    want = _fields(jreader.iter_batches(corpus[0], 1, CHUNK,
                                        use_native=False, **kw))
    got = _fields(reader.iter_batches(corpus[0], 1, CHUNK, **kw))
    assert got == want
    assert want


def test_batches_fill_the_callers_buffers(corpus):
    """``out`` hands each batch its buffer: the batch's data is that
    buffer, filled in place, and the batches equal the allocating path's."""
    given = []

    def out():
        given.append(np.full(CHUNK, 0xAB, dtype=np.uint8))
        return given[-1]

    want = _fields(reader.iter_batches_multi(corpus, 1, CHUNK))
    batches = list(reader.iter_batches_multi(corpus, 1, CHUNK, out=out))
    assert _fields(batches) == want
    assert len(given) == len(batches)
    for b, buf in zip(batches, given):
        assert np.shares_memory(b.data, buf)


def test_native_chunker_contract(corpus):
    data = np.fromfile(corpus[0], dtype=np.uint8)
    assert native.token_count(data) == oracle.total_count(data.tobytes())
    with pytest.raises(ValueError, match="n_shards x chunk_bytes"):
        native.fill_batch(data, False, 1, CHUNK, 64,
                          np.empty(CHUNK + 1, np.uint8),
                          np.empty(1, np.int64), np.empty(1, np.int64))


def test_prefetch_reraises_a_producer_error():
    def batches():
        yield 1
        yield 2
        raise OSError("disk went away")

    got = []
    with pytest.raises(OSError, match="disk went away"):
        for b in reader.prefetch(batches(), depth=2):
            got.append(b)
    assert got == [1, 2]


def test_prefetch_stops_on_early_exit():
    pulled = []

    def batches():
        for i in range(10_000):
            pulled.append(i)
            yield i

    before = set(threading.enumerate())
    it = reader.prefetch(batches(), depth=3)
    assert [next(it) for _ in range(2)] == [0, 1]
    producer = [t for t in threading.enumerate() if t not in before]
    assert [t.name for t in producer] == ["ingest-prefetch"]
    it.close()
    producer[0].join(timeout=5)  # it gives up within one 0.1 s put timeout
    assert not producer[0].is_alive()
    # Two taken, three queued, one blocked in its put when the stop came.
    assert len(pulled) <= 2 + 3 + 1


def test_prefetch_keeps_order_and_batch_fields(corpus):
    want = list(reader.iter_batches_multi(corpus, 1, CHUNK))
    got = list(reader.prefetch(reader.iter_batches_multi(corpus, 1, CHUNK),
                               depth=1))
    assert _fields(got) == _fields(want)


@pytest.fixture(scope="module")
def span_files(tmp_path_factory):
    """One file, and a corpus of three whose middle member is empty."""
    d = tmp_path_factory.mktemp("spans")
    paths = []
    for i, data in enumerate((_text(20, 3000), b"", _text(21, 2000))):
        p = d / f"part{i}.txt"
        p.write_bytes(data)
        paths.append(str(p))
    return {"one": paths[0], "three": paths}


def _spans(paths, shuffled: bool):
    """Spans at each file's first and last bytes (both sides of every
    seam), and random spans inside each file."""
    rng = np.random.default_rng(22)
    spans, start = [], 0
    for size in map(os.path.getsize, paths):
        if size:
            spans += [(start, 3), (start + size - 1, 1),
                      (start + size - 4, 4)]
            offs = rng.integers(0, size - 20, 60)
            spans += [(start + int(o), int(n))
                      for o, n in zip(offs, rng.integers(1, 20, 60))]
        start += size
    spans.sort()
    if shuffled:
        spans = [spans[i] for i in rng.permutation(len(spans))]
    return spans


@pytest.mark.parametrize("order", ["sorted", "shuffled", "empty"])
@pytest.mark.parametrize("files", ["one", "three"])
def test_read_words_at_multi_matches_jax(span_files, files, order):
    paths = span_files[files]
    spans = [] if order == "empty" else _spans(
        [paths] if files == "one" else paths, order == "shuffled")
    offsets = np.array([o for o, _ in spans], dtype=np.int64)
    lengths = np.array([n for _, n in spans], dtype=np.int64)
    got = reader.read_words_at_multi(paths, offsets, lengths)
    assert got == jreader.read_words_at_multi(paths, spans)
    assert len(got) == len(spans)
