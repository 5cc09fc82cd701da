"""The port's n-gram family against the JAX package's, on the CPU.

The same seeded corpora go through both packages and every field is
compared exactly as uint32: the per-byte gram streams, the per-chunk gram
tables and ``count_ngrams`` for n = 1-4 against the JAX ``backend='xla'``
path on overlong-free data (where the JAX package makes its backends
bit-identical); the lane-seam straddle and the overlong cases against the
JAX ``backend='pallas'`` path in interpret mode, as ``tests/test_ngram.py``
runs it; the seam carry (``compose_carry``, ``seam_gram_table``, a chunk
of no tokens) against the JAX functions; and streamed ``count_file`` runs
over a 3-file corpus at 4 KB chunks, superstep 2 and window 2 against the
JAX executor, the JAX single-buffer result of each file and an n-gram
oracle; host recovery of such a run against the JAX recovery of the same
table.  Tolerance zero: this is integer hashing and counting.
"""

import collections
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.ops import ngram as jngram
from mapreduce_tpu.ops import table as jtable
from mapreduce_tpu.ops import tokenize as jtok
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import constants, convert
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import ngram as ngram_ops
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
from mapreduce_tpu_torch.runtime import executor

FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count")
CAP = 1 << 14


def _result(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


def _corpus(seed: int, n_words: int, vocab: int = 120) -> bytes:
    """Zipf words with runs of mixed separators, some long enough that a
    gram's span passes 127 bytes (stored as ``SEAM_GRAM_LENGTH``)."""
    rng = np.random.default_rng(seed)
    words = [b"w%x" % i for i in range(vocab)]
    seps = [b" ", b"  ", b"\t", b"\n", b" \r\n", b" " * 140]
    out = []
    for i in rng.zipf(1.4, n_words):
        out.append(words[int(i) % vocab])
        out.append(seps[int(rng.integers(0, len(seps) * 20)) % len(seps)
                        if rng.random() < 0.2 else 0])
    return b"".join(out)


def oracle_ngrams(data: bytes, n: int) -> dict:
    """{token tuple: count} of the sliding windows of n tokens."""
    toks = data.split()
    return dict(collections.Counter(
        tuple(toks[i:i + n]) for i in range(len(toks) - n + 1)))


def _as_grams(result) -> dict:
    return {tuple(w.split()): c for w, c in zip(result.words, result.counts)}


def _jtable(t) -> dict:
    return {f: np.asarray(getattr(t, f)).astype(np.uint32) for f in t._fields}


def _assert_tables_equal(want: dict, got: dict) -> None:
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_plain_gram_stream_equals_jax(n):
    data = _corpus(1, 400)
    buf = tok_ops.pad_to(data, -(-len(data) // 128) * 128)
    want = jtok.ngrams(jtok.tokenize(jnp.asarray(buf)), n)
    got = tok_ops.ngrams(tok_ops.tokenize(torch.from_numpy(buf)), n)
    for f in want._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.uint32),
            np.asarray(getattr(want, f)), err_msg=f)


@functools.lru_cache(maxsize=None)
def _xla_tables(n: int):
    data = _corpus(2, 3000)
    jcfg = JConfig(backend="xla", table_capacity=CAP)
    padded = jwc._pad_for_backend(data, jcfg)
    want = _jtable(jwc._ngram_step(jnp.asarray(padded), CAP, n, jcfg))
    return data, want, jwc.count_ngrams(data, n, jcfg)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_gram_table_and_count_ngrams_equal_jax_xla(n, backend):
    """Overlong-free data: the port's plain and kernel paths both equal
    the JAX plain path, table and recovered result (long spans
    included)."""
    data, want_tbl, want = _xla_tables(n)
    cfg = Config(backend=backend, table_capacity=CAP, chunk_bytes=1 << 15)
    chunk = torch.from_numpy(wc._pad_for_backend(data, cfg))
    got_tbl, _ = wc._ngram_map(chunk, n, CAP, 0, cfg, summary=False)
    if backend == "xla":  # same padding: the tables are the JAX one
        _assert_tables_equal(want_tbl, convert.table_to_numpy(got_tbl))
    got = wc.count_ngrams(data, n, cfg, device="cpu")
    assert _result(got) == _result(want)
    assert _as_grams(got) == oracle_ngrams(data, n)
    assert any(len(w) >= 127 for w in got.words) == (n > 1)


PALLAS = dict(chunk_bytes=128 * 66, table_capacity=CAP, backend="pallas")


def _overlong_cases():
    lane = b" ".join(b"w%d" % (i % 37) for i in range(1800))[:128 * 66 - 2]
    lane = lane.rsplit(b" ", 1)[0]  # the whole chunk, ending on a token
    small = _corpus(3, 2000)
    return {
        "lane_seam": (lane, 2),
        "overlong_between": (small[:4000] + b" " + b"x" * 40 + b" "
                             + small[4000:], 2),
        "adjacent_trigram": (b"aa bb " + b"y" * 50 + b" cc dd ee "
                             + b"z" * 40 + b" ff gg", 3),
    }


@pytest.mark.parametrize("case", ["lane_seam", "overlong_between",
                                  "adjacent_trigram"])
def test_kernel_path_equals_jax_pallas(case):
    """The seam and overlong cases of ``tests/test_ngram.py``: the port's
    kernel path equals the JAX Pallas path (interpreted) in table and
    result, and its cut stream is already in the order the JAX package's
    position sort makes: sorting it by ``packed`` changes nothing."""
    data, n = _overlong_cases()[case]
    jcfg = JConfig(**PALLAS)
    cfg = Config(**PALLAS)
    padded = jwc._pad_for_backend(data, jcfg)
    want_tbl = _jtable(jwc._ngram_step(jnp.asarray(padded), CAP, n, jcfg))
    chunk = torch.from_numpy(padded)
    got_tbl, _ = wc._ngram_map(chunk, n, CAP, 0, cfg, summary=False)
    _assert_tables_equal(want_tbl, convert.table_to_numpy(got_tbl))
    want = jwc.count_ngrams(data, n, jcfg)
    got = wc.count_ngrams(data, n, cfg, device="cpu")
    assert _result(got) == _result(want)
    stream, over = kernel_tok.tokenize_split(chunk, cfg.pallas_max_token)
    cut = stream.cut(int(stream.total + over))
    order = torch.sort(cut.packed, stable=True).indices
    for plane in ngram_ops.position_sorted(cut):
        assert torch.equal(plane, plane[order])
    if case != "lane_seam":
        assert int(over) > 0 and got.dropped_count > 0
    if case == "adjacent_trigram":
        assert got.words == [b"cc dd ee"] and got.dropped_count == 6


def _random_carry(rng, m: int, aligned: str, n_live: int):
    kind = np.zeros(m, np.uint32)
    live = slice(m - n_live, m) if aligned == "right" else slice(0, n_live)
    kind[live] = rng.choice([1, 1, 1, 2], n_live)
    vals = [np.where(kind > 0, rng.integers(0, 1 << 32, m), 0)
            .astype(np.uint32) for _ in range(4)]
    return jngram.GramCarry(*(jnp.asarray(v) for v in vals),
                            jnp.asarray(kind))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_carry_and_seam_table_equal_jax(n):
    rng = np.random.default_rng(n)
    m = n - 1
    for _ in range(12):
        prefix = _random_carry(rng, m, "right", int(rng.integers(0, m + 1)))
        first = _random_carry(rng, m, "left", int(rng.integers(0, m + 1)))
        last = _random_carry(rng, m, "right", int(rng.integers(0, m + 1)))
        p_prefix, p_first, p_last = (convert.state_from_numpy(c, "cpu")
                                     for c in (prefix, first, last))
        want = jngram.compose_carry(prefix, last)
        got = ngram_ops.compose_carry(p_prefix, p_last)
        for f in want._fields:
            np.testing.assert_array_equal(
                convert.state_to_numpy(got)._asdict()[f],
                np.asarray(getattr(want, f)), err_msg=f)
        want_t = _jtable(jngram.seam_gram_table(prefix, first, n))
        got_t = ngram_ops.seam_gram_table(p_prefix, p_first, n)
        _assert_tables_equal(want_t, convert.table_to_numpy(got_t))


@pytest.mark.parametrize("n", [2, 3])
def test_summary_of_a_chunk_of_no_tokens_equals_jax(n):
    """A chunk of separators: an empty summary, so the carry passes
    through it unchanged and a window can span three chunks."""
    buf = np.full(256, 0x20, np.uint8)
    buf[100:103] = np.frombuffer(b"abc", np.uint8)
    for data in (np.full(256, 0x20, np.uint8), buf):
        want = jngram.summary_from_stream(
            jtok.tokenize(jnp.asarray(data)), jnp.uint32(5), n)
        got = ngram_ops.summary_from_stream(
            tok_ops.tokenize(torch.from_numpy(data)), 5, n)
        for w, g in zip(want, got):
            for f in w._fields:
                np.testing.assert_array_equal(
                    getattr(g, f).numpy().astype(np.uint32),
                    np.asarray(getattr(w, f)), err_msg=f)
    cfg = Config(**PALLAS)
    chunk = torch.full((128 * 66,), 0x20, dtype=torch.uint8)
    t, summ = wc._ngram_map(chunk, n, CAP, 3, cfg, summary=True)
    assert int(t.n_valid()) == 0 and t.total_count() == 0
    assert all(int(c.kind.abs().sum()) == 0 for c in summ)


CHUNK = 4096
JSTREAM = JConfig(backend="pallas", map_impl="split", combiner="off",
                  pallas_max_token=8, chunk_bytes=CHUNK, table_capacity=CAP,
                  superstep=2, inflight_groups=2)
STREAM = convert.config_from_dict(dataclasses.asdict(JSTREAM))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three files: one long (a 9,000-byte separator run makes a chunk
    of no tokens, and a window of n=3 spans three chunks around it), one
    of a single token (fewer than n-1), one ending in an overlong token."""
    d = tmp_path_factory.mktemp("ngram")
    a = _corpus(5, 1400) + b" " * 9000 + b"lone " + b"\n" * 4200 + b"tail x"
    b = b"single"
    c = _corpus(6, 900) + b" " + b"q" * 20 + b" end"
    paths = []
    for name, data in (("a", a), ("b", b), ("c", c)):
        p = d / f"{name}.txt"
        p.write_bytes(data)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("n", [2, 3])
def test_streamed_ngrams_equal_jax_and_oracle(corpus, n):
    want = jexecutor.count_file(corpus, JSTREAM, mesh=data_mesh(1), ngram=n)
    got = executor.count_file(corpus, STREAM, device="cpu", ngram=n)
    assert _result(got) == _result(want)
    merged: collections.Counter = collections.Counter()
    single: collections.Counter = collections.Counter()
    jcfg = JConfig(backend="xla", table_capacity=CAP)
    for p in corpus:
        data = open(p, "rb").read()
        merged.update(oracle_ngrams(data, n))
        single.update(_as_grams(jwc.count_ngrams(data, n, jcfg)))
    long_free = {g: c for g, c in merged.items()
                 if all(len(t) <= 8 for t in g)}
    assert _as_grams(got) == long_free
    assert dict(single) == dict(merged)
    assert got.total == sum(merged.values())
    assert got.dropped_count == sum(merged.values()) - sum(long_free.values())
    bases = got.run.bases.ravel()
    assert len(bases) > 6  # many chunks, so many seams
    # The xla backend counts the overlong token: the streamed run equals
    # the per-file single-buffer results exactly.
    xla = executor.count_file(corpus, dataclasses.replace(STREAM,
                                                          backend="xla"),
                              device="cpu", ngram=n)
    assert _as_grams(xla) == dict(merged)


def test_force_split_run_recovers_like_jax(tmp_path):
    """A separator-free run longer than a chunk is cut by the chunker, and
    both halves are stream entries: a seam gram over the cut recovers the
    span the JAX package recovers (the row bases are the entry ends)."""
    p = tmp_path / "run.txt"
    p.write_bytes(b"aa bb " + b"r" * 6000 + b" cc dd " + b"ee " * 900)
    jcfg = dataclasses.replace(JSTREAM, backend="xla")
    cfg = dataclasses.replace(STREAM, backend="xla")
    want = jexecutor.count_file(str(p), jcfg, mesh=data_mesh(1), ngram=2)
    got = executor.count_file(str(p), cfg, device="cpu", ngram=2)
    assert _result(got) == _result(want)
    assert any(w.startswith(b"r") and w.endswith(b"cc") for w in got.words)


def test_recover_from_file_equals_jax_over_three_files(tmp_path):
    """Host recovery of a streamed bigram run over three files of 4 KB
    chunks, with cross-chunk seam entries and words past W = 32 bytes:
    ``recover_from_file``'s words, counts and first-occurrence order equal
    the JAX package's recovery of the same table and row bases, and the
    grams equal the oracle's."""
    long_word = b"L" * 40
    parts = (_corpus(7, 1200) + b" " + long_word + b" tail",
             b"m" * 36 + b" x",
             _corpus(8, 900) + b" " + long_word + b" end")
    paths = []
    for i, data in enumerate(parts):
        p = tmp_path / f"part{i}.txt"
        p.write_bytes(data)
        paths.append(str(p))
    cfg = dataclasses.replace(STREAM, backend="xla")
    rr = executor.run_job(wc.NGramCountJob(2, cfg, "cpu"), paths, cfg)
    live = (rr.value.count > 0) | (rr.value.count_hi > 0)
    assert int((live & (rr.value.length == ngram_ops.SEAM_GRAM_LENGTH))
               .sum()) > 0
    got = executor.recover_from_file(rr.value, paths, rr.bases,
                                     rr.bases.shape[1], ngram=2)
    jtbl = jtable.CountTable(**{
        f: jnp.asarray(v) for f, v in convert.table_to_numpy(rr.value)
        .items()})
    want = jexecutor.recover_from_file(jtbl, paths, rr.bases,
                                       rr.bases.shape[1], ngram=2)
    assert _result(got) == _result(want)
    merged: collections.Counter = collections.Counter()
    for data in parts:
        merged.update(oracle_ngrams(data, 2))
    assert _as_grams(got) == dict(merged)
    assert any(long_word in w for w in got.words)
    assert any(w.startswith(b"m" * 36) for w in got.words)


def test_replay_and_resume_keep_the_carry(corpus, tmp_path):
    """A transient fault replays from the anchor (carry and table with
    it); a preemption at every step, resumed from its snapshot, gives the
    uninterrupted result, file seams included (the carry resets there)."""
    want = _result(executor.count_file(corpus, STREAM, device="cpu",
                                       ngram=3))
    cfg = dataclasses.replace(STREAM, fault_plan="at=dispatch:3:transient")
    assert _result(executor.count_file(corpus, cfg, device="cpu", ngram=3,
                                       retry=1)) == want
    from mapreduce_tpu_torch.runtime import faults

    k = 0
    while True:  # a preemption at each token wait, until none is left
        ck = str(tmp_path / f"ck{k}.npz")
        cfg = dataclasses.replace(STREAM,
                                  fault_plan=f"at=token-wait:{k}:preemption")
        try:
            executor.count_file(corpus, cfg, device="cpu", ngram=3,
                                checkpoint_path=ck, checkpoint_every=1)
        except faults.Preempted:
            pass
        else:
            break
        assert _result(executor.count_file(corpus, STREAM, device="cpu",
                                           ngram=3, checkpoint_path=ck)) \
            == want, k
        k += 1
    assert k >= 6


def test_one_host_read_a_chunk(corpus, monkeypatch):
    """A streamed n-gram run and a batched-sketch run read the host once a
    chunk (the ``host_read`` span), as the word count does."""
    reads = collections.Counter()
    real = wc.span

    def counting(name, timer=None):
        reads[name] += 1
        return real(name, timer)

    monkeypatch.setattr(wc, "span", counting)
    runs = {"wordcount": {}, "ngram": {"ngram": 2},
            "sketch": {"ngram": 2, "distinct_sketch": True},
            "batched": {"count_sketch": True}}
    for name, kw in runs.items():
        reads.clear()
        cfg = dataclasses.replace(STREAM, sketch_flush_every=4) \
            if name == "batched" else STREAM
        r = executor.count_file(corpus, cfg, device="cpu", **kw)
        assert reads["host_read"] == len(r.run.bases), name


def test_hot_cache_is_a_no_op_for_grams():
    data = _corpus(7, 2000)
    base = Config(**PALLAS)
    want = wc.count_ngrams(data, 2, base, device="cpu")
    cfg = dataclasses.replace(base, map_impl="fused", combiner="hot-cache")
    wc.BRANCHES.clear()
    got = wc.count_ngrams(data, 2, cfg, device="cpu")
    assert _result(got) == _result(want)
    assert wc.BRANCHES["combiner_hits"] == 0
    assert wc.BRANCHES["spill_fallbacks"] == 0


def test_gram_spans_past_the_packed_gate_use_the_generic_build():
    """A chunk past 2**25 positions takes the generic build; the same
    grams give the same table as the packed build's (lengths included)."""
    data = _corpus(8, 300)
    buf = torch.from_numpy(tok_ops.pad_to(data, -(-len(data) // 128) * 128))
    gs = ngram_ops.mark_long_spans(tok_ops.ngrams(tok_ops.tokenize(buf), 2))
    packed = ngram_ops.gram_table(gs, 1024, 0, max_pos=buf.shape[0])
    generic = ngram_ops.gram_table(gs, 1024, 0, max_pos=(1 << 25) + 128)
    _assert_tables_equal(convert.table_to_numpy(packed),
                         convert.table_to_numpy(generic))
    assert int((packed.length == constants.SEAM_GRAM_LENGTH).sum()) > 0


@pytest.mark.parametrize("kw,identity", [
    ({"ngram": 2}, "ngram2"),
    ({"ngram": 3, "top_k": 5, "count_sketch": True},
     "freqsketchedwordcountjob(ngram3-top5)"),
    ({"distinct_sketch": True}, "sketchedwordcountjob(wordcount)"),
])
def test_telemetered_family_runs(corpus, tmp_path, kw, identity):
    """A telemetered run of a family: ``run_start`` names the JAX job
    identity, the map runs in stats mode (the gram map's counters are its
    batch table's dropped accounting) and the result is the untelemetered
    one."""
    from mapreduce_tpu.models import wordcount as jwc_mod
    from mapreduce_tpu_torch.obs import ledger, telemetry

    n = kw.get("ngram", 1)
    jjob = jwc_mod.NGramCountJob(n, JSTREAM, top_k=kw.get("top_k")) \
        if n > 1 else jwc_mod.WordCountJob(JSTREAM)
    if kw.get("count_sketch"):
        jjob = jwc_mod.FreqSketchedWordCountJob(jjob)
    elif kw.get("distinct_sketch"):
        jjob = jwc_mod.SketchedWordCountJob(jjob)
    assert jjob.identity() == identity
    path = str(tmp_path / "run.jsonl")
    tel = telemetry.Telemetry.create(ledger_path=path)
    try:
        got = executor.count_file(corpus, STREAM, device="cpu",
                                  telemetry=tel, **kw)
    finally:
        tel.close()
    want = executor.count_file(corpus, STREAM, device="cpu", **kw)
    assert _result(got) == _result(want)
    recs = ledger.read_ledger(path)
    start = next(r for r in recs if r["kind"] == "run_start")
    assert start["job"] == identity
    data = next(r for r in recs if r["kind"] == "data")
    assert data["chunks"] == len(got.run.bases)
    if n > 1:
        assert data["dropped_tokens"] > 0  # the overlong token's grams
