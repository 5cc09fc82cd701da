"""The port's sketches against the JAX package's, on the CPU.

HyperLogLog registers and Count-Min cells after the same keys, in both
packages, compared exactly as uint32 (a cell driven past 2**32 wraps in
both); the host mirror ``hash_word`` against the device's keys of words and
of gram spans; the HLL estimate equal as a float; ``sketch_flush_every``
4 against 1; and streamed sketched runs, one whose table overflows, against
the JAX executor.  Tolerance zero, except where a test states one against
the true distinct count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.ops import sketch as jsketch
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import sketch
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.runtime import executor

FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count", "distinct_estimate")


def _result(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


def _keys(seed: int, n: int):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo[:7] = 0  # key_lo == 0: the largest rho
    cnt = rng.integers(0, 50, n).astype(np.uint32)
    cnt[::5] = 0  # empty table slots
    return hi, lo, cnt


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("precision", [4, 10, 14])
def test_registers_equal_jax(precision):
    regs, jregs = sketch.empty(precision, "cpu"), jsketch.empty(precision)
    for seed in range(3):
        hi, lo, cnt = _keys(seed, 5000)
        jregs = jsketch.update_from_keys(jregs, jnp.asarray(hi),
                                         jnp.asarray(lo), jnp.asarray(cnt > 0))
        regs = sketch.update_from_keys(regs, _t(hi), _t(lo), _t(cnt) > 0)
        np.testing.assert_array_equal(regs.numpy().astype(np.uint32),
                                      np.asarray(jregs))
    other = sketch.update_from_keys(sketch.empty(precision, "cpu"),
                                    *(_t(x) for x in _keys(9, 300)[:2]),
                                    torch.ones(300, dtype=torch.bool))
    np.testing.assert_array_equal(
        sketch.merge(regs, other).numpy(),
        np.asarray(jsketch.merge(jregs, jnp.asarray(other.numpy()
                                                    .astype(np.uint32)))))
    assert sketch.estimate(regs) == jsketch.estimate(np.asarray(jregs))
    assert sketch.estimate(regs.numpy()) == sketch.estimate(regs)


def test_cms_equals_jax_and_wraps_past_2_32():
    """Cells start just below 2**32, so the adds wrap: the port's int64
    cells are masked to 32 bits after every add, as JAX's uint32 wrap."""
    start = np.full((4, 1 << 8), 0xFFFFFFF0, np.uint32)
    start[1] = 7
    jcms = jnp.asarray(start)
    cms = convert.state_from_numpy(start, "cpu")
    for seed in range(3):
        hi, lo, cnt = _keys(10 + seed, 3000)
        jcms = jsketch.cms_update(jcms, jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(cnt))
        cms = sketch.cms_update(cms, _t(hi), _t(lo), _t(cnt))
        np.testing.assert_array_equal(cms.numpy().astype(np.uint32),
                                      np.asarray(jcms))
    assert int(cms.max()) < (1 << 32)
    assert (cms.numpy()[0] < 0xFFFFFFF0).any()  # a cell wrapped
    merged = sketch.cms_merge(cms, convert.state_from_numpy(start, "cpu"))
    np.testing.assert_array_equal(
        merged.numpy().astype(np.uint32),
        np.asarray(jsketch.cms_merge(jcms, jnp.asarray(start))))
    for word in (b"a", b"hello world", b"zzz"):
        assert sketch.cms_query(cms, word) \
            == jsketch.cms_query(np.asarray(jcms), word)


def test_cms_and_register_shapes_are_checked():
    with pytest.raises(ValueError, match="precision"):
        sketch.empty(3)
    with pytest.raises(ValueError, match="depth"):
        sketch.cms_empty(9)
    with pytest.raises(ValueError, match="width_log2"):
        sketch.cms_empty(4, 30)


def test_hash_word_matches_the_device_keys():
    """Words against the tokenizer's keys; gram spans (separators inside)
    against the gram table's keys."""
    rng = np.random.default_rng(3)
    vocab = [bytes(rng.integers(33, 127, int(k)).astype(np.uint8))
             for k in rng.integers(1, 20, 200)]
    data = b" ".join(vocab[int(i)] for i in rng.integers(0, 200, 800))
    buf = torch.from_numpy(tok_ops.pad_to(data, -(-len(data) // 128) * 128))
    s = tok_ops.tokenize(buf)
    ends = torch.nonzero(s.count).squeeze(1)
    for e in ends[:300].tolist():
        p, n = int(s.pos[e]), int(s.length[e])
        assert sketch.hash_word(data[p:p + n]) \
            == (int(s.key_hi[e]), int(s.key_lo[e]))
        assert sketch.hash_word(data[p:p + n]) \
            == jsketch.hash_word(data[p:p + n])
    for n in (2, 3):
        cfg = Config(table_capacity=4096, chunk_bytes=1 << 14)
        chunk = torch.from_numpy(wc._pad_for_backend(data, cfg))
        t, _ = wc._ngram_map(chunk, n, 4096, 0, cfg, summary=False)
        r = wc.recover_result(t, data, ngram=n)
        occ = t.occupied()
        order = torch.argsort(t.pos_lo[occ])  # recover_result's order
        keys = zip(t.key_hi[occ][order].tolist(),
                   t.key_lo[occ][order].tolist())
        assert len(r.words) > 100
        for w, key in zip(r.words, keys):
            assert sketch.hash_word(w) == key == jsketch.hash_word(w), w


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two files of ~3,000 distinct words: past a 1,024-entry table."""
    d = tmp_path_factory.mktemp("sketch")
    rng = np.random.default_rng(11)
    paths = []
    for i in range(2):
        words = [b"u%d_%d" % (i, int(k)) for k in rng.integers(0, 1600, 4000)]
        p = d / f"part{i}.txt"
        p.write_bytes(b" ".join(words))
        paths.append(str(p))
    return paths


JCFG = JConfig(backend="xla", chunk_bytes=8192, table_capacity=1024,
               superstep=2, inflight_groups=2)
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


@pytest.mark.parametrize("kw", [{"distinct_sketch": True},
                                {"count_sketch": True},
                                {"ngram": 2, "distinct_sketch": True}],
                         ids=["distinct", "count", "ngram2-distinct"])
def test_overflowing_sketched_runs_equal_jax(corpus, kw):
    want = jexecutor.count_file(corpus, JCFG, mesh=data_mesh(1), **kw)
    got = executor.count_file(corpus, CFG, device="cpu", **kw)
    assert _result(got) == _result(want)
    assert got.dropped_uniques > 0  # the table overflowed
    if "count_sketch" in kw:
        np.testing.assert_array_equal(got.cms, np.asarray(want.cms))
        for w in (b"u0_5", b"u1_1599", b"absent"):
            assert got.estimate_count(w) == want.estimate_count(w)
        assert got.distinct_estimate is None
    else:
        true = len(set(open(corpus[0], "rb").read().split())
                   | set(open(corpus[1], "rb").read().split())) \
            if "ngram" not in kw else None
        if true is not None:  # HLL at p=14: within 3 % at this size
            assert abs(got.distinct_estimate - true) / true < 0.03


@pytest.mark.parametrize("kw", [{"distinct_sketch": True},
                                {"count_sketch": True}])
def test_flush_every_4_equals_1(corpus, kw):
    one = executor.count_file(corpus, CFG, device="cpu", **kw)
    four = executor.count_file(corpus, dataclasses.replace(
        CFG, sketch_flush_every=4), device="cpu", **kw)
    assert _result(one) == _result(four)
    if one.cms is not None:
        np.testing.assert_array_equal(one.cms, four.cms)
    job = wc.SketchedWordCountJob(wc.WordCountJob(
        dataclasses.replace(CFG, sketch_flush_every=3), "cpu"))
    state = job.init_state()
    assert state.cursor == 0 and state.pend_hi.shape[0] == 3 * 1024


def test_batched_cursor_stays_on_the_host_and_state_matches_jax(corpus):
    """The batched state after each combine equals the JAX one leaf for
    leaf, the cursor included (the port keeps it as a host int)."""
    jcfg = dataclasses.replace(JCFG, sketch_flush_every=3)
    cfg = dataclasses.replace(CFG, sketch_flush_every=3)
    jjob = jwc.FreqSketchedWordCountJob(jwc.WordCountJob(jcfg))
    job = wc.FreqSketchedWordCountJob(wc.WordCountJob(cfg, "cpu"))
    jstate, state = jjob.init_state(), job.init_state()
    data = open(corpus[0], "rb").read()
    for step in range(5):
        raw = data[step * 4000:(step + 1) * 4000]
        buf = tok_ops.pad_to(raw, 8192)
        jupd = jjob.map_chunk(jnp.asarray(buf), jnp.uint32(step))
        jstate = jjob.combine(jstate, jupd)
        state = job.combine(state, job.map_chunk(torch.from_numpy(buf), step))
        assert isinstance(state.cursor, int)
        assert state.cursor == int(jstate.cursor) == (step + 1) % 3
        for a, b in zip(convert.state_to_leaves(state),
                        convert.state_to_leaves(convert.state_from_numpy(
                            jstate, "cpu"))):
            np.testing.assert_array_equal(a, b)
    fin = job.finalize(state)
    jfin = jjob.finalize(jstate)
    np.testing.assert_array_equal(fin.cms.numpy().astype(np.uint32),
                                  np.asarray(jfin.cms))


def test_both_sketches_are_refused(corpus):
    with pytest.raises(ValueError, match="mutually exclusive"):
        executor.count_file(corpus, CFG, device="cpu", distinct_sketch=True,
                            count_sketch=True)
    with pytest.raises(ValueError, match="sketch_flush_every"):
        Config(sketch_flush_every=0)


def test_the_ladder_rebinds_the_wrapped_base_job(monkeypatch, corpus):
    """A resource storm at dispatch that clears only once the map runs the
    torch sort: under a sketch wrapper the ladder's rungs must reach the
    base job, whose map is what runs (else the storm never clears)."""
    cfg = Config(backend="pallas", pallas_max_token=8, chunk_bytes=8192,
                 table_capacity=1024, map_impl="fused", combiner="hot-cache",
                 sort_impl="radix", superstep=2, inflight_groups=2,
                 failure_policy={"resource_retries": 1,
                                 "transient_retries": 1, "degrade": True,
                                 "backoff_base_s": 0.0, "jitter_frac": 0.0})
    want = executor.count_file(corpus, cfg, device="cpu",
                               distinct_sketch=True)
    seen = []
    real = wc._map_stream

    def storming(chunk, config, capacity, pos_hi=0, with_stats=False):
        seen.append((config.combiner, config.map_impl, config.sort_impl))
        if config.sort_impl != "xla":
            raise RuntimeError("RESOURCE_EXHAUSTED: injected storm")
        return real(chunk, config, capacity, pos_hi, with_stats)

    monkeypatch.setattr(wc, "_map_stream", storming)
    got = executor.count_file(corpus, cfg, device="cpu",
                              distinct_sketch=True)
    assert _result(got) == _result(want)
    assert got.run.pipeline["degrade_steps"] \
        == ["combiner-off", "map-split", "sort-xla"]
    assert seen[0] == ("hot-cache", "fused", "radix")
    assert ("off", "fused", "radix") in seen \
        and ("off", "split", "radix") in seen
    assert set(seen[-3:]) == {("off", "split", "xla")}
