"""The port's checkpoints against the JAX package's, on the CPU.

Both packages stream the same 2-file corpus with a snapshot every 2 steps
(the JAX side on a one-device mesh, backend pallas, its Pallas kernel in
interpret mode).  The snapshots after step 2 and step 4 must be equal leaf
for leaf as uint32, with the same cursor, row bases, file index and
``__meta``; a JAX snapshot resumes in the port, and a port snapshot in the
JAX package, to the uninterrupted result.  The same holds for a streamed
top-k run (its job is ``wordcount-top{k}`` in both packages), and both
refuse a plain run's snapshot for a top-k run.  So it does for the n-gram
and sketch families (``ngram2``, ``ngram2-top5``, and distinct- and
count-sketched runs at ``sketch_flush_every`` 1 and 4, whose composite
states are written in the JAX pytree's leaf order), and a snapshot of
another job identity is refused; and for grep (one literal pattern, a
class pattern, three patterns in one pass) and the sample, whose
snapshots resume across packages and whose other pattern is refused.  The
refusals (another
chunk size, capacity or input; future and legacy formats) and the
``.prev`` fallback after corruption are the port's alone.
"""

import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import grep as jgrep
from mapreduce_tpu.models import sample as jsample
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import grep, sample
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.runtime import checkpoint as ckpt
from mapreduce_tpu_torch.runtime import executor
from mapreduce_tpu_torch.runtime.logging import LOGGER_NAME

CHUNK = 4096
JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=CHUNK, table_capacity=4096,
               rescue_overlong=4)
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_engines():
    """One JAX ``Engine`` per job kind and configuration: the JAX executor
    builds one per run, and each compiles its programs anew (~12 s
    interpreted), though runs of one job and config run the same ones."""
    memo = {}
    real = jexecutor.Engine

    def engine(job, mesh, **kw):
        key = (job.identity(), getattr(job, "config", None),
               tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = real(job, mesh, **kw)
        return memo[key]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jexecutor, "Engine", engine)
        yield


def _text(seed: int, n_words: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(250)] + [b"streamed_over"]
    return b" ".join(vocab[int(i) % len(vocab)]
                     for i in rng.zipf(1.3, n_words))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages over the same corpus with ``checkpoint_every=2``:
    their results and the directory holding ``jax.npz`` and ``port.npz``
    (the step-4 snapshots; ``.prev``: step 2)."""
    d = tmp_path_factory.mktemp("ck")
    paths = []
    for i, n in enumerate((2200, 2000)):  # 2 + 3 chunks
        p = d / f"part{i}.txt"
        p.write_bytes(_text(20 + i, n))
        paths.append(str(p))
    want = jexecutor.count_file(paths, JCFG, mesh=data_mesh(1),
                                checkpoint_path=str(d / "jax.npz"),
                                checkpoint_every=2)
    got = executor.count_file(paths, CFG, device="cpu",
                              checkpoint_path=str(d / "port.npz"),
                              checkpoint_every=2)
    return {"dir": d, "paths": paths, "jax": want, "port": got}


def _assert_results_equal(want, got):
    for f in ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count"):
        assert getattr(want, f) == getattr(got, f), f


def test_results_equal(run):
    _assert_results_equal(run["jax"], run["port"])


@pytest.mark.parametrize("suffix,step", [("", 4), (".prev", 2)])
def test_snapshot_equals_jax_leaf_for_leaf(run, suffix, step):
    want = np.load(run["dir"] / f"jax.npz{suffix}")
    got = np.load(run["dir"] / f"port.npz{suffix}")
    assert sorted(got.files) == sorted(want.files)
    assert int(got["__step"]) == int(want["__step"]) == step
    for k in want.files:
        if k == "__meta":
            assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    meta = json.loads(bytes(got["__meta"]))
    assert (meta["backend"], meta["pallas_max_token"], meta["job"],
            meta["n_devices"], meta["format"]) == ("pallas", 8, "wordcount",
                                                   1, 2)
    assert ckpt.verify(str(run["dir"] / f"port.npz{suffix}")) is True


def _copy_snapshot(src, dst) -> str:
    shutil.copy(src, dst)
    shutil.copy(ckpt.integrity_path(str(src)), ckpt.integrity_path(str(dst)))
    return str(dst)


def test_jax_snapshot_resumes_in_the_port(run, tmp_path):
    ck = _copy_snapshot(run["dir"] / "jax.npz.prev", tmp_path / "from_jax.npz")
    got = executor.count_file(run["paths"], CFG, device="cpu",
                              checkpoint_path=ck)
    _assert_results_equal(run["jax"], got)
    assert got.run.metrics.bytes_processed \
        < sum(os.path.getsize(p) for p in run["paths"])


def test_port_snapshot_resumes_in_jax(run, tmp_path):
    ck = _copy_snapshot(run["dir"] / "port.npz.prev",
                        tmp_path / "from_port.npz")
    got = jexecutor.count_file(run["paths"], JCFG, mesh=data_mesh(1),
                               checkpoint_path=ck)
    _assert_results_equal(run["jax"], got)


@pytest.mark.parametrize("change,key", [
    ({"chunk_bytes": 2 * CHUNK}, "chunk_bytes"),
    ({"table_capacity": 2048}, "leaf 0"),
    ({"pallas_max_token": 9}, "pallas_max_token"),
])
def test_mismatched_run_is_refused(run, tmp_path, change, key):
    ck = _copy_snapshot(run["dir"] / "port.npz", tmp_path / "ck.npz")
    cfg = dataclasses.replace(CFG, **change)
    with pytest.raises(ckpt.CheckpointMismatch, match=key):
        executor.count_file(run["paths"], cfg, device="cpu",
                            checkpoint_path=ck)


def test_other_input_is_refused(run, tmp_path):
    ck = _copy_snapshot(run["dir"] / "port.npz", tmp_path / "ck.npz")
    with pytest.raises(ckpt.CheckpointMismatch, match="input_size"):
        executor.count_file(run["paths"][:1], CFG, device="cpu",
                            checkpoint_path=ck)
    other = tmp_path / "other.txt"
    data = bytearray(open(run["paths"][1], "rb").read())
    data[:5] = b"zzzzz"  # same size, other head
    other.write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointMismatch, match="input_hash"):
        executor.count_file([run["paths"][0], str(other)], CFG, device="cpu",
                            checkpoint_path=ck)


def test_corrupt_snapshot_falls_back_to_prev(run, tmp_path):
    ck = _copy_snapshot(run["dir"] / "port.npz", tmp_path / "ck.npz")
    _copy_snapshot(run["dir"] / "port.npz.prev", ckpt.previous_path(ck))
    with open(ck, "r+b") as f:
        f.seek(200)
        f.write(b"\xff" * 64)
    assert ckpt.verify(ck) is False
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_verified(ck)
    (_, step, *_), fallback = ckpt.load_resilient(ck)
    assert step == 2 and fallback["loaded"] == ckpt.previous_path(ck)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = logging.getLogger(LOGGER_NAME)
    logger.addHandler(handler)
    try:
        got = executor.count_file(run["paths"], CFG, device="cpu",
                                  checkpoint_path=ck)
    finally:
        logger.removeHandler(handler)
    assert "corrupt checkpoint; resumed from previous good snapshot" \
        in logged
    _assert_results_equal(run["jax"], got)
    # The previous snapshot is corrupt too: nothing to resume from.
    with open(ckpt.previous_path(ck), "r+b") as f:
        f.seek(200)
        f.write(b"\xff" * 64)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load_resilient(ck)


def test_exists_with_only_prev(run, tmp_path):
    ck = str(tmp_path / "ck.npz")
    assert not ckpt.exists(ck)
    _copy_snapshot(run["dir"] / "port.npz.prev", ckpt.previous_path(ck))
    assert ckpt.exists(ck)
    (_, step, *_), fallback = ckpt.load_resilient(ck)
    assert step == 2 and fallback is not None


def test_future_and_legacy_formats_are_named(tmp_path):
    future = str(tmp_path / "future.npz")
    np.savez(future, __leaf_0=np.zeros(2, np.uint32), __step=np.int64(1),
             __offset=np.int64(0), __bases=np.zeros((1, 1), np.int64),
             __meta=np.frombuffer(json.dumps({"format": 3}).encode(),
                                  np.uint8))
    with pytest.raises(ckpt.CheckpointMismatch, match="newer version"):
        ckpt.load(future)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, key_hi=np.zeros(2, np.uint32), __step=np.int64(1),
             __offset=np.int64(0), __bases=np.zeros((1, 1), np.int64))
    with pytest.raises(ckpt.CheckpointMismatch, match="older version"):
        ckpt.load(legacy)


def test_table_leaves_round_trip():
    gen = torch.Generator().manual_seed(5)
    t = table_ops.empty(64, "cpu")
    t = t._replace(**{f: torch.randint(0, 1 << 32, getattr(t, f).shape,
                                       generator=gen)
                      for f in t._fields})
    leaves = convert.table_to_leaves(t)
    assert [leaf.shape for leaf in leaves] == [(1, 64)] * 7 + [(1,)] * 4
    assert all(leaf.dtype == np.uint32 for leaf in leaves)
    back = convert.leaves_to_table(leaves, "cpu")
    for f in t._fields:
        assert torch.equal(getattr(back, f), getattr(t, f)), f


@pytest.fixture(scope="module")
def topk_run(run):
    """Both packages' streamed top-3 runs over ``run``'s corpus, a snapshot
    every 2 steps (``jax_top3.npz``, ``port_top3.npz``)."""
    d = run["dir"]
    want = jexecutor.count_file(run["paths"], JCFG, mesh=data_mesh(1),
                                top_k=3, checkpoint_path=str(d / "jax_top3.npz"),
                                checkpoint_every=2)
    got = executor.count_file(run["paths"], CFG, device="cpu", top_k=3,
                              checkpoint_path=str(d / "port_top3.npz"),
                              checkpoint_every=2)
    return {"jax": want, "port": got}


@pytest.mark.parametrize("suffix,step", [("", 4), (".prev", 2)])
def test_topk_snapshot_equals_jax(run, topk_run, suffix, step):
    _assert_results_equal(topk_run["jax"], topk_run["port"])
    assert len(topk_run["port"].words) == 3
    want = np.load(run["dir"] / f"jax_top3.npz{suffix}")
    got = np.load(run["dir"] / f"port_top3.npz{suffix}")
    assert sorted(got.files) == sorted(want.files)
    assert int(got["__step"]) == int(want["__step"]) == step
    for k in want.files:
        if k == "__meta":
            assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(bytes(got["__meta"]))["job"] == "wordcount-top3"


def test_topk_snapshots_resume_across_packages(run, topk_run, tmp_path):
    ck = _copy_snapshot(run["dir"] / "jax_top3.npz.prev",
                        tmp_path / "from_jax.npz")
    got = executor.count_file(run["paths"], CFG, device="cpu", top_k=3,
                              checkpoint_path=ck)
    _assert_results_equal(topk_run["jax"], got)
    assert got.run.metrics.bytes_processed \
        < sum(os.path.getsize(p) for p in run["paths"])
    ck = _copy_snapshot(run["dir"] / "port_top3.npz.prev",
                        tmp_path / "from_port.npz")
    got = jexecutor.count_file(run["paths"], JCFG, mesh=data_mesh(1),
                               top_k=3, checkpoint_path=ck)
    _assert_results_equal(topk_run["jax"], got)


def test_plain_snapshot_is_refused_for_a_topk_run(run, topk_run, tmp_path):
    ck = _copy_snapshot(run["dir"] / "port.npz", tmp_path / "port.npz")
    with pytest.raises(ckpt.CheckpointMismatch, match="job"):
        executor.count_file(run["paths"], CFG, device="cpu", top_k=3,
                            checkpoint_path=ck)
    from mapreduce_tpu.runtime import checkpoint as jckpt

    ck = _copy_snapshot(run["dir"] / "jax.npz", tmp_path / "jax.npz")
    with pytest.raises(jckpt.CheckpointMismatch, match="job"):
        jexecutor.count_file(run["paths"], JCFG, mesh=data_mesh(1), top_k=3,
                             checkpoint_path=ck)
    # And the other way: a top-k snapshot is not a plain run's.
    ck = _copy_snapshot(run["dir"] / "port_top3.npz",
                        tmp_path / "port_top3.npz")
    with pytest.raises(ckpt.CheckpointMismatch, match="job"):
        executor.count_file(run["paths"], CFG, device="cpu",
                            checkpoint_path=ck)


#: The n-gram and sketch families: ``count_file`` arguments and the
#: ``sketch_flush_every`` of each.
FAMILIES = {
    "ngram2": ({"ngram": 2}, 1),
    "ngram2-top5": ({"ngram": 2, "top_k": 5}, 1),
    "distinct-f1": ({"distinct_sketch": True}, 1),
    "distinct-f4": ({"distinct_sketch": True}, 4),
    "count-f1": ({"count_sketch": True}, 1),
    "count-f4": ({"count_sketch": True}, 4),
}


@pytest.fixture(scope="module")
def families(run):
    """Both packages' runs of a family over ``run``'s corpus, a snapshot
    every 2 steps (``jax_<kind>.npz``, ``port_<kind>.npz``), made on first
    use."""
    done = {}

    def get(kind):
        if kind not in done:
            kw, flush = FAMILIES[kind]
            d = run["dir"]
            jcfg = dataclasses.replace(JCFG, sketch_flush_every=flush)
            cfg = dataclasses.replace(CFG, sketch_flush_every=flush)
            want = jexecutor.count_file(
                run["paths"], jcfg, mesh=data_mesh(1),
                checkpoint_path=str(d / f"jax_{kind}.npz"),
                checkpoint_every=2, **kw)
            got = executor.count_file(
                run["paths"], cfg, device="cpu",
                checkpoint_path=str(d / f"port_{kind}.npz"),
                checkpoint_every=2, **kw)
            done[kind] = {"jax": want, "port": got, "cfg": cfg,
                          "jcfg": jcfg, "kw": kw}
        return done[kind]

    return get


def _assert_family_results_equal(want, got):
    _assert_results_equal(want, got)
    assert want.distinct_estimate == got.distinct_estimate
    assert (want.cms is None) == (got.cms is None)
    if got.cms is not None:
        np.testing.assert_array_equal(got.cms, np.asarray(want.cms))


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_family_snapshot_equals_jax(run, families, kind):
    f = families(kind)
    _assert_family_results_equal(f["jax"], f["port"])
    for suffix, step in (("", 4), (".prev", 2)):
        want = np.load(run["dir"] / f"jax_{kind}.npz{suffix}")
        got = np.load(run["dir"] / f"port_{kind}.npz{suffix}")
        assert sorted(got.files) == sorted(want.files)
        assert int(got["__step"]) == int(want["__step"]) == step
        for k in want.files:
            if k == "__meta":
                assert json.loads(bytes(got[k])) \
                    == json.loads(bytes(want[k]))
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_family_snapshots_resume_across_packages(run, families, kind,
                                                 tmp_path):
    f = families(kind)
    ck = _copy_snapshot(run["dir"] / f"jax_{kind}.npz.prev",
                        tmp_path / "from_jax.npz")
    got = executor.count_file(run["paths"], f["cfg"], device="cpu",
                              checkpoint_path=ck, **f["kw"])
    _assert_family_results_equal(f["jax"], got)
    assert got.run.metrics.bytes_processed \
        < sum(os.path.getsize(p) for p in run["paths"])
    ck = _copy_snapshot(run["dir"] / f"port_{kind}.npz.prev",
                        tmp_path / "from_port.npz")
    got = jexecutor.count_file(run["paths"], f["jcfg"], mesh=data_mesh(1),
                               checkpoint_path=ck, **f["kw"])
    _assert_family_results_equal(f["jax"], got)


@pytest.mark.parametrize("kind,other,match", [
    ("ngram2", {"ngram": 3}, "job"),
    ("ngram2", {}, "job"),
    ("ngram2-top5", {"ngram": 2}, "job"),
    ("distinct-f1", {"count_sketch": True}, "job"),
    ("distinct-f1", {}, "job"),
    ("count-f4", {"count_sketch": True}, "state structure"),
])
def test_family_snapshot_of_another_job_is_refused(run, families, kind,
                                                   other, match, tmp_path):
    """Another identity is refused by the fingerprint; the same identity
    at another flush cadence by the leaves' layout."""
    families(kind)
    ck = _copy_snapshot(run["dir"] / f"port_{kind}.npz",
                        tmp_path / "ck.npz")
    with pytest.raises(ckpt.CheckpointMismatch, match=match):
        executor.count_file(run["paths"], CFG, device="cpu",
                            checkpoint_path=ck, **other)


def test_state_leaves_round_trip_in_jax_order():
    """A batched sketch over an n-gram state flattens as the JAX pytree
    does: the table's 11 leaves, the carry's 5, the sketch, the pending
    planes and the cursor (a host int, written as a uint32 leaf)."""
    from mapreduce_tpu_torch.models import wordcount as wc

    cfg = dataclasses.replace(CFG, sketch_flush_every=2)
    job = wc.SketchedWordCountJob(wc.NGramCountJob(3, cfg, "cpu"))
    state = job.init_state()
    state = state._replace(cursor=1, pend_cnt=state.pend_cnt + 7)
    leaves = convert.state_to_leaves(state)
    assert len(leaves) == 11 + 5 + 1 + 3 + 1
    assert leaves[-1].shape == (1,) and int(leaves[-1][0]) == 1
    back = convert.leaves_to_state(leaves, job.init_state(), "cpu")
    assert back.cursor == 1 and isinstance(back.cursor, int)
    assert torch.equal(back.pend_cnt, state.pend_cnt)
    assert torch.equal(back.table.carry.kind, state.table.carry.kind)


def _grep_families():
    return {
        "grep": (lambda p, c, **kw: jgrep.grep_file(p, b"w1", c, **kw),
                 lambda p, c, **kw: grep.grep_file(p, b"w1", c, **kw)),
        "grepc": (lambda p, c, **kw: jgrep.grep_file(
            p, b"w[0-9]", c, syntax="class", **kw),
            lambda p, c, **kw: grep.grep_file(p, b"w[0-9]", c,
                                              syntax="class", **kw)),
        "grep3": (lambda p, c, **kw: jgrep.grep_file_multi(
            p, [b"w1", b" w", b"e"], c, **kw),
            lambda p, c, **kw: grep.grep_file_multi(p, [b"w1", b" w", b"e"],
                                                    c, **kw)),
        "sample16": (lambda p, c, **kw: jsample.sample_file(p, 16, c, **kw),
                     lambda p, c, **kw: sample.sample_file(p, 16, c, **kw)),
    }


@pytest.fixture(scope="module")
def grep_runs(run):
    """Both packages' grep and sample runs over ``run``'s corpus, a
    snapshot every 2 steps (``jax_<kind>.npz``, ``port_<kind>.npz``)."""
    d = run["dir"]
    out = {}
    for kind, (jfn, pfn) in _grep_families().items():
        want = jfn(run["paths"], JCFG, mesh=data_mesh(1),
                   checkpoint_path=str(d / f"jax_{kind}.npz"),
                   checkpoint_every=2)
        got = pfn(run["paths"], CFG, device="cpu",
                  checkpoint_path=str(d / f"port_{kind}.npz"),
                  checkpoint_every=2)
        out[kind] = {"jax": want, "port": got, "fns": (jfn, pfn)}
    return out


@pytest.mark.parametrize("kind", ["grep", "grepc", "grep3", "sample16"])
def test_grep_and_sample_snapshots_equal_jax(run, grep_runs, kind):
    f = grep_runs[kind]
    assert f["port"] == f["jax"]
    for suffix, step in (("", 4), (".prev", 2)):
        want = np.load(run["dir"] / f"jax_{kind}.npz{suffix}")
        got = np.load(run["dir"] / f"port_{kind}.npz{suffix}")
        assert sorted(got.files) == sorted(want.files)
        assert int(got["__step"]) == int(want["__step"]) == step
        for k in want.files:
            if k == "__meta":
                assert json.loads(bytes(got[k])) \
                    == json.loads(bytes(want[k]))
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["grep", "grepc", "grep3", "sample16"])
def test_grep_and_sample_snapshots_resume_across_packages(run, grep_runs,
                                                          kind, tmp_path):
    f = grep_runs[kind]
    jfn, pfn = f["fns"]
    ck = _copy_snapshot(run["dir"] / f"jax_{kind}.npz.prev",
                        tmp_path / "from_jax.npz")
    assert pfn(run["paths"], CFG, device="cpu", checkpoint_path=ck) \
        == f["jax"]
    ck = _copy_snapshot(run["dir"] / f"port_{kind}.npz.prev",
                        tmp_path / "from_port.npz")
    assert jfn(run["paths"], JCFG, mesh=data_mesh(1), checkpoint_path=ck) \
        == f["jax"]


@pytest.mark.parametrize("kind,other", [
    ("grep", lambda p, c, **kw: grep.grep_file(p, b"w2", c, **kw)),
    ("grep", lambda p, c, **kw: grep.grep_file(p, b"w1", c, syntax="class",
                                               **kw)),
    ("grep3", lambda p, c, **kw: grep.grep_file_multi(
        p, [b"w1", b" w", b"f"], c, **kw)),
    ("sample16", lambda p, c, **kw: sample.sample_file(p, 17, c, **kw)),
    ("grep", lambda p, c, **kw: executor.count_file(p, c, **kw)),
], ids=["other-pattern", "other-syntax", "other-set", "other-k",
        "wordcount"])
def test_grep_and_sample_snapshot_of_another_job_is_refused(
        run, grep_runs, kind, other, tmp_path):
    """Same state shape, another pattern (or syntax, pattern set or k): the
    job identity in the fingerprint refuses the resume."""
    ck = _copy_snapshot(run["dir"] / f"port_{kind}.npz", tmp_path / "ck.npz")
    with pytest.raises(ckpt.CheckpointMismatch, match="job"):
        other(run["paths"], CFG, device="cpu", checkpoint_path=ck)
