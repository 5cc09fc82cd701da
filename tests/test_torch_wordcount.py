"""The port's word count end to end against the JAX package's, on the CPU.

``count_words`` runs the port's kernel path (on a CPU tensor, the kernel's
plain PyTorch version) and the JAX package's Pallas path in interpret mode
on the same seeded corpora: Zipf text, dense one-letter text (where the TPU
layout's compact windows spill; the port's dense stream takes no
fallback), overlong tokens (the tiered rescue, and the residual it leaves
accounted), a buffer of separators only, a buffer that ends in overlong
runs (the poison rows sort last, just before the stream's one dead row)
and table-capacity spill.  Every
``WordCountResult`` field must be equal, exactly: this is integer hashing
and counting, tolerance zero.

The JAX reference is the single-stream kernel path (``map_impl='fused'``,
``combiner='off'``), which the JAX package documents as bit-identical to its
split path except that, under batch-capacity spill, the split path's
separate seam table can change the ``dropped_uniques`` upper bound.  The
port emits one stream, as the fused path does, so it is held to that path.

The streamed ``count_file`` is held to the JAX ``executor.count_file`` on a
one-device mesh (its default split path: no batch-capacity spill there),
to JAX ``count_words`` over the whole file, and to the oracle.
"""

import ast
import dataclasses
import functools
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.runtime import executor
from mapreduce_tpu_torch.utils import oracle

N = 1 << 14  # every corpus is N bytes: one JAX compile per config
W = 8
REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_config(capacity: int) -> JConfig:
    return JConfig(backend="pallas", map_impl="fused", combiner="off",
                   pallas_max_token=W, chunk_bytes=1 << 14,
                   table_capacity=capacity, rescue_overlong=4)


def _port_config(capacity: int, **kw):
    d = {**dataclasses.asdict(_jax_config(capacity)), **kw}
    return convert.config_from_dict(d)


def _zipf(seed: int, n_words: int = 2600) -> list[bytes]:
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(200)] + [b"abcdefgh"]
    return [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]


def _with_overlong(seed: int, n_long: int) -> bytes:
    """Zipf words with ``n_long`` tokens longer than W: most fit the rescue
    window, a few do not (they stay accounted)."""
    rng = np.random.default_rng(seed)
    words = _zipf(seed, 2200)
    longs = [b"over%03d" % i * 3 for i in range(5)] + [b"L" * 200]
    for i in rng.choice(len(words), n_long, replace=False):
        words[i] = longs[int(rng.integers(0, len(longs)))]
    return b" ".join(words)


CORPORA = {
    "zipf": lambda: b" ".join(_zipf(0)),
    "dense": lambda: b"a b " * 3000 + b" ".join(_zipf(1, 500)),
    "rescue_tier2": lambda: _with_overlong(2, 10),  # 4 < overlong <= 16
    "rescue_residual": lambda: _with_overlong(3, 40),  # overlong > 16
    "separators": lambda: b" \n\t" * N,  # no token: the stream is its dead row
    # Three overlong runs close the buffer (N bytes, no separator after).
    "overlong_end": lambda: b" ".join(_zipf(4, 5000))[:N - 180] + b" "
    + b" ".join([b"over007" * 4, b"L" * 45, b"over009" * 15])[:179],
}


def _exactly_n(data: bytes) -> bytes:
    """Cut or pad (with spaces) to N bytes."""
    return data[:N].ljust(N, b" ")


def _data(case: str) -> bytes:
    return _exactly_n(CORPORA[case]())


@functools.lru_cache(maxsize=None)
def _jax_result(case: str, capacity: int):
    return jwc.count_words(_data(case), _jax_config(capacity))


def _assert_results_equal(want, got):
    for f in ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count"):
        assert getattr(want, f) == getattr(got, f), f


@pytest.mark.parametrize("case", list(CORPORA))
def test_count_words_matches_jax(case):
    wc.BRANCHES.clear()
    got = wc.count_words(_data(case), _port_config(4096), device="cpu")
    _assert_results_equal(_jax_result(case, 4096), got)
    assert got.total == oracle.total_count(_data(case))
    if case == "zipf":
        assert got.as_dict() == oracle.word_counts(_data(case))
        assert not wc.BRANCHES["spill_fallbacks"]
    if case == "dense":
        # The dense stream holds every row: no pair rerun.
        assert wc.BRANCHES["spill_fallbacks"] == 0
        assert got.as_dict() == oracle.word_counts(_data(case))
    if case.startswith("rescue"):
        assert wc.BRANCHES["rescue_escalations"] == 1
        assert got.dropped_count > 0  # the 200-byte tokens stay accounted
    if case == "separators":
        assert (got.total, got.words) == (0, [])
    if case == "overlong_end":
        # All three are rescued at the first tier: the rescue slice found
        # the poison rows at the end of the stream.
        assert wc.BRANCHES["rescue_passes"] == 1
        assert not wc.BRANCHES["rescue_escalations"]
        assert got.dropped_count == 0
        assert got.as_dict() == oracle.word_counts(_data(case))


def test_capacity_spill_matches_jax():
    got = wc.count_words(_data("zipf"), _port_config(64), device="cpu")
    want = _jax_result("zipf", 64)
    _assert_results_equal(want, got)
    assert got.dropped_uniques > 0 and len(got.words) == 64


def test_count_table_matches_jax_field_by_field():
    data = _data("rescue_tier2")
    want = jwc.count_table(data, _jax_config(4096))
    got = wc.count_table(data, _port_config(4096), device="cpu")
    got = convert.table_to_numpy(got)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), got[f],
                                      err_msg=f)


def test_pair_mode_and_sort3_give_the_same_result():
    data = _data("rescue_tier2")
    want = wc.count_words(data, _port_config(4096), device="cpu")
    for kw in ({"compact_slots": 0}, {"sort_mode": "sort3"},
               {"map_impl": "split"}):
        _assert_results_equal(
            want, wc.count_words(data, _port_config(4096, **kw),
                                 device="cpu"))


def test_xla_backend_matches_oracle():
    data = _data("zipf") + b" " + b"L" * 300
    got = wc.count_words(data, wc.Config(backend="xla"), device="cpu")
    assert got.as_dict() == oracle.word_counts(data)


def test_fixture_golden():
    got = wc.count_words((REPO / "test.txt").read_bytes(), device="cpu")
    assert got.as_dict() == {b"Hello": 2, b"World": 2, b"EveryOne": 1,
                             b"Good": 2, b"News": 1, b"Morning": 1}
    assert got.words[:3] == [b"Hello", b"World", b"EveryOne"]
    assert got.total == 9


def _stream_corpus() -> bytes:
    # Two overlong tokens per 4 KB chunk at most: within the per-chunk
    # rescue budget, so streamed and single-buffer runs rescue alike.
    words = _zipf(7, 4000)
    for i in range(150, len(words), 500):
        words[i] = b"streamed_over%d" % (i % 3)
    return _exactly_n(b" ".join(words))


def test_count_file_matches_jax_count_words(tmp_path):
    data = _stream_corpus()
    path = tmp_path / "corpus.txt"
    path.write_bytes(data)
    cfg = dataclasses.replace(_port_config(4096), chunk_bytes=4096)
    got = executor.count_file(str(path), cfg, device="cpu")
    want = jwc.count_words(data, _jax_config(4096))
    _assert_results_equal(want, got)
    assert got.as_dict() == oracle.word_counts(data)
    assert got.total == oracle.total_count(data)


def test_count_file_matches_jax_count_file(tmp_path):
    from mapreduce_tpu.parallel.mesh import data_mesh
    from mapreduce_tpu.runtime import executor as jexecutor

    path = tmp_path / "corpus.txt"
    path.write_bytes(_stream_corpus())
    jcfg = dataclasses.replace(_jax_config(4096), chunk_bytes=4096,
                               map_impl="split")
    # One device: interpret mode deadlocks on the streamed stable2 path
    # over the conftest's 8 virtual CPU devices.
    want = jexecutor.count_file(str(path), jcfg, mesh=data_mesh(1))
    cfg = dataclasses.replace(_port_config(4096), chunk_bytes=4096)
    got = executor.count_file(str(path), cfg, device="cpu")
    _assert_results_equal(want, got)


def test_count_file_multi_file_and_top_k(tmp_path):
    data = _stream_corpus()
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(data[:7001])
    b.write_bytes(data[7001:])
    cfg = dataclasses.replace(_port_config(4096), chunk_bytes=4096)
    joined = data[:7001] + b"\n" + data[7001:]
    got = executor.count_file([str(a), str(b)], cfg, device="cpu")
    assert got.as_dict() == oracle.word_counts(joined)
    want = wc.count_words(joined, _port_config(4096), device="cpu")
    _assert_results_equal(want, got)
    # Streamed top-k (the JAX top-k job's semantics): the evicted words fold
    # into dropped_*, distinct stays the whole corpus's.
    top = executor.count_file([str(a), str(b)], cfg, device="cpu", top_k=5)
    want_top = wc.apply_top_k(want, 5)
    for f in ("words", "counts", "total", "distinct"):
        assert getattr(top, f) == getattr(want_top, f), f
    assert top.dropped_count == want.total - sum(top.counts)
    assert top.dropped_uniques == len(want.words) - 5


def test_streamed_first_occurrence_carries_the_chunk_id(tmp_path):
    """pos_hi is the chunk index, and (pos_hi, pos_lo) decodes through the
    row bases to each word's first byte offset in the file."""
    from mapreduce_tpu_torch.data import reader
    from mapreduce_tpu_torch.parallel.mapreduce import Engine

    data = _stream_corpus()
    path = tmp_path / "c.txt"
    path.write_bytes(data)
    cfg = dataclasses.replace(_port_config(4096), chunk_bytes=4096)
    batches = list(reader.iter_batches(str(path), 1, cfg.chunk_bytes))
    assert len(batches) >= 4
    tbl = Engine(wc.WordCountJob(cfg, "cpu"), "cpu").run(
        b.data for b in batches)
    occ = tbl.occupied()
    chunk_id = tbl.pos_hi[occ].numpy()
    bases = np.stack([b.base_offsets for b in batches])
    absolute = executor.absolute_offsets(chunk_id, tbl.pos_lo[occ].numpy(),
                                         bases, 1)
    first = {}
    for m in re.finditer(rb"[^ \t\n\r]+", data):
        first.setdefault(m.group(), m.start())
    words = [data[a:a + n] for a, n in zip(absolute, tbl.length[occ].tolist())]
    assert sorted(absolute.tolist()) == sorted(first[w] for w in words)
    assert len(words) == len(first)
    assert set(chunk_id.tolist()) <= set(range(len(batches)))
    assert len(set(chunk_id.tolist())) > 1


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wc.count_words(b"hello world")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.count_file(str(REPO / "test.txt"))


def test_package_imports_neither_jax_nor_the_jax_package(tmp_path):
    pkg = REPO / "mapreduce_tpu_torch"
    for src in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "mapreduce_tpu",
                                    "bench", "tools"), src
    code = ("import sys; import mapreduce_tpu_torch as m; "
            "r = m.count_words(b'a b a', device='cpu'); "
            "assert r.as_dict() == {b'a': 2, b'b': 1}; "
            "c = m.Config(map_impl='fused', combiner='hot-cache', "
            "sort_impl='radix'); "
            "r = m.count_words(b'a b a', c, device='cpu'); "
            "assert r.as_dict() == {b'a': 2, b'b': 1}; "
            "import mapreduce_tpu_torch.ops.cuda.radix; "
            "from mapreduce_tpu_torch.ops import ngram, sketch; "
            "from mapreduce_tpu_torch.models import wordcount as wc; "
            "r = wc.count_ngrams(b'a b a b', 2, device='cpu'); "
            "assert r.as_dict() == {b'a b': 2, b'b a': 1}; "
            "r = m.count_file('test.txt', device='cpu', ngram=2, "
            "distinct_sketch=True); "
            "assert r.total == 8 and r.distinct_estimate is not None; "
            "assert sketch.hash_word(b'a') == sketch.hash_word(b'a'); "
            "import mapreduce_tpu_torch.cli, mapreduce_tpu_torch.native; "
            "from mapreduce_tpu_torch.runtime import checkpoint, faults; "
            "from mapreduce_tpu_torch.obs import spans; "
            "from mapreduce_tpu_torch.obs import (flight, ledger, registry, "
            "telemetry, timeline); "
            "from mapreduce_tpu_torch.ops import datastats; "
            "from mapreduce_tpu_torch.runtime import profiling; "
            "from mapreduce_tpu_torch.models import (build_model, grep, "
            "model_names, sample); "
            "from mapreduce_tpu_torch.utils import verify; "
            "assert grep.grep_bytes(b'a b\\na', b'a', device='cpu')[1:] "
            "== (2, 2); "
            "assert grep.grep_file_multi('test.txt', [b'o', b'Hello'], "
            "device='cpu')[1].lines == 2; "
            "assert sample.sample_file('test.txt', 4, device='cpu').total "
            "== 9; "
            "assert len(sample.sample_bytes(b'a b a', 9, device='cpu')"
            ".tokens) == 3; "
            "assert all(build_model(n, device='cpu') for n in model_names()); "
            "assert verify.recount_exact('test.txt', [b'Hello']) "
            "== {b'Hello': 2}; "
            "tel = telemetry.Telemetry.create(ledger_path='%s.jsonl'); "
            "r = m.count_file('test.txt', device='cpu', "
            "checkpoint_path='%s', checkpoint_every=1, telemetry=tel); "
            "tel.close(); "
            "assert timeline.reconstruct(ledger.read_ledger("
            "'%s.jsonl'))['groups'] == 1; "
            "assert r.total == 9 and checkpoint.exists('%s'); "
            "c = m.Config(fault_plan='at=dispatch:0:transient'); "
            "r = m.count_file('test.txt', c, device='cpu', retry=1); "
            "assert r.total == 9 and faults.classify(KeyboardInterrupt()) "
            "== 'preemption'; "
            "from mapreduce_tpu_torch.parallel import distributed, mesh; "
            "from mapreduce_tpu_torch.runtime import executor; "
            "rr = executor.run_job_global(wc.WordCountJob(device='cpu'), "
            "'test.txt', mesh=mesh.two_level_mesh(1, 1), "
            "merge_strategy='hier-kr-tree'); "
            "assert rr.value.total_count() == 9; "
            "from mapreduce_tpu_torch import tuning; "
            "from mapreduce_tpu_torch.obs import datahealth, fleet, history; "
            "from mapreduce_tpu_torch.analysis import geometry; "
            "r = m.count_file('test.txt', m.Config(autotune='hint'), "
            "device='cpu'); "
            "assert tuning.validate_knobs(r.run.tune['proposal']) is None; "
            "assert geometry.resolve_auto('no-such.json') == 'default'; "
            "assert distributed.process_count() == 1; "
            "import torch; "
            "from mapreduce_tpu_torch.analysis import cli as acli, "
            "kernel_info; "
            "rep = acli.analyze_models(['wordcount_pallas'], "
            "torch.device('cpu')); "
            "assert rep.models == ['wordcount_pallas', '<kernels>']; "
            "assert not rep.errors and kernel_info.ATTR_FIELDS; "
            "from mapreduce_tpu_torch.tools import (autotune, corpora, "
            "geomsearch, redplan); "
            "assert len(corpora.GENERATORS['zipf'](4096)) <= 4096; "
            "assert redplan.check_disagreement(1.0, 0.1)['flag']; "
            "assert autotune.probe_config({'chunk_bytes': 1 << 20, "
            "'superstep': 1, 'inflight_groups': 4, 'prefetch_depth': 4, "
            "'combiner': 'hot-cache'}).map_impl == 'fused'; "
            "assert geomsearch.probe_config(None, 1 << 20).sort_impl "
            "== 'radix'; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'mapreduce_tpu', 'bench', 'tools')]; "
            "assert not bad, bad") % ((tmp_path / "ck.npz",) * 4)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_from_jax_dict():
    cfg = convert.config_from_dict(dataclasses.asdict(JConfig()))
    assert cfg == wc.Config()
    assert cfg.rescue_slots_max == JConfig().rescue_slots_max == 32768
    assert cfg.batch_uniques == JConfig().batch_uniques
    # The map's knobs map across as they are, the autotuner's 'auto'
    # values and its hint mode too.
    for kw in ({"combiner": "salt"}, {"geometry": "combiner16"},
               {"sort_mode": "segmin"}, {"merge_every": 3},
               {"combiner": "auto"}, {"geometry": "auto"},
               {"merge_strategy": "auto"}, {"autotune": "hint"}):
        assert convert.config_from_dict(dataclasses.asdict(
            JConfig(**kw))) == wc.Config(**kw)
    # The fused map, the hot-key combiner and the radix seam map across.
    jcfg = JConfig(map_impl="fused", combiner="hot-cache", combiner_slots=16,
                   sort_impl="radix")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.map_impl, cfg.combiner, cfg.combiner_slots, cfg.sort_impl) \
        == ("fused", "hot-cache", 16, "radix")
    assert cfg.resolved_combiner_slots == jcfg.resolved_combiner_slots == 16
    # A JAX geometry carries across whole, as the port's Geometry: the port
    # reads its radix bits and cache depth.
    from mapreduce_tpu.config import Geometry

    from mapreduce_tpu_torch import config as port_config

    jcfg = JConfig(map_impl="fused", combiner="hot-cache",
                   geometry=Geometry(combiner_slots=24, radix_bits=2,
                                     radix_block_rows=128))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.geometry == port_config.Geometry(
        combiner_slots=24, radix_bits=2, radix_block_rows=128)
    assert (cfg.combiner_slots, cfg.resolved_combiner_slots,
            cfg.resolved_geometry.radix_bits, cfg.geometry_label) \
        == (None, 24, 2, "custom") == (
            jcfg.combiner_slots, jcfg.resolved_combiner_slots,
            jcfg.resolved_geometry.radix_bits, jcfg.geometry_label)


def test_registry_names_and_identities_equal_jax():
    """The port's registry names every model the JAX registry names; each
    builds a job with the JAX job's identity, and the fleet twins carry
    the JAX twins' topology and merge strategy marks."""
    from mapreduce_tpu import models as jmodels
    from mapreduce_tpu_torch import models

    assert models.model_names() == jmodels.model_names()
    for name in models.model_names():
        job = models.build_model(name, device="cpu")
        want = jmodels.build_model(name)
        assert job.identity() == want.identity(), name
        assert job.device == torch.device("cpu")
        for mark in ("analysis_fleet", "analysis_merge_strategy"):
            assert getattr(job, mark, None) == getattr(want, mark, None), \
                (name, mark)
        if "fleet" in name:
            assert job.config == convert.config_from_dict(
                dataclasses.asdict(want.config)), name
    assert models.build_model("wordcount_combiner", device="cpu").config \
        == convert.config_from_dict(dataclasses.asdict(
            jmodels.COMBINER_ANALYSIS_CONFIG))
    assert models.build_model("wordcount_telemetry", device="cpu").config \
        == models.build_model("wordcount_pallas", device="cpu").config
    with pytest.raises(ValueError, match="unknown model"):
        models.build_model("nope", device="cpu")
