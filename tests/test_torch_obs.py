"""The port's telemetry planes against the JAX package's, on the CPU.

Module parity: the metrics registry, the run ledger, the flight recorder,
the data-plane aggregator and the timeline give the JAX modules' answers
on the same inputs.

Ledger parity: both packages stream the same 5-chunk file (4 KB chunks,
table capacity 2048; the JAX side on a one-device mesh, backend pallas,
its Pallas kernel in interpret mode) through a telemetered ``run_job`` at
``(inflight_groups, superstep)`` of (4, 1), (1, 1) and (4, 3), fault-free
and under faults.  The ledgers, with their clock readings dropped (stamps,
``phases``, ``elapsed_s``, ``mem``, ``compile_events``, rates), must be
equal record for record; the ``data`` record differs only in the JAX
kernel's window-slot fields (``window_slot_capacity``,
``window_occupancy``), which the port's dense stream does not have.  The
JAX package's readers (``tools/obs_report.py``, ``tools/trace_export.py``,
``tools/obswatch.py``, ``obs.timeline``, ``obs.datahealth``) read the
port's ledgers as they are.

Invariants: no torn line under preemption, one ``group`` record per
retired group, replayed groups counted once, the group record's host cost
under 1 ms, no change without telemetry, and a kernel build reported as
``compile_events``.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mapreduce_tpu import cli as jcli
from mapreduce_tpu import obs as jobs
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import grep as jgrep
from mapreduce_tpu.models import sample as jsample
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.obs import datahealth as jdatahealth
from mapreduce_tpu.obs import flight as jflight
from mapreduce_tpu.obs import ledger as jledger
from mapreduce_tpu.obs import registry as jregistry
from mapreduce_tpu.obs import timeline as jtimeline
from mapreduce_tpu.ops import datastats as jdatastats
from mapreduce_tpu.parallel import mapreduce as jmr
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import cli, convert, native
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models import grep, sample
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.obs import flight, ledger, registry, spans, \
    telemetry, timeline
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops.cuda import _build
from mapreduce_tpu_torch.parallel import mapreduce as pmr
from mapreduce_tpu_torch.runtime import checkpoint as ckpt
from mapreduce_tpu_torch.runtime import executor, faults, profiling
from mapreduce_tpu_torch.utils import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
CHUNK = 4096
JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=CHUNK, table_capacity=2048,
               rescue_overlong=4)
WINDOWS = [(4, 1), (1, 1), (4, 3)]
NO_BACKOFF = {"backoff_base_s": 0.0, "jitter_frac": 0.0}
#: Fields that hold clock readings (or paths of the run's own files).
CLOCK = {"ts", "run_id", "phases", "elapsed_s", "mem", "compile_events",
         "read_at", "staged_at", "dispatched_at", "token_ready_at",
         "retired_at", "retire_wait_s", "h2d_done_at", "started_at",
         "ended_at", "gb_per_s", "words_per_s", "bytes_per_s", "eta_s",
         "save_s", "path", "flight_dump", "input"}
#: The JAX kernel's window-slot fields, which the port does not have.
WINDOW_FIELDS = {"window_slot_capacity", "window_occupancy"}
#: The window statistics of ``run_end``'s ``pipeline`` that both packages
#: count (the rest: the overlap fraction is a clock reading, and the port
#: adds its pinned buffers, H2D milliseconds and recoveries).
PIPE_KEYS = ("inflight_groups", "prefetch_depth", "dispatch_groups",
             "depth_max", "depth_mean", "full_retires", "boundary_drains",
             "window_filled", "full_frac", "degrade_steps")


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_engines():
    """One JAX ``Engine`` per job kind, map configuration and stats mode:
    the JAX executor builds one per run and each compiles its programs
    anew (~12 s interpreted); the programs read neither the fault plan,
    the policy nor the pipeline knobs."""
    memo = {}
    real = jexecutor.Engine

    def engine(job, mesh, **kw):
        cfg = getattr(job, "config", None)
        if cfg is not None:
            cfg = dataclasses.replace(cfg, fault_plan=None,
                                      failure_policy=None, inflight_groups=1,
                                      superstep=1, prefetch_depth=None)
        key = (type(job), job.identity(), cfg, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = real(job, mesh, **kw)
        return memo[key]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jexecutor, "Engine", engine)
        yield


def _text(seed: int, n_words: int) -> bytes:
    """Zipf words with a token longer than W = 8 now and then (the
    rescue)."""
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(250)] + [b"abcdefgh"]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]
    for i in range(120, len(words), 900):
        words[i] = b"streamed_over%d" % (i % 3)
    return b" ".join(words)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = _text(7, 5200)
    p = tmp_path_factory.mktemp("obs") / "corpus.txt"
    p.write_bytes(data)
    # 5 chunks: a window of 4 fills, superstep 3 leaves a remainder of 2.
    assert len(list(reader_mod.iter_batches_multi(str(p), 1, CHUNK))) == 5
    return str(p), oracle.word_counts(data)


@contextlib.contextmanager
def _tools():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import obs_report
        import obswatch
        import trace_export
        yield obs_report, trace_export, obswatch
    finally:
        sys.path.remove(str(REPO / "tools"))


def _configs(inflight, superstep, **kw):
    jcfg = dataclasses.replace(JCFG, inflight_groups=inflight,
                               superstep=superstep, **kw)
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _run_pair(tmp_path, path, inflight, superstep, *, plan=None,
              policy=None, retry=0, checkpoint=False, jax_config=None,
              job_pair=None):
    """Both packages' telemetered ``run_job`` over ``path``: ``{pkg:
    (result or exception, ledger path, registry snapshot)}``.  A fresh
    registry each; a heartbeat cadence of an hour, so each run writes
    exactly its first ``progress`` record.  ``job_pair``: ``(JAX job of a
    config, port job of a config)`` factories (default: the word
    count)."""
    jcfg, cfg = _configs(inflight, superstep, fault_plan=plan,
                         failure_policy=policy, **(jax_config or {}))
    jjob, pjob = job_pair or (jwc.WordCountJob,
                          lambda c: wc.WordCountJob(c, "cpu"))
    out = {}
    for name in ("jax", "port"):
        led = str(tmp_path / f"{name}.jsonl")
        kw = {"checkpoint_path": str(tmp_path / f"{name}.npz"),
              "checkpoint_every": 2} if checkpoint else {}
        if name == "jax":
            reg = jregistry.MetricsRegistry()
            tel = jobs.Telemetry.create(ledger_path=led, registry=reg,
                                        progress_every_s=3600)
            fn = lambda: jexecutor.run_job(  # noqa: E731
                jjob(jcfg), path, jcfg, mesh=data_mesh(1),
                retry=retry, telemetry=tel, **kw)
        else:
            reg = registry.MetricsRegistry()
            tel = telemetry.Telemetry.create(ledger_path=led, registry=reg,
                                             progress_every_s=3600)
            fn = lambda: executor.run_job(  # noqa: E731
                pjob(cfg), path, cfg, retry=retry,
                telemetry=tel, **kw)
        try:
            res = fn()
        except Exception as e:
            res = e
        finally:
            tel.close()
        out[name] = (res, led, reg.snapshot())
    return out


def _normalized(path) -> list:
    """A ledger without its clock readings and window-slot fields."""
    out = []
    for rec in ledger.read_ledger(path):
        rec = {k: v for k, v in rec.items()
               if k not in CLOCK and k not in WINDOW_FIELDS}
        if "pipeline" in rec:
            rec["pipeline"] = {k: rec["pipeline"][k] for k in PIPE_KEYS
                               if k in rec["pipeline"]}
        out.append(rec)
    return out


def _assert_same_ledger(out):
    j, p = _normalized(out["jax"][1]), _normalized(out["port"][1])
    assert [r["kind"] for r in p] == [r["kind"] for r in j]
    for a, b in zip(j, p):
        assert b == a, a["kind"]
    return p


def _assert_same_registry(out):
    """The same instrument names; the counters and the in-flight depth
    histogram (depths are not clock readings) equal."""
    j, p = out["jax"][2], out["port"][2]
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(p[kind]) == sorted(j[kind]), kind
    assert p["counters"] == j["counters"]
    assert p["histograms"]["executor.inflight_depth"] \
        == j["histograms"]["executor.inflight_depth"]


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("executor.runs", driver="run_job").inc()
    reg.counter("c").inc(2.5)
    reg.counter("c").inc(0.5)
    reg.counter("executor.faults", seam="h2d", fault_class="transient").inc()
    reg.gauge("g").set(7)
    for v in (0.0004, 0.003, 0.2, 7.0, 500.0):
        reg.observe("h", v)
    reg.histogram("custom", buckets=(1.0, 2.0)).observe(1.5)
    with pytest.raises(ValueError):
        reg.gauge("c")
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    return reg.snapshot()


def test_registry_snapshot_matches_jax():
    assert _drive_registry(registry) == _drive_registry(jregistry)
    assert telemetry.Telemetry.disabled().registry \
        is registry.get_registry()


def test_ledger_records_and_reader_match_jax(tmp_path):
    recs = [("run_start", {"driver": "run_job", "devices": 1}),
            ("step", {"step_first": 0, "arr": np.arange(3),
                      "scalar": np.int64(5), "t": torch.tensor(4)}),
            ("group", {"data": {"chunks": 1}}), ("run_end", {"bytes": 9})]
    got = {}
    for name, mod in (("jax", jledger), ("port", ledger)):
        p = str(tmp_path / f"{name}.jsonl")
        with mod.RunLedger(p, "rid") as led:
            for kind, fields in recs:
                led.write(kind, **fields)
            assert led.records_written == len(recs)
        with open(p, "a") as f:  # a torn last line: skipped by readers
            f.write('{"kind": "step", "ts"')
        got[name] = p
    for reader in (ledger.read_ledger, jledger.read_ledger):
        for p in got.values():
            rows = [{k: v for k, v in r.items() if k != "ts"}
                    for r in reader(p)]
            assert rows == [{k: v for k, v in r.items() if k != "ts"}
                            for r in jledger.read_ledger(got["jax"])]
            assert rows[0]["ledger_version"] == ledger.LEDGER_VERSION \
                == jledger.LEDGER_VERSION
            assert rows[1]["arr"] == [0, 1, 2] and rows[1]["t"] == 4
            assert [r["kind"] for r in reader(p, kind="group")] == ["group"]
    assert ledger.shard_path("a.jsonl", 3) == jledger.shard_path("a.jsonl", 3)
    assert ledger.shard_flight_path("a.jsonl", 2) \
        == jledger.shard_flight_path("a.jsonl", 2)


def test_flight_dump_matches_jax(tmp_path):
    payloads = {}
    for name, mod in (("jax", jflight), ("port", flight)):
        rec = mod.FlightRecorder(capacity=3)
        for i in range(5):
            rec.record("step", step_first=i)
        p = str(tmp_path / f"{name}.flight.json")
        assert rec.dump(p, context={"step": 4}, registry_snapshot={"a": 1},
                        data={"chunks": 5}) == p
        assert rec.dump(str(tmp_path / "second.json")) == p  # first wins
        with open(p) as f:
            payloads[name] = json.load(f)
        with pytest.raises(ValueError):
            mod.FlightRecorder(capacity=0)
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("dumped_at", "events")}
    assert strip(payloads["port"]) == strip(payloads["jax"])
    assert [{k: v for k, v in e.items() if k != "ts"}
            for e in payloads["port"]["events"]] \
        == [{k: v for k, v in e.items() if k != "ts"}
            for e in payloads["jax"]["events"]]
    assert payloads["port"]["events_recorded"] == 5
    # The state summary: a table's leaves by metadata, as the JAX one
    # summarises the same arrays (dtypes named by each library).
    t = wc.table_ops.empty(64, "cpu")
    port = flight.summarize_state(t)
    jax_ = jflight.summarize_state(list(convert.table_to_numpy(t).values()))
    assert port["n_leaves"] == jax_["n_leaves"] == len(t)
    assert [leaf["shape"] for leaf in port["leaves"]] \
        == [leaf["shape"] for leaf in jax_["leaves"]]
    assert port["total_nbytes"] == sum(int(x.nbytes) for x in t)
    assert all(leaf["device"] == "cpu" for leaf in port["leaves"])


#: Per-group values fed to both aggregators: counters, then the gauges
#: (occupied slots, tokens, the top count, cumulative dropped).
GROUPS = [
    ({"chunks": 2, "overlong": 3, "rescued": 2, "dropped_tokens": 1,
      "dropped_uniques": 1, "rescue_invocations": 1}, (10, 40, 9, 1)),
    ({"chunks": 1, "combiner_hits": 30, "combiner_flushes": 4,
      "combiner_evicted": 1, "rescue_escalations": 1, "spill_rows": 5,
      "fallback_chunks": 1}, (12, (1 << 32) + 77, (1 << 32) + 5, 1)),
    ({"chunks": 1}, (0, 0, 0, 0)),
]


def _jax_stats(counters, gauges):
    valid, tokens, top, dropped = gauges
    u = lambda v: np.array([v], np.uint32)  # noqa: E731
    pair = lambda v: (u(v & 0xFFFFFFFF), u(v >> 32))  # noqa: E731
    fields = {f: u(counters.get(f, 0)) for f in jdatastats._COUNTERS}
    (tl, th), (pl, ph), (dl, dh) = pair(tokens), pair(top), pair(dropped)
    return jdatastats.DataStats(**fields, table_valid=u(valid),
                                total_lo=tl, total_hi=th, top_lo=pl,
                                top_hi=ph, dropped_lo=dl, dropped_hi=dh)


def test_data_aggregator_matches_jax():
    port = datastats.DataAggregator(capacity=2048, backend="pallas",
                                    map_impl="fused", combiner="hot-cache")
    ref = jdatastats.DataAggregator(capacity=2048, devices=1,
                                    backend="pallas", map_impl="fused",
                                    combiner="hot-cache")
    for counters, gauges in GROUPS:
        valid, tokens, top, dropped = gauges
        got = port.group_data(datastats.DataStats(
            **counters, table_valid=valid, tokens=tokens, top_count=top,
            dropped=dropped))
        assert got == ref.group_data(_jax_stats(counters, gauges))
        assert port.snapshot() == ref.snapshot()
    assert port.run_record() == ref.run_record()
    assert datastats.COUNTERS == jdatastats._COUNTERS
    assert datastats.supports(wc.WordCountJob(wc.Config(), "cpu"))
    assert not datastats.supports(object())


def test_chunk_stats_fold_and_gauges():
    """``add``, ``with_table_gauges`` and ``StatsFetch`` on a CPU table
    give the numbers the JAX ``with_table_gauges`` gives on its fields."""
    cfg = wc.Config(chunk_bytes=CHUNK, table_capacity=64)
    job = wc.WordCountJob(cfg, "cpu")
    data = b"b a b c c c " * 40
    chunk = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    t, s1 = job.map_chunk_stats(chunk, 0)
    assert isinstance(s1.dropped_tokens, torch.Tensor)
    state = job.combine(job.init_state(), t)
    stats = job.state_stats(state, datastats.add(s1, datastats.map_stats(
        overlong=2)))
    got = datastats.StatsFetch(stats).result()
    assert (got.chunks, got.overlong, got.table_valid, got.tokens,
            got.top_count, got.dropped) == (2, 2, 3, 240, 120, 0)
    ref = jdatastats.with_table_gauges(
        jdatastats.zeros(), jwc.table_ops.CountTable(
            **{f: np.asarray(v) for f, v in
               convert.table_to_numpy(state).items()}))
    assert int(ref.table_valid) == got.table_valid
    assert (int(ref.total_hi) << 32 | int(ref.total_lo)) == got.tokens
    assert (int(ref.top_hi) << 32 | int(ref.top_lo)) == got.top_count


def test_timeline_reconstruct_matches_jax(tmp_path, corpus):
    path, _ = corpus
    out = _run_pair(tmp_path, path, 4, 1)
    for name in ("jax", "port"):
        records = list(ledger.read_ledger(out[name][1]))
        for kw in ({}, {"with_collective": True}):
            got = timeline.reconstruct(records, **kw)
            assert got == jtimeline.reconstruct(records, **kw)
            assert got["groups"] == 5
        assert [timeline.group_intervals(r) for r in
                timeline.iter_groups(records)] \
            == [jtimeline.group_intervals(r) for r in
                jtimeline.iter_groups(records)]
        assert list(timeline.iter_collectives(records)) \
            == list(jtimeline.iter_collectives(records))
    assert timeline.PHASE_LANE == jtimeline.PHASE_LANE
    assert timeline.reconstruct([{"kind": "step"}]) is None


# ---------------------------------------------------------------------------
# ledger parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_ledger_parity_fault_free(tmp_path, corpus, inflight, superstep):
    path, want = corpus
    out = _run_pair(tmp_path, path, inflight, superstep)
    recs = _assert_same_ledger(out)
    _assert_same_registry(out)
    kinds = [r["kind"] for r in recs]
    n_groups = 5 // superstep + 5 % superstep  # the remainder: one a chunk
    assert kinds[0] == "run_start" and kinds[-3:] == ["collective", "data",
                                                      "run_end"]
    assert kinds.count("step") == kinds.count("group") == n_groups
    data = next(r for r in recs if r["kind"] == "data")
    assert data["chunks"] == 5 and data["tokens"] == sum(want.values())
    assert "window_occupancy" in next(
        r for r in jledger.read_ledger(out["jax"][1]) if r["kind"] == "data")
    start = recs[0]
    assert (start["devices"], start["backend"], start["geometry"],
            start["merge_strategy"], start["combiner"]) \
        == (1, "pallas", "default", "tree", "off")


CASES = {
    "transient_dispatch": {"plan": "at=dispatch:2:transient", "retry": 2},
    "random_plan": {"plan": "seed=7,rate=0.2,classes=transient+resource,"
                            "max=6", "retry": 2, "checkpoint": True},
    "ledger_append": {"plan": "at=ledger-append:1:transient", "retry": 0},
    "ladder": {"policy": {"resource_retries": 1, "transient_retries": 1,
                          "degrade": True, **NO_BACKOFF},
               "jax_config": {"map_impl": "fused", "combiner": "hot-cache",
                              "combiner_slots": 8, "sort_impl": "radix"}},
    "preemption": {"plan": "at=dispatch:2:preemption", "retry": 1,
                   "checkpoint": True},
    "permanent": {"plan": "at=token-wait:1:permanent", "retry": 2},
}


def _storm(monkeypatch):
    """Every step raises a resource error until the torch sort, in both
    packages' engines."""
    for cls, name in ((jmr.Engine, "step"), (jmr.Engine, "step_many"),
                      (pmr.Engine, "step")):
        real = getattr(cls, name)

        def storming(self, state, chunk, step_index, *a, _real=real):
            if self.job.config.sort_impl != "xla":
                raise RuntimeError("RESOURCE_EXHAUSTED: injected storm")
            return _real(self, state, chunk, step_index, *a)

        monkeypatch.setattr(cls, name, storming)


@pytest.mark.parametrize("inflight,superstep", WINDOWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_parity_under_faults(tmp_path, monkeypatch, corpus, case,
                                    inflight, superstep):
    path, want = corpus
    if case == "ladder":
        _storm(monkeypatch)
    out = _run_pair(tmp_path, path, inflight, superstep, **CASES[case])
    recs = _assert_same_ledger(out)
    _assert_same_registry(out)
    kinds = [r["kind"] for r in recs]
    res = out["port"][0]
    if case == "preemption":
        assert isinstance(res, faults.Preempted)
        assert kinds[-1] == "checkpoint" and recs[-1]["preempt"] is True
        assert "run_end" not in kinds
        assert not os.path.exists(out["port"][1] + ".flight.json")
        return
    if case == "permanent":
        assert isinstance(res, faults.PermanentFault)
        assert kinds[-1] == "failure"
        with open(out["port"][1] + ".flight.json") as f:
            dump = json.load(f)
        assert dump["context"]["step"] == recs[-1]["step"]
        assert dump["context"]["fault_class"] == "permanent"
        return
    assert not isinstance(res, BaseException), res
    got = executor.recover_from_file(res.value, path, res.bases)
    assert got.as_dict() == want
    assert "fault" in kinds
    if case == "ladder":
        assert [r["ladder_step"] for r in recs if r["kind"] == "degrade"] \
            == ["combiner-off", "map-split", "sort-xla"]
    # The chaotic run's own ledger is its plan: replayed, it fires the
    # same crossings.
    fired = faults.fired_sequence(ledger.read_ledger(out["port"][1]))
    assert fired == jexecutor.faults_mod.fired_sequence(
        jledger.read_ledger(out["jax"][1]))
    replay = faults.FaultPlan.from_ledger(ledger.read_ledger(out["port"][1]))
    assert sorted(replay.events) == sorted((s, i) for s, i, _ in fired)


#: Grep and the sample through ``run_job``: the JAX and the port job of
#: a config.
GREP_JOBS = {
    "grep": (lambda c: jgrep.GrepJob(b"w1"),
             lambda c: grep.GrepJob(b"w1", device="cpu")),
    "grep3c": (lambda c: jgrep.MultiGrepJob([b"w[0-9]", b" w", b"\n"],
                                            "class"),
               lambda c: grep.MultiGrepJob([b"w[0-9]", b" w", b"\n"],
                                           "class", device="cpu")),
    "sample": (lambda c: jsample.ReservoirSampleJob(16, c),
               lambda c: sample.ReservoirSampleJob(16, c, "cpu")),
}


@pytest.mark.parametrize("inflight,superstep", [(4, 1), (4, 3)])
@pytest.mark.parametrize("kind", sorted(GREP_JOBS))
def test_grep_and_sample_ledger_parity(tmp_path, corpus, kind, inflight,
                                       superstep):
    """A telemetered streamed grep or sample writes the JAX ledger: its
    job identity in ``run_start``, the ``data`` record its family fills
    (grep: ``tokens`` = the matches over all patterns; sample: the
    population, and the live reservoir slots as ``table_valid``) and
    ``run_end.words == 0``; the result is the untelemetered one."""
    path, want = corpus
    out = _run_pair(tmp_path, path, inflight, superstep,
                    job_pair=GREP_JOBS[kind])
    recs = _assert_same_ledger(out)
    _assert_same_registry(out)
    res = out["port"][0]
    assert not isinstance(res, BaseException), res
    start = recs[0]
    assert start["job"] == GREP_JOBS[kind][0](JCFG).identity()
    data = next(r for r in recs if r["kind"] == "data")
    assert recs[-1]["kind"] == "run_end" and recs[-1]["words"] == 0
    assert data["chunks"] == 5
    if kind == "sample":
        assert data["table_valid"] == 16
        assert data["tokens"] == int(res.value.total_lo)
    else:
        m = res.value.matches_lo + (res.value.matches_hi << 32)
        assert data["tokens"] == int(m.sum()) > 0
    jres = out["jax"][0]
    for a, b in zip(jres.value, res.value):
        np.testing.assert_array_equal(b.numpy().astype(np.uint32),
                                      np.asarray(a).reshape(b.shape))


@pytest.mark.parametrize("plan", ["at=dispatch:2:transient",
                                  "at=token-wait:1:transient",
                                  "at=h2d:3:transient"])
def test_absorbed_faults_leave_grep_lines_exact(tmp_path, plan):
    """A fault plan that ``--retry 1`` absorbs replays from the anchor,
    the line carry with it: the CLI prints the fault-free counts."""
    p = tmp_path / "lines.txt"
    p.write_bytes((b"MATCH " + b"w " * 2500 + b"MATCH\nplain line\n") * 4
                  + b"x MATCH y\n" * 300)
    argv = [str(p), "--grep", "MATCH", "--grep", "in", "--stream",
            "--chunk-bytes", "4096", "--inflight", "4", "--superstep", "2",
            "--format", "json", "--platform", "cpu"]
    outs = []
    for extra in ([], ["--retry", "1", "--fault-plan", plan]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv + extra) == 0
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0]["patterns"][0] == {"pattern": "MATCH", "matches": 308,
                                      "lines": 304}


# ---------------------------------------------------------------------------
# the JAX package's readers on the port's ledgers
# ---------------------------------------------------------------------------


def _with_clock_of(port_path, jax_path, out_path):
    """The port's ledger with the JAX run's clock readings, record for
    record (the two are equal without them): the same run, as far as a
    reader can tell."""
    with open(out_path, "w") as f:
        for p, j in zip(ledger.read_ledger(port_path),
                        ledger.read_ledger(jax_path)):
            rec = dict(p)
            for k in CLOCK - {"path", "input", "flight_dump"}:
                if k in j:
                    rec[k] = j[k]
            f.write(json.dumps(rec) + "\n")


def _main_out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _health(ledger_path):
    h = jdatahealth.classify_run(jledger.read_ledger(ledger_path))
    flags = [f for f in h["flags"] if f["flag"] != "occupancy-starved"]
    signals = {k: v for k, v in h["signals"].items()
               if k != "window_occupancy"}
    return h["verdict"], flags, signals


def test_reference_readers_read_the_port_ledger(tmp_path, corpus):
    path, _ = corpus
    out = _run_pair(tmp_path, path, 4, 1,
                    plan="at=dispatch:2:transient", retry=2)
    port, ref = out["port"][1], out["jax"][1]
    same = str(tmp_path / "port_on_jax_clock.jsonl")
    _with_clock_of(port, ref, same)
    reports = {}
    with _tools() as (obs_report, trace_export, obswatch):
        for name, p in (("port", port), ("jax", ref), ("same", same)):
            rc, text = _main_out(obs_report.main, [p, "--json"])
            assert rc == 0
            reports[name] = json.loads(text)["runs"][-1]
            rc, text = _main_out(obs_report.main, [p])
            assert rc == 0 and "bottleneck:" in text, text
            assert _main_out(trace_export.main, [p])[0] == 0
            with open(p + ".trace.json") as f:
                assert json.load(f)["traceEvents"]
            rc, text = _main_out(obswatch.main, [p, "--once", "--json"])
            assert rc == 0
            watch = json.loads(text)
            assert watch["bound"] == json.loads(json.dumps(
                jtimeline.reconstruct(jledger.read_ledger(p))))[
                    "bottleneck"]["resource"]
            reports[name + "_watch"] = watch
        rc, text = _main_out(obs_report.main, ["--compare", port, ref])
        assert rc == 0 and text
    # The port's ledger reads as its own run: the JAX timeline of it is
    # the port's timeline of it.
    for p in (port, same):
        assert jtimeline.reconstruct(jledger.read_ledger(p)) \
            == timeline.reconstruct(ledger.read_ledger(p))
    # On the JAX run's clock the readers' verdicts are the JAX ledger's.
    for key in ("timeline", "failure_count"):
        assert reports["same"][key] == reports["jax"][key], key
    assert reports["same_watch"]["bound"] == reports["jax_watch"]["bound"]
    assert reports["same_watch"]["bottleneck"] \
        == reports["jax_watch"]["bottleneck"]
    # The data-health verdict is the JAX run's, but for the window-slot
    # flag the port's dense stream cannot raise.
    assert _health(port) == _health(ref)
    assert _health(port)[0] == "rescue-heavy"


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def _port_run(tmp_path, path, cfg, name="run", **kw):
    led = str(tmp_path / f"{name}.jsonl")
    with telemetry.Telemetry.create(ledger_path=led,
                                    registry=registry.MetricsRegistry(),
                                    progress_every_s=3600) as tel:
        try:
            res = executor.run_job(wc.WordCountJob(cfg, "cpu"), path, cfg,
                                   telemetry=tel, **kw)
        except Exception as e:
            res = e
    return res, list(ledger.read_ledger(led)), led


def test_preempted_ledger_has_no_torn_line(tmp_path, corpus, monkeypatch):
    """A SIGINT that lands in the middle of a ledger write is deferred to
    the loop's next safe point: the line completes, the run preempts, and
    every line of the ledger parses, the last a preemption checkpoint."""
    path, _ = corpus
    _, cfg = _configs(4, 1)
    deferrable = threading.current_thread() is threading.main_thread() \
        and signal.getsignal(signal.SIGINT) is signal.default_int_handler
    if not deferrable:
        # No deferral outside the main thread: an injected preemption.
        cfg = dataclasses.replace(cfg,
                                  fault_plan="at=dispatch:2:preemption")
    real = ledger.RunLedger.write
    sent = []

    def write(self, kind, **fields):
        """Write the line in two halves with a SIGINT between them."""
        if kind == "step" and fields["step_first"] == 2 and deferrable \
                and not sent:
            line = json.dumps({"ts": time.time(), "run_id": self.run_id,
                               "kind": kind, **fields},
                              default=ledger._json_default) + "\n"
            self._f.write(line[:10])
            self._f.flush()
            sent.append(True)
            signal.raise_signal(signal.SIGINT)
            self._f.write(line[10:])
            self._f.flush()
            self.records_written += 1
            return
        real(self, kind, **fields)

    monkeypatch.setattr(ledger.RunLedger, "write", write)
    res, recs, led = _port_run(tmp_path, path, cfg, retry=1,
                               checkpoint_path=str(tmp_path / "ck.npz"),
                               checkpoint_every=50)
    assert isinstance(res, faults.Preempted) and res.checkpointed
    with open(led) as f:
        lines = f.read().splitlines()
    assert [json.loads(line)["kind"] for line in lines] \
        == [r["kind"] for r in recs]
    assert recs[-1]["kind"] == "checkpoint" and recs[-1]["preempt"] is True
    assert "run_end" not in [r["kind"] for r in recs]
    assert sent == ([True] if deferrable else [])


@pytest.mark.parametrize("plan", [None, "at=token-wait:1:transient",
                                  "at=dispatch:3:transient"])
@pytest.mark.parametrize("inflight,superstep", WINDOWS)
def test_one_group_record_per_group_and_data_counted_once(
        tmp_path, corpus, plan, inflight, superstep):
    """Every group's steps are in exactly one ``group`` record, also after
    a replay, and the run's ``data`` record is the fault-free run's: a
    replayed group's statistics are counted once."""
    path, want = corpus
    _, cfg = _configs(inflight, superstep)
    _, clean, _ = _port_run(tmp_path, path, cfg, name="clean")
    res, recs, _ = _port_run(
        tmp_path, path, dataclasses.replace(cfg, fault_plan=plan),
        retry=2)
    assert not isinstance(res, BaseException), res
    steps = [s for r in recs if r["kind"] == "group"
             for s in range(r["step_first"], r["step_last"] + 1)]
    assert sorted(steps) == list(range(5))
    assert len([r for r in recs if r["kind"] == "group"]) \
        == res.pipeline["dispatch_groups"]
    data = [{k: v for k, v in r.items() if k not in ("ts", "run_id")}
            for r in recs if r["kind"] == "data"]
    assert data == [{k: v for k, v in r.items() if k not in ("ts", "run_id")}
                    for r in clean if r["kind"] == "data"]
    assert data[0]["tokens"] == sum(want.values())
    for r in recs:
        if r["kind"] == "group":
            g = r
            assert g["read_at"] <= g["staged_at"] <= g["dispatched_at"] \
                <= g["token_ready_at"] <= g["retired_at"]


def test_group_record_cost_under_1ms(tmp_path):
    """The group record's host cost (stamps, registry, data counters and
    the JSONL append) averages under 1 ms."""

    class _B:  # what _group_life reads off a batch
        def __init__(self, step):
            self.step = step
            self.lengths = np.array([4096], np.int64)

    n = 300
    data = {"chunks": 1, "overlong": 2, "occupancy": 0.1, "top_mass": 0.2}
    with telemetry.Telemetry.create(
            ledger_path=str(tmp_path / "cost.jsonl")) as tel:
        t0 = time.perf_counter()
        for i in range(n):
            life = executor._group_life([_B(i)], time.perf_counter(), 4096)
            life["dispatched_at"] = life["staged_at"]
            executor._group_record(tel, life,
                                   token_ready_at=life["staged_at"] + 0.01,
                                   retired_at=life["staged_at"] + 0.011,
                                   wait_s=0.005, data=data)
        dt = time.perf_counter() - t0
    assert dt / n < 1e-3, f"{1e3 * dt / n:.3f} ms per group record"
    assert len(list(ledger.read_ledger(str(tmp_path / "cost.jsonl"),
                                       kind="group"))) == n


def test_telemetry_off_changes_nothing(tmp_path, corpus, monkeypatch):
    """Without a handle the run takes no stats path, reads no memory and
    crosses no ledger-append seam; with one, the branch counts and the
    fired crossings of the other seams are the same."""
    path, want = corpus
    plan = ("seed=5,rate=0.3,seams=reader-read+stage-acquire+h2d+dispatch"
            "+token-wait,classes=transient,max=4")
    _, cfg = _configs(4, 1, fault_plan=plan)
    plans = []
    real_resolve = faults.FaultPlan.resolve.__func__

    def resolve(cls, spec):
        got = real_resolve(cls, spec)
        plans.append(got)
        return got

    monkeypatch.setattr(faults.FaultPlan, "resolve", classmethod(resolve))
    runs = {}
    for name in ("off", "on"):
        wc.BRANCHES.clear()
        if name == "off":
            calls = []
            for mod, fn in ((wc.WordCountJob, "map_chunk_stats"),
                            (datastats, "StatsFetch"),
                            (telemetry, "device_memory_stats")):
                monkeypatch.setattr(mod, fn, lambda *a, _c=calls, **k:
                                    _c.append(a))
            res = executor.run_job(wc.WordCountJob(cfg, "cpu"), path, cfg,
                                   retry=4)
            monkeypatch.undo()
            monkeypatch.setattr(faults.FaultPlan, "resolve",
                                classmethod(resolve))
            assert calls == []
        else:
            res, recs, _ = _port_run(tmp_path, path, cfg, retry=4)
            assert [r for r in recs if r["kind"] == "data"]
        runs[name] = (dict(wc.BRANCHES), plans[-1].fired,
                      convert.table_to_numpy(res.value))
    assert runs["on"][0] == runs["off"][0] and runs["on"][0]["chunks"] >= 5
    assert runs["on"][1] == runs["off"][1] and runs["off"][1]
    for f in runs["off"][2]:
        np.testing.assert_array_equal(runs["on"][2][f], runs["off"][2][f])


def test_a_build_shows_as_compile_events(tmp_path, corpus, monkeypatch):
    """The host chunker's first-use build lands in the first ``step``
    record's ``compile_events``, and an nvcc build reports through the
    same hook."""
    path, _ = corpus
    _, cfg = _configs(4, 1)
    real_lib = native.library_path()
    native.load()

    def slow_build(out):
        time.sleep(0.05)
        shutil.copy(real_lib, out)

    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "chunker.so")
    monkeypatch.setattr(native, "_build", slow_build)
    monkeypatch.setattr(native, "_lib", None)
    res, recs, _ = _port_run(tmp_path, path, cfg)
    assert not isinstance(res, BaseException), res
    steps = [r for r in recs if r["kind"] == "step"]
    ev = steps[0]["compile_events"]["gxx_chunker"]
    assert ev["count"] == 1 and ev["seconds"] >= 0.05
    assert all("compile_events" not in r for r in steps[1:])
    # nvcc: a stand-in compiler that writes its output, into a scratch
    # build directory.
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ];"
                    " then shift; : > \"$1\"; fi; shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / "build" / f"{name}.so")
    with telemetry.Telemetry.create() as tel:
        _build.build_all(["radix"])
        assert list(tel._drain_compiles()) == ["nvcc_radix"]


def test_device_memory_stats_reads_the_allocator_once(monkeypatch):
    """On a CUDA device: the allocator's current and peak allocated bytes
    (what ``memory_allocated`` and ``max_memory_allocated`` return) from
    one read; on the CPU, nothing; a failed read is absorbed."""
    reads = []

    def nested(device=None):
        reads.append(device)
        return {"allocated_bytes": {"all": {"current": 5, "peak": 9}},
                "reserved_bytes": {"all": {"current": 64}}}

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", nested)
    dev = torch.device("cuda")
    assert telemetry.device_memory_stats(dev) == {
        "bytes_in_use": 5, "peak_bytes_in_use": 9, "devices_reporting": 1}
    assert reads == [dev]
    assert telemetry.device_memory_stats(torch.device("cpu")) == {}
    assert telemetry.device_memory_stats(None) == {}
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device=None: {})
    assert telemetry.device_memory_stats(dev) == {}


def test_occupancy_matches_a_recount(tmp_path, corpus):
    """At every group (window 4, superstep 3), the record's occupancy is
    the occupancy of the table of its steps, recounted after the run."""
    path, _ = corpus
    _, cfg = _configs(4, 3)
    res, recs, _ = _port_run(tmp_path, path, cfg)
    eng = pmr.Engine(wc.WordCountJob(cfg, "cpu"), "cpu")
    state = eng.init_states()
    valid = []
    for b in reader_mod.iter_batches_multi(path, 1, CHUNK):
        state = eng.step(state, b.data, b.step)
        valid.append(int(state.n_valid()))
    groups = [r for r in recs if r["kind"] == "group"]
    assert [g["data"]["occupancy"] for g in groups] \
        == [round(valid[g["step_last"]] / 2048, 4) for g in groups]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(argv, capsysbinary, rc=0):
    old = os.getcwd()
    os.chdir(REPO)
    try:
        assert cli.main([*argv, "--platform", "cpu"]) == rc
    finally:
        os.chdir(old)
    return capsysbinary.readouterr()


def test_cli_ledger_metrics_profile(tmp_path, corpus, capsysbinary):
    """``--ledger``, ``--metrics-out`` and ``--profile`` leave stdout as it
    was; the registry's retired groups are the ledger's ``group`` records,
    and the profile holds the executor's spans."""
    path, _ = corpus
    flags = [path, "--stream", "--chunk-bytes", str(CHUNK), "--no-echo"]
    want = _cli(flags, capsysbinary).out
    led, met, prof = (str(tmp_path / n) for n in ("l.jsonl", "m.json", "p"))
    registry.get_registry().reset()  # the CLI writes the process's registry
    got = _cli([*flags, "--ledger", led, "--metrics-out", met,
                "--profile", prof], capsysbinary).out
    assert got == want
    recs = list(ledger.read_ledger(led))
    with open(met) as f:
        snap = json.load(f)
    groups = [r for r in recs if r["kind"] == "group"]
    assert snap["counters"]["executor.groups_retired"] == len(groups) == 5
    traces = list(pathlib.Path(prof).glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert {"read_wait", "stage", "dispatch", "retire_wait"} <= names


def test_cli_batch_ledger_matches_jax(tmp_path, capsysbinary):
    """A batch run's ledger: ``run_start``, ``data``, ``run_end``, as the
    JAX CLI writes them."""
    leds = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        leds[name] = str(tmp_path / f"{name}.jsonl")
        argv = ["test.txt", "--backend", "xla", "--ledger", leds[name]]
        out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        old = os.getcwd()
        os.chdir(REPO)
        try:
            with contextlib.redirect_stdout(out):
                assert main(argv + (["--platform", "cpu"]
                                    if name == "port" else [])) == 0
        finally:
            os.chdir(old)
    capsysbinary.readouterr()
    j, p = _normalized(leds["jax"]), _normalized(leds["port"])
    assert [r["kind"] for r in p] == ["run_start", "data", "run_end"]
    assert p == j


def test_cli_failed_run_leaves_its_flight_dump(tmp_path, corpus,
                                               capsysbinary):
    path, _ = corpus
    led, met = str(tmp_path / "l.jsonl"), str(tmp_path / "m.json")
    with pytest.raises(faults.PermanentFault):
        _cli([path, "--stream", "--chunk-bytes", str(CHUNK), "--ledger",
              led, "--metrics-out", met, "--fault-plan",
              "at=dispatch:1:permanent"], capsysbinary)
    recs = list(ledger.read_ledger(led))
    assert recs[-1]["kind"] == "failure"
    assert recs[-1]["flight_dump"] == led + ".flight.json"
    with open(led + ".flight.json") as f:
        dump = json.load(f)
    assert dump["context"]["step"] == 1 and dump["events"]
    assert dump["context"]["fault_class"] == "permanent"
    with open(met) as f:
        assert json.load(f)["counters"]


def test_cli_preempted_run_exits_75_with_a_parseable_ledger(
        tmp_path, corpus, capsysbinary):
    path, _ = corpus
    led = str(tmp_path / "l.jsonl")
    err = _cli([path, "--stream", "--chunk-bytes", str(CHUNK), "--ledger",
                led, "--checkpoint", str(tmp_path / "ck.npz"),
                "--fault-plan", "at=token-wait:0:preemption"], capsysbinary,
               rc=75).err
    assert b"preempted:" in err
    recs = list(ledger.read_ledger(led))
    with open(led) as f:
        assert len(f.read().splitlines()) == len(recs)
    assert recs[-1]["kind"] == "checkpoint" and recs[-1]["preempt"]
    assert not os.path.exists(led + ".flight.json")


def test_cli_unopenable_ledger_exits_2(tmp_path, capsysbinary):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    err = _cli(["test.txt", "--ledger", str(blocker / "l.jsonl")],
               capsysbinary, rc=2).err
    assert b"cannot open ledger" in err


def test_profile_trace_writes_on_failure(tmp_path):
    with pytest.raises(RuntimeError):
        with profiling.trace(str(tmp_path / "p")):
            with spans.span("inside"):
                raise RuntimeError("boom")
    (trace,) = (tmp_path / "p").glob("*.json")
    assert "inside" in {e.get("name") for e in
                        json.loads(trace.read_text())["traceEvents"]}
    with profiling.trace(None):  # a falsy path profiles nothing
        pass
