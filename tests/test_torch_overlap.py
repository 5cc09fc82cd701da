"""Window-boundary merges (``Config.merge_overlap``) over CPU ranks against
the JAX package's overlapped runs.

One gloo world of 2 ranks (``data_mesh(2)`` in JAX) and one of 2 x 2
(``two_level_mesh(2, 2)``, two hosts of two) run the port's ``run_job``
with ``merge_overlap=True``: the word count under the five strategies
(``hier-*`` on 2 x 2, and the tree there too), once with a table that
spills, bigrams
and grep with four patterns over a corpus of three files (file
boundaries are partial boundaries for jobs with a boundary hook).  The
finished value equals the JAX run's in every field, as does the number of
partials (``pipeline["partial_merges"]``) and the ledger's ``collective``
records without clock readings; the value also equals the port's own
overlap-off run.  Overlapped snapshots resume across packages in both
directions and refuse the other mode; faults at the partials' crossings
of the ``collective-finish`` seam are absorbed by an explicit policy;
``run_job_global`` killed after a partial resumes exactly; and D = 1 runs
in process.  The JAX side is backend pallas in pair mode (the kernel
interpreted), 4 KB chunks.
"""

import concurrent.futures
import dataclasses
import shutil

import jax
import numpy as np
import pytest

import torch_world
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import grep as jgrep
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.obs import Telemetry as JTelemetry
from mapreduce_tpu.ops import datastats as jdatastats
from mapreduce_tpu.parallel.mesh import data_mesh, two_level_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu.runtime import faults as jfaults
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import grep
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.obs.ledger import read_ledger
from mapreduce_tpu_torch.runtime import executor

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               compact_slots=0, sort_mode="sort3", pallas_max_token=8,
               chunk_bytes=4096, table_capacity=4096, rescue_overlong=4,
               merge_overlap=True, inflight_groups=2)
CFG = {k: v for k, v in dataclasses.asdict(
    convert.config_from_dict(dataclasses.asdict(JCFG))).items()
    if k in ("backend", "map_impl", "combiner", "compact_slots", "sort_mode",
             "pallas_max_token", "chunk_bytes", "table_capacity",
             "rescue_overlong", "merge_overlap", "inflight_groups")}
OFF = dict(CFG, merge_overlap=False)
#: The 2 x 2 runs merge every retired group (a window of one).
JCFG22 = dataclasses.replace(JCFG, inflight_groups=1)
CFG22 = dict(CFG, inflight_groups=1)
PATTERNS = ["w1", "w2 w", "3", "w4"]
#: The one-axis strategies on 2 ranks, the two-level ones (and the tree,
#: level by level) on 2 x 2: the five strategies, each against JAX once
#: (the JAX keyrange programs take ~12 s each to compile interpreted).
STRATEGIES = {2: ("tree", "gather", "keyrange"),
              4: ("tree", "hier-tree-tree", "hier-kr-tree")}
NO_BACKOFF = {"backoff_base_s": 0.0, "jitter_frac": 0.0}
#: Clock readings in ledger records, and the host stamp of a world of
#: two hosts (the JAX reference is one process).
CLOCK = {"ts", "run_id", "started_at", "ended_at", "host"}


def _text(seed: int, n_words: int, vocab: int = 300) -> bytes:
    """Zipf words with a token longer than W = 8 now and then."""
    rng = np.random.default_rng(seed)
    words = [b"w%x" % (int(i) % vocab) for i in rng.zipf(1.3, n_words)]
    for i in range(150, len(words), 1100):
        words[i] = b"overlapped_run%d" % (i % 3)
    return b" ".join(words)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    one = d / "one.txt"
    one.write_bytes(_text(5, 14000))  # 7 steps of 2 rows, 4 of 4
    spill = d / "spill.txt"
    rng = np.random.default_rng(6)  # ~9,000 distinct words: spills
    spill.write_bytes(b" ".join(b"s%x" % int(i) for i in
                                rng.integers(0, 1 << 30, 9000)))
    three = []
    for i, n in enumerate((2500, 400, 3000)):
        p = d / f"part{i}.txt"
        p.write_bytes(_text(20 + i, n) + b"\nw1 w2 w3 w4\n")
        three.append(str(p))
    return {"one": str(one), "spill": str(spill), "three": three, "dir": d}


def _case(name, path, job="wordcount", config=CFG, **kw):
    return {"name": name, "kind": "run_job",
            "args": {"job": job, "path": path, "config": config, **kw}}


def _jax_job(kind, cfg):
    if kind == "wordcount":
        return jwc.WordCountJob(cfg)
    if kind == "ngram":
        return jwc.NGramCountJob(2, cfg)
    return jgrep.MultiGrepJob([p.encode() for p in PATTERNS])


def _jax_run(kind, path, cfg, mesh, driver="run_job", ledger=None, **kw):
    """A JAX run; with ``ledger``, telemetered without the data-statistics
    mode (the port's world case runs so too)."""
    fn = getattr(jexecutor, driver)
    if ledger is None:
        return fn(_jax_job(kind, cfg), path, cfg, mesh=mesh, **kw)
    real = jdatastats.supports
    jdatastats.supports = lambda job: False
    try:
        with JTelemetry.create(ledger_path=ledger,
                               progress_every_s=3600) as tel:
            return fn(_jax_job(kind, cfg), path, cfg, mesh=mesh,
                      telemetry=tel, **kw)
    finally:
        jdatastats.supports = real


def _port_worlds(corpus, ck):
    """The port's worlds: one of 2 ranks and one of 2 x 2 with many cases
    each, then a killed world of 2 x 2 and its resume."""
    d = corpus["dir"]
    one, three = corpus["one"], corpus["three"]
    cases = [_case(f"wc-{s}", one, merge_strategy=s,
                   **({"ledger": str(d / f"port2-{s}.jsonl"),
                       "data_stats": False} if s == "tree" else {}))
             for s in STRATEGIES[2]]
    cases += [
        _case("wc-off", one, config=OFF),
        _case("spill", corpus["spill"], merge_strategy="keyrange"),
        _case("ngram", three, job="ngram", n=2),
        _case("ngram-off", three, job="ngram", config=OFF, n=2),
        _case("grep", three, job="grep_multi", patterns=PATTERNS),
        _case("preempt", one, checkpoint_path=ck["port"],
              checkpoint_every=2,
              config=dict(CFG, fault_plan="at=dispatch:5:preemption")),
        _case("resume-jax", one, checkpoint_path=ck["jax"],
              checkpoint_every=2),
        _case("flip-off", one, config=OFF,
              checkpoint_path=str(d / "jax-flip.npz")),
        _case("preempt-off", one, checkpoint_path=str(d / "off.npz"),
              config=dict(OFF, fault_plan="at=dispatch:5:preemption"),
              checkpoint_every=2),
        _case("flip-on", one, checkpoint_path=str(d / "off.npz")),
    ]
    for i, plan in enumerate(("at=collective-finish:0:transient,"
                              "at=collective-finish:2:transient",
                              "seed=11,rate=0.5,seams=collective-finish,"
                              "max=4")):
        cases.append(_case(f"chaos{i}", one, ledger=str(
            d / f"chaos{i}.jsonl"), data_stats=False, config=dict(
            CFG22, fault_plan=plan, failure_policy={
                "transient_retries": 4, **NO_BACKOFF})))
    world2 = torch_world.spawn_world(2, cases, d / "w2")

    cases = [_case(f"wc-{s}", one, config=CFG22, merge_strategy=s,
                   mesh=[2, 2],
                   **({"ledger": str(d / f"port4-{s}.jsonl"),
                       "data_stats": False} if s == "tree" else {}))
             for s in STRATEGIES[4]]
    cases += [
        _case("ngram", three, job="ngram", config=CFG22, mesh=[2, 2],
              n=2),
        _case("grep", three, job="grep_multi", config=CFG22,
              mesh=[2, 2], patterns=PATTERNS),
        _case("global", one, config=CFG22, mesh=[2, 2],
              driver="run_job_global", merge_strategy="hier-kr-tree")]
    world4 = torch_world.spawn_world(4, cases, d / "w4", hosts=2)

    # run_job_global killed on every rank after its partials (a
    # window of one and a snapshot every step merge at each), then
    # resumed; JAX resumes a copy of the same snapshot.
    ck["kill"] = str(d / "kill.npz")
    glob = dict(config=CFG22, driver="run_job_global", mesh=[2, 2],
                merge_strategy="hier-kr-tree",
                checkpoint_path=ck["kill"])
    killed = torch_world.spawn_world(
        4, [_case("kill", one, ledger=str(d / "kill.jsonl"),
                  ledger_every=True, checkpoint_every=1,
                  **dict(glob, config=dict(
                      CFG22, fault_plan="at=process-kill:2:permanent")))],
        d / "wk", hosts=2, group_timeout_s=60, expect_rc=113)
    shutil.copy(ck["kill"], d / "kill-jax.npz")
    resumed = torch_world.spawn_world(4, [_case("resume", one, **glob)],
                                      d / "wr", hosts=2)
    return world2, world4, killed, resumed


@pytest.fixture(scope="module")
def runs(corpus):
    """The JAX references and the port's worlds (:func:`_port_worlds`,
    in their own processes meanwhile), then the JAX resumes of the
    port's snapshots."""
    d = corpus["dir"]
    one, three = corpus["one"], corpus["three"]
    jax_out, ck = {}, {}
    with torch_world.shared_jax_engines():
        # A JAX overlapped snapshot, preempted after two checkpoints.
        ck["jax"] = str(d / "jax.npz")
        with pytest.raises(jfaults.Preempted):
            _jax_run("wordcount", one, dataclasses.replace(
                JCFG, fault_plan="at=dispatch:5:preemption"), data_mesh(2),
                checkpoint_path=ck["jax"], checkpoint_every=2)
        shutil.copy(ck["jax"], d / "jax-flip.npz")
        ck["port"] = str(d / "port.npz")
        # The worlds run in their own processes while this one computes
        # the JAX references.
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            worlds = pool.submit(_port_worlds, corpus, ck)
            for n, mesh, cfg in ((2, data_mesh(2), JCFG),
                                 (4, two_level_mesh(2, 2), JCFG22)):
                for s in STRATEGIES[n]:
                    jax_out[n, "wc", s] = _jax_run(
                        "wordcount", one, cfg, mesh, merge_strategy=s,
                        ledger=str(d / f"jax{n}-{s}.jsonl") if s == "tree"
                        else None)
                jax_out[n, "ngram"] = _jax_run("ngram", three, cfg, mesh)
                jax_out[n, "grep"] = _jax_run("grep", three, cfg, mesh)
            jax_out[2, "spill"] = _jax_run(
                "wordcount", corpus["spill"], JCFG, data_mesh(2),
                merge_strategy="keyrange")
            jax_out[4, "global"] = _jax_run(
                "wordcount", one, JCFG22, two_level_mesh(2, 2),
                driver="run_job_global", merge_strategy="hier-kr-tree")
            world2, world4, killed, resumed = worlds.result()
        jax_out["resume-port"] = _jax_run(
            "wordcount", one, JCFG, data_mesh(2), checkpoint_path=ck["port"])
        jax_out["resume-kill"] = _jax_run(
            "wordcount", one, JCFG22, two_level_mesh(2, 2),
            driver="run_job_global", merge_strategy="hier-kr-tree",
            checkpoint_path=str(d / "kill-jax.npz"))
    return {"jax": jax_out, 2: world2, 4: world4, "killed": killed,
            "resumed": resumed, "dir": d}


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


def _assert_value(want, got):
    """Every leaf of the finished value, as uint32."""
    w, g = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(w, g)):
        np.testing.assert_array_equal(np.asarray(b).astype(np.uint32),
                                      np.asarray(a).astype(np.uint32),
                                      err_msg=f"leaf {i}")


def _assert_run(want, got):
    _assert_value(want.value, got["value"])
    np.testing.assert_array_equal(got["bases"], want.bases)
    assert got["pipeline"]["partial_merges"] \
        == want.pipeline["partial_merges"]


def _collective(path) -> list:
    return [{k: v for k, v in r.items() if k not in CLOCK}
            for r in read_ledger(path) if r["kind"] == "collective"]


@pytest.mark.parametrize("n,strategy",
                         [(n, s) for n in (2, 4) for s in STRATEGIES[n]])
def test_word_count_matches_jax_overlap(runs, n, strategy):
    """Every rank's value, bases and partial count, per strategy."""
    want = runs["jax"][n, "wc", strategy]
    assert want.pipeline["partial_merges"] >= 2
    for rank in range(n):
        _assert_run(want, _ok(runs[n][rank][f"wc-{strategy}"]))


@pytest.mark.parametrize("n", (2, 4))
def test_collective_records_match_jax(runs, n):
    """The coordinator's ``collective`` records (``op='partial'`` then
    ``op='finish'``), clock readings aside, are the JAX run's."""
    d = runs["dir"]
    got = _collective(d / f"port{n}-tree.jsonl")
    assert got == _collective(d / f"jax{n}-tree.jsonl")
    ops = [r["op"] for r in got]
    assert ops[-1] == "finish" and set(ops[:-1]) == {"partial"}
    assert len(ops) - 1 == runs["jax"][n, "wc", "tree"] \
        .pipeline["partial_merges"]


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("kind", ("ngram", "grep"))
def test_bigrams_and_grep_match_jax_overlap(runs, n, kind):
    """Over three files: window and file-boundary partials, the seam and
    line carries kept across each partial."""
    want = runs["jax"][n, kind]
    for rank in range(n):
        _assert_run(want, _ok(runs[n][rank][kind]))


def test_spilled_table_matches_jax_overlap(runs):
    """A table that spills: every field, ``dropped_*`` included, equals
    the JAX overlap run of the same mesh and strategy (each merge order
    bounds ``dropped_uniques`` its own way)."""
    want = runs["jax"][2, "spill"]
    assert int(np.asarray(want.value.dropped_uniques)) > 0
    for rank in range(2):
        _assert_run(want, _ok(runs[2][rank]["spill"]))


def test_overlap_equals_the_overlap_off_run(runs):
    for name in ("wc", "ngram"):
        on = _ok(runs[2][0]["wc-tree" if name == "wc" else name])
        off = _ok(runs[2][0][f"{name}-off"])
        _assert_value(off["value"], on["value"])
        assert "partial_merges" not in off["pipeline"]


def test_snapshots_resume_across_packages(runs):
    """A port overlapped snapshot resumes in JAX, a JAX one in the port,
    both to the uninterrupted run; each refuses the other mode."""
    want = runs["jax"][2, "wc", "tree"].value
    for rank in range(2):
        err = runs[2][rank]["preempt"]
        assert err[0] == "error" and "Preempted" in err[1], err
        _assert_value(want, _ok(runs[2][rank]["resume-jax"])["value"])
        for name in ("flip-off", "flip-on"):
            err = runs[2][rank][name]
            assert err[0] == "error" and "CheckpointMismatch" in err[1], err
    _assert_value(want, runs["jax"]["resume-port"].value)


@pytest.mark.parametrize("i", (0, 1))
def test_faults_at_partial_crossings_are_absorbed(runs, i):
    """``collective-finish`` faults that land on partials (crossing 0 is
    the first partial) are retried on an explicit policy on every rank:
    the value is the fault-free one and the ledger counts the partials."""
    want = _ok(runs[2][0]["wc-tree"])["value"]
    _assert_value(want, _ok(runs[2][0][f"chaos{i}"])["value"])
    led = runs["dir"] / f"chaos{i}.jsonl"
    colls = _collective(led)
    n_partial = sum(1 for c in colls if c["op"] == "partial")
    assert n_partial >= 2 and colls[-1]["op"] == "finish"
    hits = [r for r in read_ledger(led) if r["kind"] == "fault"
            and r["seam"] == "collective-finish"]
    assert hits and all(f["injected"] for f in hits)
    assert min(f["index"] for f in hits) < n_partial
    end = [r for r in read_ledger(led) if r["kind"] == "run_end"][0]
    assert end["pipeline"]["partial_merges"] == n_partial
    start = [r for r in read_ledger(led) if r["kind"] == "run_start"][0]
    assert start["merge_overlap"] is True and start["retry"] == 0


def test_global_driver_matches_jax_and_resumes_after_a_kill(runs):
    """``run_job_global`` with overlap equals JAX's; killed on every rank
    after partials retired, it resumes to the same value, and JAX resumes
    the same snapshot to it."""
    want = runs["jax"][4, "global"]
    for rank in range(4):
        _assert_run(want, _ok(runs[4][rank]["global"]))
        _assert_value(want.value, _ok(runs["resumed"][rank]["resume"])
                      ["value"])
    _assert_value(want.value, runs["jax"]["resume-kill"].value)
    assert runs["killed"] == [113] * 4
    for host in (0, 1):
        recs = list(read_ledger(str(runs["dir"] / f"kill.jsonl.h{host}"
                                                  ".jsonl")))
        kinds = [(r["kind"], r.get("op"), r.get("seam")) for r in recs]
        partial = kinds.index(("collective", "partial", None))
        assert partial < kinds.index(("fault", None, "process-kill"))


def test_one_rank_in_process(corpus, tmp_path):
    """D = 1: the overlapped word count and bigrams (tree, and keyrange,
    whose merge on one rank gives the result shape) and grep equal their
    overlap-off runs; a bare ``retry`` is the JAX usage error."""
    cfg = convert.config_from_dict(dataclasses.asdict(JCFG))
    off = dataclasses.replace(cfg, merge_overlap=False)
    for job in (lambda c: wc.WordCountJob(c, "cpu"),
                lambda c: wc.NGramCountJob(2, c, "cpu"),
                lambda c: grep.MultiGrepJob([p.encode() for p in PATTERNS],
                                            device="cpu")):
        for s in ("tree", "keyrange"):
            if s == "keyrange" and isinstance(job(off), grep.MultiGrepJob):
                continue
            on = executor.run_job(job(cfg), corpus["three"], cfg,
                                  merge_strategy=s)
            want = executor.run_job(job(off), corpus["three"], off,
                                    merge_strategy=s)
            _assert_value(convert.state_to_numpy(want.value),
                          convert.state_to_numpy(on.value))
            assert on.pipeline["partial_merges"] >= 2
    with pytest.raises(ValueError, match="merge_overlap requires retry=0"):
        executor.run_job(wc.WordCountJob(cfg, "cpu"), corpus["one"], cfg,
                         retry=1)
