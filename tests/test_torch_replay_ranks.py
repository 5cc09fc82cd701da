"""Window replay, the degradation ladder and preemption across CPU ranks,
against the JAX package on ``data_mesh(2)``.

The JAX reference is one process over the mesh, where a fault stops every
device at once; in the port each rank is a process, and the ranks agree
on every failure.  One gloo world of 2 ranks runs the port's ``run_job``
under a fault plan at each seam (``retry=2``): with the plan on every
rank, the finished value, the row bases and the coordinator's ledger
equal the JAX run's with that plan (clock readings aside); with the plan
on rank 1 only, every rank's value equals the fault-free run's, and a
permanent fault fails both ranks with its class.  Bigrams, whose map
gathers over the ranks every step, replay alike.  A resource storm walks
the ladder on every rank, or fails both with the resource class when it
never clears; ``executor.retries_by_class`` counts a replay on each rank.
A preemption injected on every rank ends each CLI rank with exit 75 and
one snapshot, and a real SIGINT to one rank does the same on both; each
relaunch prints what the JAX CLI prints.  The JAX side is backend pallas
in pair mode (the kernel interpreted), 4 KB chunks, a window of 2 groups.
"""

import concurrent.futures
import contextlib
import dataclasses
import io
import os

import jax
import numpy as np
import pytest

import torch_world
from mapreduce_tpu import cli as jcli
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.obs import Telemetry as JTelemetry
from mapreduce_tpu.ops import datastats as jdatastats
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.obs.ledger import read_ledger
from mapreduce_tpu_torch.runtime import checkpoint as ckpt

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               compact_slots=0, sort_mode="sort3", pallas_max_token=8,
               chunk_bytes=4096, table_capacity=4096, rescue_overlong=4,
               inflight_groups=2)
CFG = {k: v for k, v in dataclasses.asdict(
    convert.config_from_dict(dataclasses.asdict(JCFG))).items()
    if k in ("backend", "map_impl", "combiner", "compact_slots", "sort_mode",
             "pallas_max_token", "chunk_bytes", "table_capacity",
             "rescue_overlong", "inflight_groups")}
#: (seam, crossing): one transient fault each (tests/test_faults.py).
SEAMS = [("reader-read", 1), ("stage-acquire", 1), ("h2d", 1),
         ("dispatch", 1), ("token-wait", 1), ("checkpoint-save", 0),
         ("ledger-append", 1), ("collective-finish", 0)]
#: The storm's start: the ladder's every rung is below it.
LADDER = dict(CFG, map_impl="fused", combiner="hot-cache", combiner_slots=8,
              sort_impl="radix", compact_slots=None, sort_mode="stable2",
              failure_policy={"resource_retries": 1, "transient_retries": 1,
                              "degrade": True, "backoff_base_s": 0.0,
                              "jitter_frac": 0.0})
#: Clock readings and paths, the JAX kernel's window-slot fields, and the
#: window statistics both packages count (tests/test_torch_obs.py).
CLOCK = {"ts", "run_id", "phases", "elapsed_s", "mem", "compile_events",
         "read_at", "staged_at", "dispatched_at", "token_ready_at",
         "retired_at", "retire_wait_s", "h2d_done_at", "started_at",
         "ended_at", "gb_per_s", "words_per_s", "bytes_per_s", "eta_s",
         "save_s", "path", "flight_dump", "input"}
PIPE_KEYS = ("inflight_groups", "prefetch_depth", "dispatch_groups",
             "depth_max", "depth_mean", "full_retires", "boundary_drains",
             "window_filled", "full_frac", "degrade_steps")


def _text(seed: int, n_words: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"w%x" % (int(i) % 300) for i in rng.zipf(1.3, n_words)]
    for i in range(150, len(words), 1100):
        words[i] = b"replayed_run%d" % (i % 3)
    return b" ".join(words)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    p = d / "one.txt"
    p.write_bytes(_text(8, 10000))  # 6 steps of 2 rows
    return str(p), d


def _case(name, path, job="wordcount", config=CFG, **kw):
    return {"name": name, "kind": "run_job",
            "args": {"job": job, "path": path, "config": config, **kw}}


def _seam_kw(seam, d, name):
    return {"checkpoint_path": str(d / f"{name}.npz"),
            "checkpoint_every": 2} if seam == "checkpoint-save" else {}


def _cli(path, ck, *extra):
    return [path, "--stream", "--chunk-bytes", "4096", "--inflight", "2",
            "--checkpoint", ck, "--checkpoint-every", "50",
            "--platform", "cpu", *extra]


def _port_world(path, d):
    cases = [_case("base", path), _case("ngram-base", path, job="ngram", n=2)]
    for seam, index in SEAMS:
        plan = f"at={seam}:{index}:transient"
        cases.append(_case(f"all-{seam}", path, retry=2,
                           ledger=str(d / f"port-{seam}.jsonl"),
                           data_stats=False, config=dict(CFG, fault_plan=plan),
                           **_seam_kw(seam, d, f"port-{seam}")))
        cases.append(_case(f"one-{seam}", path, retry=2, plan_ranks=[1],
                           config=dict(CFG, fault_plan=plan),
                           **_seam_kw(seam, d, f"one-{seam}")))
    perm = dict(CFG, fault_plan="at=dispatch:1:permanent")
    cases += [
        _case("all-permanent", path, retry=3, config=perm, data_stats=False,
              ledger=str(d / "port-permanent.jsonl")),
        _case("one-permanent", path, retry=3, config=perm, plan_ranks=[1]),
        _case("ngram-all", path, job="ngram", n=2, retry=2, config=dict(
            CFG, fault_plan="at=dispatch:1:transient,"
                            "at=token-wait:2:transient")),
        _case("ngram-one", path, job="ngram", n=2, retry=2, plan_ranks=[1],
              config=dict(CFG, fault_plan="at=dispatch:1:transient,"
                                          "at=token-wait:2:transient")),
        _case("ladder-all", path, config=LADDER,
              storm={"ranks": [0, 1], "until": {"sort_impl": "xla"}}),
        _case("ladder-one", path, config=LADDER,
              storm={"ranks": [1], "until": {"sort_impl": "xla"}}),
        _case("ladder-out", path, config=LADDER, storm={"ranks": [1]})]
    preempt = str(d / "preempt.npz")
    sig = str(d / "sigint.npz")
    cases += [
        {"name": "cli-preempt", "kind": "cli", "args": {"argv": _cli(
            path, preempt, "--fault-plan", "at=dispatch:3:preemption")}},
        {"name": "cli-preempt-resume", "kind": "cli",
         "args": {"argv": _cli(path, preempt)}},
        {"name": "cli-sigint", "kind": "cli",
         "args": {"argv": _cli(path, sig), "sigint_at": [1, 2]}},
        {"name": "cli-sigint-resume", "kind": "cli",
         "args": {"argv": _cli(path, sig)}}]
    return torch_world.spawn_world(2, cases, d / "w", group_timeout_s=60)


@pytest.fixture(scope="module")
def runs(corpus):
    """The port's world (in its own processes) and meanwhile the JAX
    references: each seam's plan, the permanent fault, and the JAX CLI's
    stdout."""
    path, d = corpus
    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(_port_world, path, d)
        with torch_world.shared_jax_engines():
            real = jdatastats.supports
            jdatastats.supports = lambda job: False
            try:
                out["base"] = jexecutor.run_job(jwc.WordCountJob(JCFG), path,
                                                JCFG, mesh=data_mesh(2))
                for seam, index in SEAMS + [("dispatch-permanent", 1)]:
                    name = seam.split("-permanent")[0]
                    cls = "permanent" if seam.endswith("permanent") \
                        else "transient"
                    cfg = dataclasses.replace(
                        JCFG, fault_plan=f"at={name}:{index}:{cls}")
                    led = str(d / f"jax-{seam}.jsonl")
                    with JTelemetry.create(ledger_path=led,
                                           progress_every_s=3600) as tel:
                        try:
                            out[seam] = jexecutor.run_job(
                                jwc.WordCountJob(cfg), path, cfg,
                                mesh=data_mesh(2), telemetry=tel,
                                retry=3 if cls == "permanent" else 2,
                                **_seam_kw(seam, d, f"jax-{seam}"))
                        except Exception as e:
                            out[seam] = e
            finally:
                jdatastats.supports = real
        raw = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                               write_through=True)
        with contextlib.redirect_stdout(raw):
            assert jcli.main([path]) == 0
        out["stdout"] = raw.buffer.getvalue()
        out["world"] = world.result()
    return out


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


def _assert_value(want, got):
    w, g = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(w, g)):
        np.testing.assert_array_equal(np.asarray(b).astype(np.uint32),
                                      np.asarray(a).astype(np.uint32),
                                      err_msg=f"leaf {i}")


def _normalized(path) -> list:
    out = []
    for rec in read_ledger(str(path)):
        rec = {k: v for k, v in rec.items() if k not in CLOCK}
        if "pipeline" in rec:
            rec["pipeline"] = {k: rec["pipeline"][k] for k in PIPE_KEYS
                               if k in rec["pipeline"]}
        out.append(rec)
    return out


@pytest.mark.parametrize("seam", [s for s, _ in SEAMS])
def test_plan_on_every_rank_matches_jax(runs, corpus, seam):
    """The same plan on every rank: the run the JAX mesh runs, value,
    bases and ledger alike."""
    want = runs[seam]
    for rank in (0, 1):
        got = _ok(runs["world"][rank][f"all-{seam}"])
        _assert_value(want.value, got["value"])
        np.testing.assert_array_equal(got["bases"], want.bases)
    d = corpus[1]
    jl, pl = _normalized(d / f"jax-{seam}.jsonl"), \
        _normalized(d / f"port-{seam}.jsonl")
    assert [r["kind"] for r in pl] == [r["kind"] for r in jl]
    for a, b in zip(jl, pl):
        assert b == a, a["kind"]
    assert [r["seam"] for r in pl if r["kind"] == "fault"] == [seam]


@pytest.mark.parametrize("seam", [s for s, _ in SEAMS])
def test_plan_on_one_rank_replays_every_rank(runs, seam):
    """A fault on rank 1 alone: both ranks agree on it, replay from their
    own anchors, and finish with the fault-free value."""
    base = _ok(runs["world"][0]["base"])
    for rank in (0, 1):
        got = _ok(runs["world"][rank][f"one-{seam}"])
        _assert_value(base["value"], got["value"])
        np.testing.assert_array_equal(got["bases"], base["bases"])


def test_replay_is_counted_on_every_rank(runs):
    """``executor.retries_by_class``: one transient replay on each rank,
    whichever rank the fault hit."""
    key = "executor.retries_by_class{fault_class=transient}"
    for name in ("all-dispatch", "one-dispatch"):
        for rank in (0, 1):
            assert _ok(runs["world"][rank][name])["retries"] == {key: 1}


def test_permanent_fault_fails_every_rank(runs, corpus):
    """No budget is spent on a permanent fault: the JAX run's failure and
    ledger on every rank's plan; on rank 1's alone both ranks fail with
    the class."""
    assert type(runs["dispatch-permanent"]).__name__ == "PermanentFault"
    for name in ("all-permanent", "one-permanent"):
        for rank in (0, 1):
            err = runs["world"][rank][name]
            assert err[0] == "error" and err[1].startswith(
                "PermanentFault("), err
    d = corpus[1]
    assert _normalized(d / "port-permanent.jsonl") \
        == _normalized(d / "jax-dispatch-permanent.jsonl")


def test_bigrams_replay_across_ranks(runs):
    """The bigram map gathers over the ranks every step: a fault before
    the step on every rank or on one replays every rank alike."""
    base = _ok(runs["world"][0]["ngram-base"])
    for name in ("ngram-all", "ngram-one"):
        for rank in (0, 1):
            got = _ok(runs["world"][rank][name])
            _assert_value(base["value"], got["value"])
            assert got["pipeline"]["recoveries"] == 2


def test_resource_storm_walks_the_ladder_on_every_rank(runs):
    """A storm on both ranks or on rank 1 alone steps the ladder down on
    both, rung by rung, to the fault-free value; a storm that never
    clears fails both ranks with the resource class."""
    base = _ok(runs["world"][0]["base"])
    for name in ("ladder-all", "ladder-one"):
        for rank in (0, 1):
            got = _ok(runs["world"][rank][name])
            assert got["pipeline"]["degrade_steps"] \
                == ["combiner-off", "map-split", "sort-xla"]
            _assert_value(base["value"], got["value"])
    errs = [runs["world"][rank]["ladder-out"] for rank in (0, 1)]
    assert "RESOURCE_EXHAUSTED" in errs[1][1]
    assert errs[0][1].startswith("ResourceFault("), errs


@pytest.mark.parametrize("how", ("preempt", "sigint"))
def test_preemption_exits_75_on_every_rank_and_resumes(runs, corpus, how):
    """An injected preemption on every rank, or a real SIGINT to rank 1
    alone: both ranks drain at the same step and exit 75, the coordinator
    saves the one snapshot, and the relaunch prints what the JAX CLI
    prints for the corpus."""
    world = runs["world"]
    assert [world[r][f"cli-{how}"] for r in (0, 1)] == [(75, b"")] * 2
    snap = corpus[1] / f"{how}.npz"
    assert ckpt.exists(str(snap))
    assert 0 < ckpt.load(str(snap))[1] < 6
    assert world[0][f"cli-{how}-resume"] == (0, runs["stdout"])
    assert world[1][f"cli-{how}-resume"] == (0, b"")
    assert not os.path.exists(str(snap) + ".tmp")
