"""Runs over several hosts: the per-host byte ranges (mode (a)) and the one
global program (mode (b), ``run_job_global``) against the JAX package.

A world of 4 gloo CPU ranks laid out as 2 hosts of 2
(``tests/torch_world.py``, ``hosts=2``) runs:

* mode (a): each host streams its aligned ``host_byte_range`` over its own
  ranks (``local_data_mesh``, ``run_job(byte_range=)``); each host's
  partial table equals the JAX ``run_job(byte_range=)`` on a local mesh of
  2 devices (as ``tests/test_multihost.py`` runs it in one process), and
  the partials merged on the coordinator equal the JAX merge and the
  oracle;
* mode (b): ``run_job_global`` over ``two_level_mesh(2, 2)`` equals the
  JAX ``run_job_global`` run in one process on the same mesh, on every
  rank, and so does the one over the world's axis (nothing spills);
* with a ledger (every rank handed the same path), the coordinator's main
  file and one shard a host, ``<ledger>.h0.jsonl`` and
  ``<ledger>.h1.jsonl``, whose records carry their ``host`` and equal the
  JAX records of ``attach_host`` without clock readings (a host's
  ``host_bytes`` are its rows'); a failed run dumps each host's flight
  record to its own path;
* a ``process-kill`` planned at the same crossing on every rank ends
  every process (exit 113) after a snapshot, each shard holding the
  fault record; a world of fresh processes resumes to the uninterrupted
  result; a kill on one rank alone ends its peers' runs with an error
  within the (short) group timeout.

``Telemetry.attach_host`` alone equals the JAX handle's (its records,
paths and stamps), as ``tests/test_fleet.py`` tests the JAX one.
"""

import os

import numpy as np
import pytest
import torch

import torch_world
from mapreduce_tpu import obs as jobs
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.ops import table as jtable
from mapreduce_tpu.parallel import distributed as jdist
from mapreduce_tpu.parallel.mesh import data_mesh, two_level_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.obs import ledger, telemetry
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.utils import oracle

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=4096, table_capacity=2048,
               rescue_overlong=4)
CFG = {"backend": "pallas", "map_impl": "split", "combiner": "off",
       "pallas_max_token": 8, "chunk_bytes": 4096, "table_capacity": 2048,
       "rescue_overlong": 4}
#: Clock readings and paths (as tests/test_torch_obs.py), the run-epoch
#: clock pair, and the window statistics both packages count.
CLOCK = {"ts", "run_id", "phases", "elapsed_s", "mem", "compile_events",
         "read_at", "staged_at", "dispatched_at", "token_ready_at",
         "retired_at", "retire_wait_s", "h2d_done_at", "started_at",
         "ended_at", "gb_per_s", "words_per_s", "bytes_per_s", "eta_s",
         "save_s", "path", "flight_dump", "input", "clock"}
PIPE_KEYS = ("inflight_groups", "prefetch_depth", "dispatch_groups",
             "depth_max", "depth_mean", "full_retires", "boundary_drains",
             "window_filled", "full_frac")


def _text(seed: int, n_words: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"h%x" % i for i in range(400)] + [b"overlong_word"]
    return b" ".join(vocab[int(i) % len(vocab)]
                     for i in rng.zipf(1.3, n_words))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("mh") / "c.txt"
    p.write_bytes(_text(23, 11000))  # ~4 steps of 4 rows
    return str(p)


def _case(name, corpus, **kw):
    return {"name": name, "kind": "run_job",
            "args": {"job": "wordcount", "path": corpus, "config": CFG,
                     **kw}}


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX references and, in the background meanwhile, the port's
    worlds: the main 2 x 2 world, the killed one and the resuming one."""
    d = tmp_path_factory.mktemp("mhrun")
    out = {"dir": d, "jax": {}}
    size = os.path.getsize(corpus)
    led = str(d / "port.jsonl")
    out["ledger"] = led
    cases = [
        _case("host", corpus, mesh="local", byte_range="host"),
        _case("global", corpus, driver="run_job_global"),
        _case("global22", corpus, driver="run_job_global", mesh=[2, 2],
              merge_strategy="hier-kr-tree", ledger=led, ledger_every=True),
        _case("failed", corpus, driver="run_job_global",
              ledger=str(d / "failed.jsonl"), ledger_every=True,
              config=dict(CFG, fault_plan="at=dispatch:1:permanent"))]
    ck = str(d / "kill.npz")
    kill = dict(driver="run_job_global", checkpoint_path=ck,
                checkpoint_every=1, ledger=str(d / "kill.jsonl"),
                ledger_every=True)
    rk = str(d / "range.npz")
    tmp = {n: tmp_path_factory.mktemp(n) for n in ("w", "wk", "wr")}

    def worlds():
        return (torch_world.spawn_world(
            4, cases, tmp["w"], hosts=2, group_timeout_s=60),
            torch_world.spawn_world(
            4, [_case("kill", corpus, config=dict(
                CFG, fault_plan="at=process-kill:1:permanent"), **kill)],
            tmp["wk"], hosts=2, group_timeout_s=60, expect_rc=113),
            torch_world.spawn_world(
            4, [_case("resume", corpus, driver="run_job_global",
                      checkpoint_path=ck, checkpoint_every=1),
                _case("range-vs-whole", corpus, byte_range="host",
                      checkpoint_path=ck),
                _case("range-save", corpus, byte_range=[0, 8192],
                      checkpoint_path=rk, checkpoint_every=1),
                _case("range-other", corpus, byte_range=[0, 12288],
                      checkpoint_path=rk),
                _case("peer-dies", corpus, driver="run_job_global",
                      plan_ranks=[3], config=dict(
                          CFG, fault_plan="at=process-kill:0:permanent"))],
            tmp["wr"], hosts=2, group_timeout_s=20,
            expect_rc=[0, 0, 0, 113]))

    ports = torch_world.Later(worlds)
    with torch_world.shared_jax_engines():
        for p in range(2):
            lo, hi = jdist.align_range_to_separator(
                corpus, *jdist.host_byte_range(size, p, 2))
            out["jax"]["range", p] = (lo, hi)
            out["jax"]["host", p] = jexecutor.run_job(
                jwc.WordCountJob(JCFG), corpus, JCFG, mesh=data_mesh(2),
                byte_range=(lo, hi))
        out["jax"]["merged"] = jtable.merge(
            out["jax"]["host", 0].value, out["jax"]["host", 1].value,
            capacity=JCFG.table_capacity)
        tel = jobs.Telemetry.create(ledger_path=str(d / "jax.jsonl"),
                                    progress_every_s=3600)
        tel.attach_host(1, 2, local_devices=2,
                        clock={"wall": 1.0, "mono": 0.5})
        try:
            out["jax"]["global22"] = jexecutor.run_job_global(
                jwc.WordCountJob(JCFG), corpus, JCFG,
                mesh=two_level_mesh(2, 2), merge_strategy="hier-kr-tree",
                telemetry=tel)
        finally:
            tel.close()
    out["world"], out["killed"], out["resumed"] = ports.result()
    return out


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


def _assert_fields(want, got):
    for f in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)).astype(np.uint32),
            np.asarray(getattr(want, f)).astype(np.uint32), err_msg=f)


@pytest.mark.parametrize("host", [0, 1])
def test_per_host_range_equals_jax(runs, host):
    """Mode (a): both ranks of a host hold its partial table, equal to the
    JAX per-host run on a local mesh of 2, over the same aligned range."""
    want = runs["jax"]["host", host]
    for rank in (2 * host, 2 * host + 1):
        got = _ok(runs["world"][rank]["host"])
        assert tuple(got["byte_range"]) == runs["jax"]["range", host]
        _assert_fields(want.value, got["value"])
        np.testing.assert_array_equal(got["bases"], want.bases)
        assert got["bytes"] == want.metrics.bytes_processed


def test_partials_merge_to_the_whole_corpus(runs, corpus):
    """The two hosts' partial tables merged on the coordinator (the port's
    ``table_ops.merge``) equal the JAX merge, every field, and the
    oracle's counts."""
    parts = [convert.state_from_numpy(
        _ok(runs["world"][r]["host"])["value"], torch.device("cpu"))
        for r in (0, 2)]
    merged = table_ops.merge(parts[0], parts[1],
                             capacity=JCFG.table_capacity)
    _assert_fields(runs["jax"]["merged"], convert.state_to_numpy(merged))
    cnt = np.asarray(runs["jax"]["merged"].count)
    with open(corpus, "rb") as f:
        want = oracle.word_counts(f.read())
    assert sorted(cnt[cnt > 0].tolist()) == sorted(want.values())
    assert int(merged.total_count()) == sum(want.values())


@pytest.mark.parametrize("name", ["global", "global22"])
def test_run_job_global_equals_jax(runs, name):
    """Mode (b) over ``two_level_mesh(2, 2)`` (hier-kr-tree) and over the
    world's axis (the default, tree): the replicated value and the bases
    on every rank, held to the JAX run on the two-level mesh (nothing
    spills, so every strategy gives one table)."""
    want = runs["jax"]["global22"]
    assert int(np.asarray(want.value.dropped_uniques)) == 0
    for res in runs["world"]:
        got = _ok(res[name])
        _assert_fields(want.value, got["value"])
        np.testing.assert_array_equal(got["bases"], want.bases)


def _normalized(path) -> list:
    out = []
    for rec in ledger.read_ledger(path):
        rec = {k: v for k, v in rec.items()
               if k not in CLOCK and k not in ("host", "host_bytes")}
        if "pipeline" in rec:
            rec["pipeline"] = {k: rec["pipeline"][k] for k in PIPE_KEYS
                               if k in rec["pipeline"]}
        out.append(rec)
    return out


def test_global_ledger_shards_equal_jax(runs):
    """The coordinator's main file and the two host shards: every record
    equals the JAX run's under ``attach_host`` without clock readings;
    each shard's records carry its host, ``run_start`` the topology, and
    a host's ``host_bytes`` are its rows' (the hosts' sum is the JAX
    single process's, which holds every row)."""
    led, d = runs["ledger"], runs["dir"]
    want = _normalized(str(d / "jax.jsonl"))
    jshard = list(ledger.read_ledger(ledger.shard_path(str(d / "jax.jsonl"),
                                                       1)))
    assert _normalized(led) == want
    host_bytes = []
    for p in (0, 1):
        path = ledger.shard_path(led, p)
        assert _normalized(path) == want, p
        recs = list(ledger.read_ledger(path))
        assert all(r["host"] == p for r in recs)
        start = recs[0]
        assert (start["kind"], start["driver"], start["processes"],
                start["local_devices"]) == ("run_start", "run_job_global",
                                            2, 2)
        assert set(start["clock"]) == {"wall", "mono"}
        assert "retry" not in start
        host_bytes.append([r["host_bytes"] for r in recs
                           if r["kind"] == "group"])
    assert [a + b for a, b in zip(*host_bytes)] \
        == [r["host_bytes"] for r in jshard if r["kind"] == "group"]
    assert all(r.get("host") == 0 for r in ledger.read_ledger(led))
    assert not os.path.exists(ledger.shard_path(led, 2))


def test_failed_global_run_dumps_each_hosts_flight(runs):
    """A dispatch failure ends the run on every rank; each host's first
    rank dumps its flight record to its own path, host 1 to the shard's
    flight path, and both shards hold the ``failure`` record."""
    path = str(runs["dir"] / "failed.jsonl")
    for res in runs["world"]:
        err = res["failed"]
        assert err[0] == "error" and "dispatch" in err[1], err
    assert os.path.exists(path + ".flight.json")
    assert os.path.exists(ledger.shard_flight_path(path, 1))
    for p in (0, 1):
        kinds = [r["kind"] for r in ledger.read_ledger(
            ledger.shard_path(path, p))]
        assert "failure" in kinds, (p, kinds)


def test_process_kill_then_resume_equals_uninterrupted(runs):
    """Every rank exits 113 at the planned crossing, after the
    coordinator's snapshot; each host's shard holds the injected
    ``process-kill`` fault; fresh processes resume to the uninterrupted
    result on every rank.  A snapshot of the whole corpus refuses to
    resume a host's byte range, and a range's snapshot another range."""
    assert runs["killed"] == [113] * 4
    d = runs["dir"]
    assert os.path.exists(d / "kill.npz")
    for p in (0, 1):
        faults = [r for r in ledger.read_ledger(ledger.shard_path(
            str(d / "kill.jsonl"), p)) if r["kind"] == "fault"]
        assert any(f["seam"] == "process-kill" and f["injected"]
                   for f in faults), (p, faults)
    want = runs["jax"]["global22"]
    for res in runs["resumed"][:3]:
        got = _ok(res["resume"])
        _assert_fields(want.value, got["value"])
        np.testing.assert_array_equal(got["bases"], want.bases)
        _ok(res["range-save"])
        for name in ("range-vs-whole", "range-other"):
            err = res[name]
            assert err[0] == "error" and "byte_range" in err[1], err


def test_a_dead_rank_ends_its_peers_runs(runs):
    """One rank killed in the middle of a global run: every peer's run
    ends with an error within the group timeout instead of waiting for
    it (the world was joined within its limit), and the peers go on."""
    for res in runs["resumed"][:3]:
        err = res["peer-dies"]
        assert err[0] == "error", err
    assert runs["resumed"][3] is None


def test_attach_host_equals_jax(tmp_path):
    """The handle alone, as the JAX package's tests/test_fleet.py checks
    its own: shard and stamps in shard mode, the suffixed flight paths,
    stamps only without a shard, a disabled handle untouched."""
    recs = {}
    for name, mod in (("jax", jobs), ("port", telemetry)):
        p = str(tmp_path / f"{name}.jsonl")
        create = mod.Telemetry.create
        tel = create(ledger_path=p)
        tel.attach_host(1, 2, local_devices=2,
                        clock={"wall": 10.0, "mono": 3.0})
        assert tel.flight_path == ledger.shard_flight_path(p, 1)
        tel.ledger_write("run_start", driver="t", write=False)
        tel.ledger_write("group", step_first=0, write=False)
        tel.ledger_write("checkpoint", step=1, write=True)
        tel.close()
        strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                           if k not in ("ts", "run_id")}
        recs[name] = ([strip(r) for r in ledger.read_ledger(p)],
                      [strip(r) for r in ledger.read_ledger(
                          ledger.shard_path(p, 1))])
        fp = str(tmp_path / f"{name}.flight.json")
        t = mod.Telemetry(flight_path=fp)
        t.attach_host(1, 2)
        assert t.flight_path == fp + ".h1"
        a = str(tmp_path / f"{name}-a.jsonl")
        t = create(ledger_path=a)
        t.attach_host(0, 3, clock={"wall": 1.0, "mono": 0.5}, shard=False)
        t.ledger_write("run_start", driver="t")
        t.close()
        assert t.shard is None and not os.path.exists(
            ledger.shard_path(a, 0))
        rec = next(ledger.read_ledger(a))
        assert rec["host"] == 0 and rec["processes"] == 3
        off = mod.Telemetry.disabled()
        off.attach_host(1, 2)
        assert off.shard is None and not off.host
    assert recs["port"] == recs["jax"]
    main, shard = recs["port"]
    assert [r["kind"] for r in main] == ["checkpoint"]
    assert [r["kind"] for r in shard] == ["run_start", "group", "checkpoint"]
    assert shard[0]["clock"] == {"wall": 10.0, "mono": 3.0}


def test_wrong_host_layout_is_refused(monkeypatch):
    """A world whose nodes would hold different numbers of ranks, or a
    launcher node rank that disagrees with the rank's place, raises."""
    from mapreduce_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda: 3)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not split into hosts"):
        distributed.process_count()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("GROUP_RANK", "0")
    with pytest.raises(ValueError, match="numbered node by node"):
        distributed.process_index()
    monkeypatch.setenv("GROUP_RANK", "1")
    assert (distributed.process_index(), distributed.process_count(),
            distributed.local_device_count()) == (1, 2, 2)
    assert distributed.host_byte_range(1001) \
        == jdist.host_byte_range(1001, 1, 2)
    assert list(distributed.host_shards(8)) \
        == list(jdist.host_shards(8, 1, 2))
