"""Checkpoints and the CLI over D ranks against the JAX package.

Checkpoints at D = 4: the port's world of 4 gloo CPU ranks
(``tests/torch_world.py``) and the JAX package on ``data_mesh(4)`` stream
the same corpus with a snapshot every step (backend pallas, the Pallas
kernel interpreted, 4 KB chunks).  The snapshots are equal leaf for leaf
(every leaf ``[4, ...]``, rank order), with the same cursor, bases and
``__meta`` (``n_devices`` 4); a JAX snapshot resumes in the port's world,
and a port snapshot in the JAX package, to the uninterrupted result; a
snapshot of another device count is refused.  The same for the n-gram
job, whose state carries the seam carry.

The CLI: ``--stream --merge-strategy keyrange`` on 2 gloo ranks prints the
JAX CLI's stdout byte for byte (and what one rank prints); a hier-*
strategy is the JAX CLI's usage error (the CLI drives one axis), and
``--merge-overlap`` and ``--retry`` in a world of several ranks are
refused naming their items.  The run ledger of 2 ranks equals the
JAX run's on ``data_mesh(2)`` record for record.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest

import torch_world
from mapreduce_tpu import cli as jcli
from mapreduce_tpu import obs as jobs
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import cli, convert
from mapreduce_tpu_torch.obs import ledger
from mapreduce_tpu_torch.runtime import checkpoint as ckpt

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=4096, table_capacity=4096,
               rescue_overlong=4)
CFG = {k: getattr(convert.config_from_dict(dataclasses.asdict(JCFG)), k)
       for k in ("backend", "map_impl", "combiner", "pallas_max_token",
                 "chunk_bytes", "table_capacity", "rescue_overlong")}
D = 4
JOBS = {"wordcount": {}, "ngram2": {"ngram": 2}}


def _text(seed: int, n_words: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"c%x" % i for i in range(200)] + [b"checkpointed"]
    return b" ".join(vocab[int(i) % len(vocab)]
                     for i in rng.zipf(1.3, n_words))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("ckd") / "c.txt"
    p.write_bytes(_text(31, 9000))  # 3 steps of 4 rows
    return str(p)


def _copy(src, dst) -> str:
    shutil.copy(src, dst)
    shutil.copy(ckpt.integrity_path(str(src)), ckpt.integrity_path(str(dst)))
    return str(dst)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX runs (snapshot every step) and the port's world: its own
    snapshotted run of each job, and a resume of each JAX ``.prev``
    snapshot; then the JAX package resuming the port's ``.prev``."""
    d = tmp_path_factory.mktemp("snap")
    out = {"dir": d}
    with torch_world.shared_jax_engines():
        for job, kw in JOBS.items():
            out["jax", job] = jexecutor.count_file(
                corpus, JCFG, mesh=data_mesh(D),
                checkpoint_path=str(d / f"jax-{job}.npz"),
                checkpoint_every=1, **kw)
            _copy(d / f"jax-{job}.npz.prev", d / f"from-jax-{job}.npz")
        cases = []
        for job, kw in JOBS.items():
            cases.append({"name": f"run-{job}", "kind": "count_file",
                          "args": {"path": corpus, "config": CFG,
                                   "checkpoint_path": str(
                                       d / f"port-{job}.npz"),
                                   "checkpoint_every": 1, **kw}})
            cases.append({"name": f"resume-{job}", "kind": "count_file",
                          "args": {"path": corpus, "config": CFG,
                                   "checkpoint_path": str(
                                       d / f"from-jax-{job}.npz"), **kw}})
        cases.append({"name": "other-d", "kind": "count_file",
                      "args": {"path": corpus, "config": CFG,
                               "checkpoint_path": str(
                                   d / "from-jax-wordcount.npz")}})
        out["port"] = torch_world.spawn_world(
            D, cases[:-1], tmp_path_factory.mktemp("w4"))
        out["port2"] = torch_world.spawn_world(
            2, cases[-1:], tmp_path_factory.mktemp("w2"))
        for job, kw in JOBS.items():
            ck = _copy(d / f"port-{job}.npz.prev", d / f"from-port-{job}.npz")
            out["jax-resume", job] = jexecutor.count_file(
                corpus, JCFG, mesh=data_mesh(D), checkpoint_path=ck, **kw)
    return out


FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count")


def _assert_result(want, got):
    get = got.get if isinstance(got, dict) else \
        (lambda f: getattr(got, f))
    for f in FIELDS:
        assert getattr(want, f) == get(f), f


@pytest.mark.parametrize("job", sorted(JOBS))
@pytest.mark.parametrize("suffix", ["", ".prev"])
def test_snapshot_equals_jax_leaf_for_leaf(runs, job, suffix):
    want = np.load(runs["dir"] / f"jax-{job}.npz{suffix}")
    got = np.load(runs["dir"] / f"port-{job}.npz{suffix}")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k == "__meta":
            assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(bytes(got["__meta"]))["n_devices"] == D
    assert got["__leaf_0"].shape[0] == D and got["__bases"].shape[1] == D
    assert runs["port"][0][f"run-{job}"] is not None
    _assert_result(runs["jax", job], runs["port"][0][f"run-{job}"])


@pytest.mark.parametrize("job", sorted(JOBS))
def test_jax_snapshot_resumes_in_the_port(runs, job):
    got = runs["port"][0][f"resume-{job}"]
    assert got is not None and type(got) is not tuple, got
    _assert_result(runs["jax", job], got)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_port_snapshot_resumes_in_jax(runs, job):
    _assert_result(runs["jax", job], runs["jax-resume", job])


def test_snapshot_of_another_device_count_is_refused(runs):
    for rank in (0, 1):
        err = runs["port2"][rank]["other-d"]
        assert err[0] == "error" and "n_devices" in err[1], err


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

REPO = torch_world.REPO


def _jax_stdout(*args: str) -> bytes:
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(out):
            assert jcli.main(list(args)) == 0
    finally:
        os.chdir(old)
    return out.buffer.getvalue()


def test_cli_keyrange_on_two_ranks_prints_jax_stdout(corpus,
                                                     tmp_path_factory):
    flags = ["--stream", "--chunk-bytes", "4096", "--merge-strategy",
             "keyrange"]
    # The world runs in the background while the JAX CLI computes.
    world = torch_world.Later(
        torch_world.spawn_world,
        2, [{"name": fmt, "kind": "cli",
             "args": {"argv": [corpus, *flags, "--format", fmt,
                               "--platform", "cpu"]}}
            for fmt in ("reference", "json")],
        tmp_path_factory.mktemp("cli"))
    wants = {fmt: _jax_stdout(corpus, *flags, "--format", fmt)
             for fmt in ("reference", "json")}
    for fmt, want in wants.items():
        assert world[0][fmt] == (0, want), fmt
        assert world[1][fmt] == (0, b"")  # only the coordinator prints
        one = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                               write_through=True)
        with contextlib.redirect_stdout(one):
            assert cli.main([corpus, "--stream", "--chunk-bytes", "4096",
                             "--format", fmt, "--platform", "cpu"]) == 0
        assert one.buffer.getvalue() == want  # D does not change it


@pytest.mark.parametrize("argv,item", [
    (["--merge-strategy", "hier-kr-tree"], "needs a multi-axis device mesh"),
    (["--merge-strategy", "hier-tree-tree"],
     "needs a multi-axis device mesh"),
    (["--merge-overlap", "--retry", "1"],
     "--merge-overlap requires --retry 0"),
])
def test_cli_refusals_name_their_items(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--stream", "--platform", "cpu", *argv])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_cli_refuses_retry_and_batch_runs_in_a_world(monkeypatch, capsys):
    """In a world of several ranks (the launcher's ``WORLD_SIZE``) the
    single-buffer path is a usage error, and ``--retry`` with
    ``--merge-overlap`` is the JAX CLI's, both raised before any rank
    joins the world (``--retry`` alone runs: window replay spans the
    ranks)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for argv, msg in ((["--stream", "--retry", "1", "--merge-overlap"],
                       "--merge-overlap requires --retry 0"),
                      ([], "runs --stream only")):
        with pytest.raises(SystemExit) as e:
            cli.main(["test.txt", "--platform", "cpu", *argv])
        assert e.value.code == 2
        assert msg in capsys.readouterr().err



# ---------------------------------------------------------------------------
# the run ledger
# ---------------------------------------------------------------------------

#: Clock readings and paths, the JAX kernel's window-slot fields, and the
#: window statistics both packages count (as tests/test_torch_obs.py).
CLOCK = {"ts", "run_id", "phases", "elapsed_s", "mem", "compile_events",
         "read_at", "staged_at", "dispatched_at", "token_ready_at",
         "retired_at", "retire_wait_s", "h2d_done_at", "started_at",
         "ended_at", "gb_per_s", "words_per_s", "bytes_per_s", "eta_s",
         "save_s", "path", "flight_dump", "input"}
WINDOW_FIELDS = {"window_slot_capacity", "window_occupancy"}
PIPE_KEYS = ("inflight_groups", "prefetch_depth", "dispatch_groups",
             "depth_max", "depth_mean", "full_retires", "boundary_drains",
             "window_filled", "full_frac")


def _normalized(path) -> list:
    out = []
    for rec in ledger.read_ledger(path):
        rec = {k: v for k, v in rec.items()
               if k not in CLOCK and k not in WINDOW_FIELDS}
        if "pipeline" in rec:
            rec["pipeline"] = {k: rec["pipeline"][k] for k in PIPE_KEYS
                               if k in rec["pipeline"]}
        out.append(rec)
    return out


@pytest.mark.parametrize("strategy", ["tree", "keyrange"])
def test_ledger_of_two_ranks_equals_jax(corpus, tmp_path, strategy):
    """A telemetered run over 2 ranks writes one ledger (the
    coordinator's) equal record for record to the JAX run's on
    ``data_mesh(2)``: ``run_start`` with ``devices`` 2 and the strategy,
    a ``step`` and a ``group`` record a step, the ``collective`` finish,
    and the ``data`` record summed over the ranks."""
    led = {name: str(tmp_path / f"{name}.jsonl") for name in ("jax", "port")}
    # The world runs in the background while the JAX run computes.
    world = torch_world.Later(
        torch_world.spawn_world,
        2, [{"name": "run", "kind": "run_job",
             "args": {"job": "wordcount", "path": corpus, "config": CFG,
                      "merge_strategy": strategy, "ledger": led["port"]}}],
        tmp_path / "w")
    with torch_world.shared_jax_engines():
        tel = jobs.Telemetry.create(ledger_path=led["jax"],
                                    progress_every_s=3600)
        try:
            jexecutor.run_job(jwc.WordCountJob(JCFG), corpus, JCFG,
                              mesh=data_mesh(2), merge_strategy=strategy,
                              telemetry=tel)
        finally:
            tel.close()
    assert type(world[0]["run"]) is dict, world[0]["run"]
    want, got = _normalized(led["jax"]), _normalized(led["port"])
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for a, b in zip(want, got):
        assert b == a, a["kind"]
    start = got[0]
    assert (start["devices"], start["merge_strategy"]) == (2, strategy)
