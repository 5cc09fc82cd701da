"""The port's streamed executor against the JAX package's, on the CPU.

``run_job`` / ``count_file`` must equal the JAX ``count_file`` (its
``run_job`` on a one-device mesh, backend pallas, the Pallas kernel in
interpret mode) on one file and on a 3-file corpus: words, counts, order,
total, distinct and ``dropped_*``, exactly.  The window and the superstep
change no result; without a retry budget a failing step is logged with
its resume cursor and re-raised, and a run killed after a checkpoint
resumes to the uninterrupted result.  The CLI's streamed checkpointed run
prints what ``./main`` prints with the same flags; ``--retry`` and
``--fault-plan`` run, and a preempted run exits 75 and resumes as the JAX
CLI does (the failure policy itself: ``tests/test_torch_faults.py``).
"""

import contextlib
import dataclasses
import io
import logging
import os
import pathlib

import numpy as np
import pytest

from mapreduce_tpu import cli as jcli
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import cli, convert
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.obs.ledger import read_ledger
from mapreduce_tpu_torch.runtime import checkpoint as ckpt
from mapreduce_tpu_torch.runtime import executor
from mapreduce_tpu_torch.runtime.logging import LOGGER_NAME
from mapreduce_tpu_torch.utils import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
CHUNK = 4096
# One chunk shape for every JAX run of this file: one interpreted compile.
JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=CHUNK, table_capacity=4096,
               rescue_overlong=4)


def _port_config(**kw):
    return dataclasses.replace(convert.config_from_dict(
        dataclasses.asdict(JCFG)), **kw)


def _text(seed: int, n_words: int) -> bytes:
    """Zipf words with a few tokens longer than W = 8 (the rescue), at most
    two a chunk."""
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(250)] + [b"abcdefgh"]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]
    for i in range(120, len(words), 900):
        words[i] = b"streamed_over%d" % (i % 3)
    return b" ".join(words)


@pytest.fixture(scope="module")
def one_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("one") / "corpus.txt"
    p.write_bytes(_text(1, 4000))  # 5 chunks
    return str(p)


@pytest.fixture(scope="module")
def three_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("three")
    paths = []
    for i, n in enumerate((1500, 300, 2500)):
        p = d / f"part{i}.txt"
        p.write_bytes(_text(10 + i, n))
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def jax_results(one_file, three_files):
    mesh = data_mesh(1)  # interpret mode deadlocks at 8 devices (ADVICE)
    return {"one": jexecutor.count_file(one_file, JCFG, mesh=mesh),
            "three": jexecutor.count_file(three_files, JCFG, mesh=mesh)}


def _corpus(name, one_file, three_files):
    return one_file if name == "one" else three_files


def _assert_results_equal(want, got):
    for f in ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count"):
        assert getattr(want, f) == getattr(got, f), f


@pytest.mark.parametrize("corpus", ["one", "three"])
@pytest.mark.parametrize("inflight,superstep", [(4, 1), (1, 1), (4, 3),
                                                (1, 3)])
def test_count_file_matches_jax(jax_results, one_file, three_files, corpus,
                                inflight, superstep):
    path = _corpus(corpus, one_file, three_files)
    cfg = _port_config(inflight_groups=inflight, superstep=superstep)
    got = executor.count_file(path, cfg, device="cpu")
    _assert_results_equal(jax_results[corpus], got)
    joined = b"\n".join(pathlib.Path(p).read_bytes()
                        for p in ([path] if corpus == "one" else path))
    assert got.as_dict() == oracle.word_counts(joined)
    assert got.dropped_count == 0


def test_run_job_result_and_pipeline(three_files):
    """The window statistics and phases of a streamed run.  As in the JAX
    package, a file boundary is a group and window boundary only for a job
    with a boundary hook: the word count's superstep-3 groups run across
    the files, the bigram job's end at each file."""
    cfg = _port_config(superstep=3, inflight_groups=2)
    job = wc.WordCountJob(cfg, "cpu")
    rr = executor.run_job(job, three_files, cfg)
    sizes = [os.path.getsize(p) for p in three_files]
    steps = [-(-n // CHUNK) for n in sizes]
    assert rr.bases.shape == (sum(steps), 1)
    assert rr.metrics.bytes_processed == sum(sizes)
    assert rr.metrics.words_counted == rr.value.total_count()
    pipe = rr.pipeline
    assert pipe["dispatch_groups"] == -(-sum(steps) // 3)
    assert pipe["boundary_drains"] == 0
    grams = executor.run_job(wc.NGramCountJob(2, cfg, "cpu"), three_files,
                             cfg).pipeline
    assert grams["dispatch_groups"] == sum(-(-n // 3) for n in steps)
    assert grams["boundary_drains"] == len(steps) - 1
    assert pipe["inflight_groups"] == 2 and pipe["prefetch_depth"] == 6
    phases = rr.metrics.phases
    for phase in ("read_wait", "stage", "dispatch", "host_read", "h2d_tail",
                  "compute_tail", "stream", "reduce", "total"):
        assert phase in phases, phase
    # The map's host read is timed inside dispatch and counts as a wait.
    assert phases["host_read"] <= phases["dispatch"]
    blocked = sum(phases.get(p, 0.0) for p in (
        "read_wait", "host_read", "retire_wait", "h2d_tail", "compute_tail"))
    assert pipe["overlap_fraction"] \
        == round(max(0.0, 1.0 - blocked / phases["stream"]), 4)
    res = executor.count_file(three_files, cfg, device="cpu")
    assert "recover" in res.run.metrics.phases and res.run.value is None


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@contextlib.contextmanager
def _captured_log():
    h = _Capture()
    logger = logging.getLogger(LOGGER_NAME)
    logger.addHandler(h)
    try:
        yield h.records
    finally:
        logger.removeHandler(h)


def _failing_engine(at_step: int):
    class FailingEngine(executor.Engine):
        def step(self, state, chunk, step_index):
            if step_index >= at_step:
                raise RuntimeError("injected device fault")
            return super().step(state, chunk, step_index)
    return FailingEngine


def test_step_failure_is_logged_with_resume_cursor(monkeypatch, one_file):
    monkeypatch.setattr(executor, "Engine", _failing_engine(2))
    with _captured_log() as records, \
            pytest.raises(RuntimeError, match="injected device fault"):
        executor.count_file(one_file, _port_config(), device="cpu")
    failed = [r for r in records if r.getMessage() == "step failed"]
    assert len(failed) == 1
    assert failed[0].fields["step"] == 2
    assert failed[0].fields["resume_hint"] == \
        "enable checkpointing to resume"
    assert failed[0].fields["offset"] > 0


@pytest.mark.parametrize("superstep", [1, 3])
def test_kill_after_checkpoint_resumes_to_the_same_result(
        monkeypatch, tmp_path, three_files, superstep):
    cfg = _port_config(superstep=superstep)
    want = executor.count_file(three_files, cfg, device="cpu")
    ck = str(tmp_path / "ck.npz")
    with monkeypatch.context() as m:
        m.setattr(executor, "Engine", _failing_engine(3))
        with _captured_log() as records, \
                pytest.raises(RuntimeError, match="injected device fault"):
            executor.count_file(three_files, cfg, device="cpu",
                                checkpoint_path=ck, checkpoint_every=2)
    failed = [r for r in records if r.getMessage() == "step failed"]
    assert failed[0].fields["resume_hint"] == ck
    # The snapshot ends the first file: the resume starts at a file seam.
    _, step, offset, bases, file_index = ckpt.load(ck)
    assert (step, offset, bases.shape, file_index) \
        == (2, os.path.getsize(three_files[0]), (2, 1), 0)
    with _captured_log() as records:
        got = executor.count_file(three_files, cfg, device="cpu",
                                  checkpoint_path=ck, checkpoint_every=2)
    resumed = [r.fields for r in records
               if r.getMessage() == "resumed from checkpoint"]
    assert resumed == [{"step": 2, "offset": offset}]
    _assert_results_equal(want, got)
    assert got.run.metrics.bytes_processed \
        == sum(os.path.getsize(p) for p in three_files) - offset


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


def test_cli_stream_checkpoint_matches_jax_cli(tmp_path, capsysbinary):
    flags = ["--stream", "--checkpoint-every", "1", "--chunk-bytes", "4096"]
    want = _jax_stdout("test.txt", "--checkpoint",
                       str(tmp_path / "jax.npz"), *flags)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        ck = str(tmp_path / "port.npz")
        for _ in range(2):  # the second run resumes from the snapshot
            assert cli.main(["test.txt", "--checkpoint", ck, *flags,
                             "--platform", "cpu", "--stats"]) == 0
            captured = capsysbinary.readouterr()
            assert captured.out == want
            assert b"[stats]" in captured.err
    finally:
        os.chdir(old)
    assert ckpt.exists(ck)


def _jax_tune_lines(tune) -> list:
    """The JAX CLI's ``autotune:`` stderr lines for a proposal."""
    import types

    with contextlib.redirect_stderr(io.StringIO()) as err:
        jcli._print_tune(types.SimpleNamespace(last_tune=tune))
    return err.getvalue().splitlines()


def _port_stdout(capsysbinary, *args: str, rc: int = 0) -> bytes:
    old = os.getcwd()
    os.chdir(REPO)
    try:
        assert cli.main([*args, "--platform", "cpu"]) == rc
    finally:
        os.chdir(old)
    return capsysbinary.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--checkpoint", "ck.npz"],
    ["--stream", "--retry", "1"],
    ["--stream", "--fault-plan", "at=dispatch:0:transient", "--retry", "1"],
    ["--stream", "--merge-overlap"],
    ["--stream", "--merge-overlap", "--retry", "1"],
    ["--stream", "--autotune"],
    ["--stream", "--ledger", "LEDGER"],
])
def test_cli_refusals(argv, capsysbinary, tmp_path):
    """``--checkpoint`` without ``--stream`` is a usage error; ``--retry``
    and ``--fault-plan`` run, and a fault the budget absorbs leaves the
    output exact; ``--merge-overlap`` runs and prints what the plain run
    prints, and with ``--retry`` it is the JAX CLI's usage error;
    ``--ledger`` runs, prints what the plain run prints and leaves a
    ledger that parses; ``--autotune`` runs, prints what the plain run
    prints, and its stderr ``autotune:`` lines are the JAX CLI's
    ``_print_tune`` of the JAX tuner's proposal over the run's records
    (and of no proposal, when the hint is unavailable)."""
    overlap = "--merge-overlap" in argv
    if "--autotune" in argv:
        import types

        from mapreduce_tpu import tuning as jtuning

        ledger = str(tmp_path / "tune.jsonl")
        want = _port_stdout(capsysbinary, "test.txt")
        old = os.getcwd()
        os.chdir(REPO)
        try:
            assert cli.main(["test.txt", *argv, "--ledger", ledger,
                             "--platform", "cpu"]) == 0
        finally:
            os.chdir(old)
        got = capsysbinary.readouterr()
        assert got.out == want
        recs = list(read_ledger(ledger))
        kinds = [r["kind"] for r in recs]
        assert kinds.count("tune") == 1 and kinds[-1] == "run_end"
        end, start = recs[-1], recs[0]
        prop = jtuning.propose(
            recs[:kinds.index("tune")] + [
                {"run_id": end["run_id"], "kind": "run_end",
                 "phases": end["phases"], "pipeline": end["pipeline"]}],
            run_id=end["run_id"], current={
                "chunk_bytes": start["chunk_bytes"],
                "superstep": start["superstep"],
                "inflight_groups": end["pipeline"]["inflight_groups"],
                "prefetch_depth": end["pipeline"]["prefetch_depth"]})
        lines = [ln for ln in got.err.decode().splitlines()
                 if ln.startswith("autotune: ")]
        assert lines == _jax_tune_lines(prop) and len(lines) == 2
        with contextlib.redirect_stderr(io.StringIO()) as err:
            cli._print_tune(types.SimpleNamespace(last_tune=None))
        assert err.getvalue().splitlines() == _jax_tune_lines(None)
        return
    if ("--retry" in argv and not overlap) or "--ledger" in argv \
            or argv == ["--stream", "--merge-overlap"]:
        ledger = tmp_path / "run.jsonl"
        argv = [str(ledger) if a == "LEDGER" else a for a in argv]
        want = _port_stdout(capsysbinary, "test.txt")
        assert _port_stdout(capsysbinary, "test.txt", *argv) == want
        if "--ledger" in argv:
            kinds = [r["kind"] for r in read_ledger(str(ledger))]
            assert kinds[0] == "run_start" and kinds[-1] == "run_end"
            assert len(ledger.read_text().splitlines()) == len(kinds)
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", *argv])
    assert e.value.code == 2
    err = capsysbinary.readouterr().err
    assert (b"--checkpoint requires --stream" in err) \
        if argv[0] == "--checkpoint" else \
        b"--merge-overlap requires --retry 0" in err


def test_cli_preempted_run_exits_75_and_resumes_like_jax(tmp_path,
                                                         capsysbinary):
    """An injected preemption at the first completion wait exits 75 with
    the window drained into a snapshot; the relaunch resumes and prints
    what the JAX CLI prints for the same two commands."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(_text(3, 4000))  # 5 chunks: the window of 4 fills
    flags = ["--stream", "--chunk-bytes", "4096", "--checkpoint-every", "50"]
    plan = ["--fault-plan", "at=token-wait:0:preemption"]
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        ck = str(tmp_path / f"{name}.npz")
        argv = [str(corpus), "--checkpoint", ck, *flags]
        extra = ["--platform", "cpu"] if name == "port" else []
        old = os.getcwd()
        os.chdir(REPO)
        try:
            assert main([*argv, *plan, *extra]) == 75
            first = capsysbinary.readouterr()
            assert b"\npreempted: preempted at step " in b"\n" + first.err
            assert ckpt.exists(ck)
            assert main([*argv, *extra]) == 0
            outs[name] = (first.out, capsysbinary.readouterr().out)
        finally:
            os.chdir(old)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == b"" and b"Total Count:4000" in outs["port"][1]
    # The port's one device drained four groups of one chunk each (the JAX
    # CLI's mesh of 8 CPU devices takes the corpus in one step).
    assert ckpt.load(str(tmp_path / "port.npz"))[1] == 4


def test_config_pipeline_knobs_map_from_jax():
    jcfg = JConfig(superstep=3, inflight_groups=2, prefetch_depth=5)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.superstep, cfg.inflight_groups, cfg.prefetch_depth,
            cfg.resolved_prefetch_depth) == (3, 2, 5, 5)
    assert convert.config_from_dict(dataclasses.asdict(JConfig())) \
        .resolved_prefetch_depth == JConfig().resolved_prefetch_depth == 4
    for kw in ({"merge_overlap": True}, {"autotune": "hint"},
               {"fault_plan": "seed=1"}):
        if "fault_plan" in kw:
            # The fault plan (and the failure policy) map across.
            jc = JConfig(fault_plan="seed=1,rate=0.1",
                         failure_policy={"transient_retries": 2})
            cfg = convert.config_from_dict(dataclasses.asdict(jc))
            assert cfg.fault_plan == jc.fault_plan
            assert cfg.failure_policy.as_dict() \
                == jc.failure_policy.as_dict()
            continue
        if "merge_overlap" in kw:
            # Window-boundary merges map across.
            assert convert.config_from_dict(dataclasses.asdict(
                JConfig(**kw))).merge_overlap is True
            continue
        # The autotuner's mode carries across, as the JAX field is.
        cfg = convert.config_from_dict(dataclasses.asdict(JConfig(**kw)))
        assert cfg.autotune == JConfig(**kw).autotune == "hint"
    for kw in ({"superstep": 0}, {"inflight_groups": 0},
               {"prefetch_depth": 0}):
        with pytest.raises(ValueError):
            wc.Config(**kw)
