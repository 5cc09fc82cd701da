"""The port's CLI against the JAX package's, on the CPU.

``python -m mapreduce_tpu_torch ... --platform cpu`` must print stdout
byte-identical to ``./main`` (the JAX CLI) for the flags the port takes,
refuse every other JAX flag with a usage error, and refuse to run without a
card unless asked for the CPU.  Outputs are compared as bytes: exact.
"""

import contextlib
import functools
import io
import os
import pathlib
import subprocess
import sys

import pytest

from mapreduce_tpu import cli as jcli
from mapreduce_tpu_torch import cli

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(argv: list[str], cwd=REPO, **env) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
                **env}
    return subprocess.run(argv, cwd=cwd, env=full_env, capture_output=True,
                          timeout=300)


@functools.lru_cache(maxsize=None)
def _jax_stdout(*args: str) -> bytes:
    """The JAX CLI's stdout, run in-process (as tests/test_cli.py runs it)
    from the repo root."""
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(out):
            assert jcli.main(list(args)) == 0
    finally:
        os.chdir(old)
    return out.buffer.getvalue()


def _port_stdout(*args: str) -> bytes:
    proc = _run([sys.executable, "-m", "mapreduce_tpu_torch", *args,
                 "--platform", "cpu"])
    assert proc.returncode == 0, proc.stderr.decode()
    return proc.stdout


@pytest.mark.parametrize("fmt", ["reference", "json"])
def test_stdout_identical_to_jax_cli(fmt):
    want = _jax_stdout("test.txt", "--format", fmt)
    assert _port_stdout("test.txt", "--format", fmt) == want
    if fmt == "reference":
        assert want.endswith(b"Total Count:9\n")


@pytest.mark.parametrize("flags", [
    ("--map-impl", "fused", "--combiner", "hot-cache"),
    ("--map-impl", "fused", "--combiner", "hot-cache", "--combiner-slots",
     "16", "--format", "json"),
    ("--sort-impl", "radix_partition"),
    ("--sort-impl", "radix", "--format", "json"),
])
def test_kernel_flags_stdout_identical_to_jax_cli(flags):
    """The fused map with the hot-key combiner and the radix sort seam:
    the same bytes as the JAX CLI with the same flags."""
    want = _jax_stdout("test.txt", *flags)
    assert _port_stdout("test.txt", *flags) == want


@pytest.mark.parametrize("mode", ["salt", "auto"])
def test_unported_combiners_are_refused(mode, capsys):
    """'salt' runs and prints the JAX CLI's stdout; 'auto' resolves
    through the autotuner's prior, which is not ported: exit 2 naming
    its item."""
    if mode == "salt":
        flags = ("--combiner", "salt", "--format", "json")
        assert _port_stdout("test.txt", *flags) == \
            _jax_stdout("test.txt", *flags)
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", "--combiner", mode])
    assert e.value.code == 2
    assert "ROADMAP.md item A8b (ii), the autotuner" \
        in capsys.readouterr().err


def test_in_process_flags_match_jax_cli(capsysbinary, tmp_path):
    """tsv, --no-echo, top-k, stream, several files: the port in-process
    against the JAX CLI's stdout (a streamed run against the JAX CLI's
    single-buffer run: the JAX streamed executor's compile alone would
    cost more than this file's time budget; the two print the same)."""
    other = tmp_path / "more.txt"
    other.write_bytes(b"Good Good\tbye\nHello")
    files = ["test.txt", str(other)]
    cases = [["--no-echo", "--top-k", "3"] + files,
             ["--stream", "--chunk-bytes", "4096", "--format", "tsv"] + files]
    old = os.getcwd()
    os.chdir(REPO)
    try:
        for args in cases:
            assert cli.main(args + ["--platform", "cpu"]) == 0
            got = capsysbinary.readouterr().out
            jax_args = [a for a in args if a not in ("--stream", "4096",
                                                     "--chunk-bytes")]
            assert got == _jax_stdout(*jax_args), args
    finally:
        os.chdir(old)


@pytest.mark.parametrize("flags", [
    ("--backend", "xla", "--format", "json"),
    ("--backend", "pallas", "--sort-mode", "sort3"),
    ("--backend", "pallas", "--sort-mode", "sort3", "--compact-slots", "0"),
    ("--backend", "pallas", "--compact-slots", "128", "--max-token-bytes",
     "3", "--rescue-overlong", "1", "--rescue-overlong-max", "2",
     "--rescue-window", "100", "--format", "json"),
    ("--backend", "pallas", "--max-token-bytes", "4", "--rescue-overlong",
     "0", "--format", "json"),
])
def test_kernel_knob_flags_stdout_identical_to_jax_cli(flags, capsysbinary):
    """The JAX CLI's backend, sort-mode, slot and overlong-rescue flags:
    the same bytes as the JAX CLI with the same flags (in-process)."""
    want = _jax_stdout("test.txt", *flags)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        assert cli.main(["test.txt", *flags, "--platform", "cpu"]) == 0
    finally:
        os.chdir(old)
    assert capsysbinary.readouterr().out == want


def test_version_flag_matches_jax_cli(capsysbinary):
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["--version"])
        assert e.value.code == 0
    jax_out, port_out = capsysbinary.readouterr().out.splitlines()
    assert port_out == jax_out.replace(b"mapreduce-tpu", b"mapreduce-tpu-torch")
    assert port_out.startswith(b"mapreduce-tpu-torch ")


@pytest.mark.parametrize("flags,item", [
    (("--sort-mode", "segmin"), None),
    (("--stream", "--merge-strategy", "auto"), "A8b (ii), the autotuner"),
    (("--autotune",), "A8b (ii), the autotuner"),
    (("--geometry", "auto"), "A8b (ii), the autotuner"),
])
def test_flags_the_port_refuses_name_their_item(flags, item, capsysbinary,
                                                monkeypatch):
    """The autotuner's flags exit 2 naming its item.  ``--sort-mode
    segmin`` runs on the CPU (the JAX CLI's stdout); off the CPU the JAX
    CLI's guard exits 2 before any device work unless
    ``MAPREDUCE_ALLOW_SEGMIN`` says yes, in both command lines."""
    if item is None:
        monkeypatch.delenv("MAPREDUCE_ALLOW_SEGMIN", raising=False)
        monkeypatch.chdir(REPO)
        run = ["test.txt", *flags, "--format", "tsv"]
        assert cli.main(run + ["--platform", "cpu"]) == 0
        assert capsysbinary.readouterr().out == _jax_stdout(*run)
        assert cli.main(run + ["--platform", "gpu"]) == 2
        err = capsysbinary.readouterr().err.decode()
        assert "MAPREDUCE_ALLOW_SEGMIN=1" in err and "segmin" in err
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", *flags])
    assert e.value.code == 2
    assert f"(ROADMAP.md item {item})" \
        in capsysbinary.readouterr().err.decode()


@pytest.mark.parametrize("flags", [
    ("--merge-overlap",),
    ("--stream", "--merge-overlap", "--retry", "1"),
], ids=["no-stream", "retry"])
def test_merge_overlap_usage_errors_match_jax_cli(flags, capsys):
    """``--merge-overlap`` requires ``--stream`` and ``--retry 0``: exit 2
    with the JAX message."""
    errs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["test.txt", *flags] + (["--platform", "cpu"]
                                         if main is cli.main else []))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    want, got = errs
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


def test_merge_overlap_stdout_identical_to_jax_cli(capsysbinary, tmp_path):
    """A streamed run with window-boundary merges over two files (each
    window of one group merged as it retires) prints the JAX CLI's
    single-buffer stdout."""
    other = tmp_path / "more.txt"
    other.write_bytes(b"Good Good\tbye\nHello " * 700)
    files = ["test.txt", str(other)]
    old = os.getcwd()
    os.chdir(REPO)
    try:
        assert cli.main(["--stream", "--merge-overlap", "--chunk-bytes",
                         "4096", "--inflight", "1", *files,
                         "--platform", "cpu"]) == 0
        got = capsysbinary.readouterr().out
    finally:
        os.chdir(old)
    assert got == _jax_stdout(*files)


@pytest.mark.parametrize("flags", [("--compact-slots", "64"),
                                   ("--compact-slots", "12", "--sort-mode",
                                    "sort3")])
def test_bad_compact_slots_are_refused_as_by_jax(flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", *flags])
    assert e.value.code == 2
    assert "compact_slots" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--top"]])
def test_other_jax_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", *flag])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_missing_file_and_bad_config(capsys):
    assert cli.main(["no-such-file.txt", "--platform", "cpu"]) == 2
    assert "cannot read" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main([str(REPO / "test.txt"), "--chunk-bytes", "100",
                  "--platform", "cpu"])


def test_gpu_is_the_default_and_is_not_faked(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([str(REPO / "test.txt")]) == 3
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture(scope="module")
def seams_file(tmp_path_factory):
    """~20 KB of words: several 4 KB chunks, so grams cross seams."""
    import numpy as np

    rng = np.random.default_rng(8)
    words = [b"the", b"cat", b"sat", b"on", b"mat", b"and", b"dog"]
    p = tmp_path_factory.mktemp("cli") / "seams.txt"
    p.write_bytes(b" ".join(words[int(i)] for i in rng.integers(0, 7, 5000)))
    return str(p)


#: The n-gram and sketch command lines, each on test.txt as it is and on a
#: multi-chunk file with 4 KB chunks.
FAMILY_CASES = {
    "ngram": ("--ngram", "2"),
    "stream-ngram": ("--stream", "--ngram", "3", "--chunk-bytes", "4096"),
    "distinct-json": ("--stream", "--distinct-sketch", "--format", "json"),
    "estimate": ("--stream", "--estimate", "the", "--estimate", "zzz"),
    "ngram-count-topk": ("--stream", "--ngram", "2", "--count-sketch",
                         "--top-k", "5"),
}


def _on_seams(flags) -> tuple:
    if "--stream" not in flags or "--chunk-bytes" in flags:
        return flags
    return (*flags, "--chunk-bytes", "4096", "--sketch-flush-every", "4")


def _jax_cli(argv: list[str]) -> subprocess.CompletedProcess:
    """``./main`` on one CPU device: the conftest's 8-device ``XLA_FLAGS``
    would give a streamed run an 8-device mesh of 32 MB chunks."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run(["./main", *argv], cwd=REPO, env=env,
                          capture_output=True, timeout=300)


@pytest.fixture(scope="module")
def jax_family_stdout(seams_file):
    """The JAX CLI's (``./main``, one CPU device) stdout for every family
    case, the processes run two at a time: a streamed JAX run at the
    default 32 MB chunk interprets its kernel over the whole chunk, ~45 s
    on one core."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = {(case, path): (path, *(flags if path == "test.txt"
                                   else _on_seams(flags)))
            for case, flags in FAMILY_CASES.items()
            for path in ("test.txt", seams_file)}
    with ThreadPoolExecutor(max_workers=2) as pool:
        procs = {k: pool.submit(_jax_cli, list(argv))
                 for k, argv in jobs.items()}
        out = {}
        for k, fut in procs.items():
            proc = fut.result()
            assert proc.returncode == 0, proc.stderr.decode()
            out[k] = (jobs[k], proc.stdout)
    return out


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_flags_stdout_identical_to_jax_cli(case, seams_file,
                                                  jax_family_stdout,
                                                  capsysbinary):
    """The n-gram and sketch flags: the port in-process against the JAX
    CLI on test.txt and on a multi-chunk file (streamed there at 4 KB
    chunks, sketches flushed every 4 steps)."""
    for path in ("test.txt", seams_file):
        argv, want = jax_family_stdout[(case, path)]
        old = os.getcwd()
        os.chdir(REPO)
        try:
            assert cli.main([*argv, "--platform", "cpu"]) == 0
        finally:
            os.chdir(old)
        assert capsysbinary.readouterr().out == want, argv
    if case == "estimate":
        assert b"estimate:the\t" in want and b"estimate:zzz\t0" in want


@pytest.mark.parametrize("flags", [
    ("--ngram", "0"),
    ("--count-sketch",),
    ("--estimate", "x"),
    ("--distinct-sketch",),
    ("--stream", "--distinct-sketch", "--count-sketch"),
    ("--stream", "--distinct-sketch", "--estimate", "x"),
    ("--stream", "--sketch-flush-every", "4"),
], ids=["ngram0", "count-no-stream", "estimate-no-stream",
        "distinct-no-stream", "both", "both-estimate", "flush-no-sketch"])
def test_family_usage_errors_match_jax_cli(flags, capsys):
    """Each n-gram or sketch usage error exits 2 with the JAX message."""
    errs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["test.txt", *flags] + (["--platform", "cpu"]
                                         if main is cli.main else []))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    want, got = errs
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


@pytest.fixture(scope="module")
def lines_file(tmp_path_factory):
    """~30 KB of short lines and one line far longer than a 4 KB chunk:
    matches, and matching lines split across chunks."""
    import numpy as np

    rng = np.random.default_rng(9)
    words = [b"the", b"cat", b"sat", b"w1", b"a1b", b"dog", b"o W"]
    seps = [b" ", b" ", b"\n", b"\t"]
    body = b"".join(words[int(i)] + seps[int(j)] for i, j in zip(
        rng.integers(0, 7, 4000), rng.integers(0, 4, 4000)))
    p = tmp_path_factory.mktemp("grep") / "lines.txt"
    p.write_bytes(body + b"the " + b"x " * 3000 + b"cat\n")
    return str(p)


GREP_CASES = {
    "one": ("--grep", "the"),
    "one-json": ("--grep", "the", "--format", "json"),
    "one-tsv": ("--grep", "o W", "--format", "tsv"),
    "three": ("--grep", "the", "--grep", "o W", "--grep", "1\n"),
    "three-json": ("--grep", "cat", "--grep", "\n", "--grep", "zz",
                   "--format", "json"),
    "three-tsv": ("--grep", "the", "--grep", "sat", "--grep", "dog",
                  "--format", "tsv"),
    "class": ("--grep", "[a-z][0-9]", "--grep-syntax", "class"),
    "class-multi-json": ("--grep", "w.", "--grep", "[^ ]1[a-c]",
                         "--grep-syntax", "class", "--format", "json"),
}


def _in_repo_main(argv: list) -> int:
    old = os.getcwd()
    os.chdir(REPO)
    try:
        return cli.main(argv)
    finally:
        os.chdir(old)


@pytest.mark.parametrize("stream", [False, True], ids=["batch", "stream"])
@pytest.mark.parametrize("case", list(GREP_CASES))
def test_grep_stdout_identical_to_jax_cli(case, stream, lines_file,
                                          capsysbinary):
    """``--grep``: one and three patterns, class syntax, every format, on
    test.txt and on a file of many 4 KB chunks (streamed there), the port
    in-process against the JAX CLI in-process (its streamed run takes the
    conftest's 8-device mesh: grep's counts do not depend on it)."""
    flags = GREP_CASES[case]
    for path in ("test.txt", lines_file):
        extra = ("--stream", "--chunk-bytes", "4096") if stream else ()
        want = _jax_stdout(path, *flags, *extra)
        assert _in_repo_main([path, *flags, *extra, "--platform", "cpu"]) \
            == 0
        assert capsysbinary.readouterr().out == want, (path, flags)


SAMPLE_CASES = {
    "reference": ("--sample", "4"),
    "json": ("--sample", "7", "--format", "json"),
    "tsv-all": ("--sample", "100000", "--format", "tsv"),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_stdout_identical_to_jax_cli(case, lines_file, capsysbinary):
    """``--sample`` in batch mode, on test.txt and the lines file; the
    buffers hold no token longer than W, so the JAX CLI's ``auto`` (the
    plain path on the CPU) and the port's (the kernel path) draw the same
    sample."""
    flags = SAMPLE_CASES[case]
    for path in ("test.txt", lines_file):
        want = _jax_stdout(path, *flags)
        assert _in_repo_main([path, *flags, "--platform", "cpu"]) == 0
        assert capsysbinary.readouterr().out == want, (path, flags)


@pytest.mark.parametrize("flags", [
    ("--sample", "9", "--format", "json"),
    ("--sample", "5", "--backend", "pallas", "--max-token-bytes", "8"),
], ids=["plain", "kernel"])
def test_streamed_sample_stdout_identical_to_jax_cli(flags, lines_file,
                                                     capsysbinary):
    """A streamed sample hashes the chunk ids, so the JAX CLI runs on one
    device (``./main`` without the conftest's mesh): 4 KB chunks, the
    plain path and the kernel path (W = 8)."""
    argv = [lines_file, *flags, "--stream", "--chunk-bytes", "4096"]
    proc = _jax_cli(argv)
    assert proc.returncode == 0, proc.stderr.decode()
    assert _in_repo_main([*argv, "--platform", "cpu"]) == 0
    assert capsysbinary.readouterr().out == proc.stdout


@pytest.mark.parametrize("flags", [
    ("--grep-syntax", "class"),
    ("--sample", "0"),
    ("--grep", "x", "--ngram", "2"),
    ("--sample", "3", "--top-k", "2"),
    ("--grep", "x", "--stream", "--distinct-sketch"),
    ("--sample", "3", "--stream", "--count-sketch"),
    ("--grep", "x", "--stream", "--estimate", "a"),
    ("--grep", "x", "--stream", "--merge-every", "2"),
    ("--grep", "x", "--sample", "3"),
    ("--grep", "x", "--verify-sample", "3"),
    ("--sample", "3", "--verify-sample", "3"),
    ("--ngram", "2", "--verify-sample", "3"),
    ("--verify-sample", "-1"),
    ("--grep", "x", "--stream", "--merge-strategy", "gather"),
    ("--sample", "3", "--merge-strategy", "keyrange"),
], ids=["syntax-alone", "sample0", "grep-ngram", "sample-topk",
        "grep-distinct", "sample-count", "grep-estimate", "grep-merge-every",
        "grep-sample", "grep-verify", "sample-verify", "ngram-verify",
        "verify-negative", "grep-merge-strategy", "sample-merge-no-stream"])
def test_grep_and_sample_usage_errors_match_jax_cli(flags, capsys):
    """Each usage error of the two modes exits 2 with the JAX message."""
    errs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["test.txt", *flags] + (["--platform", "cpu"]
                                         if main is cli.main else []))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    want, got = errs
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


@pytest.mark.parametrize("flags", [
    ("--grep", "a\\", "--grep-syntax", "class"),
    ("--grep", "b" * 257),
    ("--grep", "ok", "--grep", "[z-a]", "--grep-syntax", "class"),
], ids=["dangling", "too-long", "empty-range"])
def test_bad_patterns_exit_2_as_in_jax(flags, capsys):
    """A pattern the job refuses: ``error: ...`` and exit 2, no usage."""
    errs = []
    for main in (jcli.main, cli.main):
        argv = ["test.txt", *flags]
        assert (main(argv) if main is jcli.main
                else _in_repo_main(argv + ["--platform", "cpu"])) == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and errs[1].startswith("error: ") \
        and "grep" in errs[1]


@pytest.mark.parametrize("strategy", ["gather", "keyrange"])
def test_other_merge_strategies_name_a9(strategy, capsys):
    """On one rank every one-axis strategy runs and prints what 'tree'
    prints (the multi-rank runs: tests/test_torch_distributed*.py); its
    two-level counterpart is the JAX CLI's usage error (the CLI drives
    one axis), exit 2 with the JAX message."""
    out = {}
    for s in ("tree", strategy):
        assert _in_repo_main(["test.txt", "--platform", "cpu", "--stream",
                              "--merge-strategy", s, "--no-echo"]) == 0
        out[s] = capsys.readouterr().out
    assert out[strategy] == out["tree"] and "Total Count:9" in out["tree"]
    hier = {"gather": "hier-tree-tree", "keyrange": "hier-kr-tree"}[strategy]
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", "--stream",
                  "--merge-strategy", hier])
    assert e.value.code == 2
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as je:
        jcli.main(["test.txt", "--stream", "--merge-strategy", hier])
    assert je.value.code == 2
    jerr = capsys.readouterr().err
    assert "needs a multi-axis device mesh" in err
    assert err.splitlines()[-1].split(": ", 2)[-1] \
        == jerr.splitlines()[-1].split(": ", 2)[-1]


@pytest.mark.parametrize("mode", [("--grep", "o"), ("--sample", "3")])
def test_batch_ledger_of_grep_and_sample_matches_jax(mode, tmp_path):
    """A telemetered batch grep or sample writes ``run_start`` and
    ``run_end`` only, with the JAX CLI's fields (clock readings and the
    backend, which ``auto`` resolves differently, aside)."""
    from mapreduce_tpu_torch.obs import ledger

    recs = []
    for main, name in ((jcli.main, "jax"), (cli.main, "port")):
        path = str(tmp_path / f"{name}.jsonl")
        argv = ["test.txt", *mode, "--ledger", path]
        assert (main(argv) if main is jcli.main
                else _in_repo_main(argv + ["--platform", "cpu"])) == 0
        recs.append([{k: v for k, v in r.items() if k not in (
            "ts", "run_id", "elapsed_s", "backend")}
            for r in ledger.read_ledger(path)])
    want, got = recs
    assert [r["kind"] for r in got] == ["run_start", "run_end"]
    assert got == want
