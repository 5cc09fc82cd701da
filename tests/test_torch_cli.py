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
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", "--combiner", mode])
    assert e.value.code == 2
    assert "ROADMAP.md item A10" in capsys.readouterr().err


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
    (("--sort-mode", "segmin"), "A14"),
    (("--merge-overlap",), "A8b (iii)"),
    (("--autotune",), "A8b (ii), the autotuner"),
])
def test_flags_the_port_refuses_name_their_item(flags, item, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", *flags])
    assert e.value.code == 2
    assert f"(ROADMAP.md item {item})" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [("--compact-slots", "64"),
                                   ("--compact-slots", "12", "--sort-mode",
                                    "sort3")])
def test_bad_compact_slots_are_refused_as_by_jax(flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["test.txt", "--platform", "cpu", *flags])
    assert e.value.code == 2
    assert "compact_slots" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--verify-sample", "3"], ["--grep", "x"],
                                  ["--sample", "3"], ["--top"]])
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
