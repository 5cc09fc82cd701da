"""The port's grep records mode against the plain reference, on the CPU.

``grep_records`` (``models/grep.py``) runs through ``run_job`` and returns
the counts and every matching line, in file order.  Its answer is held to
``portbench/reference/grep.py`` (a ``bytes.find`` loop over each file)
exactly, on seeded ``key<TAB>value<LF>`` records at 4 to 64 KB chunks with
explicit geometry: records cut by a chunk seam between key and value and
inside the value, matches in a file's first and last line, two files as
one corpus, two and overlapping occurrences in a line, a pattern that
matches every line (a TAB), a class pattern (against a ``re`` oracle), a fault
replayed under ``retry=1``, the emit's one sync a chunk and the spans,
the emit's out-of-memory error,
the refusals (a snapshot, a byte range, a
pattern that can match LF) and the CLI's ``--grep-records``.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from mapreduce_tpu_torch import cli
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import grep
from mapreduce_tpu_torch.obs import registry
from mapreduce_tpu_torch.obs.telemetry import Telemetry
from portbench.reference import grep as ref

WORDS = [b"ab", b"cd", b"XY", b"YZ", b"XYZ", b"XYZXYZ", b"qXYZq", b"Z", b"X"]


def _records(seed: int, n: int) -> bytes:
    """``n`` records ``<10-digit key><TAB><value><LF>``; a value is 1..12
    words of ``WORDS`` joined by spaces, so values hold separators and
    some hold the pattern once, twice or overlapping."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = [WORDS[j] for j in rng.integers(0, len(WORDS),
                                                 rng.integers(1, 13))]
        out.append(b"%010d\t%s\n" % (i, b" ".join(words)))
    return b"".join(out)


def _expected(paths, pattern: bytes) -> ref.Expected:
    """The reference over each file of a corpus, concatenated."""
    parts = [ref.scan(open(p, "rb").read(), pattern) for p in paths]
    return ref.Expected(sum((e.records for e in parts), []),
                        sum(e.matches for e in parts),
                        sum(e.lines for e in parts))


def _write(tmp_path, name: str, data: bytes) -> str:
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _cuts(paths, bases: np.ndarray) -> set:
    """Where the chunk seams fell in matching lines: 'key' where a seam
    follows a matching line's TAB, 'value' where it falls after a space of
    its value."""
    data = b"".join(open(p, "rb").read() for p in paths)
    kinds = set()
    for b in bases.ravel().tolist():
        if 0 < b < len(data):
            start = data.rfind(b"\n", 0, b) + 1
            end = data.find(b"\n", b)
            if b"XYZ" in data[start:end if end >= 0 else len(data)]:
                kinds.add({9: "key", 32: "value"}.get(data[b - 1], "other"))
    return kinds


def _check(got, paths, pattern: bytes) -> None:
    exp = _expected(paths, pattern)
    assert ref.readings(got, exp) == dict.fromkeys(ref.LIMITS, 0)
    assert got.records == exp.records
    plain = grep.grep_file(paths, pattern, _config(4096), device="cpu")
    assert (got.matches, got.lines) == (plain.matches, plain.lines)


def _config(chunk: int, superstep: int = 2, window: int = 2,
            **kw) -> Config:
    return Config(chunk_bytes=chunk, superstep=superstep,
                  inflight_groups=window, **kw)


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    first = b"XYZ\tthe first line matches\n" + _records(1, 1500)
    last = _records(2, 1200) + b"9999999999\tlast line XYZ, no LF"
    return [_write(d, "a.txt", first), _write(d, "b.txt", last)]


@pytest.mark.parametrize("chunk,superstep,window", [
    (4096, 1, 4), (4096 + 128, 2, 2), (16384, 3, 1), (65536, 1, 4)])
def test_records_equal_the_reference_at_several_geometries(
        two_files, chunk, superstep, window):
    """Two files as one corpus, the first file's first line and the second
    file's last (unterminated) line matching; every seam a chunk size
    makes, some between a matching record's key and value and some inside
    its value at the smaller sizes."""
    got = grep.grep_records(two_files, b"XYZ",
                            _config(chunk, superstep, window), device="cpu")
    _check(got, two_files, b"XYZ")
    assert got.records[0] == b"XYZ\tthe first line matches"
    assert got.records[-1] == b"9999999999\tlast line XYZ, no LF"
    assert got.matches > got.lines > 100  # lines with several occurrences
    if chunk < 16384:
        assert {"key", "value"} <= _cuts(two_files, got.run.bases)


def test_overlapping_occurrences_and_a_pattern_on_every_line(two_files):
    """``XYZXYZ`` occurs twice, overlapping, in ``XYZXYZXYZ``; a TAB is in
    every line, so every line is a record (no cap)."""
    twice = grep.grep_records(two_files, b"XYZXYZ", _config(4096),
                              device="cpu")
    _check(twice, two_files, b"XYZXYZ")
    assert 0 < twice.lines < twice.matches
    every = grep.grep_records(two_files, b"\t", _config(4096), device="cpu")
    _check(every, two_files, b"\t")
    lines = sum(open(p, "rb").read().count(b"\n") for p in two_files) + 1
    assert every.lines == len(every.records) == lines


def test_a_class_pattern_against_re(two_files):
    regex = rb"X[YQ]Z"
    got = grep.grep_records(two_files, b"X[YQ]Z", _config(4096),
                            device="cpu", syntax="class")
    want = []
    for p in two_files:
        want += [line for line in open(p, "rb").read().split(b"\n")
                 if re.search(regex, line)]
    assert got.records == want and got.lines == len(want)


def test_a_fault_replayed_under_retry_emits_once(two_files):
    """A group whose completion wait fails has already emitted: its
    replay, from the kept state, must not emit it twice."""
    reg = registry.get_registry()
    before = reg.counter("executor.chunks").value
    cfg = _config(4096, 2, 2, fault_plan="at=token-wait:3:transient")
    got = grep.grep_records(two_files, b"XYZ", cfg, device="cpu", retry=1)
    ran = reg.counter("executor.chunks").value - before
    assert ran > got.run.bases.size  # the replay ran chunks again
    _check(got, two_files, b"XYZ")


def test_one_emit_sync_a_chunk_and_the_spans(two_files):
    """The emit's count read is the records mode's one host sync a chunk
    (``executor.host_syncs{site=emit}``); ``grep.emit`` is a phase of the
    stream and ``grep.records`` one of ``recover``, around the read."""
    reg = registry.get_registry()
    reg.reset()
    got = grep.grep_records(two_files, b"XYZ", _config(4096),
                            device="cpu")
    counters = reg.snapshot()["counters"]
    syncs = {k: v for k, v in counters.items()
             if k.startswith("executor.host_syncs{")}
    assert syncs == {"executor.host_syncs{site=emit}":
                     counters["executor.chunks"]}
    assert counters["executor.chunks"] == got.run.bases.size
    phases = got.run.metrics.phases
    assert phases["grep.emit"] <= phases["dispatch"]
    assert phases["recover.read"] <= phases["grep.records"] \
        <= phases["recover"]


@pytest.mark.parametrize("error,raised", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     MemoryError),
    (MemoryError(), MemoryError),
    (RuntimeError("an unrelated failure"), RuntimeError)])
def test_the_emit_names_only_a_memory_limit(monkeypatch, error, raised):
    """Positions that memory cannot hold raise an out-of-memory error with
    their count, which the failure policy classes as ``resource``; any
    other error of the compaction passes through unchanged.  The emit's
    count goes through the reader the driver sets."""
    from mapreduce_tpu_torch.ops import tracepoints
    from mapreduce_tpu_torch.runtime import faults

    marks = torch.zeros(64, dtype=torch.bool)
    marks[[3, 40]] = True
    reads = []

    def read(flags):
        reads.append(flags.tolist())
        return flags.tolist()

    with tracepoints.host_read_by(read):
        assert grep._emit(marks).tolist() == [3, 40]
    assert reads == [[2]]

    def fail(*a, **k):
        raise error

    monkeypatch.setattr(torch, "nonzero_static", fail)
    with pytest.raises(raised) as got:
        grep._emit(marks)
    if raised is MemoryError:
        assert "2 matching-line positions" in str(got.value)
        assert faults.classify(got.value) == "resource"
    else:
        assert got.value is error


def test_overlapped_merges_and_telemetry_keep_every_record(two_files):
    """Window-boundary merges fold the emitted positions into the
    accumulator; a telemetered run maps in data-statistics mode."""
    cfg = dataclasses.replace(_config(4096, 1, 2), merge_overlap=True)
    _check(grep.grep_records(two_files, b"XYZ", cfg, device="cpu"),
           two_files, b"XYZ")
    tel = Telemetry.create()
    try:
        got = grep.grep_records(two_files, b"XYZ", _config(4096),
                                device="cpu", telemetry=tel)
    finally:
        tel.close()
    _check(got, two_files, b"XYZ")


def test_what_records_mode_refuses(two_files, tmp_path):
    with pytest.raises(ValueError, match="without checkpoint_path"):
        grep.grep_records(two_files, b"XYZ", _config(4096), device="cpu",
                          checkpoint_path=str(tmp_path / "ck.npz"),
                          checkpoint_every=1)
    assert not (tmp_path / "ck.npz").exists()
    with pytest.raises(ValueError, match="a byte range"):
        grep.grep_records(two_files, b"XYZ", _config(4096), device="cpu",
                          byte_range=(0, 4096))
    for pattern, syntax in ((b"Z\nX", "literal"), (b"[^a]", "class")):
        with pytest.raises(ValueError, match="must not match LF"):
            grep.grep_records(two_files, pattern, device="cpu",
                              syntax=syntax)


def test_the_cli_prints_the_records_then_the_counts(two_files,
                                                    capsysbinary):
    exp = _expected(two_files, b"XYZ")
    assert cli.main([*two_files, "--grep", "XYZ", "--grep-records",
                     "--chunk-bytes", "8192", "--platform", "cpu"]) == 0
    out = capsysbinary.readouterr().out
    lines = b"".join(r + b"\n" for r in exp.records)
    assert out == lines + b"Matches:%d\nMatching Lines:%d\n" % (
        exp.matches, exp.lines)
    assert cli.main([*two_files, "--grep", "XYZ", "--grep-records",
                     "--format", "tsv", "--platform", "cpu"]) == 0
    assert capsysbinary.readouterr().out == lines \
        + b"matches\t%d\nlines\t%d\n" % (exp.matches, exp.lines)
    assert cli.main([*two_files, "--grep", "XYZ", "--grep-records",
                     "--format", "json", "--platform", "cpu"]) == 0
    assert json.loads(capsysbinary.readouterr().out) == {
        "pattern": "XYZ", "matches": exp.matches, "lines": exp.lines,
        "records": [r.decode() for r in exp.records]}
    for flags, says in (
            (["--grep", "a", "--grep", "b"], "one --grep pattern"),
            (["--grep", "a", "--sample", "3"], "--sample is not supported"),
            (["--grep", "a", "--stream", "--autotune"],
             "--autotune is not supported"),
            (["--sample", "3"], "requires --grep")):
        with pytest.raises(SystemExit) as e:
            cli.main([two_files[0], *flags, "--grep-records",
                      "--platform", "cpu"])
        assert e.value.code == 2
        assert says in capsysbinary.readouterr().err.decode()
