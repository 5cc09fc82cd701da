"""The grep cell on the CPU: the records generator, the plain reference
and its controls, and whole runs of the harness."""

import numpy as np
import pytest

from portbench import cell, control, corpus
from portbench.corpus import random_records
from portbench.jobs import grep as job
from portbench.reference import grep as ref
from portbench.tests.conftest import PROGRAM, SMALL, config, small_corpus

WORKLOAD = "grep-pavlo.node"
BIG_SEED = 2**31 + 4321


def _small() -> dict:
    return small_corpus("grep-pavlo")


def test_widths_unique_keys_and_one_planted_record_in_10000():
    s = _small()
    part = corpus.generate(s, BIG_SEED)
    assert part == corpus.generate(s, BIG_SEED)
    assert part != corpus.generate(s, BIG_SEED + 1)
    rows = np.frombuffer(part, np.uint8).reshape(s["records"], 102)
    assert np.all(rows[:, 10] == ord("\t")) and np.all(rows[:, -1] == 10)
    keys = [bytes(k) for k in rows[:, :10]]
    assert keys == [b"%010d" % i for i in range(s["records"])]
    assert b"X" not in part.replace(b"XYZ", b"")
    hits = [i for i, r in enumerate(rows) if b"XYZ" in bytes(r)]
    assert len(hits) == s["records"] // s["one_in"] == 2
    assert [h // s["one_in"] for h in hits] == [0, 1]
    assert part.count(b"XYZ") == 2
    values = rows[:, 11:101]
    assert set(np.unique(values).tobytes()) == set(
        random_records.ALNUM.replace(b"X", b"")) | {ord("X")}


def test_the_node_size_and_the_stated_counts():
    cfg = config("grep-pavlo")
    s = cfg["corpus"]
    width = s["key_bytes"] + s["value_bytes"] + 2
    assert s["records"] * width == cfg["bytes"] == 571_200_000
    assert s["records"] // s["one_in"] == cfg["matching_records"] == 560
    assert s["pattern"].encode() == job.PATTERN == ref.PATTERN
    assert cfg["reduced"] == {}


def test_reference_by_hand():
    data = b"a\tXYZXYZ\nb\tno\nXYZ\tc XYZ\nlast XYZ"
    exp = ref.scan(data)
    assert exp.records == [b"a\tXYZXYZ", b"XYZ\tc XYZ", b"last XYZ"]
    assert (exp.matches, exp.lines) == (5, 3)
    assert ref.expected(data, 2) == (exp.records * 2, 10, 6)
    assert ref.scan(b"ZZZ\n").records == []


def test_every_control_reads_not_correct():
    exp = ref.expected(corpus.generate(_small(), BIG_SEED), 1)
    assert ref.readings(ref.Found(*exp), exp) == dict.fromkeys(ref.LIMITS, 0)
    for name, control_fn in ref.CONTROLS.items():
        r = ref.readings(control_fn(exp, None), exp)
        assert any(r[k] > ref.LIMITS[k] for k in ref.LIMITS), name


def test_the_program_against_the_reference_and_the_controls():
    r = control.seed_readings(WORKLOAD, BIG_SEED, "cpu", True,
                              SMALL["grep-pavlo"], PROGRAM)
    assert r["program"] == dict.fromkeys(ref.LIMITS, 0)
    assert r["reordered"]["record_mismatch"] == 2
    assert r["one_dropped"]["record_mismatch"] == 1


@pytest.mark.parametrize("trace", [False, True])
def test_whole_runs_read_correct(trace):
    line = cell.run_cell(WORKLOAD, 2**31 + 17, 0.0, trace, "cpu",
                         corpus_override=SMALL["grep-pavlo"],
                         program_override=PROGRAM)
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert set(line["checks"]) == set(ref.LIMITS)
    got = line["metrics"]
    if not trace:
        assert set(got) == {"wc_job_ms", "setup_s"}
        return
    # Host-clock readers read on the CPU; the roofline finds no kernel.
    assert got["grep_emit_ms.grep"]["value"] > 0
    assert got["grep_records_ms.grep"]["value"] > 0
    assert got["host_syncs.grep"]["value"] == 1.0
    for name in ("read_wait_pct", "read_fill_ms", "dispatch_ms",
                 "recover_ms", "recover_read_ms"):
        assert got[f"{name}.grep"]["value"] > 0, name
    assert got["recover_read_ms.grep"]["value"] \
        <= got["grep_records_ms.grep"]["value"] \
        <= got["recover_ms.grep"]["value"]
    assert "grep_scan_roofline.grep" not in got
    assert "stage_pin_ms.grep" not in got  # the CPU's stage pins nothing
    assert not any(k.endswith(".job") for k in got)


def test_the_readers_read_nothing_from_a_program_without_the_spans():
    jobs = [cell.Job(start=0.0, end=1.0, bytes=1, chunks=3,
                     phases={"dispatch": 0.5}, traced=False)]
    run = cell.Run(setup_s=0.0, window_s=1.0, jobs=jobs, expected=None,
                   trace=None, peaks={})
    for name in ("grep_emit_ms", "grep_records_ms", "grep_scan_roofline"):
        assert cell.reader(name)(run) is None, name


def test_the_roofline_is_the_bytes_bound_over_the_kernel_time():
    from portbench.trace import Trace

    jobs = [cell.Job(start=0.0, end=1.0, bytes=3_350_000, chunks=1,
                     phases={}, traced=True)]
    trace = Trace(window_s=1.0, busy_s=1e-5,
                  ops=[("Memcpy HtoD", 5e-6), ("grep_kernel", 4e-6),
                       ("nonzero", 6e-6)], idle_by_region={})
    run = cell.Run(setup_s=0.0, window_s=1.0, jobs=jobs, expected=None,
                   trace=trace, peaks=cell.load_json(cell.HERE
                                                     / "peaks.json"))
    assert cell.reader("grep_scan_roofline.grep")(run) == pytest.approx(10.0)
