"""The readers of the job's host-time parts: what they read from the
jobs' phases and the registry, and that they read nothing, without
raising, from a program that keeps no such span or counter."""

import pytest

from portbench import cell
from portbench.tests.conftest import PROGRAM, small

#: The phase readers: metric -> (phase, per chunk rather than per job).
PHASES = {
    "recover_fetch_ms.job": ("recover.fetch", False),
    "recover_order_ms.job": ("recover.order", False),
    "recover_read_ms.job": ("recover.read", False),
    "recover_assemble_ms.job": ("recover.assemble", False),
    "rescue_ms.job": ("rescue", True),
    "read_fill_ms.job": ("read_fill", True),
    "stage_pin_ms.job": ("stage_pin", False),
}


def _run(phases: list) -> cell.Run:
    jobs = [cell.Job(start=0.0, end=1.0, bytes=1, chunks=3, phases=p,
                     traced=False) for p in phases]
    return cell.Run(setup_s=0.0, window_s=1.0, jobs=jobs, expected=None,
                    trace=None, peaks={})


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_phase_readers(metric):
    phase, per_chunk = PHASES[metric]
    read = cell.reader(metric)
    assert read(_run([{"recover": 1.0}, {"dispatch": 0.5}])) is None
    got = read(_run([{phase: 0.030}, {phase: 0.010}]))
    assert got == pytest.approx(40.0 / (6 if per_chunk else 2))


def test_host_syncs_reads_the_registry(monkeypatch):
    from mapreduce_tpu_torch.obs import registry

    reg = registry.MetricsRegistry()
    monkeypatch.setattr(registry, "get_registry", lambda: reg)
    read = cell.reader("host_syncs.job")
    assert read(_run([{}])) is None
    reg.counter("executor.chunks").inc(3)
    reg.counter("executor.host_syncs", site="flags").inc(3)
    reg.counter("executor.host_syncs", site="scalars").inc(21)
    assert read(_run([{}])) == 8


def test_the_traced_line_has_the_parts(workload):
    line = cell.run_cell(workload, 2**31 + 7, 0.0, True, "cpu",
                         corpus_override=small(workload),
                         program_override=PROGRAM)
    assert line["correct"] is True
    got = line["metrics"]
    for metric in PHASES:
        if metric.startswith("stage_pin"):
            assert metric not in got  # the CPU's stage pins nothing
        else:
            assert got[metric]["value"] > 0, metric
    parts = sum(got[m]["value"] for m in PHASES if m.startswith("recover_"))
    assert parts <= got["recover_ms.job"]["value"]
    assert got["host_syncs.job"]["value"] >= 5
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert {"recover.read", "recover.order"} <= set(gaps)
