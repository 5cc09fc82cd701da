"""One run of one cell: set-up, the measured window, the check, the line.

Everything particular to a cell is a file found by name.
``BENCHMARK.json`` names the cell's configuration, traffic mix and
metrics; the configuration's file (``configs/``) gives its corpus kind
(``corpus/<kind>.py``), the program's ``Config`` and its kind of job,
whose program side is ``jobs/<job>.py`` and whose plain reference, with
the numbers compared and their limits, is ``reference/<job>.py``; the
traffic file (``traffic/``) names the loop that drives the window
(``loops/<loop>.py``); each metric is read by ``metrics/<name>.py``,
where ``<name>`` is the metric's name up to its first dot
(``dispatch_ms.job`` is read by ``metrics/dispatch_ms.py``).

A run:

1. generates the configuration's part from ``--seed``, writes it under
   ``$TMPDIR`` and ``fsync``s it;
2. runs one warm-up job over the corpus (the part listed as the
   configuration says): kernel builds, the first read of every byte;
3. measures: the traffic's loop runs jobs, each the user's whole job,
   until ``--seconds`` have passed; jobs begun by then finish.  With
   ``--trace 1`` the profiler records the window's first whole jobs (at
   least ``TRACE_MIN_JOBS`` and ``TRACE_MIN_S`` seconds of them), and the
   jobs after them run untraced;
4. reads the device's peak memory, checks that no JAX module was loaded,
   and holds the sampled jobs' results to the plain reference's answer
   for the same file (``check.py``).

With ``--trace 0`` nothing else runs in the process during the window: no
profiler, no ledger, no thread of the benchmark's own, no comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

from portbench import check, corpus
from portbench.trace import WINDOW

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that may not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "mapreduce_tpu")

#: Results held for the comparison: the window's first and last job and a
#: sample of this many of the others, drawn from the seed.  The rest are
#: dropped as they come, so the heap does not grow over the window.
SAMPLED = 2

#: The traced part of a ``--trace 1`` window: whole jobs, at least this
#: many and at least this long.
TRACE_MIN_JOBS = 2
TRACE_MIN_S = 3.0


@dataclasses.dataclass
class Job:
    """One job of the window, on the host clock."""

    start: float
    end: float
    bytes: int
    chunks: int  # streaming steps (each one chunk on one card)
    phases: dict  # the run's PhaseTimer phases, ``recover`` included
    traced: bool


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py:read(run)``)."""

    setup_s: float
    window_s: float  # first job's start to the last job's result
    jobs: list  # [Job] of the window
    expected: object  # the reference's answer for one job
    trace: Optional[object]  # trace.Trace of the traced jobs, or None
    peaks: dict  # peaks.json

    @property
    def host_jobs(self) -> list:
        """The jobs host-clock phase metrics read: the untraced ones where
        the window has any (the profiler adds host time to every launch)."""
        plain = [j for j in self.jobs if not j.traced]
        return plain or self.jobs

    @property
    def traced_jobs(self) -> list:
        return [j for j in self.jobs if j.traced]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic and metrics resolved."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": load_json(ROOT / config["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def load(package: str, name: str):
    """``portbench/<package>/<name>.py``, the file a cell's data names."""
    return importlib.import_module(f"portbench.{package}.{name}")


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric up to its first dot>.py``."""
    return load("metrics", metric.split(".")[0]).read


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``, or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def quiet_logger() -> logging.Logger:
    """A logger for the program that drops its per-job INFO lines."""
    logger = logging.getLogger("portbench.program")
    logger.setLevel(logging.WARNING)
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler(sys.stderr))
    return logger


def write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def host_clocks() -> dict:
    """The wall clock and this process's CPU seconds (user, system), for
    the line's reader: a job that waited for a core shows as wall without
    CPU, one on a slower core as more of both."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "process_user": ru.ru_utime,
            "process_system": ru.ru_stime}


def forbidden_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole (the
    port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             corpus_override: Optional[dict] = None,
             program_override: Optional[dict] = None) -> dict:
    """One run; returns the result line's object (``checks`` last).

    ``corpus_override`` and ``program_override`` replace keys of the
    configuration's ``corpus`` and ``program`` (the tests' small sizes on
    the CPU); a run of the benchmark passes neither."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(workload)
    cfg, traffic = spec["config"], spec["traffic"]
    corpus_spec = {**cfg["corpus"], **(corpus_override or {})}
    listed = corpus_spec["listed"]
    entry, ref = load("jobs", cfg["job"]), load("reference", cfg["job"])
    loop = load("loops", traffic["loop"])

    import torch
    from torch.profiler import record_function

    from mapreduce_tpu_torch.config import Config

    program = Config(**{**cfg["program"], **(program_override or {})})
    on_card = torch.device(device).type == "cuda"
    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = tempfile.mkdtemp(prefix="portbench-", dir=tmp_root)
    try:
        part_path = os.path.join(workdir, "part.txt")
        marks = {"imports": time.perf_counter()}
        part = corpus.generate(corpus_spec, seed)
        marks["generate"] = time.perf_counter()
        part_bytes = len(part)
        write_synced(part_path, part)
        del part
        marks["write"] = time.perf_counter()
        paths = [part_path] * listed
        logger = quiet_logger()
        kept = Sample(seed)

        def timed(traced: bool) -> Job:
            region = record_function("job") if traced \
                else contextlib.nullcontext()
            with region:
                start = time.perf_counter()
                result, rr = entry.run(paths, program, device, logger)
                end = time.perf_counter()
            kept.offer(result)
            return Job(start=start, end=end, bytes=part_bytes * listed,
                       chunks=int(rr.bases.shape[0]) * int(rr.bases.shape[1]),
                       phases=dict(rr.metrics.phases), traced=traced)

        # Warm-up: builds, first launches, the corpus read whole.
        entry.run(paths, program, device, logger)
        if on_card:
            torch.cuda.synchronize()
        marks["warm_up"] = time.perf_counter()
        setup_s = marks["warm_up"] - t_start
        traced = Traced(on_card) if trace else None
        before = host_clocks()
        jobs = loop.window(timed, seconds, traffic, traced)
        during = {k: v1 - before[k] for k, v1 in host_clocks().items()}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.empty_cache()
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)
        summary = None
        if traced is not None:
            from portbench import trace as trace_mod

            summary = trace_mod.summarize(
                traced.prof.profiler.kineto_results.events())
            del traced
        with open(part_path, "rb") as f:
            exp = ref.expected(f.read(), listed)
        verdict = check.judge(kept.results(), ref, exp)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run = Run(setup_s=setup_s,
              window_s=max(j.end for j in jobs) - min(j.start for j in jobs),
              jobs=jobs, expected=exp, trace=summary,
              peaks=load_json(HERE / "peaks.json"))
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    line = {"correct": verdict["failed"] == 0, "attempted": len(jobs),
            "failed": verdict["failed"], "metrics": metrics, "device": dev,
            "compared": len(kept.results()),
            "power_limit_w": power_limit_w() if on_card else None}
    if summary is not None:
        line["breakdown"] = summary.breakdown()
    # For the line's reader (the driver ignores them): each job's wall,
    # the process's CPU seconds over the window, and where set-up went.
    line["jobs_s"] = [round(j.end - j.start, 4) for j in jobs]
    line["window_clocks_s"] = during
    last, line["setup_parts"] = t_start, {}
    for name, t in marks.items():
        line["setup_parts"][name] = t - last
        last = t
    line["checks"] = verdict["checks"]
    return line


class ForbiddenImport(RuntimeError):
    def __init__(self, found: list):
        super().__init__("loaded in the process that measured: "
                         + ", ".join(found))


class Sample:
    """The results held for the comparison (see ``SAMPLED``): a reservoir
    over the jobs between the first and the last, from the seed."""

    def __init__(self, seed: int):
        self.rng = corpus.rng_for(seed)
        self.first = self.last = None
        self.middle: list = []
        self.seen = 0  # jobs offered to the reservoir

    def offer(self, result) -> None:
        if self.first is None:
            self.first = result
            return
        if self.last is not None:
            self.seen += 1
            if len(self.middle) < SAMPLED:
                self.middle.append(self.last)
            else:
                i = int(self.rng.integers(0, self.seen))
                if i < SAMPLED:
                    self.middle[i] = self.last
        self.last = result

    def results(self) -> list:
        return [r for r in [self.first, *self.middle, self.last]
                if r is not None]


class Traced:
    """The profiled part of a ``--trace 1`` window, a context: the
    profiler records everything inside, in the ``WINDOW`` region, until
    the loop finds it has ``enough`` whole jobs."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.on_card:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.region = record_function(WINDOW)
        self.region.__enter__()
        self.t0 = time.perf_counter()
        return self

    def enough(self, jobs: list) -> bool:
        return (sum(j.traced for j in jobs) >= TRACE_MIN_JOBS
                and time.perf_counter() - self.t0 >= TRACE_MIN_S)

    def __exit__(self, *exc):
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self.region.__exit__(*exc)
        self.prof.stop()
        return False


def main(argv: list, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", t_start)
    except ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
