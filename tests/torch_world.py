"""A world of D CPU ranks for the port's multi-rank tests.

``spawn_world(n, cases, tmp)`` starts this file as ``n`` processes of one
``torch.distributed`` gloo world (the environment a launcher exports:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), each running every case
in order, and returns ``[per-rank {case name: result}]``.  ``hosts``
lays the ranks out as that many nodes of ``n // hosts`` ranks, as
``torchrun --nnodes`` does.  The ranks import only the port, never JAX.
The join has a time limit, and the process group a short timeout: a
rank that fails or hangs ends the world, and the test fails with every
rank's stderr.

A case is ``{"name", "kind", "args"}``; ``kind`` names a function of
``CASES`` below, and ``args`` are plain JSON (a ``config`` is a dict of
``Config`` fields).  A case that raises records ``("error", repr)``: a
refusal raised alike on every rank is a result, and the next case runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[1]


def _config(d, plan_ranks=None):
    """A case's ``Config``; with ``plan_ranks`` its fault plan stays on
    those ranks only."""
    import torch.distributed as dist

    from mapreduce_tpu_torch.config import Config

    d = dict(d or {})
    if plan_ranks is not None and dist.get_rank() not in plan_ranks:
        d.pop("fault_plan", None)
    return Config(**d)


def _numpy(state):
    from mapreduce_tpu_torch import convert

    return convert.state_to_numpy(state)


def _result_fields(r):
    if r is None:
        return None
    return {"words": list(r.words), "counts": list(r.counts),
            "total": r.total, "distinct": r.distinct,
            "dropped_uniques": r.dropped_uniques,
            "dropped_count": r.dropped_count,
            "distinct_estimate": r.distinct_estimate,
            "cms": None if r.cms is None else r.cms}


def _job(kind: str, config, args):
    from mapreduce_tpu_torch.models import grep, sample
    from mapreduce_tpu_torch.models import wordcount as wc

    if kind == "wordcount":
        return wc.WordCountJob(config, "cpu")
    if kind == "topk":
        return wc.TopKWordCountJob(args["k"], config, "cpu")
    if kind == "ngram":
        return wc.NGramCountJob(args["n"], config, "cpu")
    if kind == "hll":
        return wc.SketchedWordCountJob(wc.WordCountJob(config, "cpu"))
    if kind == "cms":
        return wc.FreqSketchedWordCountJob(wc.WordCountJob(config, "cpu"))
    if kind == "grep":
        return grep.GrepJob(args["patterns"][0].encode(), device="cpu")
    if kind == "grep_multi":
        return grep.MultiGrepJob([p.encode() for p in args["patterns"]],
                                 device="cpu")
    if kind == "sample":
        return sample.ReservoirSampleJob(args["k"], config, "cpu")
    raise ValueError(f"unknown job {kind!r}")


def _mesh(mesh):
    """A case's mesh: None (the world's axis), ``"local"`` (this host's
    ranks) or ``[R, L]`` (a two-level mesh)."""
    from mapreduce_tpu_torch.parallel import distributed
    from mapreduce_tpu_torch.parallel.mesh import two_level_mesh

    if mesh is None:
        return None
    if mesh == "local":
        return distributed.local_data_mesh()
    return two_level_mesh(*mesh)


def _host_range(path):
    """This host's byte range of ``path``, aligned to a separator."""
    from mapreduce_tpu_torch.parallel import distributed

    lo, hi = distributed.host_byte_range(os.path.getsize(path))
    return distributed.align_range_to_separator(path, lo, hi)


def case_run_job(job, path, config=None, merge_strategy=None,
                 checkpoint_path=None, checkpoint_every=0, retry=0,
                 ledger=None, telemetered_ranks=None, mesh=None,
                 byte_range=None, driver="run_job", ledger_every=False,
                 plan_ranks=None, data_stats=True, storm=None, **job_args):
    """``run_job``'s (or ``run_job_global``'s) finished value as numpy
    (the JAX layout), its bases and the bytes it streamed.  With
    ``ledger``, the ranks in ``telemetered_ranks`` (default: all) run
    telemetered (a heartbeat an hour) and the coordinator writes the
    ledger there, as the CLI does; ``ledger_every`` hands every rank the
    path (the global driver's contract).  ``byte_range`` ``"host"`` reads
    this host's aligned range.  ``plan_ranks``
    keeps the config's fault plan on those ranks only.  ``data_stats``
    False runs a telemetered job without its data-statistics mode.
    ``storm`` (see :func:`_storm`) makes steps fail as out of memory.
    The result's ``pipeline`` is the run's window statistics."""
    import torch.distributed as dist

    from mapreduce_tpu_torch.obs.telemetry import Telemetry
    from mapreduce_tpu_torch.parallel import distributed
    from mapreduce_tpu_torch.runtime import executor

    cfg = _config(config, plan_ranks)
    on = ledger is not None and (telemetered_ranks is None
                                 or dist.get_rank() in telemetered_ranks)
    tel = None if not on else Telemetry.create(
        ledger_path=ledger if ledger_every or distributed.is_coordinator()
        else None, progress_every_s=3600)
    kw = {}
    if byte_range is not None:
        kw["byte_range"] = _host_range(path) if byte_range == "host" \
            else tuple(byte_range)
    if driver == "run_job":
        kw["retry"] = retry
    before = _bytes_sent()
    retries = _bytes_sent("executor.retries_by_class")
    try:
        with _storm(storm), _no_stats(not data_stats):
            rr = getattr(executor, driver)(
                _job(job, cfg, job_args), path, cfg, mesh=_mesh(mesh),
                merge_strategy=merge_strategy,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, telemetry=tel, **kw)
    finally:
        if tel is not None:
            tel.close()
    after = _bytes_sent()
    return {"value": _numpy(rr.value), "bases": rr.bases,
            "bytes": rr.metrics.bytes_processed, "pipeline": rr.pipeline,
            "byte_range": kw.get("byte_range"),
            "sent": {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)},
            "retries": {k: v - retries.get(k, 0) for k, v in
                        _bytes_sent("executor.retries_by_class").items()
                        if v != retries.get(k, 0)}}


@contextlib.contextmanager
def _storm(spec):
    """With ``spec`` (``{"ranks": [...], "until": {field: value}}``), every
    step on those ranks raises an out-of-memory error until the job's
    config has every ``until`` value (never, without it): a resource
    storm the degradation ladder walks."""
    if spec is None:
        yield
        return
    import torch.distributed as dist

    from mapreduce_tpu_torch.parallel import mapreduce as pmr

    real = pmr.Engine.step
    until = spec.get("until")

    def storming(self, state, chunk, step_index):
        if dist.get_rank() in spec["ranks"] and (until is None or any(
                getattr(self.job.config, k) != v for k, v in until.items())):
            raise RuntimeError("RESOURCE_EXHAUSTED: injected storm")
        return real(self, state, chunk, step_index)

    pmr.Engine.step = storming
    try:
        yield
    finally:
        pmr.Engine.step = real


@contextlib.contextmanager
def _sigint_at(rank: int, step: int):
    """On ``rank``, a SIGINT to this process when step ``step`` runs."""
    import signal

    import torch.distributed as dist

    from mapreduce_tpu_torch.parallel import mapreduce as pmr

    real = pmr.Engine.step

    def step_fn(self, state, chunk, step_index):
        if dist.get_rank() == rank and step_index == step:
            os.kill(os.getpid(), signal.SIGINT)
        return real(self, state, chunk, step_index)

    pmr.Engine.step = step_fn
    try:
        yield
    finally:
        pmr.Engine.step = real


@contextlib.contextmanager
def _no_stats(on: bool):
    """While ``on``, no job has a data-statistics mode."""
    if not on:
        yield
        return
    from mapreduce_tpu_torch.ops import datastats

    real = datastats.supports
    datastats.supports = lambda job: False
    try:
        yield
    finally:
        datastats.supports = real


def _bytes_sent(name: str = "collectives.bytes_sent") -> dict:
    """The registry's ``name`` counters by label."""
    from mapreduce_tpu_torch.obs import registry

    return {k: v for k, v in
            registry.get_registry().snapshot()["counters"].items()
            if k.startswith(name)}


def case_topology(size, shards, mesh=None):
    """This rank's host, the pure helpers' defaults on a corpus of
    ``size`` bytes and ``shards`` rows, and ``mesh``'s levels."""
    from mapreduce_tpu_torch.parallel import distributed

    out = {"process_index": distributed.process_index(),
           "process_count": distributed.process_count(),
           "local_device_count": distributed.local_device_count(),
           "byte_range": distributed.host_byte_range(size),
           "shards": list(distributed.host_shards(shards)),
           "local": _axis_fields(distributed.local_data_mesh()),
           "global": _axis_fields(distributed.global_data_mesh())}
    if mesh is not None:
        m = _mesh(mesh)
        out["mesh"] = {"flat": _axis_fields(m), "outer": _axis_fields(m.outer),
                       "inner": _axis_fields(m.inner)}
    return out


def _axis_fields(axis):
    import torch.distributed as dist

    ranks = list(axis.ranks) if axis.ranks is not None \
        else list(range(axis.size))
    return {"rank": axis.rank, "size": axis.size, "ranks": ranks,
            "name": axis.name,
            "group_rank": None if axis.group is None
            else dist.get_rank(axis.group)}


def case_count_file(path, config=None, mesh=None, plan_ranks=None, **kw):
    """``count_file``'s result fields (None off the coordinator);
    ``plan_ranks`` keeps the config's fault plan on those ranks only."""
    from mapreduce_tpu_torch.runtime import executor

    return _result_fields(executor.count_file(
        path, _config(config, plan_ranks), device="cpu", mesh=_mesh(mesh),
        **kw))


def case_grep_file(path, patterns, config=None, **kw):
    from mapreduce_tpu_torch.models import grep

    if len(patterns) == 1:
        r = grep.grep_file(path, patterns[0].encode(), _config(config),
                           device="cpu", **kw)
        return [(r.matches, r.lines)]
    return [(r.matches, r.lines) for r in grep.grep_file_multi(
        path, [p.encode() for p in patterns], _config(config), device="cpu",
        **kw)]


def case_sample_file(path, k, config=None, **kw):
    from mapreduce_tpu_torch.models import sample

    r = sample.sample_file(path, k, _config(config), device="cpu", **kw)
    return None if r is None else (list(r.tokens), r.total)


def case_collective(op, tables=None, capacity=0, pairs=None):
    """One collective: ``psum64`` of rank r's ``pairs[r]`` (lo, hi) or
    ``psum`` of the state ``(pairs[r], pairs[r][0])``, or
    tree, gather or keyrange over crafted tables, rank r's built from
    ``tables[r]`` (rows of (key_hi, key_lo, pos_hi, pos_lo, count,
    length))."""
    import torch

    from mapreduce_tpu_torch.ops import table as table_ops
    from mapreduce_tpu_torch.parallel import collectives
    from mapreduce_tpu_torch.parallel.mesh import data_mesh

    axis = data_mesh()
    if op == "psum64":
        lo, hi = (torch.tensor(v, dtype=torch.int64)
                  for v in pairs[axis.rank])
        return tuple(int(x) for x in collectives.psum64(lo, hi, axis))
    if op == "psum":  # a state of two leaves
        v = torch.tensor(pairs[axis.rank], dtype=torch.int64)
        return tuple(x.tolist() for x in collectives.psum((v, v[0]), axis))
    rows = tables[axis.rank]
    n = max(len(rows), 1)
    pad = -(-n // 8) * 8
    cols = [[table_ops.SENT] * pad, [table_ops.SENT] * pad,
            [table_ops.INF] * pad, [table_ops.INF] * pad, [0] * pad,
            [0] * pad]
    for i, row in enumerate(rows):
        for c, v in zip(cols, row):
            c[i] = v
    khi, klo, phi, plo, cnt, ln = (torch.tensor(c, dtype=torch.int64)
                                   for c in cols)
    z = torch.zeros((), dtype=torch.int64)
    t = table_ops._build(khi, klo, phi, plo, cnt, torch.zeros_like(cnt), ln,
                         capacity, z, z, z, z)

    def merge(a, b):
        return table_ops.merge(a, b, capacity=capacity)

    if op == "tree":
        out = collectives.tree_merge(t, merge, axis)
    elif op == "gather":
        out = collectives.gather_merge(t, merge, axis)
    else:
        out = collectives.key_range_merge(t, axis)
    return _numpy(out)


def case_cli(argv, sigint_at=None):
    """The CLI's exit code and stdout (bytes: the echo writes raw).
    ``sigint_at`` ``[rank, step]`` sends that rank a real SIGINT when its
    step ``step`` is mapped."""
    from mapreduce_tpu_torch import cli

    if sigint_at is not None:
        with _sigint_at(*sigint_at):
            return case_cli(argv)

    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
        out.flush()
    return rc, raw.getvalue()


CASES = {"run_job": case_run_job, "count_file": case_count_file,
         "grep_file": case_grep_file, "sample_file": case_sample_file,
         "collective": case_collective, "cli": case_cli,
         "topology": case_topology}


def _worker(spec_path: str) -> int:
    import torch

    from mapreduce_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    distributed.initialize(spec["platform"], backend=spec["backend"],
                           timeout_s=spec["timeout_s"])
    import torch.distributed as dist

    rank = dist.get_rank()
    results = {}
    for case in spec["cases"]:
        try:
            results[case["name"]] = CASES[case["kind"]](**case["args"])
        except Exception as e:  # a refusal is a result; the world goes on
            results[case["name"]] = ("error", repr(e))
    with open(Path(spec["out"]) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    distributed.shutdown()
    return 0


#: The JAX step programs of every ``shared_jax_engines`` block of the
#: process, by job kind, config, mesh shape and stats mode: a test module
#: that runs after another reuses its compiled steps.
_JAX_STEPS: dict = {}


@contextlib.contextmanager
def shared_jax_engines():
    """For the JAX references of a test module: the JAX executor builds an
    Engine per run and compiles its step anew (~10 s interpreted).  The
    step reads neither the merge strategy nor a top-k finalize, nor the
    loop's knobs (the window, the fault plan and policy, window-boundary
    merges), so engines of one job kind, config and mesh size share it,
    in every block of the process (the finish programs stay each
    engine's); equal engines are one.  Imports JAX, so only the test
    process calls it."""
    from mapreduce_tpu.runtime import executor as jexecutor

    real = jexecutor.Engine
    whole: dict = {}
    steps = _JAX_STEPS

    def engine(job, mesh, **kw):
        kind = job.identity().split("-top")[0]
        cfg = getattr(job, "config", None)
        if cfg is not None:  # knobs of the loop, not of the programs
            cfg = dataclasses.replace(
                cfg, merge_overlap=False, fault_plan=None,
                failure_policy=None, inflight_groups=1, superstep=1,
                prefetch_depth=None)
        key = (kind, cfg, tuple(mesh.shape.items()),
               kw.get("data_stats", False))
        # The global driver's engine is the per-host one without stats.
        full = (job.identity(), key,
                tuple(sorted({"data_stats": False, **kw}.items())))
        if full in whole:
            return whole[full]
        eng = whole[full] = real(job, mesh, **kw)
        donor = steps.get(key)
        if donor is None or donor._step_fn is None:
            steps[key] = eng
        else:
            eng._step_fn = donor._step_fn
        return eng

    jexecutor.Engine = engine
    try:
        yield
    finally:
        jexecutor.Engine = real


class Later:
    """A value computed in a background thread: ``later[key]`` (or
    :meth:`result`) waits for it and re-raises what it raised.  A test
    module starts its port worlds this way before it computes its JAX
    references, so the two overlap instead of running one after the
    other."""

    def __init__(self, fn, *args, **kwargs):
        import concurrent.futures

        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._future = self._pool.submit(fn, *args, **kwargs)
        self._pool.shutdown(wait=False)

    def result(self):
        return self._future.result()

    def __getitem__(self, key):
        return self.result()[key]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(n: int, cases: list, tmp: Path, timeout_s: float = 120,
                platform: str = "cpu", hosts: int = 1,
                group_timeout_s: Optional[float] = None,
                expect_rc=0) -> list:
    """Run ``cases`` on a gloo world of ``n`` ranks (on the CPU, or with
    ``platform='gpu'`` every rank's job on the card) laid out as ``hosts``
    nodes; returns each rank's ``{name: result}``.  Raises (with every
    rank's stderr) when a rank fails or the world outlives ``timeout_s``.
    ``group_timeout_s`` is the process group's timeout (at most
    ``timeout_s``, the default).  ``expect_rc``, one code or one a rank,
    is the exit code each rank must end with (a planned ``process-kill``);
    a rank expected to end otherwise than 0 has None for its results, and
    when every rank is, the result is their exit codes."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    if n % hosts:
        raise ValueError(f"{n} ranks do not split into {hosts} hosts")
    local = n // hosts
    spec = tmp / "world.json"
    spec.write_text(json.dumps({"cases": cases, "out": str(tmp),
                                "timeout_s": min(timeout_s, group_timeout_s or timeout_s),
                                "platform": platform, "backend": "gloo"}))
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "PYTEST_XDIST_WORKER")}
    base.update({"WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(local),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "OMP_NUM_THREADS": "1",
                 "PYTHONPATH": os.pathsep.join(
                     [str(REPO), base.get("PYTHONPATH", "")])})
    procs = []
    for r in range(n):
        e = dict(base, RANK=str(r), LOCAL_RANK=str(r % local),
                 GROUP_RANK=str(r // local))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(spec)], cwd=REPO, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout_s
    outs = [None] * n
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    want_rc = expect_rc if isinstance(expect_rc, (list, tuple)) \
        else [expect_rc] * n
    failed = [r for r, p in enumerate(procs) if p.returncode != want_rc[r]]
    if failed:
        errs = "\n".join(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                         f"{(outs[r] or ('', ''))[1][-4000:]}"
                         for r in range(n))
        raise RuntimeError(f"a world of {n} ranks failed or timed out "
                           f"(ranks {failed}):\n{errs}")
    if all(want_rc):
        return [p.returncode for p in procs]
    results = []
    for r in range(n):
        if want_rc[r]:
            results.append(None)
            continue
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    raise SystemExit(_worker(sys.argv[1]))
