"""The port's mesh passes (``sharding-lint``, ``collective-cost``) over the
in-process fake world, against the JAX package's on the CPU.

A fleet twin (``analysis_fleet``) is traced on rank 0 of a world of
``processes x local_devices`` ranks over ``torch.distributed``'s ``fake``
backend (``analysis/trace.py:fake_world``): its collectives record and
move nothing.  On the three registry twins the two passes give the JAX
package's verdicts (pass id, severity and hook of each finding), the
``collective_cost`` artifact has the JAX keys, and its ``total_bytes`` is
what ``collectives.bytes_sent`` counted during the same trace.  The JAX
side uses one cached analysis a twin, under :mod:`test_torch_graphcheck`'s
``jax.core`` alias fixture.  The known-bad fixtures of
``tests/test_collective.py`` are ported as eager jobs: a collective in one
branch of a host branch on a rank-local value, the same collective over
different levels in the two branches, different collectives in the two;
branches that agree and a uniform predicate stay quiet; a collective over
a group the mesh does not hold is a sharding-lint ERROR.
"""

import functools
import json

import pytest
import torch
import torch.distributed as dist

from mapreduce_tpu_torch import analysis
from mapreduce_tpu_torch import models as models_mod
from mapreduce_tpu_torch.analysis import cli as acli
from mapreduce_tpu_torch.analysis import core, trace
from mapreduce_tpu_torch.analysis.passes.collective import CollectivePass
from mapreduce_tpu_torch.analysis.passes.cost import CostPass
from mapreduce_tpu_torch.analysis.passes.sharding import ShardingPass
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.parallel import collectives
from mapreduce_tpu_torch.parallel import mesh as mesh_mod

from test_torch_graphcheck import janalysis  # noqa: F401

CPU = torch.device("cpu")
TWINS = ["wordcount_fleet2", "wordcount_fleet2x4", "wordcount_fleet8"]
MESH_PASSES = ("sharding-lint", "collective-cost")


def _mesh_passes():
    return [ShardingPass(), CollectivePass()]


@functools.lru_cache(maxsize=None)
def _port(name: str):
    ctx = core.AnalysisContext(models_mod.build_model(name, device=CPU),
                               name, CPU)
    return core.run_pipeline(ctx, _mesh_passes()), ctx


_JAX: dict = {}


def _jax_report(jan, name):
    if name not in _JAX:
        from mapreduce_tpu import models as jmodels
        from mapreduce_tpu.analysis import passes as jp

        _JAX[name] = jan.analyze_job(
            jmodels.build_model(name), name,
            passes=[jp.sharding.ShardingPass(), jp.collective.CollectivePass()])
    return _JAX[name]


def _verdicts(report) -> list:
    return sorted((f.severity, f.pass_id, f.hook) for f in report.findings
                  if f.pass_id in MESH_PASSES)


@pytest.mark.parametrize("name", TWINS)
def test_fleet_twin_verdicts_equal_jax(janalysis, name):
    jan, _ = janalysis
    want = _jax_report(jan, name)
    got, _ = _port(name)
    assert _verdicts(got) == _verdicts(want)
    assert not got.errors, got.format_text()
    jart = want.artifacts[name]["collective_cost"]
    art = got.artifacts[name]["collective_cost"]
    assert set(art) >= set(jart)
    assert art["mesh"]["devices"] == jart["mesh"]["devices"]
    assert [a["size"] for a in art["mesh"]["axes"]] \
        == [a["size"] for a in jart["mesh"]["axes"]]
    assert [a["level"] for a in art["mesh"]["axes"]] \
        == [{"dcn": "net", "ici": "nvlink"}[a["level"]]
            for a in jart["mesh"]["axes"]]


@pytest.mark.parametrize("name", TWINS)
def test_total_bytes_is_what_collectives_counted(name):
    report, ctx = _port(name)
    art = report.artifacts[name]["collective_cost"]
    traces = ctx.engine_traces
    assert art["total_bytes"] == sum(t.bytes_sent for t in traces.values())
    assert art["total_bytes"] > 0 and art["modeled_total_s"] > 0
    assert not traces["step"].collectives  # the map is rank-local
    groups = {n.attr("group") for n in traces["finish"].collectives}
    assert groups <= {"data", "replica", "world"}
    assert "<unknown>" not in groups


def test_the_world_is_torn_down_and_the_mesh_is_the_fleets():
    _port.cache_clear()
    report, ctx = _port("wordcount_fleet2x4")
    assert not dist.is_initialized()
    assert not mesh_mod._GROUPS and not mesh_mod._CONTROL
    assert ctx.mesh_spec.label() == "2nx4v"
    assert report.artifacts["wordcount_fleet2x4"]["collective_cost"][
        "mesh"]["label"] == "2nx4v"
    # hier-kr-tree: keyrange inside a node, a tree across the two.
    ops = [(n.name.split(".")[1], n.attr("group"))
           for n in ctx.engine_traces["finish"].collectives]
    assert ("alltoall_base_", "data") in ops and ("send", "replica") in ops


def test_cost_artifact_collective_marker_is_priced():
    name = "wordcount_fleet2"
    job = models_mod.build_model(name, device=CPU)
    ctx = core.AnalysisContext(job, name, CPU)
    core.run_pipeline(ctx, [CostPass()])
    assert ctx.artifacts["cost"]["collective"]["priced"] is False
    assert ctx.artifacts["cost"]["collective"]["total_bytes"] > 0
    core.run_pipeline(ctx, [CostPass(), CollectivePass()])
    coll = ctx.artifacts["cost"]["collective"]
    assert coll["priced"] is True and coll["priced_by"] == "collective-cost"
    assert coll["modeled_s"] == ctx.artifacts["collective_cost"][
        "modeled_total_s"]


def test_fake_world_refuses_beside_a_real_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        job = models_mod.build_model("wordcount_fleet8", device=CPU)
        report = analysis.analyze_job(job, "wordcount_fleet8", device=CPU,
                                      passes=_mesh_passes())
    finally:
        dist.destroy_process_group()
    errs = [f for f in report.errors if f.pass_id == "sharding-lint"]
    assert errs and "already initialised" in errs[0].message


def test_collective_baseline_gate(tmp_path):
    name = "wordcount_fleet8"
    job = models_mod.build_model(name, device=CPU)
    analysis.analyze_job(job, name, device=CPU, baselines_dir=str(tmp_path),
                         write_baselines=True, passes=_mesh_passes())
    path = tmp_path / f"{name}.collective.json"
    base = json.loads(path.read_text())
    assert base["mesh"] == "8n"
    for change, severity in (({"modeled_total_s":
                               base["modeled_total_s"] * 0.5}, "error"),
                             ({"modeled_total_s":
                               base["modeled_total_s"] * 2}, "warning"),
                             ({"mesh": "2nx4v"}, "error"), ({}, None)):
        path.write_text(json.dumps({**base, **change}))
        report = analysis.analyze_job(job, name, device=CPU,
                                      baselines_dir=str(tmp_path),
                                      passes=[CollectivePass()])
        got = [f.severity for f in report.findings if f.severity != "info"]
        assert got == ([severity] if severity else []), change


# -- the divergence and group fixtures ----------------------------------------


class _Scalar:
    """A minimal job on a 2 x 2 fleet whose keyrange hook is the fixture:
    counts non-pad bytes into one scalar."""

    analysis_fleet = {"processes": 2, "local_devices": 2}
    analysis_merge_strategy = "keyrange"
    device = CPU

    def init_state(self):
        return torch.zeros((), dtype=torch.int64)

    def map_chunk(self, chunk, chunk_id):
        return (chunk != 0).sum()

    def combine(self, state, update):
        return state + update

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return state

    def flag(self, state):
        """A host branch's predicate: a declared read of this rank's own
        state."""
        return tracepoints.host_read((state > 0).reshape(1))[0]


class OneBranch(_Scalar):
    def keyrange_merge(self, state, axis):
        if self.flag(state):
            state = collectives.all_gather(state, axis).sum(0)
        return state


class LevelMismatch(_Scalar):
    def keyrange_merge(self, state, axis):
        level = axis.inner if self.flag(state) else axis.outer
        return collectives.all_gather(state, level).sum(0)


class Divergent(_Scalar):
    def keyrange_merge(self, state, axis):
        if self.flag(state):
            return collectives.psum(state, axis)
        return collectives.all_gather(state, axis).sum(0)


class Agree(_Scalar):
    def keyrange_merge(self, state, axis):
        if self.flag(state):
            return collectives.all_gather(state, axis).sum(0)
        return collectives.all_gather(state, axis).max(0).values


class UniformPredicate(_Scalar):
    def keyrange_merge(self, state, axis):
        total = collectives.psum(state, axis)  # the same on every rank
        if self.flag(total):
            return collectives.all_gather(total, axis).sum(0)
        return total


class StrayGroup(_Scalar):
    def keyrange_merge(self, state, axis):
        x = state.clone().reshape(1)
        dist.all_reduce(x, group=dist.new_group([0, 1]))
        return x[0]


DIVERGENCE = {OneBranch: "never enter the collective",
              LevelMismatch: "MISMATCHED groups",
              Divergent: "different collective programs",
              Agree: None, UniformPredicate: None}


@pytest.mark.parametrize("job", list(DIVERGENCE), ids=lambda j: j.__name__)
def test_divergence_fixtures(job):
    report = analysis.analyze_job(job(), job.__name__, device=CPU,
                                  passes=_mesh_passes())
    errs = [f for f in report.errors if f.pass_id == "collective-cost"]
    want = DIVERGENCE[job]
    if want is None:
        assert not report.errors, report.format_text()
        return
    assert len(errs) == 1 and want in errs[0].message, report.format_text()
    assert errs[0].hook == "finish" and errs[0].location
    assert report.exit_code == 1


def test_stray_group_is_a_sharding_error():
    report = analysis.analyze_job(StrayGroup(), "stray", device=CPU,
                                  passes=_mesh_passes())
    errs = [f for f in report.errors if f.pass_id == "sharding-lint"]
    assert len(errs) == 1 and "not one of the mesh's" in errs[0].message
    assert "[0, 1]" in errs[0].message
    warns = [f for f in report.findings if f.severity == "warning"
             and "cannot attribute" in f.message]
    assert warns


def test_divergence_verdicts_equal_the_jax_fixtures(janalysis):
    """The JAX package's known-bad fixtures flag as the port's do: one
    ERROR of the collective-cost pass each, the same kind of message;
    its uniform-predicate case stays quiet as the port's does."""
    jan, mesh = janalysis
    import test_collective as jfix
    from mapreduce_tpu.analysis import passes as jp

    cases = [(jfix.OneBranchCollectiveJob(), OneBranch,
              "never enter the collective"),
             (jfix.DivergentCollectiveJob(), Divergent,
              "different collective programs")]
    for jjob, pjob, phrase in cases:
        want = jan.analyze_job(jjob, "j", mesh=mesh,
                               passes=[jp.collective.CollectivePass()])
        got = analysis.analyze_job(pjob(), "p", device=CPU,
                                   passes=[CollectivePass()])
        pick = [(f.severity, f.pass_id) for f in want.errors]
        assert pick == [(f.severity, f.pass_id) for f in got.errors]
        assert phrase in want.errors[0].message
        assert phrase in got.errors[0].message


def test_cli_lists_the_new_passes(capsys):
    assert acli.main(["--list"]) == 0
    passes = capsys.readouterr().out.splitlines()[1].split(": ")[1]
    assert {"sharding-lint", "collective-cost", "kernel-race"} \
        <= set(passes.split(", "))


def test_rank_local_reads_follow_the_dataflow():
    """A read of the state is rank-local; a read of an all-reduce over the
    whole mesh is not; a read no collective follows is not explored."""
    job = OneBranch()
    traces = trace.trace_engine(job, CPU, fleet=job.analysis_fleet)
    finish = traces["finish"]
    assert trace.rank_local_reads(finish, 4) == [0]
    assert len(finish.branches) == 1
    r, alt = finish.branches[0]
    assert alt.flags[0] == trace.flipped(finish.flags[0])
    job = UniformPredicate()
    traces = trace.trace_engine(job, CPU, fleet=job.analysis_fleet)
    assert trace.rank_local_reads(traces["finish"], 4) == []
    assert trace.rank_local_reads(traces["step"], 4) == []
