"""The port's static analysis (``mapreduce_tpu_torch.analysis``) against
the JAX package's (``mapreduce_tpu.analysis``) on the CPU.

The same known-bad fixture jobs, written once on each package's job API (a
non-commutative merge, an unpaired 32-bit counter, a lane-paired counter,
a host read in the map: the port's counterpart of the JAX ``CallbackJob``),
and the shipped ``wordcount``, ``sketch`` and ``grep`` models, get the
same ERROR and WARNING verdicts from both: the set of ``(severity,
pass_id, hook)`` over the passes both packages have.  The reports format
alike, the CLIs list the same models, and the op recorder shows a kernel
wrapper as one node.

The JAX analysis reads ``jax.core.ClosedJaxpr``/``Jaxpr``, which this jax
keeps under ``jax.extend.core``: the module fixture :func:`janalysis` sets
the alias for this module only and restores ``jax.core`` afterwards.
"""

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu_torch import analysis
from mapreduce_tpu_torch import models as models_mod
from mapreduce_tpu_torch.analysis import cli as acli
from mapreduce_tpu_torch.analysis import core, trace
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.parallel.mapreduce import MapReduceJob

#: The passes compared here: the mesh passes over the fleet twins are held
#: to the JAX package's in ``test_torch_mesh_analysis.py``; the race pass
#: certifies the CUDA sources (``test_torch_kernelrace.py``).
SHARED_PASSES = ("reducer-algebra", "overflow-dtype", "host-sync",
                 "hbm-cost", "fusion-opportunity")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def janalysis():
    """The JAX package's analysis, importable under this jax."""
    from jax.extend import core as jcore

    missing = object()
    saved = {k: getattr(jax.core, k, missing)
             for k in ("ClosedJaxpr", "Jaxpr")}
    jax.core.ClosedJaxpr, jax.core.Jaxpr = jcore.ClosedJaxpr, jcore.Jaxpr
    try:
        from mapreduce_tpu import analysis as jan
        from mapreduce_tpu.parallel.mesh import data_mesh

        yield jan, data_mesh(8)
    finally:
        for k, v in saved.items():
            if v is missing:
                delattr(jax.core, k)
            else:
                setattr(jax.core, k, v)


def verdicts(report) -> set:
    return {(f.severity, f.pass_id, f.hook) for f in report.findings
            if f.severity in (core.ERROR, core.WARNING)
            and f.pass_id in SHARED_PASSES}


def jax_verdicts(jan, mesh, job, model, **kw):
    """The JAX pipeline's verdicts over the shared passes only."""
    from mapreduce_tpu.analysis import passes as jp

    passes = [jp.algebra.AlgebraPass(), jp.overflow.OverflowPass(),
              jp.hostsync.HostSyncPass(), jp.cost.CostPass(),
              jp.fusion.FusionPass()]
    return verdicts(jan.analyze_job(job, model, mesh=mesh, passes=passes,
                                    **kw))


# -- the fixture jobs, on each package's API ---------------------------------


class _JScalar:
    def init_state(self):
        return jnp.zeros((), jnp.uint32)

    def map_chunk(self, chunk, chunk_id):
        return jnp.sum((chunk != 0).astype(jnp.uint32))

    def combine(self, state, update):
        return state + update

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return state

    def identity(self):
        return type(self).__name__.lower()


class _JNonCommutative(_JScalar):
    def merge(self, a, b):
        return a - b


class _JCount(NamedTuple):
    count: jax.Array


class _JCounter(_JScalar):
    def init_state(self):
        return _JCount(count=jnp.zeros((), jnp.uint32))

    def map_chunk(self, chunk, chunk_id):
        return _JCount(count=jnp.sum((chunk != 0).astype(jnp.uint32)))

    def combine(self, state, update):
        return _JCount(count=state.count + update.count)

    def merge(self, a, b):
        return _JCount(count=a.count + b.count)


class _JPair(NamedTuple):
    count: jax.Array
    count_hi: jax.Array


class _JPaired(_JScalar):
    def init_state(self):
        return _JPair(jnp.zeros((), jnp.uint32), jnp.zeros((), jnp.uint32))

    def map_chunk(self, chunk, chunk_id):
        return _JPair(jnp.sum((chunk != 0).astype(jnp.uint32)),
                      jnp.zeros((), jnp.uint32))

    def combine(self, state, update):
        return _JPair(state.count + update.count,
                      state.count_hi + update.count_hi)

    def merge(self, a, b):
        return self.combine(a, b)


class _JHostRead(_JScalar):
    def map_chunk(self, chunk, chunk_id):
        total = jnp.sum((chunk != 0).astype(jnp.uint32))
        return jax.pure_callback(
            lambda x: np.asarray(x, dtype=np.uint32),
            jax.ShapeDtypeStruct((), np.uint32), total)


class _Scalar(MapReduceJob):
    """A correct job: count non-pad bytes into one int64 scalar (a bare
    leaf, so the overflow lint stays quiet)."""

    device = CPU

    def init_state(self):
        return torch.zeros((), dtype=torch.int64)

    def map_chunk(self, chunk, chunk_id):
        return (chunk != 0).sum()

    def combine(self, state, update):
        return state + update

    def merge(self, a, b):
        return a + b


class _NonCommutative(_Scalar):
    def merge(self, a, b):
        return a - b


class _Count(NamedTuple):
    count: torch.Tensor


class _Counter(_Scalar):
    def init_state(self):
        return _Count(torch.zeros((), dtype=torch.int64))

    def map_chunk(self, chunk, chunk_id):
        return _Count((chunk != 0).sum())

    def combine(self, state, update):
        return _Count(state.count + update.count)

    def merge(self, a, b):
        return _Count(a.count + b.count)


class _Pair(NamedTuple):
    count: torch.Tensor
    count_hi: torch.Tensor


class _Paired(_Scalar):
    def init_state(self):
        return _Pair(torch.zeros((), dtype=torch.int64),
                     torch.zeros((), dtype=torch.int64))

    def map_chunk(self, chunk, chunk_id):
        return _Pair((chunk != 0).sum(), torch.zeros((), dtype=torch.int64))

    def combine(self, state, update):
        return _Pair(state.count + update.count,
                     state.count_hi + update.count_hi)

    def merge(self, a, b):
        return self.combine(a, b)


class _HostRead(_Scalar):
    """The map reads its count to the host and back: an undeclared sync."""

    def map_chunk(self, chunk, chunk_id):
        return torch.tensor(int((chunk != 0).sum()), dtype=torch.int64)


FIXTURES = {
    "bad-merge": (_JNonCommutative, _NonCommutative),
    "bad-counter": (_JCounter, _Counter),
    "paired-counter": (_JPaired, _Paired),
    "bad-host-read": (_JHostRead, _HostRead),
}
#: The verdict each fixture exists for (beside the missing baseline).
EXPECTED = {
    "bad-merge": ("error", "reducer-algebra", "merge"),
    "bad-counter": ("error", "overflow-dtype", "init_state"),
    "paired-counter": None,
    "bad-host-read": ("error", "host-sync", "step"),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_verdicts_equal_jax(janalysis, name):
    jan, mesh = janalysis
    jjob, pjob = FIXTURES[name]
    want = jax_verdicts(jan, mesh, jjob(), name)
    got = verdicts(analysis.analyze_job(pjob(), name, device=CPU))
    assert got == want
    assert ("warning", "hbm-cost", "step") in got  # no baseline for it
    if EXPECTED[name] is None:
        assert not {v for v in got if v[0] == "error"}
    else:
        assert EXPECTED[name] in got


@pytest.mark.parametrize("name", ["wordcount", "sketch", "grep"])
def test_shipped_model_verdicts_equal_jax(janalysis, name):
    from mapreduce_tpu import models as jmodels

    jan, mesh = janalysis
    want = jax_verdicts(jan, mesh, jmodels.build_model(name), name)
    got = verdicts(analysis.analyze_job(
        models_mod.build_model(name, device=CPU), name, device=CPU))
    assert got == want == set()


def _findings(module):
    return [module.Finding(severity=s, pass_id=p, model="m", hook=h,
                           message=msg, location=loc, hint=hint)
            for s, p, h, msg, loc, hint in (
                ("info", "host-sync", "step", "i", "", "h"),
                ("error", "reducer-algebra", "merge", "e", "state.x", ""),
                ("warning", "hbm-cost", "step", "w", "", "fix it"))]


def test_report_json_and_text_equal_jax(janalysis):
    jan, _ = janalysis
    reports = []
    for module in (jan, analysis):
        r = module.Report(models=["m", "<kernels>"])
        r.extend(_findings(module))
        r.artifacts["m"] = {"cost": {"effective_input_passes": 1.5}}
        reports.append(r)
    want, got = reports
    assert got.as_json() == want.as_json()
    for sev in (None, "error", "warning", "info"):
        assert got.format_text(sev) == want.format_text(sev)
    assert got.exit_code == want.exit_code == 1
    assert json.loads(got.as_json())["findings"][0]["severity"] == "error"


def test_cli_lists_the_jax_models(janalysis, capsys):
    from mapreduce_tpu.analysis import cli as jcli

    assert jcli.main(["--list"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert acli.main(["--list"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]  # models: ...
    # The same passes in the same order, smem-budget for vmem-budget.
    assert got[1] == want[1].replace("vmem-budget", "smem-budget")
    assert {"sharding-lint", "collective-cost", "kernel-race"} \
        <= set(got[1].split(": ")[1].split(", "))


def test_cli_runs_on_the_cpu_when_asked_and_raises_without_a_card(
        monkeypatch, capsys):
    assert acli.main(["grep", "--json", "--platform", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["models"] == ["grep", "<kernels>"]
    assert payload["exit_code"] == 0
    assert "cost" in payload["artifacts"]["grep"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acli.main(["grep"])


def test_unknown_model_exits_2(capsys):
    assert acli.main(["nope", "--platform", "cpu"]) == 2
    assert "unknown model" in capsys.readouterr().err


# -- the recorder -------------------------------------------------------------


def test_kernel_wrapper_is_one_node_not_its_plain_ops():
    from mapreduce_tpu_torch.ops.cuda import radix
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok

    chunk = trace.sample_chunk(None, CPU, 8448)
    (stream, _, _), t = trace.record(
        "k", ktok.tokenize_split_compact, chunk, 32)
    assert [(n.kind, n.name) for n in t.nodes] == [
        ("kernel", "tokenize_compact")]
    node = t.nodes[0]
    rows = -(-8448 // 2) + 1  # the kernel's planes, on the CPU too
    assert node.operands == (((8448,), "uint8"),)
    assert node.results[:3] == (((rows,), "int64"),) * 3
    assert [x.kernel for x in node.plan.launches] == ["tokenize_stream"]
    # Outside a recording the plain version keeps its exact rows.
    assert ktok.tokenize_split_compact(chunk, 32)[0].packed.shape[0] \
        == int(stream.live) + 1
    cut = stream.cut(int(stream.live))
    _, t = trace.record("r", lambda: radix.radix_sort3(
        cut.key_hi, cut.key_lo, cut.packed, impl="radix"))
    assert [(n.kind, n.name) for n in t.nodes] == [
        ("kernel", "radix_sort3[radix]")]
    assert len(t.nodes[0].plan.launches) == 4 + 4 + 3 + 12


def test_trace_points_are_one_branch_when_nothing_records():
    assert tracepoints.RECORDER is None
    with tracepoints.kernel_scope("x", None) as k:
        assert not k.recording and k.result(3) == 3
    flags = torch.tensor([1, 2], dtype=torch.int64)
    assert tracepoints.host_read(flags) == [1, 2]
    assert tracepoints.host_read(flags, lambda f: ["read"]) == ["read"]
    assert tracepoints.host_scalars([5], CPU).tolist() == [5]


def test_default_step_syncs_only_where_declared():
    """The step of the default knobs (at a small chunk) syncs the host
    only through its declared reads: the map's flags and the table
    builds' host scalars, one node each."""
    from mapreduce_tpu_torch import Config
    from mapreduce_tpu_torch.analysis import costmodel
    from mapreduce_tpu_torch.models.wordcount import WordCountJob

    job = WordCountJob(Config(chunk_bytes=1 << 16), CPU)
    t = trace.trace_engine(job, CPU)["step"]
    declared = t.host_syncs
    assert [n.kind for n in declared].count("host_read") == 1
    assert costmodel.program_cost(t).host_reads == len(declared) >= 3
    assert not [n for n in t.nodes if n.syncs and n.kind == "op"]
    assert len(t.flags) == 1 and len(t.flags[0]) == 3
    assert costmodel.find_aggregation_sort(t).rows \
        == costmodel.stream_rows(t)


def test_traces_are_deterministic():
    job = models_mod.build_model("wordcount_pallas", device=CPU)
    a = trace.trace_engine(job, CPU)["step"].signature()
    b = trace.trace_engine(job, CPU)["step"].signature()
    assert a == b and len(a) > 50


def test_fleet_twins_say_their_finish_is_not_certified_here():
    """The fleet twins' finish is now certified over their fake world: no
    "analysed on one rank" note, and the mesh passes' verdicts are in the
    report (the name is the test's from before the mesh passes)."""
    job = models_mod.build_model("wordcount_fleet2x4", device=CPU)
    report = analysis.analyze_job(job, "wordcount_fleet2x4", device=CPU)
    assert not [f for f in report.findings if f.pass_id == "<pipeline>"]
    assert not [f for f in report.findings if "one rank" in f.message]
    assert ("info", "collective-cost", "step") in {
        (f.severity, f.pass_id, f.hook) for f in report.findings}
    assert "collective_cost" in report.artifacts["wordcount_fleet2x4"]
    assert not report.errors, report.format_text()


def test_custom_pass_registration():
    calls = []

    class ProbePass:
        pass_id = "probe"
        description = "test-only"

        def run(self, ctx):
            calls.append(ctx.model)
            return [core.Finding(severity=core.INFO, pass_id="probe",
                                 model=ctx.model, hook="merge",
                                 message="probe ran")]

    report = analysis.analyze_job(_Scalar(), "probed", device=CPU,
                                  passes=[ProbePass()])
    assert calls == ["probed"]
    assert [f.pass_id for f in report.findings] == ["probe"]
    assert report.exit_code == 0


def test_crashing_pass_is_an_error():
    class Boom:
        pass_id = "boom"
        description = "test-only"

        def run(self, ctx):
            raise ValueError("kaput")

    report = analysis.analyze_job(_Scalar(), "boom", device=CPU,
                                  passes=[Boom()])
    assert [(f.severity, f.hook) for f in report.findings] == [
        ("error", "<pipeline>")]
    assert "kaput" in report.findings[0].message
