"""The port's cost, budget and fusion passes on the CPU.

``wordcount_pallas`` (the kernel path) gets the JAX package's ERROR and
WARNING verdicts over the passes both have; every committed baseline
(``mapreduce_tpu_torch/analysis/baselines``) re-derives within its gate;
the shipped kernel plans are within Hopper's budgets and hold the
constants of the CUDA sources; the twin gates, the sort cross-check, the
card fixture's leg and the fusion pass each fire on a case made for them.
The JAX alias fixture is :mod:`test_torch_graphcheck`'s, per module.
"""

import dataclasses
import json
import re

import pytest
import torch

from mapreduce_tpu_torch import analysis
from mapreduce_tpu_torch import models as models_mod
from mapreduce_tpu_torch.analysis import core, costmodel, trace
from mapreduce_tpu_torch.analysis.passes import cost as cost_pass
from mapreduce_tpu_torch.analysis.passes import smem
from mapreduce_tpu_torch.analysis.passes.cost import CostPass
from mapreduce_tpu_torch.analysis.passes.fusion import FusionPass
from mapreduce_tpu_torch.analysis.passes.hostsync import HostSyncPass
from mapreduce_tpu_torch.ops.cuda import plans
from mapreduce_tpu_torch.models.wordcount import WordCountJob
from mapreduce_tpu_torch.parallel.mapreduce import MapReduceJob

from test_torch_graphcheck import (jax_verdicts, janalysis,  # noqa: F401
                                   verdicts)

CPU = torch.device("cpu")
REPO = cost_pass._BASELINES_DIR.rsplit("/mapreduce_tpu_torch/", 1)[0]


def _ctx(name, **kw):
    return core.AnalysisContext(models_mod.build_model(name, device=CPU),
                                name, CPU, **kw)


@pytest.fixture(scope="module")
def pallas_ctx():
    return _ctx("wordcount_pallas")


def _run(ctx, *passes):
    return core.run_pipeline(ctx, list(passes))


def test_pallas_model_verdicts_equal_jax(janalysis):
    from mapreduce_tpu import models as jmodels

    jan, mesh = janalysis
    want = jax_verdicts(jan, mesh, jmodels.build_model("wordcount_pallas"),
                        "wordcount_pallas")
    got = verdicts(analysis.analyze_job(
        models_mod.build_model("wordcount_pallas", device=CPU),
        "wordcount_pallas", device=CPU))
    # The kernel path's property check is skipped in both: its sample
    # chunk is below the kernel path's minimum chunk.
    assert got == want == {("warning", "reducer-algebra", "merge")}


@pytest.mark.parametrize("name", models_mod.model_names())
def test_committed_baseline_rederives_within_its_gate(name):
    report = _run(_ctx(name), CostPass())
    bad = [f.format() for f in report.findings
           if "predicted device passes" in f.message
           or "no cost baseline" in f.message]
    assert not bad, bad
    base = cost_pass.load_baseline(name)
    art = report.artifacts[name]["cost"]
    assert base["traced_chunk_bytes"] == art["traced_chunk_bytes"]
    assert base["step_device_bytes"] \
        == art["programs"]["step"]["device_bytes"]
    assert base["step_host_reads"] == art["programs"]["step"]["host_reads"]


def test_sort_cross_check_holds_on_the_kernel_path(pallas_ctx):
    report = _run(pallas_ctx, CostPass())
    art = report.artifacts["wordcount_pallas"]["cost"]["aggregation_sort"]
    assert art["traced_rows"] == art["expected_rows"] > 1000
    assert not report.errors, report.format_text()


def test_measured_leg_reads_the_card_fixture(pallas_ctx, tmp_path,
                                             monkeypatch):
    rates = {"card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
             "chunk_bytes": 32 << 20, "tokens": 5313, "overlong": 3,
             "sort_rows": 5317, "sort_ms": 0.5, "copy_gbps": 3000.0}
    path = tmp_path / "measured_rates.json"
    monkeypatch.setattr(cost_pass, "RATES_PATH", str(path))
    cases = {"consistent": (rates, "info"),
             "inconsistent": (dict(rates, sort_rows=5318), "error"),
             "malformed": ({"card": "x"}, "error")}
    for label, (body, severity) in cases.items():
        path.write_text(json.dumps(body))
        report = _run(pallas_ctx, CostPass())
        legs = [f for f in report.findings
                if "measured" in f.message or "fixture" in f.message
                or "measured_rates" in f.message]
        assert [f.severity for f in legs] == [severity], label
    assert cost_pass.measured_rates(str(tmp_path / "none.json")) is None


def test_fused_twin_prices_equal_to_split():
    report = _run(_ctx("wordcount_fused"), CostPass())
    art = report.artifacts["wordcount_fused"]["cost"]["fused_vs_split"]
    assert art["relation"] == "equal"
    assert art["fused_effective_input_passes"] \
        == art["split_effective_input_passes"]
    assert not report.errors, report.format_text()


def test_combiner_gate_keeps_the_jax_relation_and_fires_on_the_port():
    """The JAX gate, unchanged, now certifies the port's combiner: its
    dense thinned stream and its one-pass fold price strictly below the
    combiner-off twin (the name is the test's from when the gate fired)."""
    report = _run(_ctx("wordcount_combiner"), CostPass())
    art = report.artifacts["wordcount_combiner"]["cost"]["combiner_vs_off"]
    assert art["combiner_effective_input_passes"] \
        < art["off_effective_input_passes"]
    assert art["passes_saved"] > 0
    assert not report.errors, report.format_text()
    assert [f for f in report.findings
            if f.message.startswith("combiner certified:")]


def test_telemetry_gate_certifies_and_flags(tmp_path):
    report = _run(_ctx("wordcount_telemetry"), CostPass())
    art = report.artifacts["wordcount_telemetry"]["cost"]
    assert abs(art["telemetry_overhead"]["overhead_frac"]) <= 0.01
    assert not report.errors, report.format_text()
    plain = cost_pass.load_baseline("wordcount_pallas")
    for twin in ("wordcount_pallas", "wordcount_telemetry"):
        body = dict(cost_pass.load_baseline(twin))
        if twin == "wordcount_pallas":
            body["effective_input_passes"] = plain[
                "effective_input_passes"] * 0.9
        (tmp_path / f"{twin}.json").write_text(json.dumps(body))
    report = _run(_ctx("wordcount_telemetry", baselines_dir=str(tmp_path)),
                  CostPass())
    assert any("past the 1% gate" in f.message for f in report.errors)


def test_write_then_gate_roundtrip(tmp_path):
    ctx = _ctx("wordcount", baselines_dir=str(tmp_path),
               write_baselines=True)
    report = _run(ctx, CostPass())
    assert any("baseline written" in f.message for f in report.findings)
    path = tmp_path / "wordcount.json"
    base = json.loads(path.read_text())
    assert base["_regenerate"].startswith(
        "python -m mapreduce_tpu_torch.analysis")
    gate = {}
    for factor, severity in ((1.0, None), (0.5, "error"), (2.0, "warning")):
        path.write_text(json.dumps(dict(
            base, effective_input_passes=base["effective_input_passes"]
            * factor)))
        report = _run(_ctx("wordcount", baselines_dir=str(tmp_path)),
                      CostPass())
        gate[factor] = [f.severity for f in report.findings
                        if f.severity != "info"]
        assert gate[factor] == ([severity] if severity else []), factor


def test_missing_twin_baseline_is_an_error(tmp_path):
    report = _run(_ctx("wordcount_fused", baselines_dir=str(tmp_path)),
                  CostPass())
    msgs = [f.message for f in report.errors]
    assert any("no comparable baseline" in m for m in msgs), msgs


# -- kernel plans and budgets -------------------------------------------------


def test_production_kernel_plans_certified():
    found = smem.certify_production_kernels()
    assert found and all(f.severity == "info" for f in found)
    labels = {f.message.split(":")[0] for f in found}
    for geo in ("default", "tall512", "combiner16"):
        assert f"tokenize_compact [{geo}]" in labels
        assert f"radix_sort3[radix] [{geo}]" in labels


def _constants(source: str) -> dict:
    text = open(f"{REPO}/mapreduce_tpu_torch/csrc/{source}").read()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr (?:int|long long) (k\w+) = ([^;]+);", text)}


def test_plans_hold_the_sources_constants():
    tok, rad = _constants("tokenize.cu"), _constants("radix.cu")
    assert int(tok["kTile"]) == plans.TILE
    assert int(tok["kThreads"]) == plans.TOK_THREADS
    assert tok["kTileBlocks"].startswith(str(plans.TILE_BLOCKS))
    assert int(tok["kWindow"]) == plans.WINDOW
    assert int(tok["kMaxW"]) == plans.MAX_W
    assert int(tok["kMaxCache"]) == plans.MAX_CACHE
    assert int(tok["kSegments"]) == plans.SEGMENTS
    assert int(tok["kFoldCounters"]) == plans.FOLD_COUNTERS
    assert int(rad["kTile"]) == plans.RADIX_TILE
    assert int(rad["kThreads"]) == plans.RADIX_THREADS
    assert int(rad["kRadix"]) == plans.RADIX
    assert int(rad["kMaxPasses"]) == plans.MAX_PASSES
    assert int(rad["kMaxSegments"]) == plans.MAX_SEGMENTS
    assert plans.KERNELS["tokenize_stream"].register_cap == 32


def test_smem_pass_flags_a_plan_over_budget(monkeypatch):
    big = plans.KernelSpec("big", "x.cu:1", 2048, 2, 64 * 1024)
    monkeypatch.setitem(plans.KERNELS, "big", big)
    plan = plans.KernelPlan("w", (plans.Launch("big", (1, 1 << 17)),))
    msgs = [f.message for f in smem.plan_findings("smem-budget", "m",
                                                  "step", plan)]
    assert len(msgs) == 4  # shared bytes, threads, blocks an SM, grid.y
    shipped = plans.tokenize_stream(1 << 20, 32, "tokenize_compact")
    assert not smem.plan_findings("smem-budget", "m", "step", shipped)


def test_card_attributes_held_to_the_plans():
    def attrs(**kw):
        a = {"static_smem": 16508, "registers": 32, "local_bytes": 0,
             "max_threads_per_block": 1024, "const_bytes": 0,
             "blocks_per_sm": 8}
        return {"tokenize_stream": dict(a, **kw)}

    assert [f.severity for f in smem.certify_card_attributes(attrs())] \
        == ["info"]
    for kw, severity in (({"static_smem": 16512}, "error"),
                         ({"registers": 40}, "error"),
                         ({"max_threads_per_block": 128}, "error"),
                         ({"local_bytes": 8}, "warning")):
        found = smem.certify_card_attributes(attrs(**kw))
        assert severity in [f.severity for f in found], kw
    s = plans.spec_of("sort_hist<int64,drop>")
    assert s.name == "sort_hist" and s.static_smem == 12 * 256 * 4 + 3 * 48


def test_kernel_nodes_certified_in_the_radix_model():
    ctx = _ctx("wordcount_radix")
    report = _run(ctx, smem.SmemPass())
    kinds = [k["wrapper"] for k in report.artifacts["wordcount_radix"]["smem"]]
    assert kinds == ["tokenize_compact", "radix_sort3[radix_partition]"]
    assert not report.errors


# -- fusion ----------------------------------------------------------------


class _Chain(MapReduceJob):
    """A map with one elementwise chain whose intermediates stay inside it,
    and one whose first value escapes to the output."""

    device = CPU

    def init_state(self):
        return torch.zeros(4, dtype=torch.int64)

    def map_chunk(self, chunk, chunk_id):
        x = chunk.to(torch.int64)
        y = ((x * 3 + 1) ^ 5) & 255  # 3 intermediates, one chain
        return torch.stack([y.sum(), x.sum(), y.max(), x.max()])

    def combine(self, state, update):
        return state + update

    def merge(self, a, b):
        return a + b


def test_fusion_pass_finds_the_chain_and_prices_it():
    ctx = core.AnalysisContext(_Chain(), "chain", CPU)
    report = _run(ctx, FusionPass())
    step = report.artifacts["chain"]["fusion"]["programs"]["step"]
    top = step[0]
    assert top["ops"] == 4 and top["launches_saved"] == 3
    n = trace._chunk_bytes_for(_Chain())
    assert top["device_bytes_saved"] == 3 * 8 * n * 2
    assert all(f.severity == "info" for f in report.findings)


def test_cost_model_charges_views_nothing_and_kernels_their_plans():
    job = models_mod.build_model("wordcount_radix", device=CPU)
    t = trace.trace_engine(job, CPU)["step"]
    cost = costmodel.program_cost(t)
    views = [n for n in t.nodes if n.is_view]
    assert views and cost.kernel_nodes == 2
    plan_launches = sum(len(n.plan.launches) for n in t.kernels)
    ops = sum(1 for n in t.nodes if n.kind == "op" and not n.is_view)
    assert cost.launches == ops + plan_launches


def _chunk(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def test_spill_and_rescue_branches_trace_on_their_own_chunks():
    """The sample chunk takes neither branch (the host-sync pass names
    them); a chunk of 676 two-letter keys spills the combiner's windows
    and traces its pair-mode rerun, and a chunk with runs longer than W
    traces the rescue and its host-scalar copies."""
    letters = b"etaoinshrdlcumwfgypbvkjxqz"
    pairs = b" ".join(bytes([a, b]) for a in letters for b in letters) + b" "
    n = 128 * plans.WINDOW  # one full combiner window a segment
    # The combiner twin at W = 4 (two-letter keys fit): the plain
    # versions' lookback is W steps, so the trace costs an eighth.
    job = WordCountJob(dataclasses.replace(
        models_mod.COMBINER_ANALYSIS_CONFIG, pallas_max_token=4), CPU)
    t = trace.trace_engine(job, CPU, chunk=_chunk(
        (pairs * (n // len(pairs) + 1))[:n]))["step"]
    assert t.flags[0][0] > 0  # spill
    assert [k.name for k in t.kernels] == ["tokenize_combiner",
                                           "tokenize_pair"]
    job = models_mod.build_model("wordcount_pallas", device=CPU)
    n = trace._chunk_bytes_for(job)
    t = trace.trace_engine(job, CPU, chunk=_chunk(
        (b"x" * 40 + b" " + b"ab cd " * n)[:n]))["step"]
    assert t.flags[0][1] == 1  # one overlong run
    # The read, then the packed build's chunk id, two overflow bounds and
    # the rescue slice, then the rescue table's chunk id and two bounds.
    assert [x.kind for x in t.host_syncs] == ["host_read"] \
        + ["host_copy"] * 7
    report = _run(_ctx("wordcount_pallas"), HostSyncPass())
    assert any("did not take" in f.message and "rescue" in f.message
               for f in report.findings)


@pytest.mark.parametrize("plan", [
    plans.tokenize_stream(1 << 16, 32, "tokenize_compact"),
    plans.combiner(1 << 20, 32, 8),
    plans.combiner_fold(1024, 512),
    plans.radix_sort3(32769, "radix", 3, True),
], ids=lambda p: p.wrapper)
def test_a_kernel_node_is_charged_its_plans_scratch(plan):
    """A kernel node moves its operands, its results and the scratch its
    plan declares (work words, planes written and read back, a list read
    again), and launches what its plan launches."""
    node = trace.Node("kernel", plan.wrapper, (((4096,), "uint8"),),
                      (((100,), "int64"),), plan=plan)
    cost = costmodel.program_cost(trace.OpTrace("step", [node], []))
    read, written = plan.scratch_bytes
    assert read > 0 and written > 0
    assert (cost.bytes_read, cost.bytes_written) \
        == (4096 + read, 800 + written)
    assert cost.families == {"kernel": cost.device_bytes}
    assert cost.launches == len(plan.launches)
