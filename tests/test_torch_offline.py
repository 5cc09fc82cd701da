"""The port's offline drivers (``mapreduce_tpu_torch/tools/``) against the
repository's JAX tools (``tools/autotune.py``, ``geomsearch.py``,
``redplan.py``), on the CPU.

The JAX tools are loaded by file path under private module names; their
pure pieces (the profile writer, the best-known record, the check rule,
the ledger prior, the plan) are compared with the port's on the same
inputs.  Their measured searches are not run: they compile JAX programs
and import the JAX analysis package.  The port's drivers run end to end
here with ``--platform cpu`` at small sizes: every probe pass's result is
held to the numpy oracle, and the ``tuned.json`` they write must resolve
to the same geometry and merge strategy in both packages.
"""

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from mapreduce_tpu.obs import history as jhistory
from mapreduce_tpu_torch import analysis, cli
from mapreduce_tpu_torch.analysis import core, geometry, meshcost
from mapreduce_tpu_torch.config import Geometry
from mapreduce_tpu_torch.obs import history
from mapreduce_tpu_torch.runtime import executor
from mapreduce_tpu_torch.tools import autotune, corpora, geomsearch, redplan
from mapreduce_tpu_torch.utils.oracle import word_counts

REPO = pathlib.Path(__file__).resolve().parents[1]
FLEET_FIXTURE = str(REPO / "tools" / "fixtures" / "redplan_fleet.jsonl")
LEVELS = {"hbm": "hbm", "ici": "nvlink", "dcn": "net"}


def _load(name: str, path: pathlib.Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


jautotune = _load("_jax_tool_autotune", REPO / "tools" / "autotune.py")
jgeomsearch = _load("_jax_tool_geomsearch", REPO / "tools" / "geomsearch.py")
jredplan = _load("_jax_tool_redplan", REPO / "tools" / "redplan.py")
jbench = _load("_jax_tool_bench", REPO / "bench.py")


# -- corpora --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 2026])
@pytest.mark.parametrize("name", ["zipf", "natural", "webby", "markup"])
def test_corpora_equal_bench(name, seed):
    want = getattr(jbench, f"make_{name}_corpus")(1 << 16, seed=seed)
    assert corpora.GENERATORS[name](1 << 16, seed=seed) == want
    # The drivers' default seeds too.
    assert corpora.GENERATORS[name](1 << 16) \
        == getattr(jbench, f"make_{name}_corpus")(1 << 16)


# -- the profile writer and the best-known record -------------------------------

ENTRY = {"config": {"inflight_groups": 4, "prefetch_depth": 16,
                    "superstep": 1, "chunk_bytes": 1 << 25,
                    "combiner": "off", "geometry": "default",
                    "merge_strategy": "tree", "merge_overlap": "off"},
         "measured_gbps": 0.5, "stopped": "converged",
         "trail": [{"rule": "converged", "changed": {}, "converged": True,
                    "resource": None, "saving_frac": None,
                    "data_verdict": "clean"}],
         "recorded_at": "2026-08-04T00:00:00Z"}


def test_write_profile_equal_jax(tmp_path):
    files = {}
    for tag, mod in (("jax", jautotune), ("port", autotune)):
        out = tmp_path / f"{tag}.json"
        mod.write_profile(str(out), "wordcount/gpu/zipf-32mb-chunk2mb", ENTRY)
        mod.write_profile(str(out), "wordcount/gpu/natural-64mb-chunk4mb",
                          {**ENTRY, "measured_gbps": 0.7})
        mod.write_profile(str(out), "wordcount/gpu/zipf-32mb-chunk2mb",
                          {**ENTRY, "stopped": "oscillation"})
        files[tag] = out.read_bytes()
    assert files["port"] == files["jax"]
    assert set(json.loads(files["port"])["profiles"]) == {
        "wordcount/gpu/zipf-32mb-chunk2mb",
        "wordcount/gpu/natural-64mb-chunk4mb"}


def test_record_last_good_sequence_equal_jax(tmp_path, monkeypatch):
    """The JAX selftest's sequence: recorded, a CPU run refused, a deep
    regression refused, a better value recorded; then a shallow
    regression, another slot and another profile."""
    steps = [("k", ENTRY, "tpu", "tuned"),
             ("k", ENTRY, "cpu", "tuned"),
             ("k", {**ENTRY, "measured_gbps": 0.1}, "tpu", "tuned"),
             ("k", {**ENTRY, "measured_gbps": 0.9}, "tpu", "tuned"),
             ("k", {**ENTRY, "measured_gbps": 0.8}, "tpu", "tuned"),
             ("k", {**ENTRY, "measured_gbps": None}, "tpu", "tuned"),
             ("g", {**ENTRY, "measured_gbps": 0.3}, "tpu", "geometry"),
             ("k2", {**ENTRY, "measured_gbps": 0.2}, "tpu", "tuned")]
    seen = {}
    for tag, mod in (("jax", jautotune), ("port", autotune)):
        path = tmp_path / f"{tag}_LAST_GOOD.json"
        decisions, files = [], []
        for key, entry, backend, slot in steps:
            decisions.append(mod.record_last_good(key, entry, backend,
                                                  path=str(path), slot=slot))
            files.append(path.read_bytes() if path.exists() else None)
        seen[tag] = (decisions, files)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [True, False, False, True, False, False, True,
                               True]
    assert json.loads(seen["port"][1][-1])["best"]["tuned"]["value"] == 0.2
    # Without a path the port writes nothing, anywhere.
    monkeypatch.chdir(tmp_path / "..")
    before = sorted(p.name for p in pathlib.Path(".").iterdir())
    assert autotune.record_last_good("k", ENTRY, "gpu") is False
    assert sorted(p.name for p in pathlib.Path(".").iterdir()) == before


# -- the reduction planner --------------------------------------------------------

def test_check_disagreement_equal_jax():
    measured = (None, 0, 0.0, 1e-6, 2.5e-5, 5.28e-4, 6e-4, 1.056e-3,
                1.057e-3, 0.3, 2.0)
    modeled = (None, 0, -1.0, 1e-6, 2.64e-4, 5.28e-4, 1e-2)
    for m in measured:
        for d in modeled:
            assert redplan.check_disagreement(m, d) \
                == jredplan.check_disagreement(m, d), (m, d)
            assert redplan.check_disagreement(m, d, ratio=4.0) \
                == jredplan.check_disagreement(m, d, ratio=4.0), (m, d)
    assert redplan.CHECK_RATIO == jredplan.CHECK_RATIO == 2.0


def test_ledger_prior_equal_jax():
    prior = redplan.ledger_prior(FLEET_FIXTURE)
    assert prior == jredplan.ledger_prior(FLEET_FIXTURE)
    assert prior["processes"] == 2 and prior["local_devices"] == 4
    assert prior["fleet_verdict"] == "straggler-bound"
    with pytest.raises(FileNotFoundError):
        redplan.ledger_prior(str(REPO / "tools" / "fixtures" / "nope.jsonl"))


def _plan_args(**kw):
    args = dict(ledger=None, processes=None, local_devices=None,
                capacity=None, top_mass=None, occupancy=None, incumbent=None)
    args.update(kw)
    return argparse.Namespace(**args)


def _port_names(obj):
    """The JAX plan with the port's level names, mesh labels and builder
    module."""
    if isinstance(obj, dict):
        return {k: _port_names(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_port_names(v) for v in obj]
    if isinstance(obj, str):
        if obj in LEVELS:
            return LEVELS[obj]
        return obj.replace("mapreduce_tpu.parallel.", "mapreduce_tpu_torch."
                           "parallel.")
    return obj


def _jax_label(label: str) -> str:
    return label.replace("n", "d").replace("v", "i")


@pytest.mark.parametrize("kw", [
    {},
    {"processes": 1, "local_devices": 8},
    {"processes": 8, "local_devices": 1, "capacity": 32768},
    {"capacity": 32768, "top_mass": 0.3, "occupancy": 0.85,
     "incumbent": "tree"},
    {"ledger": FLEET_FIXTURE},
    {"ledger": FLEET_FIXTURE, "processes": 4, "top_mass": 0.01},
], ids=["default", "1x8", "8x1", "skewed", "ledger", "ledger-flags"])
def test_build_plan_equal_jax(kw):
    jmc = jredplan._load_meshcost()
    jrates = jmc.load_link_rates()
    rates = {"levels": {LEVELS[k]: meshcost.Link(LEVELS[k], v.alpha_s,
                                                 v.beta_bps)
                        for k, v in jrates["levels"].items()},
             "keyrange_slack": jrates["keyrange_slack"]}
    want = jredplan.build_plan(_plan_args(**kw), jmc)
    got = redplan.build_plan(_plan_args(**kw), rates=rates)
    got["mesh"]["label"] = _jax_label(got["mesh"]["label"])
    # A skip's reason is worded for nodes and cards; the skips are equal.
    assert [s["strategy"] for s in got.pop("skipped")] \
        == [s["strategy"] for s in want.pop("skipped")]
    assert got == _port_names(want)
    # On the checked-in rates the defaults plan 2 x 4 at capacity 8192.
    art = redplan.build_plan(_plan_args(**kw))
    if not kw:
        assert art["mesh"]["label"] == "2nx4v" and art["capacity"] == 8192


def test_redplan_out_and_gate(tmp_path, capsys):
    out = tmp_path / "tuned.json"
    assert redplan.main(["--platform", "cpu", "--out", str(out)]) == 0
    art = json.loads(capsys.readouterr().out)
    key = "wordcount-redplan/static/2nx4v-cap8192"
    assert art["profile_key"] == key
    prof = json.loads(out.read_text())["profiles"][key]
    assert prof["config"] == {"merge_strategy": art["top"]}
    assert prof["stopped"] == "planned" and prof["mesh"]["label"] == "2nx4v"
    assert [r["strategy"] for r in prof["ranked"]] \
        == [r["strategy"] for r in art["ranked"]]
    # The ledger prior's plan keeps the JAX note on a fleet bound elsewhere.
    assert redplan.main(["--platform", "cpu", "--ledger",
                         FLEET_FIXTURE]) == 0
    art = json.loads(capsys.readouterr().out)
    assert "fix the bottleneck the verdict names first" in art["note"]
    # --check flags the fixture (CPU-made seconds against NVLink rates).
    assert redplan.main(["--platform", "cpu", "--check", "--ledger",
                         FLEET_FIXTURE]) == 1
    chk = json.loads(capsys.readouterr().out)
    assert chk["check"]["flag"] and chk["check"]["ratio"] > 500
    assert "measured_link_rates.json" in chk["why"]
    assert redplan.main(["--platform", "cpu", "--check"]) == 2
    # The gate keeps every strategy of the 1 x 4 plan over the fake world.
    assert redplan.main(["--platform", "cpu", "--gate", "--processes", "1",
                         "--local-devices", "4"]) == 0
    art = json.loads(capsys.readouterr().out)
    assert art["gated"] == [r["strategy"] for r in art["ranked"]]


# -- the autotuner end to end -----------------------------------------------------

def _checked_measure(passes: list):
    """A ``make_measure`` whose passes are each held to the oracle."""
    real = autotune.make_measure

    def make(corpus_path, device, ledger_dir, log):
        measure, state = real(corpus_path, device, ledger_dir, log)
        want = word_counts(pathlib.Path(corpus_path).read_bytes())

        def checked(knobs):
            recs = measure(knobs)
            rr = state["result"]
            got = executor.recover_from_file(rr.value, corpus_path, rr.bases)
            passes.append({"knobs": dict(knobs), "ledger": state["ledger"],
                           "equal": got.as_dict() == want,
                           "kinds": [r["kind"] for r in recs]})
            return recs

        return checked, state

    return make


class _Capture:
    """stdout and stderr of an in-process driver run."""

    def __enter__(self):
        import contextlib
        import io

        self._out, self._err = io.StringIO(), io.StringIO()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(contextlib.redirect_stdout(self._out))
        self._stack.enter_context(contextlib.redirect_stderr(self._err))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self.out, self.err = self._out.getvalue(), self._err.getvalue()
        return False


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    """The three drivers, once, into one tuned.json: the autotuner over 2
    MB at 1 MB chunks, the geometry probe at its top 8 over 1 MB, the
    planner's default plan."""
    tmp = tmp_path_factory.mktemp("offline")
    out = tmp / "tuned.json"
    mp = pytest.MonkeyPatch()
    passes, probes = [], []
    real_probe = geomsearch.probe_pass

    def probe(cfg, path, ledger, device):
        rr, dt = real_probe(cfg, path, ledger, device)
        got = executor.recover_from_file(rr.value, path, rr.bases)
        probes.append({"geometry": cfg.resolved_geometry, "label":
                       cfg.geometry_label, "combiner_slots":
                       cfg.resolved_combiner_slots, "sort_impl":
                       cfg.sort_impl, "equal": got.as_dict()
                       == word_counts(pathlib.Path(path).read_bytes())})
        return rr, dt

    mp.setattr(autotune, "make_measure", _checked_measure(passes))
    mp.setattr(geomsearch, "probe_pass", probe)
    try:
        logs = {}
        for name, main, argv in (
                ("autotune", autotune.main,
                 ["--mb", "2", "--chunk-mb", "1", "--budget", "2",
                  "--keep-ledgers", str(tmp / "ledgers")]),
                ("geomsearch", geomsearch.main,
                 ["--probe", "--top", "8", "--mb", "1", "--chunk-mb", "1"]),
                ("redplan", redplan.main, [])):
            cap = _Capture()
            with cap:
                rc = main([*argv, "--platform", "cpu", "--out", str(out)])
            assert rc == 0, cap.err
            logs[name] = cap
    finally:
        mp.undo()
    return {"out": out, "passes": passes, "probes": probes, "logs": logs,
            "ledgers": tmp / "ledgers"}


def test_autotune_end_to_end(driven):
    passes = driven["passes"]
    assert len(passes) == 2 and all(p["equal"] for p in passes)
    assert all(p["kinds"][0] == "run_start" and p["kinds"][-1] == "run_end"
               for p in passes)
    assert sorted(p.name for p in driven["ledgers"].iterdir()) \
        == ["probe01.jsonl", "probe02.jsonl"]
    # The Zipf corpus is skew-hot: the walk turns the combiner on.
    assert passes[0]["knobs"]["combiner"] == "off"
    assert passes[1]["knobs"]["combiner"] == "hot-cache"
    line = json.loads(driven["logs"]["autotune"].out.splitlines()[-1])
    assert line["metric"] == "autotune_winner"
    key = "wordcount/cpu/zipf-2mb-chunk1mb"
    assert line["profile"] == key and line["passes"] == 2
    prof = json.loads(driven["out"].read_text())["profiles"][key]
    assert prof["config"] == line["config"] and prof["backend"] == "cpu"
    assert [t["rule"] for t in prof["trail"]][0] == "enable-combiner"
    assert "last-good write refused: no --last-good path given" \
        in driven["logs"]["autotune"].err


def test_autotune_gate_stops_before_any_run(tmp_path, monkeypatch):
    """An error finding from the certifier ends the walk before the
    warm-up or any pass touches the device."""
    class Refuse:
        pass_id = "injected-error"

        def run(self, ctx):
            return [core.Finding(severity=core.ERROR, pass_id=self.pass_id,
                                 model=ctx.model, hook="map_chunk",
                                 message="injected")]

    runs = []
    real = autotune.baseline_free_passes
    monkeypatch.setattr(autotune, "baseline_free_passes",
                        lambda: [*real(), Refuse()])
    monkeypatch.setattr(executor, "run_job",
                        lambda *a, **k: runs.append(a))
    with pytest.raises(SystemExit, match="REJECTED"):
        autotune.main(["--platform", "cpu", "--mb", "1", "--chunk-mb", "1",
                       "--budget", "2", "--out", str(tmp_path / "t.json")])
    assert runs == [] and not (tmp_path / "t.json").exists()


def test_certify_passes_are_the_baseline_free_ones():
    ids = [p.pass_id for p in autotune.baseline_free_passes()]
    assert ids == [i for i in analysis.pass_ids()
                   if i not in ("hbm-cost", "fusion-opportunity")]
    assert {"reducer-algebra", "overflow-dtype", "host-sync",
            "sharding-lint", "smem-budget", "kernel-race",
            "collective-cost"} == set(ids)


# -- the geometry search ----------------------------------------------------------

def test_geomsearch_probe_filters_and_ranks(driven):
    err = driven["logs"]["geomsearch"].err
    probes = driven["probes"]
    # Top 8: radix 4 and 5 with their slack-2 twins, the default, radix 2
    # with its twin, and aux_rows=128 (inert).
    assert [p["label"] for p in probes] == ["custom", "custom", "default",
                                            "custom"]
    assert [p["geometry"].radix_bits for p in probes] == [4, 5, 3, 2]
    assert all(p["combiner_slots"] == 8 and p["sort_impl"] == "radix"
               and p["equal"] for p in probes)
    for label in ("radix_bits=4,radix_slab_slack=2",
                  "radix_bits=5,radix_slab_slack=2",
                  "radix_bits=2,radix_slab_slack=2"):
        assert f"probe skipped {label}: the same program as" in err
    assert "probe skipped aux_rows=128: inert in the probe config" in err
    line = json.loads(driven["logs"]["geomsearch"].out.splitlines()[-1])
    key = "wordcount-geometry/cpu/zipf-1mb-chunk1mb"
    assert line["metric"] == "geomsearch_winner" and line["profile"] == key
    assert line["passes"] == 4 and line["stopped"] == "probed"
    gbps = [t["gbps"] for t in line["trail"]]
    assert gbps == sorted(gbps, reverse=True)
    assert line["measured_gbps"] == gbps[0]
    prof = json.loads(driven["out"].read_text())["profiles"][key]
    assert prof["config"] == line["config"]


def test_geomsearch_axis_combiner_slots():
    """``--axis combiner_slots``: the default and the three deeper caches,
    none skipped."""
    log = []
    cands = geomsearch.probe_filter(
        geomsearch.probe_candidates(5, "combiner_slots"),
        log.append)
    assert [c.geometry.combiner_slots for c in cands] == [8, 16, 24, 32]
    assert log == []
    kept = geomsearch.gate_candidates(cands, log.append, torch.device("cpu"))
    assert kept == cands and len(log) == 4


def test_geomsearch_stages_match_jax_artifact_keys(capsys):
    assert geomsearch.main(["--platform", "cpu"]) == 0
    art = json.loads(capsys.readouterr().out)
    assert art == geometry.search_artifact(geometry.enumerate_candidates())
    assert set(art) == {"geometry_search_version", "pricing_chunk_bytes",
                        "candidates", "default", "shortlist"}
    assert geomsearch.main(["--platform", "cpu", "--gate", "--top",
                            "2"]) == 0
    art = json.loads(capsys.readouterr().out)
    assert art["gated"] == [c["label"] for c in art["shortlist"][:2]]


def test_probe_config_has_both_read_fields_live():
    cfg = geomsearch.probe_config(Geometry(combiner_slots=24, radix_bits=5),
                                  1 << 25)
    assert cfg.resolved_combiner_slots == 24 and cfg.sort_impl == "radix"
    assert cfg.resolved_geometry.radix_bits == 5
    assert (cfg.table_capacity, cfg.batch_uniques) == (1 << 18, 1 << 16)
    # The autotuner's mapping: a hot-key cache runs on the fused map.
    knobs = {**ENTRY["config"], "combiner": "hot-cache"}
    assert autotune.probe_config(knobs).map_impl == "fused"
    assert autotune.probe_config(ENTRY["config"]).map_impl == "split"


# -- the profiles resolve alike -----------------------------------------------------

def _jax_resolve_geometry(path):
    return jgeomsearch._load_geometry().resolve_auto(str(path))


def _cli_lines(path) -> list:
    cap = _Capture()
    with cap:
        rc = cli.main([str(REPO / "test.txt"), "--platform", "cpu",
                       "--stream", "--geometry", "auto", "--merge-strategy",
                       "auto", "--geometry-profile", str(path),
                       "--combiner", "hot-cache", "--map-impl", "fused",
                       "--format", "tsv"])
    assert rc in (0, None), cap.err
    return [ln for ln in cap.err.splitlines()
            if ln.startswith(("geometry: ", "merge-strategy: "))]


@pytest.mark.parametrize("extra", [None, "spec", "preset"])
def test_profiles_resolve_alike(driven, tmp_path, extra):
    """The drivers' tuned.json (and the same with a newer spec or preset
    geometry winner) resolves to one geometry and one merge strategy in
    the port, in its command line and in the JAX package."""
    path = tmp_path / "tuned.json"
    path.write_bytes(driven["out"].read_bytes())
    if extra:
        geom = Geometry(combiner_slots=24).as_dict() if extra == "spec" \
            else "combiner16"
        autotune.write_profile(str(path), "wordcount-geometry/cpu/x",
                               {"config": {"geometry": geom},
                                "recorded_at": "2999-01-01T00:00:00Z"})
    got = geometry.resolve_auto(str(path))
    assert got == _jax_resolve_geometry(path)
    if extra == "spec":
        assert got == Geometry(combiner_slots=24).as_dict()
    elif extra == "preset":
        assert got == "combiner16"
    single = ("tree", "gather", "keyrange")
    mine = history.resolve_prior(profile_path=str(path),
                                 merge_allowed=single)
    theirs = jhistory.resolve_prior(profile_path=str(path),
                                    merge_allowed=single)
    assert mine["merge_strategy"] == theirs["merge_strategy"] == "gather"
    assert mine["geometry"] == theirs["geometry"]
    label = "default" if got == "default" else got \
        if isinstance(got, str) else "custom"
    assert _cli_lines(path) == [f"geometry: auto -> {label}",
                                "merge-strategy: auto -> gather"]


# -- no card ---------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    (autotune.main, ["--mb", "1"]),
    (geomsearch.main, []),
    (geomsearch.main, ["--probe"]),
    (redplan.main, []),
    (redplan.main, ["--check", "--ledger", FLEET_FIXTURE]),
], ids=["autotune", "geomsearch", "geomsearch-probe", "redplan",
        "redplan-check"])
def test_drivers_raise_without_a_card(argv, monkeypatch, tmp_path):
    main, args = argv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert list(tmp_path.iterdir()) == []


def test_probe_config_equals_jax_mapping():
    """The autotuner's knobs -> Config mapping is the JAX tool's, field for
    field, apart from the JAX-only backend default."""
    knobs = {**ENTRY["config"], "combiner": "hot-cache",
             "geometry": "combiner16", "merge_overlap": "on"}
    mine = dataclasses.asdict(autotune.probe_config(knobs))
    theirs = dataclasses.asdict(jautotune._probe_config(knobs))
    for field in ("chunk_bytes", "superstep", "inflight_groups",
                  "prefetch_depth", "combiner", "geometry", "map_impl",
                  "merge_strategy", "merge_overlap", "table_capacity",
                  "batch_unique_capacity"):
        assert mine[field] == theirs[field], field
    assert mine["geometry"] == "combiner16" and mine["map_impl"] == "fused"
