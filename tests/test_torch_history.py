"""The port's ledger readers against the JAX package's, on the CPU: the
data-health classifier (``obs/datahealth.py``), the run-history warehouse
(``obs/history.py``), the fleet view (``obs/fleet.py``), the timeline's
Chrome trace and ``geometry='auto'`` (``analysis/geometry.py``).

All of them are stdlib-only functions of ledger records, so the same
records give the same dict in both packages: compared as whole dicts (and
an index on disk byte for byte), on the checked-in fixtures under
``tools/fixtures/`` and on hypothesis-drawn ``data`` records.
"""

import io
import json
import os
import pathlib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mapreduce_tpu import config as jconfig
from mapreduce_tpu.obs import datahealth as jdatahealth
from mapreduce_tpu.obs import fleet as jfleet
from mapreduce_tpu.obs import history as jhistory
from mapreduce_tpu.obs import timeline as jtimeline
from mapreduce_tpu_torch.analysis import geometry
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.obs import datahealth, fleet, history, timeline
from mapreduce_tpu_torch.obs.telemetry import Telemetry

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tools" / "fixtures"
LEDGERS = sorted(p.name for p in FIXTURES.glob("*.jsonl"))
SHARDED = ("fleet_ledger.jsonl", "redplan_fleet.jsonl")


def _read(name: str) -> list:
    return history.read_jsonl(str(FIXTURES / name))


@pytest.mark.parametrize("name", LEDGERS)
def test_classifiers_equal_jax_on_fixtures(name):
    """classify on every ``data`` record, classify_run,
    classify_reliability on every run, resolve_combiner, and the split into
    run instances."""
    recs = _read(name)
    for rec in recs:
        if rec.get("kind") == "data":
            assert datahealth.classify(rec) == jdatahealth.classify(rec)
    assert datahealth.classify_run(recs) == jdatahealth.classify_run(recs)
    assert datahealth.resolve_combiner(recs) \
        == jdatahealth.resolve_combiner(recs)
    runs = fleet.split_instances(recs)
    assert runs == jfleet.split_instances(recs)
    for rid, _, _ in runs:
        assert datahealth.classify_reliability(recs, rid) \
            == jdatahealth.classify_reliability(recs, rid)


_count = st.one_of(st.none(), st.booleans(), st.integers(0, 1 << 40),
                   st.floats(0, 1e12, allow_nan=False), st.text(max_size=3))
_DATA_KEYS = ("chunks", "tokens", "fallback_chunks", "spill_rows",
              "overlong", "rescued", "dropped_tokens", "dropped_uniques",
              "top_count", "table_valid", "capacity", "window_occupancy",
              "rescue_escalations", "combiner_hits", "combiner_rows_deleted")


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(st.sampled_from(_DATA_KEYS), _count))
def test_classify_equals_jax_on_drawn_records(data):
    """Any ``data`` dict, missing and malformed fields included (the port's
    record has no ``window_occupancy``: an absent signal)."""
    assert datahealth.classify(data) == jdatahealth.classify(data)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(
    st.integers(0, 7),
    st.one_of(st.none(), st.dictionaries(st.sampled_from(("bytes", "tokens",
                                                          "x")), _count)),
    max_size=5))
def test_classify_fleet_equals_jax_on_drawn_hosts(per_host):
    assert datahealth.classify_fleet(per_host) \
        == jdatahealth.classify_fleet(per_host)


@pytest.mark.parametrize("name", LEDGERS)
def test_digest_run_equals_jax(name):
    """Every run instance's full digest."""
    recs = _read(name)
    for rid, inst, run in fleet.split_instances(recs):
        kw = dict(source=str(FIXTURES / name), run_id=rid, instance=inst)
        want = jhistory.digest_run(run, **kw)
        got = history.digest_run(run, **kw)
        assert got == want
        assert history.config_key(got) == jhistory.config_key(want)
        assert history.group_key(got) == jhistory.group_key(want)


def _tree(d: pathlib.Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_ingest_equals_jax_byte_for_byte(tmp_path):
    """One warehouse over the whole fixture zoo in each package: the same
    index rows, digest ids and files, byte for byte; the same drift
    report, series, streaks, phase shares and rendering."""
    srcs = [str(FIXTURES / n) for n in
            ("history_ledger.jsonl", "mini_ledger.jsonl",
             "mini_ledger_b.jsonl", "fleet_ledger.jsonl",
             "future_ledger.jsonl", "watch_ledger.jsonl")]
    got = history.ingest(srcs, str(tmp_path / "port"))
    want = jhistory.ingest(srcs, str(tmp_path / "jax"))
    assert got == want
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert history.drift_report(got) == jhistory.drift_report(want)
    for key in sorted(got["keys"]):
        assert history.series(got, key) == jhistory.series(want, key)
        assert history.verdict_streak(got, key) \
            == jhistory.verdict_streak(want, key)
        assert history.phase_share_series(
            str(tmp_path / "port"), got, key, "dispatch") \
            == jhistory.phase_share_series(str(tmp_path / "jax"), want, key,
                                           "dispatch")
    outs = []
    for mod, d in ((history, "port"), (jhistory, "jax")):
        buf = io.StringIO()
        mod.render(mod.read_index(str(tmp_path / d)), buf,
                   index_dir=str(tmp_path / d), drift=True)
        outs.append(buf.getvalue().replace(str(tmp_path / d), "DIR"))
    assert outs[0] == outs[1] and "regressing" in outs[0]


@pytest.mark.parametrize("rows", [
    [], [0.1], [0.1, 0.1, 0.1, 0.085], [0.1, 0.098, 0.101, 0.12],
    [0.1, 0.1, 0.1, 0.105], [0.1, None, 0.1, 0.08]],
    ids=["empty", "one", "regressing", "improving", "steady", "crashed"])
def test_classify_drift_equals_jax(rows):
    """The drift rule table on hand series, and a stamp change
    (config-drift) appended to each."""
    def row(i, gbps, geometry="default"):
        return {"id": f"r{i}", "ts": float(i), "run_id": f"r{i}",
                "instance": 0, "gb_per_s": gbps, "completed": gbps is not None,
                "group": "wc/x/b20-c4096", "geometry": geometry,
                "combiner": "off", "map_impl": "split",
                "key": f"wc/x/b20-c4096/{geometry}/off/split"}

    series = [row(i, g) for i, g in enumerate(rows)]
    assert history.classify_drift(series) == jhistory.classify_drift(series)
    series.append(row(len(rows), 0.1, geometry="tall512"))
    assert history.classify_drift(series) == jhistory.classify_drift(series)


def _jax_resolve_auto(profile_path: str):
    """The JAX ``analysis.geometry.resolve_auto``, call for call: its
    package's ``analysis/__init__`` imports the jaxpr passes, which fail
    to import on a JAX without ``jax.core.ClosedJaxpr``."""
    def valid(spec: dict) -> bool:
        try:
            jconfig.Geometry(**spec)
        except (TypeError, ValueError):
            return False
        return True

    return jhistory.resolve_prior(
        profile_path=profile_path, family="wordcount",
        presets=set(jconfig.GEOMETRY_PRESETS),
        geometry_ok=valid)["geometry"]


def _profile(tmp_path, entries: dict) -> str:
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"profiles": entries}))
    return str(path)


@pytest.mark.parametrize("entries", [
    None,
    {"wordcount-geometry/a": {"recorded_at": "2026-01-01",
                              "config": {"geometry": "tall512"}},
     "wordcount-geometry/b": {"recorded_at": "2026-03-01",
                              "config": {"geometry": "combiner16"}}},
    {"wordcount-geometry/a": {"recorded_at": "2026-01-01",
                              "config": {"geometry": "combiner16"}},
     "wordcount-geometry/b": {"recorded_at": "2026-02-01",
                              "config": {"geometry": {"warp": 9}}}},
    {"wordcount-geometry/a": {"recorded_at": "2026-02-01",
                              "config": {"geometry": {"radix_bits": 2}}}},
    {"wordcount-redplan/static/2dx4i-cap262144": {
        "recorded_at": "2026-02-01", "mesh": {"label": "2dx4i"},
        "config": {"merge_strategy": "hier-kr-tree"}},
     "wordcount-redplan/static/8i-cap262144": {
        "recorded_at": "2026-01-01", "mesh": {"label": "8i"},
        "config": {"merge_strategy": "keyrange"}}},
], ids=["missing", "freshest-preset", "future-spec", "spec", "redplan"])
def test_resolve_prior_and_resolve_auto_equal_jax(tmp_path, entries):
    """A ``tuned.json`` profile: the geometry ``auto`` warm-starts
    (through each package's own Geometry check) and the merge strategy,
    over every strategy and over the single-axis ones."""
    prof = str(tmp_path / "none.json") if entries is None \
        else _profile(tmp_path, entries)
    assert geometry.resolve_auto(prof) == _jax_resolve_auto(prof)
    single = ("tree", "gather", "keyrange")
    for allowed in (None, single):
        got = history.resolve_prior(profile_path=prof,
                                    merge_allowed=allowed)
        assert got == jhistory.resolve_prior(profile_path=prof,
                                             merge_allowed=allowed)
    res = geometry.resolve_auto(prof)
    if res != "default":  # the port's CLI builds its Config from it
        assert Config(geometry=res).resolved_geometry.as_dict() \
            == jconfig.Config(geometry=res).resolved_geometry.as_dict()


@pytest.mark.parametrize("name", LEDGERS)
def test_resolve_prior_records_equal_jax(name):
    """The records prior: run view, latest data record, its verdict, the
    combiner it resolves, for the first run and for each run_id."""
    recs = _read(name)
    assert history.resolve_prior(records=recs) \
        == jhistory.resolve_prior(records=recs)
    for rid in sorted({str(r.get("run_id")) for r in recs}):
        assert history.resolve_prior(records=recs, run_id=rid) \
            == jhistory.resolve_prior(records=recs, run_id=rid)


def test_resolve_prior_index_equals_jax(tmp_path):
    srcs = [str(FIXTURES / "history_ledger.jsonl")]
    history.ingest(srcs, str(tmp_path / "p"))
    jhistory.ingest(srcs, str(tmp_path / "j"))
    for key in ("wordcount/pallas/b28-c4194304/default/off/split",
                "no/such/key/default/off/split"):
        assert history.resolve_prior(index_dir=str(tmp_path / "p"),
                                     config_key=key) \
            == jhistory.resolve_prior(index_dir=str(tmp_path / "j"),
                                      config_key=key)


@pytest.mark.parametrize("main", SHARDED)
def test_fleet_view_and_trace_equal_jax(main):
    """The shard fixtures: discovery, the fleet view, the merged stream,
    the per-host Chrome trace and the rendering."""
    base = str(FIXTURES / main)
    paths = fleet.shard_paths(base)
    assert paths == jfleet.shard_paths(base) and sorted(paths) == [0, 1]
    by_host = fleet.load_shards([paths[h] for h in sorted(paths)])
    assert by_host == jfleet.load_shards([paths[h] for h in sorted(paths)])
    view = fleet.fleet_view(by_host)
    assert view == jfleet.fleet_view(by_host)
    assert view == fleet.from_ledger(base) == jfleet.from_ledger(base)
    assert fleet.fleet_record(view) == jfleet.fleet_record(view)
    assert fleet.merged_records(by_host) == jfleet.merged_records(by_host)
    assert fleet.to_chrome_trace(by_host) == jfleet.to_chrome_trace(by_host)
    for h, recs in by_host.items():
        off = fleet.clock_offset(recs)
        assert off == jfleet.clock_offset(recs)
        assert fleet.align(recs, off or 0.0) == jfleet.align(recs, off or 0.0)
    outs = []
    for mod in (fleet, jfleet):
        buf = io.StringIO()
        mod.render(view, buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", LEDGERS)
def test_timeline_chrome_trace_equals_jax(name):
    recs = _read(name)
    assert timeline.to_chrome_trace(recs) == jtimeline.to_chrome_trace(recs)


@pytest.mark.parametrize("mod", [fleet, history], ids=["fleet", "history"])
def test_selftests_pass(mod, capsys):
    """``python -m mapreduce_tpu_torch.obs.{fleet,history} --selftest``."""
    assert mod.main(["--selftest"]) == 0
    assert "selftest ok" in capsys.readouterr().out


def test_history_and_fleet_command_lines(tmp_path, capsys):
    """Ingest and report through the port's ``main``; the JSON payloads
    equal the JAX ones."""
    idx = str(tmp_path / "h")
    src = str(FIXTURES / "history_ledger.jsonl")
    outs = []
    for mod in (history, jhistory):
        assert mod.main(["--index", idx, src, "--drift", "--json"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    base = str(FIXTURES / "fleet_ledger.jsonl")
    trace = str(tmp_path / "trace.json")
    assert fleet.main([base, "--json", "--trace", trace]) == 0
    assert json.loads(capsys.readouterr().out) == jfleet.from_ledger(base)
    assert os.path.getsize(trace) > 0


def test_flight_dump_carries_data_health(tmp_path):
    """A failed run's flight dump holds the data summary's verdict, the
    classifier's dict."""
    data = json.loads((FIXTURES / "tuner_skewhot.jsonl").read_text()
                      .splitlines()[1])
    tel = Telemetry.create(ledger_path=str(tmp_path / "l.jsonl"))
    tel.note_data(data)
    path = tel.flight_dump(context={"where": "test"})
    tel.close()
    dump = json.loads(pathlib.Path(path).read_text())
    assert dump["data_health"] == jdatahealth.classify(data)
    assert dump["data_health"]["verdict"] == "skew-hot"
