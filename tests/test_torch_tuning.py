"""The port's autotuner (``mapreduce_tpu_torch.tuning``) against the JAX
package's, on the CPU.

The tuner is a pure function of ledger records, so the same records must
give the same dict in both packages: ``propose`` on every checked-in
tuner fixture and on hand-made records, ``search`` over the same simulated
systems, and ``validate_knobs`` through each package's own ``Config``,
compared as whole dicts with no tolerance.  One cross-package case runs a
port hint run (``Config(autotune='hint')``) with a ledger and holds its
``tune`` record to the JAX ``propose`` over the port's records: the check
that the port's records carry every field the JAX tuner reads.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from mapreduce_tpu import tuning as jtuning
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.obs import fleet as jfleet
from mapreduce_tpu.tuning import engine as jengine
from mapreduce_tpu_torch import tuning
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.obs import fleet, ledger
from mapreduce_tpu_torch.obs.telemetry import Telemetry
from mapreduce_tpu_torch.runtime import executor
from mapreduce_tpu_torch.tuning import engine

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tools" / "fixtures"
TUNER_FIXTURES = sorted(p.stem for p in FIXTURES.glob("tuner_*.jsonl"))
OTHER_LEDGERS = ("mini_ledger", "mini_ledger_b", "future_ledger",
                 "history_ledger", "watch_ledger", "fleet_ledger")


def _fixture(name: str) -> list:
    return [json.loads(line) for line in
            (FIXTURES / f"{name}.jsonl").read_text().splitlines()
            if line.strip()]


def _knobs(**kw) -> dict:
    return {**engine.default_knobs(), **kw}


def test_constants_and_defaults_equal_jax():
    assert engine.KNOBS == jengine.KNOBS
    assert engine.TUNER_VERSION == jengine.TUNER_VERSION
    assert engine.default_knobs() == jengine.default_knobs()
    for name in ("INFLIGHT_MAX", "PREFETCH_MAX", "SUPERSTEP_MAX",
                 "CHUNK_MIN", "CHUNK_MAX", "CONVERGED_SAVING_FRAC",
                 "ALWAYS_FULL_FRAC", "GEOMETRY_OCC_CEIL", "GEOMETRY_TALL"):
        assert getattr(engine, name) == getattr(jengine, name), name


@pytest.mark.parametrize("name", TUNER_FIXTURES + list(OTHER_LEDGERS))
def test_propose_equals_jax(name):
    """rule, changed, signals, trail: the whole proposal dict, and the
    signal dict it was derived from."""
    recs = _fixture(name)
    assert tuning.propose(recs) == jtuning.propose(recs)
    assert tuning.derive_signals(recs) == jtuning.derive_signals(recs)


@pytest.mark.parametrize("name,current", [
    ("tuner_reader_bound", {"prefetch_depth": 16}),
    ("tuner_device_bound", {"superstep": 32}),
    ("tuner_skewhot", {"combiner": "hot-cache"}),
    ("tuner_geometry", {"geometry": "tall512"}),
    ("tuner_geomspill", {"geometry": "default"}),
    ("tuner_tablepressure", {"chunk_bytes": 1 << 20}),
], ids=["prefetch-cap", "superstep-cap", "combiner-on", "geometry-tall",
        "geomspill-default", "chunk-min"])
def test_propose_with_current_equals_jax(name, current):
    """The caps and the already-moved knobs: the at-cap rules and the
    notes in the trail."""
    recs = _fixture(name)
    want = jtuning.propose(recs, current=_knobs(**current))
    assert tuning.propose(recs, current=_knobs(**current)) == want


def _phase_run(phases: dict, pipeline: dict) -> list:
    return [{"run_id": "x", "kind": "run_start", "chunk_bytes": 1 << 21,
             "superstep": 1, "backend": "xla"},
            {"run_id": "x", "kind": "run_end", "phases": phases,
             "pipeline": {"inflight_groups": 4, "prefetch_depth": 4,
                          **pipeline}}]


@pytest.mark.parametrize("recs", [
    _phase_run({"read_wait": 0.1, "stage": 0.2, "h2d_tail": 3.0},
               {"depth_max": 4, "full_frac": 0.5}),
    _phase_run({"read_wait": 0.3, "stage": 0.1, "dispatch": 0.1,
                "compute_tail": 8.0}, {"depth_max": 4, "full_frac": 1.0}),
    _phase_run({"read_wait": 0.1, "stage": 0.2, "h2d_tail": 3.0},
               {"depth_max": 2, "full_frac": 0.0}),
    _phase_run({"read_wait": 5.0, "dispatch": 0.1}, {"depth_max": 1}),
    _phase_run({"dispatch": 4.0, "host_read": 1.0}, {"depth_max": 4,
                                                     "full_frac": 0.3}),
    [{"run_id": "x", "kind": "run_start"}],
], ids=["h2d-fed", "compute-tail", "window-starved", "reader",
        "dispatch", "no-signal"])
def test_phase_fallback_equals_jax(recs):
    """Ledgers without ``group`` records: the phase-to-lane table decides
    (the port's ``dispatch`` and ``host_read`` included)."""
    assert tuning.propose(recs) == jtuning.propose(recs)


def _collective_bound_merged(mod, merge_strategy="tree",
                             merge_overlap=False):
    """A merged two-host stream whose fleet verdict is collective-bound
    (the JAX fleet test's records), merged by ``mod``'s fleet."""
    def start(h):
        rec = {"run_id": "cb", "kind": "run_start", "host": h,
               "backend": "xla", "clock": {"wall": 50.0, "mono": 0.0},
               "merge_strategy": merge_strategy}
        if merge_overlap:
            rec["merge_overlap"] = True
        return rec

    def group(h):
        return {"run_id": "cb", "kind": "group", "host": h, "step_first": 0,
                "step_last": 0, "staged_at": 0.99, "dispatched_at": 1.0,
                "token_ready_at": 2.0 + 0.01 * h, "retired_at": 2.0 + 0.01 * h}

    by_host = {h: [start(h), group(h),
                   {"run_id": "cb", "kind": "collective", "host": h,
                    "op": "finish", "started_at": 2.1, "ended_at": 3.6}]
               for h in (0, 1)}
    return mod.merged_records(by_host)


@pytest.mark.parametrize("strategy,overlap", [
    ("tree", False), ("tree", True), ("keyrange", True)],
    ids=["overlap-off", "overlap-on", "ladder-exhausted"])
def test_fleet_rule_equals_jax(strategy, overlap):
    """Rule 0 on a merged collective-bound fleet: overlap on, then
    keyrange, then a note; the merged streams are equal too."""
    recs = _collective_bound_merged(fleet, strategy, overlap)
    assert recs == _collective_bound_merged(jfleet, strategy, overlap)
    got = tuning.propose(recs, run_id="cb")
    assert got == jtuning.propose(recs, run_id="cb")
    assert got["signals"]["fleet_bottleneck"] == "collective-bound"


def _search_cases():
    reader, conv = _fixture("tuner_reader_bound"), _fixture("tuner_converged")
    device = _fixture("tuner_device_bound")
    occ, tbl = _fixture("tuner_occupancy"), _fixture("tuner_tablepressure")
    skew = _fixture("tuner_skewhot")
    return {
        "reader-bound": (lambda k: reader if k["prefetch_depth"] < 16
                         else conv, _knobs(), 6),
        "device-bound": (lambda k: device if k["superstep"] < 4 else conv,
                         _knobs(), 6),
        "oscillating": (lambda k: occ if k["chunk_bytes"] <= (2 << 20)
                        else tbl, _knobs(chunk_bytes=2 << 20), 10),
        "budget": (lambda k: device, _knobs(), 3),
        "skew-hot": (lambda k: skew if k["combiner"] == "off" else conv,
                     _knobs(), 4),
    }


@pytest.mark.parametrize("case", list(_search_cases()))
def test_search_equals_jax(case):
    """The walk over the same simulated systems: winner, stopped, passes
    and every pass's proposal."""
    measure, start, budget = _search_cases()[case]
    got = tuning.search(measure, start, budget=budget)
    assert got == jtuning.search(measure, start, budget=budget)
    assert got["stopped"] == {"reader-bound": "converged",
                              "device-bound": "converged",
                              "oscillating": "oscillation",
                              "budget": "budget-exhausted",
                              "skew-hot": "converged"}[case]


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("knobs,backend", [
    (_knobs(), "auto"), (_knobs(chunk_bytes=1000), "auto"),
    (_knobs(superstep=0), "auto"), (_knobs(prefetch_depth=0), "cpu"),
    (_knobs(merge_overlap="maybe"), "auto"), (_knobs(combiner="x"), "xla"),
    (_knobs(geometry="huge"), "auto"), (_knobs(merge_strategy="x"), "auto"),
    (_knobs(inflight_groups=0), "pallas"),
    (_knobs(geometry="combiner16", combiner="hot-cache"), "auto"),
], ids=["defaults", "chunk-align", "superstep", "prefetch", "overlap",
        "combiner", "geometry", "strategy", "inflight", "preset"])
def test_validate_knobs_equals_jax(knobs, backend):
    """Each package's own Config rules: the same knobs pass or raise the
    same message."""
    assert _refusal(lambda: tuning.validate_knobs(knobs, backend)) \
        == _refusal(lambda: jtuning.validate_knobs(knobs, backend))


@pytest.mark.parametrize("kw", [
    {"autotune": "hint"}, {"autotune": "on"},
    {"combiner": "auto", "combiner_slots": 16},
    {"combiner_slots": 16}, {"geometry": "auto"},
    {"merge_strategy": "auto"}, {"merge_strategy": "bogus"}],
    ids=["hint", "bad-mode", "auto-slots", "slots-off", "geometry-auto",
         "strategy-auto", "strategy-bad"])
def test_config_autotuner_values_equal_jax(kw):
    """The autotuner's values validate, resolve and refuse as the JAX
    ``Config``'s: unresolved 'auto' runs as 'off', the default geometry and
    'tree'."""
    want = _refusal(lambda: JConfig(**kw))
    assert _refusal(lambda: Config(**kw)) == want
    if want is None:
        j, c = JConfig(**kw), Config(**kw)
        assert (c.resolved_combiner, c.geometry_label,
                c.resolved_geometry.as_dict(), c.resolved_merge_strategy,
                c.autotune) == (j.resolved_combiner, j.geometry_label,
                                j.resolved_geometry.as_dict(),
                                j.resolved_merge_strategy, j.autotune)


def _corpus(n_bytes: int, seed: int) -> bytes:
    """Zipf-ish words (one key above 5 % of the tokens: skew-hot)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}".encode() for i in range(400)]
    ranks = np.minimum(rng.zipf(1.3, n_bytes // 3), len(vocab)) - 1
    out = b" ".join(vocab[r] for r in ranks)
    return out[:n_bytes].rsplit(b" ", 1)[0] + b"\n"


@pytest.fixture(scope="module")
def hint_run(tmp_path_factory):
    """One port hint run on the CPU: 16 KB chunks over a 64 KB corpus, a
    window of 2, with a ledger -> (config, result, records, the handle's
    tune, corpus path)."""
    tmp = tmp_path_factory.mktemp("torch_hint")
    path = tmp / "corpus.txt"
    path.write_bytes(_corpus(64 << 10, 20261017))
    cfg = Config(chunk_bytes=16 << 10, table_capacity=4096,
                 inflight_groups=2, autotune="hint")
    led = str(tmp / "run.jsonl")
    with Telemetry.create(ledger_path=led) as tel:
        result = executor.count_file(str(path), cfg, device="cpu",
                                     telemetry=tel)
    return cfg, result, list(ledger.read_ledger(led)), tel.last_tune, path


def test_hint_run_writes_one_tune_record(hint_run):
    """Exactly one ``tune`` record, after ``data`` and before
    ``run_end``, whose payload is ``RunResult.tune`` and the handle's
    ``last_tune``; its proposal passes the Config; the run's counts are
    those of the run without the hint."""
    cfg, result, recs, last_tune, path = hint_run
    kinds = [r["kind"] for r in recs]
    assert kinds.count("tune") == 1
    assert kinds.index("data") < kinds.index("tune") == len(kinds) - 2
    assert kinds[-1] == "run_end"
    tune = recs[kinds.index("tune")]
    payload = {k: v for k, v in tune.items() if k not in ("ts", "kind")}
    assert result.run.tune == payload == last_tune
    assert payload["mode"] == "hint" and payload["run_id"] == tune["run_id"]
    tuning.validate_knobs(payload["proposal"], cfg.backend)
    plain = executor.count_file(
        str(path), dataclasses.replace(cfg, autotune="off"), device="cpu")
    assert plain.run.tune is None
    assert (plain.words, plain.counts) == (result.words, result.counts)


def test_jax_tuner_reads_the_port_ledger(hint_run):
    """The cross-package check: the JAX ``propose`` over the port's own
    records (up to the hint, with the run_end view the hint read) gives
    the port's ``tune`` record, dict for dict; and both packages' tuners
    over the whole ledger make the record's move."""
    cfg, result, recs, _, _ = hint_run
    kinds = [r["kind"] for r in recs]
    end = recs[-1]
    seen = recs[:kinds.index("tune")] + [
        {"run_id": end["run_id"], "kind": "run_end",
         "phases": end["phases"], "pipeline": end["pipeline"]}]
    current = {"chunk_bytes": cfg.chunk_bytes, "superstep": cfg.superstep,
               "inflight_groups": cfg.inflight_groups,
               "prefetch_depth": cfg.resolved_prefetch_depth}
    want = jtuning.propose(seen, run_id=end["run_id"], current=current)
    tune = {k: v for k, v in result.run.tune.items() if k != "mode"}
    assert tune == want
    assert want["signals"]["resource_source"] == "timeline"
    assert want["signals"]["data_verdict"] == "skew-hot"
    whole = tuning.propose(recs)
    assert whole == jtuning.propose(recs)
    assert (whole["rule"], whole["changed"], whole["proposal"]) == \
        (tune["rule"], tune["changed"], tune["proposal"])


def test_hint_without_a_ledger_still_proposes(tmp_path):
    """No telemetry: the in-memory run_end view gives a phase-classified
    hint on ``RunResult.tune``, and the run is unchanged."""
    path = tmp_path / "c.txt"
    path.write_bytes(_corpus(8 << 10, 7))
    cfg = Config(chunk_bytes=4096, autotune="hint")
    r = executor.count_file(str(path), cfg, device="cpu")
    assert r.run.tune is not None and r.run.tune["mode"] == "hint"
    assert r.run.tune["signals"]["resource_source"] == "phases"
    tuning.validate_knobs(r.run.tune["proposal"])
    plain = executor.count_file(str(path), Config(chunk_bytes=4096),
                                device="cpu")
    assert (plain.words, plain.counts) == (r.words, r.counts)


def test_hint_failure_is_logged_not_raised(tmp_path, monkeypatch):
    """Advisory, as in the JAX package: a tuner that raises leaves the
    run exact, with no ``tune`` record and ``RunResult.tune`` None."""
    path = tmp_path / "c.txt"
    path.write_bytes(_corpus(8 << 10, 8))

    def broken(*a, **kw):
        raise RuntimeError("tuner down")

    monkeypatch.setattr(engine, "propose", broken)
    monkeypatch.setattr(tuning, "propose", broken)
    led = str(tmp_path / "l.jsonl")
    with Telemetry.create(ledger_path=led) as tel:
        r = executor.count_file(str(path), Config(chunk_bytes=4096,
                                                  autotune="hint"),
                                device="cpu", telemetry=tel)
    assert r.run.tune is None and tel.last_tune is None
    kinds = [x["kind"] for x in ledger.read_ledger(led)]
    assert "tune" not in kinds and kinds[-1] == "run_end"
