"""Data-health classifier: the per-run ``data`` ledger record -> a
machine-readable verdict on what the data did to the run.

The port's copy of the JAX package's ``obs/datahealth.py`` (stdlib only,
the same rules, thresholds and output), so the same records give the
same dict in both packages.  The timeline's ``bottleneck`` names the
pipeline resource that bounded a run; this module names the data shape
that bounded the device side, the signal the autotuner
(:mod:`mapreduce_tpu_torch.tuning`) reads:

==================  =======================================================
verdict             meaning (and the knob it points at)
==================  =======================================================
spill-bound         kernel windows overflowed their slot budget and
                    chunks re-ran at full resolution (each fallback ~2x
                    that chunk's map cost)
rescue-heavy        overlong (>W-byte) tokens are a measurable share of
                    the stream, or tier-2 rescue escalations fired (raise
                    ``--max-token-bytes`` / the rescue budgets)
skew-hot            one key carries more than 5 % of all tokens
                    (Zipf-hot): the map-side combiner answers it; a
                    key-range merge would load-imbalance
occupancy-starved   the kernel windows ran mostly empty (a record without
                    ``window_occupancy`` never fires it)
table-pressure      the running table is near capacity or dropping keys
clean               none of the above fired
==================  =======================================================

Several flags can fire; ``verdict`` is the first of them in the table's
order.  Every flag carries its measured signal.  The port's ``data``
record has no ``window_occupancy`` or ``window_slot_capacity`` (its
kernel emits one dense stream with no windows, as the JAX ``xla``
backend's map does): :func:`classify` reads that absence as a ``None``
signal, and ``occupancy-starved`` cannot fire.
"""

from __future__ import annotations

from typing import Iterable, Optional

#: Share of chunks taking the full-resolution fallback that makes a run
#: spill-bound (each one ~doubles that chunk's map cost).
SPILL_FALLBACK_FRAC = 0.05
#: Overlong occurrences as a share of all tokens that makes a run
#: rescue-heavy (natural text measures ~0; webby text ~5e-4/chunk budget).
OVERLONG_FRAC = 1e-3
#: Top single-key mass that makes a corpus skew-hot.  Zipf-ish natural
#: text puts >5% of all tokens on the top key ("the"); a uniform corpus
#: puts ~1/distinct there.
TOP_MASS_HOT = 0.05
#: Compact-window slot occupancy below which the sort input is mostly
#: padding (the stable2 windows carry `slots` rows whether used or not).
WINDOW_OCCUPANCY_FLOOR = 0.25
#: Running-table occupancy that signals imminent key spill.
TABLE_OCCUPANCY_CEIL = 0.9


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def _frac(num, den) -> Optional[float]:
    n, d = _num(num), _num(den)
    if n is None or not d:
        return None
    return n / d


def classify(data: dict) -> dict:
    """One run's ``data`` record -> ``{verdict, flags, signals}``.

    ``signals`` carries every derived ratio (present or None — absence of
    a signal is itself information: an xla-backend run has no windows to
    starve); each entry of ``flags`` carries the measured number that
    fired it.  Unknown/extra fields in ``data`` are ignored (ledger
    forward compat)."""
    chunks = _num(data.get("chunks")) or 0.0
    tokens = _num(data.get("tokens")) or 0.0
    signals = {
        "fallback_frac": _frac(data.get("fallback_chunks", 0), chunks),
        "overlong_frac": _frac(data.get("overlong", 0), tokens),
        "rescued_frac": _frac(data.get("rescued", 0),
                              data.get("overlong", 0)),
        "dropped_frac": _frac(data.get("dropped_tokens", 0), tokens),
        "top_mass": _frac(data.get("top_count", 0), tokens),
        "distinct_ratio": _frac(data.get("table_valid", 0), tokens),
        "table_occupancy": _frac(data.get("table_valid", 0),
                                 data.get("capacity", 0)),
        "window_occupancy": _num(data.get("window_occupancy")),
        "rescue_escalations": _num(data.get("rescue_escalations", 0)),
        # Map-side combiner telemetry: share of all tokens the
        # hot-key cache absorbed, and the net sort rows it deleted.  Pure
        # observability — no flag fires on them (the combiner is the CURE
        # for skew-hot, not a symptom), but the skew-hot detail below
        # points at the knob and the autotuner's enable-combiner rule
        # reads the verdict.
        "combiner_hit_rate": _frac(data.get("combiner_hits", 0),
                                   data.get("tokens", 0)),
        "combiner_rows_deleted": _num(data.get("combiner_rows_deleted")),
    }
    signals = {k: (round(v, 6) if v is not None else None)
               for k, v in signals.items()}
    flags = []

    def flag(name: str, detail: str) -> None:
        flags.append({"flag": name, "detail": detail})

    ff = signals["fallback_frac"]
    if ff is not None and ff > SPILL_FALLBACK_FRAC:
        flag("spill-bound",
             f"{ff:.1%} of chunks overflowed their compact window slots "
             f"and re-ran at full resolution (spill_rows="
             f"{data.get('spill_rows', 0)}) — each fallback ~doubles that "
             "chunk's map cost; raise --compact-slots or accept the 2x")
    of = signals["overlong_frac"]
    esc = signals["rescue_escalations"] or 0
    if (of is not None and of > OVERLONG_FRAC) or esc > 0:
        rf = signals["rescued_frac"]
        rescued_part = f", rescued {rf:.0%} of them" if rf is not None else ""
        flag("rescue-heavy",
             f"overlong tokens are {(of or 0):.2%} of the stream with "
             f"{int(esc)} tier-2 escalations{rescued_part} — raise "
             "--max-token-bytes / the rescue budgets for URL-dense text")
    tm = signals["top_mass"]
    if tm is not None and tm > TOP_MASS_HOT:
        ch = signals["combiner_hit_rate"]
        cure = (f"the map-side combiner is absorbing {ch:.1%} of the "
                "stream" if ch else
                "enable the map-side combiner (--combiner hot-cache, or "
                "'auto' to let this verdict decide)")
        flag("skew-hot",
             f"the hottest key carries {tm:.1%} of all tokens "
             f"(Zipf-hot): {cure}; key-range partitioning would "
             "load-imbalance — prefer tree merge")
    wo = signals["window_occupancy"]
    if wo is not None and wo < WINDOW_OCCUPANCY_FLOOR:
        flag("occupancy-starved",
             f"compact kernel windows ran {wo:.1%} full: the aggregation "
             "sort is mostly sorting padding — shrink --compact-slots or "
             "grow the chunk")
    to = signals["table_occupancy"]
    dropped_uniques = _num(data.get("dropped_uniques", 0)) or 0
    if (to is not None and to > TABLE_OCCUPANCY_CEIL) or dropped_uniques > 0:
        flag("table-pressure",
             f"running table {to if to is not None else 0:.0%} full, "
             f"{int(dropped_uniques)} distinct keys spilled — raise "
             "--table-capacity or rely on the KMV/HLL estimates")

    order = ["spill-bound", "rescue-heavy", "skew-hot",
             "occupancy-starved", "table-pressure"]
    fired = {f["flag"] for f in flags}
    verdict = next((v for v in order if v in fired), "clean")
    return {"verdict": verdict, "flags": flags, "signals": signals}


def data_record(records: Iterable[dict],
                run_id: Optional[str] = None) -> Optional[dict]:
    """The ``data`` record of one run (the first run carrying one when
    ``run_id`` is not given).  Unknown kinds/malformed rows skip — the
    ledger forward-compat contract."""
    chosen = run_id
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "data":
            continue
        if chosen is None:
            chosen = rec.get("run_id")
        if rec.get("run_id") == chosen:
            return rec
    return None


def classify_run(records: Iterable[dict],
                 run_id: Optional[str] = None) -> Optional[dict]:
    """Ledger records -> the health artifact of one run, or None when the
    run carries no ``data`` record (older ledgers degrade to "no
    data-health section", never to an error)."""
    rec = data_record(records, run_id)
    return classify(rec) if rec is not None else None


def latest_data_record(records: Iterable[dict]) -> Optional[dict]:
    """The LAST ``data`` record in a (possibly append-mode, multi-run)
    ledger — the most recent completed measurement, which is what
    history-driven decisions should read (contrast :func:`data_record`,
    which serves per-run analysis and keys on the FIRST run)."""
    last = None
    for rec in records:
        if isinstance(rec, dict) and rec.get("kind") == "data":
            last = rec
    return last


#: Hottest-host share over the per-host mean that makes a fleet
#: host-imbalanced: a host carrying >1.25x the mean bytes or
#: tokens finishes proportionally late every superstep — the signal the
#: ROADMAP-item-3 reduction-strategy planner needs before choosing
#: keyrange vs tree vs hierarchical merges.
HOST_IMBALANCE_RATIO = 1.25


def classify_fleet(per_host: dict) -> dict:
    """Per-host data counters -> the cross-host balance verdict:
    ``{verdict, flags, signals}`` like :func:`classify`, over
    ``{host: {"bytes": ..., "tokens": ...}}`` (any subset of counters;
    ``obs/fleet.py`` builds the dict from each shard's ``host_bytes``
    group fields and ``data`` records).  A counter present on >= 2 hosts
    whose hottest host carries more than :data:`HOST_IMBALANCE_RATIO`
    times the per-host mean fires ``host-imbalance``; the verdict is
    ``host-imbalance`` or ``balanced``.  Unknown/extra fields ignored."""
    signals: dict = {}
    flags = []
    for counter in ("bytes", "tokens"):
        vals = {h: _num(v.get(counter)) for h, v in per_host.items()
                if isinstance(v, dict) and _num(v.get(counter)) is not None}
        if len(vals) < 2:
            continue
        mean = sum(vals.values()) / len(vals)
        if mean <= 0:
            continue
        hot = max(sorted(vals), key=lambda h: vals[h])
        ratio = vals[hot] / mean
        signals[f"{counter}_ratio"] = round(ratio, 6)
        signals[f"{counter}_hot_host"] = hot
        if ratio > HOST_IMBALANCE_RATIO:
            flags.append({"flag": "host-imbalance", "counter": counter,
                          "detail": (f"host {hot} carries {ratio:.2f}x the "
                                     f"per-host mean {counter} "
                                     f"({vals[hot]:.0f} vs {mean:.0f}): it "
                                     "finishes proportionally late every "
                                     "superstep — rebalance the key ranges "
                                     "or prefer a skew-tolerant merge "
                                     "strategy (ROADMAP item 3)")})
    verdict = "host-imbalance" if flags else "balanced"
    return {"verdict": verdict, "flags": flags, "signals": signals}


#: Reliability verdict priority: highest-severity wins, the
#: :func:`classify` rule-table discipline.  A `failed` run died; a
#: `preempted` run exited cleanly with a resumable cursor; a `degraded`
#: run finished on a stepped-down config (alive but slower — visible,
#: not mysterious); a `fault-prone` run absorbed real faults with
#: retries; a `chaos-tested` run absorbed only INJECTED faults (a chaos
#: certification run that stayed exact).
RELIABILITY_ORDER = ("failed", "preempted", "degraded", "fault-prone",
                     "chaos-tested", "clean")


def classify_reliability(records: Iterable[dict],
                         run_id: Optional[str] = None) -> dict:
    """One run's ledger records -> the reliability verdict
    (ledger v9): ``{verdict, flags, signals}`` over the run's ``fault`` /
    ``degrade`` / ``retry`` / ``failure`` records.  Unknown kinds and
    extra fields skip (forward compat); a pre-v9 ledger with none of
    these kinds reads ``clean`` — exactly what it observed."""
    chosen = run_id
    faults: list = []
    degrades: list = []
    retries_by_class: dict = {}
    failures = 0
    preempted = False
    for rec in records:
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind not in ("fault", "degrade", "retry", "failure",
                        "checkpoint"):
            continue
        if chosen is None:
            chosen = rec.get("run_id")
        if chosen is not None and rec.get("run_id") not in (None, chosen):
            continue
        if kind == "fault":
            faults.append(rec)
            if rec.get("fault_class") == "preemption":
                preempted = True
        elif kind == "degrade":
            degrades.append(rec)
        elif kind == "retry":
            cls = rec.get("fault_class") or "transient"
            retries_by_class[cls] = retries_by_class.get(cls, 0) + 1
        elif kind == "failure":
            failures += 1
        elif kind == "checkpoint" and rec.get("preempt"):
            preempted = True
    injected = [f for f in faults if f.get("injected")]
    real = [f for f in faults if not f.get("injected")]
    seams: dict = {}
    for f in faults:
        s = f.get("seam") or "?"
        seams[s] = seams.get(s, 0) + 1
    signals = {
        "faults_total": len(faults),
        "faults_injected": len(injected),
        "faults_real": len(real),
        "retries": sum(retries_by_class.values()),
        "retries_by_class": retries_by_class,
        "failures": failures,
        "degrade_steps": [d.get("ladder_step") for d in degrades],
        "fault_seams": seams,
    }
    flags = []

    def flag(name: str, detail: str) -> None:
        flags.append({"flag": name, "detail": detail})

    if failures:
        flag("failed", f"{failures} failure record(s): the run surfaced "
             "an unrecoverable fault — see the flight dump")
    if preempted:
        flag("preempted", "the platform reclaimed the machine; the run "
             "drained, checkpointed and exited with a resumable cursor")
    if degrades:
        steps = " -> ".join(str(s) for s in signals["degrade_steps"])
        flag("degraded",
             f"resource exhaustion stepped down the degradation ladder "
             f"({steps}): the run finished on a cheaper config — slower, "
             "never wrong (each step is bit-identity-tested)")
    if real:
        flag("fault-prone",
             f"{len(real)} real fault(s) classified at seams "
             f"{sorted({f.get('seam') for f in real})} and absorbed by "
             f"{signals['retries']} retr(ies) — watch the trend in the "
             "run-history warehouse")
    if injected:
        flag("chaos-tested",
             f"{len(injected)} injected fault(s) fired from the run's "
             "fault plan; results certified bit-identical when the "
             "retry budget absorbed them")
    fired = {f["flag"] for f in flags}
    verdict = next((v for v in RELIABILITY_ORDER if v in fired), "clean")
    return {"verdict": verdict, "flags": flags, "signals": signals}


def resolve_combiner(records: Iterable[dict]) -> str:
    """Resolve ``Config.combiner='auto'`` against a prior run's ledger:
    the most recent ``data`` record's verdict decides —
    skew-hot flips the hot-key combiner on, anything else (including no
    history at all) stays off.  The same flip the autotuner's
    ``skew-hot -> enable-combiner`` rule proposes.  NOTE:
    this is the PRIMITIVE; drivers resolve through
    ``obs/history.resolve_prior(records=...)["combiner"]`` — the one
    prior-run read — which reproduces this function bit-for-bit (the
    parity is asserted in the history selftest)."""
    rec = latest_data_record(records)
    if rec is None:
        return "off"
    return "hot-cache" if classify(rec)["verdict"] == "skew-hot" else "off"
