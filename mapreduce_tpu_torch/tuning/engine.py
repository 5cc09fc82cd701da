"""Closed-loop config autotuner: a run's own ledger -> the next config.

The port's copy of the JAX package's ``tuning/engine.py``: the same rule
table, caps, reason strings and output, so the same records give the
same proposal dict in both packages.  A pure, deterministic function of
ledger records proposes the next values of the tuned knobs
(:data:`KNOBS`) from the timeline's critical-path ``bottleneck``, the
data-health verdict, the window statistics and, on a merged fleet
stream, the ``fleet_bottleneck``.  Two drivers consume it:

* **search** (:func:`search`): walks the rule table over short measured
  passes until a proposal converges, a config repeats (the oscillation
  guard) or the budget runs out;
* **online hints** (``Config(autotune='hint')`` / ``--autotune``): the
  streamed executor calls :func:`propose` on the run's own records and
  writes the recommendation as a ``tune`` ledger record; the live run is
  never changed.

The rule table (first match wins; every raising rule converges at its
cap instead of proposing a no-op):

======================  ===================================  ============
rule                    trigger                              move
======================  ===================================  ============
fleet-collective-bound  merged fleet verdict                 overlap on,
                        ``collective-bound``                 then keyrange
no-signal               no phases/pipeline/timeline at all   stop
revert-geometry         ``spill-bound``, geometry not the    geometry
                        default                              default
enable-combiner         ``skew-hot``, combiner off           combiner on
grow-chunk              ``occupancy-starved``                chunk x2
shrink-chunk            ``table-pressure``                   chunk /2
converged               projected bottleneck saving < 10 %   stop
                        of the span
raise-prefetch          bottleneck ``reader``                prefetch x2
feed-window             h2d/staging-bound, window never      prefetch x2
                        filled
raise-inflight          bottleneck ``h2d`` or ``staging``    inflight x2
try-superstep           device-bound, window always full     superstep x2
try-geometry            device-bound, window not saturated,  'tall512'
                        window occupancy <= 70 %, default
                        geometry, combiner off
device-bound            device-bound otherwise               stop
no-rule                 nothing actionable                   stop
======================  ===================================  ============

Data verdicts whose knobs lie outside the tuned set (spill-bound ->
``--compact-slots``, rescue-heavy -> the rescue budgets) and a
straggler-bound fleet are noted in the decision trail, never moved on.
Every proposal passes the port's ``Config.__post_init__`` rules
(:func:`validate_knobs`).

On the port, ``try-geometry`` cannot fire: its ``data`` record carries no
``window_occupancy``.  The timeline charges the port's ``dispatch`` (the
host launching the map's kernels) to the ``device`` lane, as the JAX
package's phase table does.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from mapreduce_tpu_torch.config import (MERGE_STRATEGIES, Config,
                                        DEFAULT_CONFIG, GEOMETRY_PRESETS)
from mapreduce_tpu_torch.obs import datahealth, history, timeline

#: Bumped when the rule table / proposal schema changes shape.
#: 2 = merge_strategy/merge_overlap joined the tuned set and
#: the fleet-collective-bound rule fires instead of noting.
TUNER_VERSION = 2

#: The knobs this tuner owns, in proposal order.  ``combiner``
#: and ``geometry`` are the non-numeric knobs: mode/preset
#: strings moved by the data-shape and device rules, not doubled/halved
#: by the pipeline ones.  Geometry knob values are 'default' or a
#: ``config.GEOMETRY_PRESETS`` name — the tuned.json / ledger round-trip
#: form (explicit Geometry dicts belong to the offline geomsearch
#: driver, not the rule table).  ``merge_strategy`` / ``merge_overlap``
#: are the placed-reduction knobs the fleet-collective-bound
#: rule moves: a ``config.MERGE_STRATEGIES`` name and an 'off'/'on'
#: string (the tuned.json round-trip form of the Config bool).
KNOBS = ("inflight_groups", "prefetch_depth", "superstep", "chunk_bytes",
         "combiner", "geometry", "merge_strategy", "merge_overlap")

#: Knobs that hold integers (everything result() must int-coerce).
_INT_KNOBS = ("inflight_groups", "prefetch_depth", "superstep",
              "chunk_bytes")

# Move envelopes (the JAX package's): prefetch's auto-resolution clamps
# at 16 (Config), a >16-deep window holds >16 chunks of staged input
# live, superstep 32 at the default chunk stages 1 GB per dispatch, and
# chunk_bytes beyond 64 MB is refused by the kernel path's envelope while
# below 1 MB dispatch overhead dominates.
INFLIGHT_MAX = 16
PREFETCH_MAX = 16
SUPERSTEP_MAX = 32
CHUNK_MIN = 1 << 20
CHUNK_MAX = 1 << 26

#: A bottleneck whose projected saving is below this share of the span is
#: not worth a config move: the pipeline is within 10% of its overlap
#: ceiling and further moves chase noise.
CONVERGED_SAVING_FRAC = 0.10
#: ``full_frac`` at or above this = the window hit capacity on nearly
#: every dispatch (the obs_report "always-full" gate).
ALWAYS_FULL_FRAC = 0.9
#: Mean stable2 window occupancy at or below which a taller window is
#: worth probing: the 384 -> 512 step grows each window 1.33x,
#: so <= 70% mean occupancy leaves headroom before the slot budget —
#: and the exact spill fallback covers the tail either way.
GEOMETRY_OCC_CEIL = 0.70
#: The taller-window preset try-geometry proposes (config.GEOMETRY_PRESETS).
GEOMETRY_TALL = "tall512"

#: Data-health verdicts whose knob is outside the tuned set: noted in the
#: trail, never moved on (verdict -> the knob that actually owns it).
#: skew-hot is not in this set: the combiner knob answers it.
_FOREIGN_DATA_KNOBS = {
    "spill-bound": "--compact-slots",
    "rescue-heavy": "--max-token-bytes / the rescue budgets",
}


def default_knobs() -> dict:
    """The shipped defaults as a knob dict (the search starting point)."""
    return {"inflight_groups": DEFAULT_CONFIG.inflight_groups,
            "prefetch_depth": DEFAULT_CONFIG.resolved_prefetch_depth,
            "superstep": DEFAULT_CONFIG.superstep,
            "chunk_bytes": DEFAULT_CONFIG.chunk_bytes,
            "combiner": DEFAULT_CONFIG.combiner,
            "geometry": DEFAULT_CONFIG.geometry_label,
            "merge_strategy": DEFAULT_CONFIG.merge_strategy,
            "merge_overlap": "on" if DEFAULT_CONFIG.merge_overlap
            else "off"}


def validate_knobs(knobs: dict, backend: str = "auto") -> None:
    """Run a knob dict through the REAL ``Config.__post_init__`` rules
    (chunk alignment, window/prefetch bounds, backend envelopes) — every
    proposal must survive this before anything acts on it.  Raises
    ``ValueError`` exactly as Config would."""
    if backend not in ("auto", "xla", "pallas"):
        backend = "auto"  # resolved/CLI names like 'cpu' validate generically
    geometry = str(knobs.get("geometry", "default"))
    overlap = str(knobs.get("merge_overlap", "off"))
    if overlap not in ("off", "on"):
        raise ValueError(f"merge_overlap knob must be 'off' or 'on', "
                         f"got {overlap!r}")
    Config(chunk_bytes=int(knobs["chunk_bytes"]),
           superstep=int(knobs["superstep"]),
           inflight_groups=int(knobs["inflight_groups"]),
           prefetch_depth=int(knobs["prefetch_depth"]),
           combiner=str(knobs.get("combiner", "off")),
           geometry=None if geometry == "default" else geometry,
           merge_strategy=str(knobs.get("merge_strategy", "tree")),
           merge_overlap=overlap == "on",
           backend=backend)


# -- ledger records -> the signal dict the rule table reads -----------------

def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


#: Phase-delta fallback when a run carries no ``group`` records (batch
#: ledgers, pre-v2 ledgers, the ledgerless hint path): which resource
#: each streaming phase blames: the one table in ``obs/timeline.py``.
_PHASE_LANE = timeline.PHASE_LANE


def _phase_resource(phases: dict) -> Optional[str]:
    lanes: dict = {}
    for phase, lane in _PHASE_LANE.items():
        v = _num(phases.get(phase))
        if v:
            lanes[lane] = lanes.get(lane, 0.0) + v
    if not lanes:
        return None
    return max(lanes, key=lambda ln: lanes[ln])


def derive_signals(records: Iterable[dict],
                   run_id: Optional[str] = None) -> dict:
    """One run's ledger records -> the flat signal dict the rule table
    reads: the run's config knobs (run_start + run_end ``pipeline``), the
    measured ``bottleneck`` verdict (reconstructed from ``group`` records
    when present, else a phase-delta fallback), the window statistics,
    and the data-health classification.  Missing pieces degrade to None —
    absence of a signal is itself information, never an error (the ledger
    forward-compat contract)."""
    # Run selection + merged-fleet host anchoring live in the run-history
    # warehouse now (obs/history.resolve_prior is the one
    # prior-run read): the chosen run's records — and, on a merged fleet
    # stream, ONE host's view of them (reconstructing a timeline from
    # every host's records would fuse the lanes into a chimera no host
    # ran) — come back as the prior's run view.
    prior = history.resolve_prior(records=records, run_id=run_id)
    chosen, recs, fleet = prior["run_id"], prior["run_records"], \
        prior["fleet"]
    start = next((r for r in recs if r.get("kind") == "run_start"), None)
    end = next((r for r in recs if r.get("kind") == "run_end"), None)
    phases = dict((end or {}).get("phases") or {})
    if not phases:  # crashed run: fold the step deltas that DID land
        for r in recs:
            if r.get("kind") == "step":
                for k, v in (r.get("phases") or {}).items():
                    if _num(v) is not None:
                        phases[k] = phases.get(k, 0.0) + float(v)
    pipeline = (end or {}).get("pipeline") or None

    config: dict = {}
    for key in ("chunk_bytes", "superstep"):
        v = _num((start or {}).get(key))
        if v is not None:
            config[key] = int(v)
    for key in ("inflight_groups", "prefetch_depth"):
        v = _num((pipeline or {}).get(key))
        if v is not None:
            config[key] = int(v)
    combiner = (start or {}).get("combiner")
    if isinstance(combiner, str):
        config["combiner"] = combiner
    # Placed-reduction knobs: run_start stamps the RESOLVED
    # strategy (never 'auto') and merge_overlap only when true.
    ms = (start or {}).get("merge_strategy")
    if isinstance(ms, str) and ms in MERGE_STRATEGIES:
        config["merge_strategy"] = ms
    if (start or {}).get("merge_overlap") is True:
        config["merge_overlap"] = "on"
    geometry = (start or {}).get("geometry")
    geometry_custom = False
    if isinstance(geometry, str) \
            and (geometry == "default" or geometry in GEOMETRY_PRESETS):
        config["geometry"] = geometry
    elif geometry not in (None, ""):
        # A 'custom' label, a spec dict, or a future shape: the rule
        # table moves preset names only, and a proposal echoing an
        # unknowable value back through validate_knobs would kill the
        # whole hint (Config rejects it).  The knob reads as 'default'
        # for validation purposes and try-geometry is gated off below —
        # an explicit candidate is the operator's (or the geomsearch
        # driver's) choice to keep, not this table's to overwrite.
        geometry_custom = True

    art = timeline.reconstruct(recs, run_id=chosen)
    bottleneck = art["bottleneck"] if art else None
    resource = source = None
    saving_frac = None
    if bottleneck:
        resource, source = bottleneck.get("resource"), "timeline"
        span = _num(bottleneck.get("span_s"))
        saving = _num(bottleneck.get("projected_saving_s"))
        if span and saving is not None:
            saving_frac = round(saving / span, 4)
    elif phases:
        resource, source = _phase_resource(phases), "phases"

    gb_per_s = _num((end or {}).get("gb_per_s"))
    if gb_per_s is None:
        b, el = _num((end or {}).get("bytes")), \
            _num((end or {}).get("elapsed_s"))
        if b and el:
            gb_per_s = round(b / 1e9 / el, 6)

    health = datahealth.classify_run(recs, run_id=chosen)
    window_occ = ((health or {}).get("signals") or {}).get(
        "window_occupancy")
    # Fleet verdict (`fleet` was detected above, before the
    # host anchoring): noted in the decision trail, never chased — the
    # knobs that answer a straggler-/collective-bound fleet (data
    # rebalancing, reduction strategy/schedule) are ROADMAP item 3's,
    # not this table's.
    fleet_verdict = ((fleet or {}).get("fleet_bottleneck") or {}).get(
        "verdict")
    return {
        "run_id": chosen,
        "gb_per_s": gb_per_s,
        "config": config,
        "backend": (start or {}).get("backend"),
        "phases": phases,
        "pipeline": pipeline,
        "bottleneck": bottleneck,
        "resource": resource,
        "resource_source": source,
        "saving_frac": saving_frac,
        "overlap_fraction": _num((pipeline or {}).get("overlap_fraction")),
        "depth_max": _num((pipeline or {}).get("depth_max")),
        "full_frac": _num((pipeline or {}).get("full_frac")),
        "data_health": health,
        "data_verdict": (health or {}).get("verdict"),
        "window_occupancy": window_occ,
        "geometry_custom": geometry_custom,
        "fleet_bottleneck": fleet_verdict if isinstance(fleet_verdict, str)
        else None,
    }


# -- the rule table ----------------------------------------------------------

def propose(records: Iterable[dict], run_id: Optional[str] = None,
            current: Optional[dict] = None) -> dict:
    """Ledger records -> the next-config proposal: a pure, deterministic
    function (same records in, same proposal out — the unit-test
    contract).  ``current`` overrides the knob values derived from the
    records (the search loop knows what it actually ran; a ledger may
    predate a knob).

    Returns a dict with ``current``/``proposal`` (all four knobs),
    ``changed`` (knob -> [old, new]), the fired ``rule`` + human
    ``reason``, ``converged``, the compact ``signals`` the rules read,
    and ``trail`` — every rule CONSIDERED, in order, with whether it
    fired and why (the machine-readable decision trail).
    """
    sig = derive_signals(records, run_id)
    cur = default_knobs()
    cur.update({k: v for k, v in sig["config"].items() if k in cur})
    if current:
        cur.update({k: (int(v) if k in _INT_KNOBS else str(v))
                    for k, v in current.items() if k in cur})

    trail: List[dict] = []

    def consider(rule: str, fired: bool, why: str) -> bool:
        trail.append({"rule": rule, "fired": fired, "why": why})
        return fired

    def result(rule: str, reason: str, changes: Optional[dict] = None,
               converged: bool = False) -> dict:
        prop = dict(cur)
        changed = {}
        for k, v in (changes or {}).items():
            v = int(v) if k in _INT_KNOBS else str(v)
            if v != cur[k]:
                changed[k] = [cur[k], v]
                prop[k] = v
        return {
            "tuner_version": TUNER_VERSION,
            "run_id": sig["run_id"],
            "current": cur,
            "proposal": prop,
            "changed": changed,
            "rule": rule,
            "reason": reason,
            "converged": bool(converged or not changed),
            "signals": {k: sig[k] for k in
                        ("resource", "resource_source", "saving_frac",
                         "overlap_fraction", "depth_max", "full_frac",
                         "data_verdict", "window_occupancy", "gb_per_s",
                         "fleet_bottleneck")},
            "trail": trail,
        }

    resource = sig["resource"]
    saving = sig["saving_frac"]
    verdict = sig["data_verdict"]
    depth_max = sig["depth_max"]
    full_frac = sig["full_frac"]

    # 0. Fleet verdict.  A collective-bound fleet
    #    GRADUATED from note to move: the runtime owns the two knobs that
    #    answer it — window-boundary overlap hides the finish inside the
    #    map stream for free (byte-exact; requires retry=0), and the
    #    merge strategy reshapes what is left.  Overlap first: it costs
    #    nothing to try and the verdict already charges only the VISIBLE
    #    collective share, so a still-collective-bound overlapped run has
    #    genuinely unhidable finish time worth a strategy move.
    if sig.get("fleet_bottleneck") == "collective-bound":
        if consider("fleet-collective-bound",
                    cur["merge_overlap"] == "off",
                    "collective-bound fleet; window-boundary overlap off"):
            return result(
                "fleet-collective-bound",
                "the visible collective finish dominates the fleet span: "
                "enable window-boundary overlap so partial merges ride "
                "inside the map stream (byte-exact to the monolithic "
                "merge; requires retry=0)",
                {"merge_overlap": "on"})
        if consider("fleet-collective-bound",
                    cur["merge_strategy"] == "tree",
                    "collective-bound with overlap on; strategy 'tree'"):
            return result(
                "fleet-collective-bound",
                "overlap already hides what it can and the per-level "
                "tree finish still dominates: switch to the keyrange "
                "owner-reduce program (bandwidth-optimal on one axis; "
                "2-D hier-* programs stay redplan/registry territory)",
                {"merge_strategy": "keyrange"})
        consider("fleet-collective-bound", False,
                 "collective-bound but overlap is on and the strategy is "
                 f"{cur['merge_strategy']!r} — the remaining lever (2-D "
                 "hierarchical placement) is redplan's, not this table's")
    # A straggler-bound fleet stays a note, never chased: its knob is
    #    data placement across hosts (ROADMAP item 3), and thrashing
    #    single-host pipeline knobs against it would be the
    #    foreign-data-knob mistake at fleet scale.
    elif sig.get("fleet_bottleneck") not in (None, "balanced"):
        consider(f"fleet-{sig['fleet_bottleneck']}", False,
                 f"fleet verdict {sig['fleet_bottleneck']!r} noted; its "
                 "knobs (host balance / reduction strategy) are outside "
                 "the tuned set — single-host rules proceed")

    # 1. Nothing to read at all: a run with no phases, no pipeline stats
    #    and no timeline gives the rules nothing — stop honestly.
    if consider("no-signal",
                not sig["phases"] and sig["pipeline"] is None
                and sig["bottleneck"] is None,
                "no phases, pipeline stats or timeline in the ledger"):
        return result("no-signal", "no telemetry to tune from",
                      converged=True)

    # 2. A searched geometry that SPILLS: the taller window
    #    the search bought is too tall for this corpus's density — every
    #    spilled chunk re-runs at full resolution, ~doubling its map
    #    cost, which poisons every signal downstream.  Revert before any
    #    other rule reads the wreckage.  (Default-geometry spill-bound
    #    runs fall through to the foreign-knob note below: their knob is
    #    --compact-slots, not a geometry this tuner set.)
    if consider("revert-geometry",
                verdict == "spill-bound" and cur["geometry"] != "default",
                f"data verdict {verdict!r}; geometry {cur['geometry']!r}"):
        return result("revert-geometry",
                      "the searched taller-window geometry overflows its "
                      "slot budget on this corpus (spill-bound: each "
                      "fallback ~doubles that chunk's map cost): revert "
                      "to the default geometry",
                      {"geometry": "default"})

    # 3. Skew-hot data: the map-side combiner is the knob that
    #    actually answers a Zipf-hot stream — enable it before any
    #    pipeline knob moves (collapsed duplicates change every downstream
    #    signal).  Already-on runs note the fact and fall through: the
    #    remaining skew cost is the sort's to carry.
    if consider("enable-combiner",
                verdict == "skew-hot" and cur["combiner"] == "off",
                f"data verdict {verdict!r}; combiner {cur['combiner']!r}"):
        return result("enable-combiner",
                      "one key carries a double-digit share of the stream "
                      "(skew-hot): enable the map-side hot-key combiner so "
                      "the dominant duplicates collapse in VMEM before the "
                      "aggregation sort sees them",
                      {"combiner": "hot-cache"})
    if verdict == "skew-hot" and cur["combiner"] != "off":
        consider("enable-combiner", False,
                 f"data verdict {verdict!r} but combiner already "
                 f"{cur['combiner']!r} — pipeline rules proceed")

    # 3-4. Data-shape rules outrank pipeline rules: a wrong chunk geometry
    #    poisons every overlap signal downstream of it.
    if consider("grow-chunk",
                verdict == "occupancy-starved"
                and cur["chunk_bytes"] * 2 <= CHUNK_MAX,
                f"data verdict {verdict!r}; chunk {cur['chunk_bytes']}"):
        return result("grow-chunk",
                      "compact kernel windows ran mostly empty "
                      "(occupancy-starved): double chunk_bytes so each "
                      "window sees denser input instead of sorting padding",
                      {"chunk_bytes": cur["chunk_bytes"] * 2})
    if consider("shrink-chunk",
                verdict == "table-pressure"
                and cur["chunk_bytes"] // 2 >= CHUNK_MIN
                and (cur["chunk_bytes"] // 2) % 128 == 0,
                f"data verdict {verdict!r}; chunk {cur['chunk_bytes']}"):
        return result("shrink-chunk",
                      "running table near capacity (table-pressure): halve "
                      "chunk_bytes so smaller per-merge batch tables "
                      "compete for slots — the real knob is "
                      "--table-capacity, which is not autotuned",
                      {"chunk_bytes": cur["chunk_bytes"] // 2})
    if verdict in _FOREIGN_DATA_KNOBS:
        consider(f"data-{verdict}", False,
                 f"data verdict {verdict!r} noted; its knob "
                 f"({_FOREIGN_DATA_KNOBS[verdict]}) is outside the tuned "
                 "set — pipeline rules proceed")

    # 4. Converged: the measured critical path says an infinitely fast
    #    bounding resource would save <10% of the span — the pipeline is
    #    at its overlap ceiling; further knob moves chase noise.
    if consider("converged",
                saving is not None and saving < CONVERGED_SAVING_FRAC,
                f"projected saving {saving} of span"
                if saving is not None else "no timeline saving measured"):
        return result("converged",
                      f"bottleneck {resource!r} projects only "
                      f"{saving:.0%} of the span recoverable "
                      f"(< {CONVERGED_SAVING_FRAC:.0%}): converged",
                      converged=True)

    # 5. Reader-bound: the prefetching reader starves the pipeline.
    if resource == "reader":
        if consider("raise-prefetch", cur["prefetch_depth"] * 2
                    <= PREFETCH_MAX,
                    f"bottleneck reader; prefetch {cur['prefetch_depth']}"):
            return result("raise-prefetch",
                          "the reader is the measured critical path: "
                          "double prefetch_depth so the reader runs "
                          "further ahead of the window",
                          {"prefetch_depth": cur["prefetch_depth"] * 2})
        return result("raise-prefetch-at-cap",
                      f"reader-bound with prefetch_depth "
                      f"{cur['prefetch_depth']} at/past the {PREFETCH_MAX} "
                      "cap: the reader itself (disk/decode) is the floor — "
                      "converged", converged=True)

    # 6. h2d/staging-bound but the window never filled: more inflight buys
    #    nothing until the feed side keeps it full — raise prefetch first.
    window_starved = (depth_max is not None
                     and depth_max < cur["inflight_groups"])
    if resource in ("h2d", "staging") and window_starved:
        if consider("feed-window", cur["prefetch_depth"] * 2 <= PREFETCH_MAX,
                    f"{resource}-bound but depth peaked at {depth_max} < "
                    f"inflight {cur['inflight_groups']}"):
            return result("feed-window",
                          f"{resource}-bound but the window never filled "
                          f"(depth_max {int(depth_max)} < inflight "
                          f"{cur['inflight_groups']}): feed it — double "
                          "prefetch_depth before touching the window",
                          {"prefetch_depth": cur["prefetch_depth"] * 2})
        return result("feed-window-at-cap",
                      f"{resource}-bound, window never filled, prefetch "
                      f"already at {PREFETCH_MAX}: converged",
                      converged=True)

    # 7. h2d/staging-bound with a fed window: deepen it so transfers and
    #    host assembly of MORE groups hide behind device compute.
    if resource in ("h2d", "staging"):
        if consider("raise-inflight",
                    cur["inflight_groups"] * 2 <= INFLIGHT_MAX,
                    f"bottleneck {resource}; "
                    f"inflight {cur['inflight_groups']}"):
            return result("raise-inflight",
                          f"{resource} is the measured critical path: "
                          "double inflight_groups so more transfers/"
                          "staging overlap device compute",
                          {"inflight_groups": cur["inflight_groups"] * 2})
        return result("raise-inflight-at-cap",
                      f"{resource}-bound with inflight_groups "
                      f"{cur['inflight_groups']} at/past the "
                      f"{INFLIGHT_MAX} cap: converged", converged=True)

    # 8. Device-bound + window always full: the device is the ceiling and
    #    the window is doing its job — STOP raising inflight; amortize
    #    per-dispatch overhead instead (decisive on high-latency links).
    if resource == "device":
        always_full = full_frac is not None and full_frac >= ALWAYS_FULL_FRAC
        if always_full and consider(
                "try-superstep", cur["superstep"] * 2 <= SUPERSTEP_MAX,
                f"device-bound, full_frac {full_frac}; "
                f"superstep {cur['superstep']}"):
            return result("try-superstep",
                          "device-bound with the window at capacity on "
                          f"{full_frac:.0%} of dispatches: a deeper window "
                          "cannot help — double superstep to amortize "
                          "per-dispatch overhead instead",
                          {"superstep": cur["superstep"] * 2})
        if always_full:
            return result("try-superstep-at-cap",
                          f"device-bound, window always full, superstep "
                          f"{cur['superstep']} at/past the "
                          f"{SUPERSTEP_MAX} cap: converged", converged=True)
        # Window not saturated: compute itself is the ceiling — which is
        #    exactly where the kernel geometry is the remaining lever
        #    With measured window headroom, propose the
        #    certified taller-window preset: fewer stable2 sort rows per
        #    chunk at a spill risk the exact fallback bounds (and the
        #    revert-geometry rule above unwinds if the probe spills).
        #    Combiner-on runs already run tall windows; skip them.
        occ = sig["window_occupancy"]
        if consider("try-geometry",
                    occ is not None and occ <= GEOMETRY_OCC_CEIL
                    and cur["geometry"] == "default"
                    and not sig["geometry_custom"]
                    and cur["combiner"] == "off",
                    f"device-bound, window occupancy {occ}, geometry "
                    f"{cur['geometry']!r}, combiner {cur['combiner']!r}"):
            return result("try-geometry",
                          "device-bound with the dispatch window "
                          f"unsaturated and kernel windows {occ:.0%} "
                          "full: compute is the ceiling and the windows "
                          "have headroom — try the certified "
                          f"{GEOMETRY_TALL!r} geometry (taller windows, "
                          "fewer aggregation-sort rows; the exact spill "
                          "fallback bounds the risk)",
                          {"geometry": GEOMETRY_TALL})
        return result("device-bound",
                      "the device is the measured critical path and the "
                      "window never saturated: compute itself is the "
                      "ceiling — converged", converged=True)

    # 9. Nothing actionable (retire-bound bookkeeping, unknown resource).
    return result("no-rule",
                  f"no move rule matches (resource={resource!r}, "
                  f"data={verdict!r}): converged", converged=True)


# -- the search loop ---------------------------------------------------------

def _key(knobs: dict):
    return tuple(int(knobs[k]) if k in _INT_KNOBS else str(knobs.get(k))
                 for k in KNOBS)


def search(measure: Callable[[dict], Iterable[dict]],
           start: Optional[dict] = None, *, budget: int = 6,
           backend: str = "auto") -> dict:
    """Walk the rule table: ``measure(knobs)`` runs one probe pass and
    returns its ledger records; :func:`propose` picks the next config;
    repeat until a proposal converges, a proposed config was already
    visited (the **oscillation guard** — two rules pulling a knob in
    opposite directions terminate instead of ping-ponging), or ``budget``
    passes are exhausted.  Every accepted config is validated through
    :func:`validate_knobs` BEFORE it is measured.

    Returns ``{winner, stopped, passes, trail}``: ``winner`` is a config
    actually MEASURED — a final proposal the budget left no pass to run
    stays in the trail but never becomes the winner (the recorded
    winner/GB-s pair must describe a config that was actually observed).
    ``stopped`` is one of ``converged`` / ``oscillation`` /
    ``budget-exhausted``; on an oscillation stop the tie is real — both
    configs' own verdicts voted to move away from them — so the winner
    is the measured config with the best run_end throughput among the
    passes (falling back to the last measured config when no pass
    carried one).  ``trail`` is the full per-pass proposal list — the
    machine-readable decision trail.
    """
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    cur = default_knobs()
    if start:
        cur.update({k: (int(v) if k in _INT_KNOBS else str(v))
                    for k, v in start.items() if k in cur})
    validate_knobs(cur, backend)
    seen = {_key(cur)}
    trail: List[dict] = []
    measured: List[tuple] = []  # (knobs, run_end gb_per_s or None) per pass
    win_idx = 0
    stopped = "budget-exhausted"
    for _ in range(budget):
        records = list(measure(dict(cur)))
        prop = propose(records, current=cur)
        trail.append(prop)
        measured.append((dict(cur), prop["signals"].get("gb_per_s")))
        win_idx = len(measured) - 1
        if prop["converged"]:
            stopped = "converged"
            break
        nxt = {k: prop["proposal"][k] for k in KNOBS}
        validate_knobs(nxt, backend)
        if _key(nxt) in seen:
            prop["oscillation"] = True
            stopped = "oscillation"
            # An oscillation is a genuine tie: each side's own verdict
            # voted to leave it.  Break it with the one signal the rule
            # table deliberately ignores — measured throughput (later
            # pass wins a throughput tie).
            rated = [(g, i) for i, (_, g) in enumerate(measured)
                     if g is not None]
            if rated:
                win_idx = max(rated)[1]
            break
        seen.add(_key(nxt))
        if len(trail) >= budget:
            # Budget exhausted: the accepted proposal would never be
            # measured — stop at the measured config instead of advancing.
            break
        cur = nxt
    # winner and winner_gbps come from the SAME pass, so a recorded
    # config/value pair always describes one observed run (on an
    # oscillation stop the last pass's throughput belongs to the losing
    # config — returning it would misprice the winner).
    winner, winner_gbps = measured[win_idx]
    return {"tuner_version": TUNER_VERSION, "winner": winner,
            "winner_gbps": winner_gbps, "stopped": stopped,
            "passes": len(trail), "trail": trail}
