"""Measured pipeline timeline: per-resource lanes from a run ledger's
``group`` records.

The port's copy of :mod:`mapreduce_tpu.obs.timeline` (stdlib only, the
same rules and output), so a run on the card can print its own
critical-path verdict where the JAX package is not installed.  It turns
the lifecycle stamps of each retired group into:

* ``lanes``: merged busy intervals per resource, relative to the run's
  first stamp;
* ``overlap_s``: pairwise concurrency seconds between lanes;
* ``device_idle``: every gap between device intervals, blamed on the lane
  that covered most of it;
* ``bottleneck``: the lane with the most exclusive seconds (active while
  no other lane is) and the projected saving if it took no time.

==========  ===============================================================
lane        interval per group
==========  ===============================================================
reader      ``read_at -> staged_at``: the group's chunks leaving the
            prefetching reader and gathering into a group
staging     ``staged_at -> dispatched_at``: the H2D enqueue, the kernel
            launches and the map's one host read of each chunk
h2d         ``staged_at -> h2d_done_at``: only where the loop observed the
            copy complete (the last group, at the stream's end)
device      ``dispatched_at -> token_ready_at``: launch to the loop seeing
            the group's CUDA event complete (an upper bound: the event may
            have completed before the loop looked)
retire      ``token_ready_at -> retired_at``: retire bookkeeping
==========  ===============================================================

``reconstruct(..., with_collective=True)`` adds a ``collective`` lane from
the ``collective`` records (the finish), kept out of the ``bottleneck``
election.  :func:`to_chrome_trace` renders the same records as Chrome
trace-event JSON (Perfetto), and ``obs/fleet.py`` renders a fleet's.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

#: Resource lanes, in display/tie-break order.
LANES: Tuple[str, ...] = ("reader", "staging", "h2d", "device", "retire")

#: LANES plus the ``collective`` lane fed by the ``collective`` ledger
#: records (the observed finish interval): opt-in
#: (``with_collective=True``) and never in the ``bottleneck`` election,
#: which names the stream's bounding resource.
FLEET_LANES: Tuple[str, ...] = LANES + ("collective",)

#: Phase-delta fallback when a run carries no ``group`` records (batch
#: ledgers, pre-v2 ledgers, a live run before any group retired): which
#: resource lane each streaming phase blames.  ``dispatch`` maps to
#: device — a large dispatch share means the enqueue blocked on a full
#: device queue — and so do ``retire_wait``, ``compute_tail`` and the
#: legacy ``drain`` they decomposed from (the JAX package's table).
PHASE_LANE = {"read_wait": "reader", "stage": "staging",
              "dispatch": "device", "retire_wait": "device",
              "compute_tail": "device", "drain": "device",
              "h2d_tail": "h2d"}

_Interval = Tuple[float, float]


# -- interval arithmetic ----------------------------------------------------

def _merge(intervals: Iterable[_Interval]) -> List[_Interval]:
    """Sorted, coalesced intervals (touching intervals merge)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _total(intervals: Iterable[_Interval]) -> float:
    return sum(e - s for s, e in intervals)


def _intersection_s(a: List[_Interval], b: List[_Interval]) -> float:
    """Total intersection seconds of two MERGED interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _cover_s(intervals: List[_Interval], lo: float, hi: float) -> float:
    """Seconds of ``intervals`` falling inside ``[lo, hi]``."""
    tot = 0.0
    for s, e in intervals:
        s2, e2 = max(s, lo), min(e, hi)
        if e2 > s2:
            tot += e2 - s2
    return tot


def _exclusive_s(lanes: dict) -> dict:
    """Per-lane seconds active while NO other lane is (sweep over the
    merged intervals) — the measured critical-path attribution."""
    events = []
    for lane, intervals in lanes.items():
        for s, e in intervals:
            events.append((s, 0, lane))
            events.append((e, 1, lane))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    active = {lane: 0 for lane in lanes}
    excl = {lane: 0.0 for lane in lanes}
    prev: Optional[float] = None
    for t, kind, lane in events:
        if prev is not None and t > prev:
            on = [ln for ln, n in active.items() if n > 0]
            if len(on) == 1:
                excl[on[0]] += t - prev
        active[lane] += 1 if kind == 0 else -1
        prev = t
    return excl


# -- group records -> intervals ---------------------------------------------

def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) \
        else None


def group_intervals(rec: dict) -> Optional[dict]:
    """One ``group`` record's lane intervals (absolute monotonic seconds).
    Returns None for records missing the core lifecycle (forward compat:
    a future record shape is skipped, never an error); zero-length
    intervals are dropped."""
    s = _num(rec.get("staged_at"))
    d = _num(rec.get("dispatched_at"))
    t = _num(rec.get("token_ready_at"))
    e = _num(rec.get("retired_at"))
    if None in (s, d, t, e):
        return None
    out = {}
    r = _num(rec.get("read_at"))
    if r is not None and s > r:
        out["reader"] = (r, s)
    if d > s:
        out["staging"] = (s, d)
    if t > d:
        out["device"] = (d, t)
    if e > t:
        out["retire"] = (t, e)
    h = _num(rec.get("h2d_done_at"))
    if h is not None and h > s:
        out["h2d"] = (s, min(h, e))
    return out or None


def iter_groups(records: Iterable[dict],
                run_id: Optional[str] = None,
                host: Optional[int] = None) -> Iterator[dict]:
    """The ``group`` records of one run (the first run carrying any, when
    ``run_id`` is not given).  ``host`` keeps only records
    stamped with that process index — the per-host lane filter fleet
    merges reconstruct through.  Unknown kinds and malformed rows skip."""
    chosen = run_id
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "group":
            continue
        if host is not None and rec.get("host") != host:
            continue
        if chosen is None:
            chosen = rec.get("run_id")
        if rec.get("run_id") == chosen:
            yield rec


def iter_collectives(records: Iterable[dict],
                     run_id: Optional[str] = None,
                     host: Optional[int] = None) -> Iterator[dict]:
    """The ``collective`` records of one run, same selection
    rules as :func:`iter_groups`."""
    chosen = run_id
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "collective":
            continue
        if host is not None and rec.get("host") != host:
            continue
        if chosen is None:
            chosen = rec.get("run_id")
        if rec.get("run_id") == chosen:
            yield rec


def collective_interval(rec: dict) -> Optional[_Interval]:
    """One ``collective`` record's (started_at, ended_at) interval, or
    None when malformed/zero-length (forward compat: skip, never error)."""
    s, e = _num(rec.get("started_at")), _num(rec.get("ended_at"))
    if s is None or e is None or e <= s:
        return None
    return (s, e)


# -- the reconstruction -----------------------------------------------------

def reconstruct(records: Iterable[dict],
                run_id: Optional[str] = None,
                host: Optional[int] = None,
                with_collective: bool = False) -> Optional[dict]:
    """Ledger records -> the timeline artifact (see module docstring), or
    None when the run carries no usable ``group`` records (a ledger
    without them degrades to "no timeline", never to an error).

    ``host`` restricts the reconstruction to one process's
    records (fleet merges call this per host over clock-aligned shards);
    ``with_collective=True`` adds the ``collective`` lane from the run's
    ``collective`` records — visible in lanes/busy/overlap but excluded
    from the ``bottleneck`` election (see :data:`FLEET_LANES`).

    All times in the artifact are seconds relative to the run's first
    observed lifecycle timestamp (``t0``), rounded to microseconds.
    """
    if with_collective:
        records = list(records)  # a second pass reads the collectives
    groups = []
    for rec in iter_groups(records, run_id, host=host):
        iv = group_intervals(rec)
        if iv is not None:
            groups.append((rec, iv))
    if not groups:
        return None
    raw: dict = {lane: [] for lane in LANES}
    for _, iv in groups:
        for lane, span in iv.items():
            raw[lane].append(span)
    if with_collective:
        run = groups[0][0].get("run_id")
        coll = [collective_interval(rec)
                for rec in iter_collectives(records, run, host=host)]
        coll = [iv for iv in coll if iv is not None]
        if coll:
            raw["collective"] = coll
    t0 = min(s for spans in raw.values() for s, _ in spans)
    lanes = {lane: _merge([(s - t0, e - t0) for s, e in spans])
             for lane, spans in raw.items()}
    t_end = max(e for spans in lanes.values() for _, e in spans)

    busy = {lane: round(_total(spans), 6) for lane, spans in lanes.items()}
    overlap = {}
    present = [ln for ln in FLEET_LANES if lanes.get(ln)]
    for i, a in enumerate(present):
        for b in present[i + 1:]:
            overlap[f"{a}+{b}"] = round(
                _intersection_s(lanes[a], lanes[b]), 6)

    # Device-idle gaps, each attributed to the lane covering most of it.
    gaps = []
    blocked_on: dict = {}
    dev = lanes["device"]
    for (_, e0), (s1, _) in zip(dev, dev[1:]):
        best, best_cov = "idle", 0.0
        for lane in LANES:
            if lane == "device" or not lanes[lane]:
                continue
            cov = _cover_s(lanes[lane], e0, s1)
            if cov > best_cov + 1e-12:
                best, best_cov = lane, cov
        gaps.append({"start": round(e0, 6), "end": round(s1, 6),
                     "s": round(s1 - e0, 6), "blocking": best,
                     "blocking_s": round(best_cov, 6)})
        blocked_on[best] = round(blocked_on.get(best, 0.0) + (s1 - e0), 6)
    idle_total = round(sum(g["s"] for g in gaps), 6)

    excl = _exclusive_s(lanes)
    populated = [lane for lane in LANES if lanes[lane]]
    resource = max(populated, key=lambda ln: (excl[ln], busy[ln]))
    saving = excl[resource]
    span = t_end
    bottleneck = {
        "resource": resource,
        "busy_s": busy[resource],
        "exclusive_s": round(saving, 6),
        "projected_saving_s": round(saving, 6),
        "projected_span_s": round(span - saving, 6),
        "span_s": round(span, 6),
        "device_busy_s": busy.get("device", 0.0),
        "device_idle_s": idle_total,
        "detail": (f"{resource} is the measured critical path: "
                   f"{saving:.3f}s of the {span:.3f}s span is "
                   f"{resource}-exclusive — an infinitely fast {resource} "
                   f"saves ~{saving:.3f}s "
                   f"({100 * saving / span:.0f}% of span)" if span > 0
                   else f"{resource} (degenerate zero-length span)"),
    }
    return {
        "run_id": groups[0][0].get("run_id"),
        "groups": len(groups),
        "t0": round(t0, 6),
        "span_s": round(span, 6),
        "lanes": {lane: [[round(s, 6), round(e, 6)] for s, e in spans]
                  for lane, spans in lanes.items()},
        "lane_busy_s": busy,
        "exclusive_s": {lane: round(v, 6) for lane, v in excl.items()},
        "overlap_s": overlap,
        "device_idle": {"total_s": idle_total, "gaps": gaps,
                        "blocked_on": blocked_on},
        "bottleneck": bottleneck,
    }


# -- Chrome trace-event rendering -------------------------------------------

# Slice names per lane (what a Perfetto track shows on each group's slice).
_SLICE = {"reader": "read", "staging": "stage", "h2d": "h2d",
          "device": "compute", "retire": "retire",
          "collective": "collective"}


def to_chrome_trace(records: Iterable[dict],
                    run_id: Optional[str] = None) -> Optional[dict]:
    """Ledger records -> Chrome trace-event JSON (the JAX package's
    ``trace_export`` payload): one **pid per resource lane**, one **tid
    per group**, complete (``ph="X"``) slices for every lifecycle
    interval, flow arrows dispatch -> token_ready, and instant markers on
    the device lane for every attributed idle gap.  Open the written file
    in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.

    Returns None when the run has no usable ``group`` records.
    """
    records = list(records)
    art = reconstruct(records, run_id)
    if art is None:
        return None
    pid = {lane: i + 1 for i, lane in enumerate(LANES)}
    events = []
    for lane in LANES:
        events.append({"ph": "M", "name": "process_name", "pid": pid[lane],
                       "args": {"name": lane}})
        events.append({"ph": "M", "name": "process_sort_index",
                       "pid": pid[lane], "args": {"sort_index": pid[lane]}})
    t0 = art["t0"]

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    named_threads = set()
    for rec in iter_groups(records, art["run_id"]):
        iv = group_intervals(rec)
        if iv is None:
            continue
        gid = int(rec.get("step_first", 0))
        label = f"g{rec.get('step_first', '?')}-{rec.get('step_last', '?')}"
        args = {k: rec.get(k) for k in
                ("step_first", "step_last", "steps", "group_bytes",
                 "retries", "retire_wait_s") if rec.get(k) is not None}
        # Data-plane annotations: the group's spill/rescue/
        # occupancy counters ride every slice's args (click a slice in
        # Perfetto to see what the data did), and groups that took the
        # spill-fallback or rescue-escalation cond get an instant marker
        # on the device lane — the 2x-map-cost chunks are visible as
        # events, not just numbers.
        data = rec.get("data")
        if isinstance(data, dict):
            args["data"] = data
        for lane, (s, e) in iv.items():
            if (pid[lane], gid) not in named_threads:
                named_threads.add((pid[lane], gid))
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid[lane], "tid": gid,
                               "args": {"name": f"group {label}"}})
            events.append({"ph": "X", "cat": "lane",
                           "name": f"{_SLICE[lane]} {label}",
                           "pid": pid[lane], "tid": gid, "ts": us(s),
                           "dur": round((e - s) * 1e6, 3), "args": args})
        if isinstance(data, dict) and "device" in iv:
            marks = []
            if data.get("fallback_chunks"):
                marks.append(f"{data['fallback_chunks']} spill fallback(s)")
            if data.get("rescue_escalations"):
                marks.append(f"{data['rescue_escalations']} rescue "
                             "escalation(s)")
            if marks:
                events.append({"ph": "i", "s": "t", "cat": "data",
                               "name": f"data: {', '.join(marks)} {label}",
                               "pid": pid["device"], "tid": gid,
                               "ts": us(iv["device"][0]),
                               "args": dict(data)})
        # Flow arrow: the dispatch hand-off from the staging lane into the
        # device lane (binds to the enclosing slices at each end).
        if "staging" in iv and "device" in iv:
            events.append({"ph": "s", "cat": "dispatch", "name": "dispatch",
                           "id": gid, "pid": pid["staging"], "tid": gid,
                           "ts": us(iv["staging"][1])})
            events.append({"ph": "f", "bp": "e", "cat": "dispatch",
                           "name": "dispatch", "id": gid,
                           "pid": pid["device"], "tid": gid,
                           "ts": us(iv["device"][1])})
    for gap in art["device_idle"]["gaps"]:
        events.append({"ph": "i", "s": "p", "cat": "idle",
                       "name": f"device idle {gap['s']:.3f}s: "
                               f"blocked on {gap['blocking']}",
                       "pid": pid["device"], "tid": 0,
                       "ts": round(gap["start"] * 1e6, 3),
                       "args": dict(gap)})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"run_id": art["run_id"], "groups": art["groups"],
                          "bottleneck": art["bottleneck"]}}
