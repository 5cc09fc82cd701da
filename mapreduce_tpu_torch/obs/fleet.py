"""Fleet observability: merge per-host ledger shards into one cross-host
timeline with straggler and collective accounting.

The port's copy of the JAX package's ``obs/fleet.py`` (stdlib only, the
same rules and output).  ``run_job_global`` writes one shard ledger per
host (``<ledger>.h<p>.jsonl``) beside the coordinator's main file; each
shard's lifecycle stamps come from that process's own
``time.perf_counter``.  This module:

* **aligns** the shards onto one time base: each shard's ``run_start``
  carries a ``clock`` {wall, mono} pair sampled when the world formed
  (``parallel.distributed.run_epoch``), so every monotonic stamp rebases
  to the shared wall clock (``aligned = stamp + (wall - mono)``); when a
  shard lacks the pair the raw stamps are kept and the artifact says
  ``aligned: false``;
* **reconstructs** per-host resource lanes through
  :func:`timeline.reconstruct` (``with_collective=True``);
* computes the **straggler decomposition**: per-superstep host skew
  (latest minus earliest ``token_ready_at``), the slowest host and each
  host's lag;
* accounts the **collective** time (the finish intervals, per host and
  fleet mean, and the share that window-boundary overlap hid);
* gives the **fleet_bottleneck** verdict: ``straggler-bound``,
  ``collective-bound`` or ``balanced`` (neither clears 10 % of the fleet
  span), with the projected saving, which the autotuner's rule 0 reads;
* classifies **host imbalance** from per-host counters through
  :func:`datahealth.classify_fleet`;
* renders the fleet as Chrome trace-event JSON, one Perfetto pid per
  host and one tid per lane.

Each shard contributes its last run instance unless a ``run_id`` is
given.  The merged record stream (``--merged``) is deterministic: shard
streams in host order plus one synthesized ``fleet`` record, which the
autotuner's ``derive_signals`` reads.  ``--selftest`` runs the
checked-in two-host shard fixtures (``tools/fixtures/fleet_ledger.h*
.jsonl``, data files read by path) against hand arithmetic.

Usage::

    python -m mapreduce_tpu_torch.obs.fleet RUN.jsonl            # summary
    python -m mapreduce_tpu_torch.obs.fleet RUN.jsonl --json     # artifact
    python -m mapreduce_tpu_torch.obs.fleet RUN.jsonl --trace out.json
    python -m mapreduce_tpu_torch.obs.fleet RUN.jsonl --merged m.jsonl
    python -m mapreduce_tpu_torch.obs.fleet a.h0.jsonl a.h1.jsonl
    python -m mapreduce_tpu_torch.obs.fleet --selftest
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from mapreduce_tpu_torch.obs import datahealth, timeline
from mapreduce_tpu_torch.obs import ledger as ledger_mod

#: Recoverable seconds (straggler skew or collective time) below this
#: share of the fleet span read as ``balanced``: the fleet is within 10%
#: of its balance ceiling and the verdict should not send anyone chasing
#: noise (the timeline verdict's converged threshold, applied fleet-wide).
FLEET_MIN_FRAC = 0.10

#: Monotonic-stamp fields rebased by clock alignment (group lifecycle +
#: collective intervals).  Unknown future stamp fields stay untouched —
#: a reader must never guess a field's clock.
ALIGN_FIELDS = ("read_at", "staged_at", "dispatched_at", "token_ready_at",
                "retired_at", "h2d_done_at", "started_at", "ended_at")

_SHARD_RE = re.compile(r"\.h(\d+)\.jsonl$")


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def read_jsonl(path: str) -> List[dict]:
    """Parse a shard file through the one tolerant JSONL reader
    (``obs/ledger.read_ledger``: unparseable lines are crash forensics,
    not errors), keeping dict records only."""
    return [r for r in ledger_mod.read_ledger(path) if isinstance(r, dict)]


def shard_paths(ledger_path: str) -> Dict[int, str]:
    """Discover ``<ledger>.h<p>.jsonl`` shard files next to a main ledger
    path (which itself need not exist)."""
    out: Dict[int, str] = {}
    for p in glob_mod.glob(glob_mod.escape(ledger_path) + ".h*.jsonl"):
        m = _SHARD_RE.search(p)
        if m:
            out[int(m.group(1))] = p
    return out


def load_shards(paths: Iterable[str]) -> Dict[int, List[dict]]:
    """Explicit shard files -> ``{host: records}``.  The host index comes
    from the ``.h<p>.jsonl`` suffix when present, else from position (a
    mode-(a) per-host ledger is a shard at a user-chosen path)."""
    out: Dict[int, List[dict]] = {}
    for i, p in enumerate(paths):
        m = _SHARD_RE.search(p)
        host = int(m.group(1)) if m else i
        while host in out:  # positional fallback collision: next free slot
            host += 1
        out[host] = read_jsonl(p)
    return out


def split_instances(records: Iterable[dict]) \
        -> List[Tuple[Optional[str], int, List[dict]]]:
    """An append-mode record stream -> ``[(run_id, instance, records)]``
    in first-appearance order — the CANONICAL run-instance splitter
    (``obs/history.py`` consumes this one rule, as the JAX package's
    report tools do).

    Instances, not just ids: the documented multi-host contract passes
    the SAME ``run_id`` to every process, ledger files are append-mode,
    and a crash+relaunch recovery appends a second run under that id —
    every ``run_start`` opens a NEW instance, so the crashed attempt and
    its recovery never fuse into one corrupt view (a file's records are
    sequential: one writer, runs never interleave)."""
    out: List[Tuple[Optional[str], int, List[dict]]] = []
    current: Dict = {}  # run_id -> index of its open instance
    for r in records:
        if not isinstance(r, dict):
            continue
        rid = r.get("run_id")
        if r.get("kind") == "run_start" or rid not in current:
            current[rid] = len(out)
            out.append((rid, sum(1 for x in out if x[0] == rid), []))
        out[current[rid]][2].append(r)
    return out


def run_status(completed: bool, failures: int) -> str:
    """The ONE completed/crashed/in-flight rule (a ``run_end`` record =
    completed; a ``failure`` record with no ``run_end`` after = crashed;
    neither = still going, or the process died without the failure path
    running).  The ``obs/history.py`` digests classify through this
    predicate."""
    if completed:
        return "completed"
    return "crashed" if failures else "in-flight"


def select_run(records: List[dict],
               run_id: Optional[str] = None) -> Tuple[Optional[str],
                                                      List[dict]]:
    """One shard's records of one RUN INSTANCE: ``run_id`` when given
    (its last instance), else the shard's last instance overall —
    derived from :func:`split_instances`."""
    runs = split_instances(records)
    if run_id is not None:
        mine = [r for r in runs if r[0] == run_id]
        return run_id, (mine[-1][2] if mine else [])
    if not runs:
        return None, []
    rid, _, recs = runs[-1]
    return rid, recs


def clock_offset(records: Iterable[dict]) -> Optional[float]:
    """This shard's monotonic->wall offset from its run_start ``clock``
    pair, or None when the shard predates the v7 stamp."""
    for r in records:
        if r.get("kind") != "run_start":
            continue
        clock = r.get("clock")
        if isinstance(clock, dict):
            wall, mono = _num(clock.get("wall")), _num(clock.get("mono"))
            if wall is not None and mono is not None:
                return wall - mono
        return None
    return None


def align(records: List[dict], offset: float) -> List[dict]:
    """Copies of ``records`` with every monotonic stamp field rebased by
    ``offset`` (no-op copies at offset 0)."""
    if not offset:
        return [dict(r) for r in records]
    out = []
    for r in records:
        r = dict(r)
        for f in ALIGN_FIELDS:
            v = _num(r.get(f))
            if v is not None:
                r[f] = round(v + offset, 6)
        out.append(r)
    return out


def _select_aligned(by_host: Dict[int, List[dict]],
                    run_id: Optional[str] = None):
    """``{host: records}`` -> ``({host: (run_id, aligned records)},
    aligned_flag)`` — the shared selection + alignment step.  Alignment
    applies only when EVERY participating shard carries a clock pair
    (mixing rebased and raw stamps would fabricate skew)."""
    sel: Dict[int, Tuple[Optional[str], List[dict]]] = {}
    for h in sorted(by_host):
        rid, recs = select_run(by_host[h], run_id)
        if recs:
            sel[h] = (rid, recs)
    if not sel:
        return {}, False
    offsets = {h: clock_offset(recs) for h, (_, recs) in sel.items()}
    aligned = all(offsets[h] is not None for h in sel)
    return {h: (rid, align(recs, offsets[h] if aligned else 0.0))
            for h, (rid, recs) in sel.items()}, aligned


def _intervals(recs: List[dict], rid: Optional[str]):
    """All absolute (aligned) lane intervals of one host's run — the
    span/trace raw material: ``[(lane, start, end, record), ...]``."""
    out = []
    for rec in timeline.iter_groups(recs, rid):
        iv = timeline.group_intervals(rec)
        if iv:
            for lane, (s, e) in iv.items():
                out.append((lane, s, e, rec))
    for rec in timeline.iter_collectives(recs, rid):
        iv = timeline.collective_interval(rec)
        if iv is not None:
            out.append(("collective", iv[0], iv[1], rec))
    return out


def _overlap_seconds(spans, others) -> float:
    """Seconds of ``spans`` covered by the union of ``others`` — the
    overlap-HIDDEN share of a host's collective time: a
    window-boundary partial merge in flight while the host's other lanes
    stay busy costs no exclusive wall-clock, so the fleet verdict charges
    only the visible remainder."""
    if not spans or not others:
        return 0.0
    merged: List[List[float]] = []
    for s, e in sorted(others):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for s, e in spans:
        for ms, me in merged:
            lo, hi = max(s, ms), min(e, me)
            if lo < hi:
                total += hi - lo
    return total


def fleet_view(by_host: Dict[int, List[dict]],
               run_id: Optional[str] = None, *,
               selected=None) -> Optional[dict]:
    """Shard records -> the fleet artifact (see module docstring), or
    None when no shard carries usable records.  ``selected`` lets a
    caller reuse one :func:`_select_aligned` result across view/trace/
    merge (alignment deep-copies every record — do it once)."""
    sel, aligned = selected if selected is not None \
        else _select_aligned(by_host, run_id)
    if not sel:
        return None
    hosts = sorted(sel)
    arts = {h: timeline.reconstruct(recs, run_id=rid, with_collective=True)
            for h, (rid, recs) in sel.items()}

    # Per-superstep straggler decomposition: each host's observed finish
    # (token_ready_at) per step_first, on the shared clock.
    finishes: Dict[int, Dict[int, float]] = {}
    per_host: Dict[str, dict] = {}
    all_iv: List = []
    for h in hosts:
        rid, recs = sel[h]
        iv = _intervals(recs, rid)
        all_iv.extend(iv)
        groups = bytes_total = host_bytes = 0
        have_host_bytes = False
        for rec in timeline.iter_groups(recs, rid):
            t = _num(rec.get("token_ready_at"))
            sf = rec.get("step_first")
            if t is not None and isinstance(sf, int):
                finishes.setdefault(sf, {})[h] = t
            groups += 1
            bytes_total += int(_num(rec.get("group_bytes")) or 0)
            hb = _num(rec.get("host_bytes"))
            if hb is not None:
                have_host_bytes = True
                host_bytes += int(hb)
        coll_spans = [(s, e) for lane, s, e, _ in iv if lane == "collective"]
        other_spans = [(s, e) for lane, s, e, _ in iv
                       if lane != "collective"]
        coll = sum(e - s for s, e in coll_spans)
        # Overlap accounting: window-boundary partial merges
        # run while the map lanes are still busy — that hidden share
        # costs no exclusive wall-clock, so the verdict below charges
        # only the visible remainder (the total stays in collective_s).
        hidden = _overlap_seconds(coll_spans, other_spans)
        tokens = sum(int(_num(r.get("tokens")) or 0) for r in recs
                     if r.get("kind") == "data")
        art = arts.get(h)
        per_host[str(h)] = {
            "run_id": rid,
            "groups": groups,
            "group_bytes": bytes_total,
            "host_bytes": host_bytes if have_host_bytes else None,
            "tokens": tokens or None,
            "device_busy_s": (art or {}).get("lane_busy_s", {}).get(
                "device", 0.0),
            "collective_s": round(coll, 6),
            "collective_hidden_s": round(hidden, 6),
            "collective_visible_s": round(coll - hidden, 6),
            "bottleneck": ((art or {}).get("bottleneck") or {}).get(
                "resource"),
        }
    if not all_iv:
        return None
    t0 = min(s for _, s, _, _ in all_iv)
    t_end = max(e for _, _, e, _ in all_iv)
    span = t_end - t0

    supersteps = []
    lag: Dict[int, float] = {h: 0.0 for h in hosts}
    slow_wins: Dict[int, int] = {h: 0 for h in hosts}
    total_skew = 0.0
    for sf in sorted(finishes):
        f = finishes[sf]
        if len(f) < 2:
            continue
        fastest, latest = min(f.values()), max(f.values())
        slowest = min(h for h, t in f.items() if t == latest)
        skew = latest - fastest
        total_skew += skew
        slow_wins[slowest] += 1
        for h, t in f.items():
            lag[h] += t - fastest
        supersteps.append({"step_first": sf, "hosts": len(f),
                           "skew_s": round(skew, 6),
                           "slowest_host": slowest})
    slowest_host = max(hosts, key=lambda h: (lag[h], -h)) \
        if total_skew > 0 else None

    coll_per_host = {str(h): per_host[str(h)]["collective_s"] for h in hosts}
    coll_vals = [v for v in coll_per_host.values() if v]
    coll_mean = sum(coll_vals) / len(coll_vals) if coll_vals else 0.0
    vis_vals = [per_host[str(h)]["collective_visible_s"] for h in hosts
                if per_host[str(h)]["collective_s"]]
    vis_mean = sum(vis_vals) / len(vis_vals) if vis_vals else 0.0

    straggler_s = round(total_skew, 6)
    collective_s = round(coll_mean, 6)
    # The verdict charges only the VISIBLE collective share: seconds a
    # window-boundary partial merge spent overlapped with busy map lanes
    # are already paid for, and switching strategy cannot win them back.
    visible_s = round(vis_mean, 6)
    hidden_s = round(collective_s - visible_s, 6)
    if span > 0 and straggler_s >= visible_s \
            and straggler_s / span > FLEET_MIN_FRAC:
        # Saving capped at the span: per-superstep skews are summed, and
        # a consistently slow host can accumulate more lag-seconds than
        # the concurrent wall-clock they could ever give back.
        verdict, saving = "straggler-bound", min(straggler_s, span)
        detail = (f"host skew costs {straggler_s:.3f}s of the "
                  f"{span:.3f}s fleet span "
                  f"({100 * straggler_s / span:.0f}%): host "
                  f"{slowest_host} ran latest on "
                  f"{slow_wins.get(slowest_host, 0)}/{len(supersteps)} "
                  "supersteps — a perfectly balanced fleet saves "
                  f"~{straggler_s:.3f}s; rebalance the data before "
                  "touching collective strategy")
    elif span > 0 and visible_s > straggler_s \
            and visible_s / span > FLEET_MIN_FRAC:
        verdict, saving = "collective-bound", visible_s
        detail = (f"the collective finish costs {visible_s:.3f}s of "
                  f"the {span:.3f}s fleet span "
                  f"({100 * visible_s / span:.0f}%), more than the "
                  f"{straggler_s:.3f}s host skew — the reduction "
                  "strategy/schedule is the lever (ROADMAP item 3)")
        if hidden_s > 0:
            detail += (f" (a further {hidden_s:.3f}s of collective time "
                       "already hides inside the map stream)")
    else:
        verdict, saving = "balanced", max(straggler_s, visible_s)
        detail = (f"neither host skew ({straggler_s:.3f}s) nor the "
                  f"visible collective finish ({visible_s:.3f}s) clears "
                  f"{FLEET_MIN_FRAC:.0%} of the {span:.3f}s fleet span")
        if hidden_s > 0:
            detail += (f" — window-boundary overlap hides {hidden_s:.3f}s "
                       f"of the {collective_s:.3f}s total collective time "
                       "inside the map stream")

    imbalance_counters = {
        h: {k: v for k, v in (("bytes", per_host[str(h)]["host_bytes"]),
                              ("tokens", per_host[str(h)]["tokens"]))
            if v is not None}
        for h in hosts}
    imbalance = datahealth.classify_fleet(imbalance_counters)

    processes = next((r.get("processes") for _, recs in sel.values()
                      for r in recs if r.get("kind") == "run_start"
                      and _num(r.get("processes")) is not None), None)
    return {
        "hosts": hosts,
        "processes": processes,
        "aligned": aligned,
        "run_ids": {str(h): sel[h][0] for h in hosts},
        "t0": round(t0, 6),
        "span_s": round(span, 6),
        "per_host": per_host,
        "supersteps": supersteps,
        "straggler": {
            "total_skew_s": straggler_s,
            "supersteps": len(supersteps),
            "slowest_host": slowest_host,
            "slowest_wins": slow_wins.get(slowest_host, 0)
            if slowest_host is not None else 0,
            "per_host_lag_s": {str(h): round(lag[h], 6) for h in hosts},
        },
        "collective": {"mean_s": collective_s,
                       "visible_mean_s": visible_s,
                       "hidden_mean_s": hidden_s,
                       "per_host_s": coll_per_host},
        "fleet_bottleneck": {
            "verdict": verdict,
            "projected_saving_s": round(saving, 6),
            "straggler_s": straggler_s,
            "collective_s": collective_s,
            "collective_visible_s": visible_s,
            "collective_hidden_s": hidden_s,
            "span_s": round(span, 6),
            "detail": detail,
        },
        "imbalance": imbalance,
    }


def fleet_record(view: dict) -> dict:
    """The synthesized ``fleet`` ledger record a merged file carries —
    what ``tuning.derive_signals`` reads ``fleet_bottleneck`` from."""
    hosts = view["hosts"]
    return {"kind": "fleet",
            "run_id": view["run_ids"].get(str(hosts[0])) if hosts else None,
            "hosts": hosts,
            "fleet_bottleneck": view["fleet_bottleneck"],
            "straggler": view["straggler"],
            "imbalance": view["imbalance"]}


def merged_records(by_host: Dict[int, List[dict]],
                   run_id: Optional[str] = None, *,
                   selected=None, view=None) -> List[dict]:
    """The deterministic merged record stream: every shard's selected run
    (clock-aligned), concatenated in host order, plus the ``fleet``
    record last.  Two invocations over the same shards produce identical
    bytes when serialized line-by-line (the byte-stability contract).
    ``selected``/``view`` reuse already-computed selection/artifact."""
    selected = selected if selected is not None \
        else _select_aligned(by_host, run_id)
    sel, _ = selected
    out: List[dict] = []
    for h in sorted(sel):
        out.extend(sel[h][1])
    if view is None:
        view = fleet_view(by_host, run_id, selected=selected)
    if view is not None:
        out.append(fleet_record(view))
    return out


# -- Chrome trace rendering (one pid per host) -------------------------------

def to_chrome_trace(by_host: Dict[int, List[dict]],
                    run_id: Optional[str] = None, *,
                    selected=None, view=None) -> Optional[dict]:
    """Shard records -> Chrome trace-event JSON: one **pid per host**
    (``host <h>``), one **tid per resource lane** inside it (reader /
    staging / h2d / device / retire / collective), complete slices per
    group lifecycle interval on the shared fleet clock.  The
    ``otherData.fleet_bottleneck`` dict carries the verdict.
    ``selected``/``view`` reuse already-computed selection/artifact."""
    selected = selected if selected is not None \
        else _select_aligned(by_host, run_id)
    if view is None:
        view = fleet_view(by_host, run_id, selected=selected)
    if view is None:
        return None
    sel, _ = selected
    t0 = view["t0"]
    tid = {lane: i for i, lane in enumerate(timeline.FLEET_LANES)}
    events: List[dict] = []
    named_threads = set()
    for idx, h in enumerate(sorted(sel)):
        pid = idx + 1
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"host {h}"}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "args": {"sort_index": pid}})
        rid, recs = sel[h]
        for lane, s, e, rec in _intervals(recs, rid):
            if (pid, tid[lane]) not in named_threads:
                named_threads.add((pid, tid[lane]))
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tid[lane], "args": {"name": lane}})
            if lane == "collective":
                name = f"collective {rec.get('op', 'finish')}"
                args = {k: rec.get(k) for k in ("op", "strategy")
                        if rec.get(k) is not None}
            else:
                label = (f"g{rec.get('step_first', '?')}-"
                         f"{rec.get('step_last', '?')}")
                name = f"{timeline._SLICE[lane]} {label}"
                args = {k: rec.get(k) for k in
                        ("step_first", "step_last", "steps", "group_bytes",
                         "host_bytes", "retries", "retire_wait_s")
                        if rec.get(k) is not None}
            events.append({"ph": "X", "cat": "lane", "name": name,
                           "pid": pid, "tid": tid[lane],
                           "ts": round((s - t0) * 1e6, 3),
                           "dur": round((e - s) * 1e6, 3), "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"hosts": view["hosts"],
                          "run_ids": view["run_ids"],
                          "fleet_bottleneck": view["fleet_bottleneck"],
                          "imbalance": view["imbalance"]}}


# -- discovery + rendering ---------------------------------------------------

def from_ledger(ledger_path: str,
                run_id: Optional[str] = None) -> Optional[dict]:
    """Convenience: discover ``<ledger>.h*.jsonl`` shards next to a main
    ledger and build the fleet view — None when no shards exist (the
    single-host case ``obs_report`` degrades on)."""
    paths = shard_paths(ledger_path)
    if not paths:
        return None
    return fleet_view({h: read_jsonl(p) for h, p in paths.items()}, run_id)


def render(view: dict, out) -> None:
    hosts = ", ".join(f"h{h}" for h in view["hosts"])
    out.write(f"fleet: {len(view['hosts'])} hosts ({hosts}), "
              f"span {view['span_s']:.3f}s, "
              f"{'aligned' if view['aligned'] else 'UNALIGNED'} clocks\n")
    for h in view["hosts"]:
        p = view["per_host"][str(h)]
        out.write(f"  h{h}: {p['groups']} groups, device busy "
                  f"{p['device_busy_s']:.3f}s, collective "
                  f"{p['collective_s']:.3f}s")
        if p.get("collective_hidden_s"):
            out.write(f" ({p['collective_hidden_s']:.3f}s overlapped)")
        if p.get("host_bytes") is not None:
            out.write(f", host bytes {p['host_bytes']}")
        if p.get("bottleneck"):
            out.write(f", bottleneck {p['bottleneck']}")
        out.write("\n")
    st = view["straggler"]
    if st["supersteps"]:
        out.write(f"  straggler: total skew {st['total_skew_s']:.3f}s "
                  f"across {st['supersteps']} supersteps; slowest host "
                  f"{st['slowest_host']} "
                  f"({st['slowest_wins']}/{st['supersteps']})\n")
    out.write(f"  collective: mean {view['collective']['mean_s']:.3f}s")
    if view["collective"].get("hidden_mean_s"):
        out.write(f" ({view['collective']['hidden_mean_s']:.3f}s hidden "
                  "by window-boundary overlap)")
    out.write("\n")
    bn = view["fleet_bottleneck"]
    out.write(f"  fleet bottleneck: {bn['verdict']} — {bn['detail']}\n")
    imb = view["imbalance"]
    for f in imb.get("flags", []):
        out.write(f"  FLEET {f['flag']}: {f['detail']}\n")


# -- selftest ----------------------------------------------------------------

def _fixture_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, os.pardir, "tools", "fixtures")


def selftest() -> int:
    """Merge the checked-in two-host shard fixtures and assert the
    hand-computed skew/verdict arithmetic, merge determinism, alignment,
    the synthesized collective-bound/balanced cases, and forward compat."""
    fdir = _fixture_dir()
    main_path = os.path.join(fdir, "fleet_ledger.jsonl")
    by_host = {h: read_jsonl(p) for h, p in shard_paths(main_path).items()}
    assert sorted(by_host) == [0, 1], f"two shard fixtures expected: {by_host.keys()}"

    view = fleet_view(by_host)
    assert view is not None and view["hosts"] == [0, 1], view
    assert view["aligned"] is True and view["processes"] == 2, view
    # Hand arithmetic (offsets: h0 wall 1000 - mono 100 = +900, h1 +500):
    # finishes h0 = 1001.0/1002.0/1003.0, h1 = 1001.5/1002.8/1003.7 ->
    # skews 0.5/0.8/0.7, total 2.0; h1 latest on all 3 supersteps.
    st = view["straggler"]
    assert [s["skew_s"] for s in view["supersteps"]] == [0.5, 0.8, 0.7], \
        view["supersteps"]
    assert st["total_skew_s"] == 2.0 and st["slowest_host"] == 1, st
    assert st["slowest_wins"] == 3 and st["per_host_lag_s"]["0"] == 0.0, st
    # Span: earliest read 1000.0 -> latest collective end 1004.05.
    assert view["span_s"] == 4.05, view["span_s"]
    # Collective: 0.3 s on each host, mean 0.3.
    assert view["collective"]["mean_s"] == 0.3, view["collective"]
    assert view["per_host"]["0"]["collective_s"] == 0.3
    # Device busy: h0 3x0.85 = 2.55, h1 1.3+1.15+0.75 = 3.2.
    assert view["per_host"]["0"]["device_busy_s"] == 2.55, view["per_host"]
    assert view["per_host"]["1"]["device_busy_s"] == 3.2, view["per_host"]
    # Verdict: 2.0 s skew >= 0.3 s collective and 49% of the 4.05 s span.
    bn = view["fleet_bottleneck"]
    assert bn["verdict"] == "straggler-bound", bn
    assert bn["projected_saving_s"] == 2.0, bn
    assert "host 1 ran latest on 3/3" in bn["detail"], bn
    # Imbalance: host_bytes 12288 vs 24576 -> ratio 24576/18432 = 1.333;
    # tokens 3000 vs 6000 -> same ratio.  Both clear the 1.25 gate.
    imb = view["imbalance"]
    assert imb["verdict"] == "host-imbalance", imb
    assert imb["signals"]["bytes_ratio"] == round(24576 / 18432, 6), imb
    assert imb["signals"]["tokens_hot_host"] == 1, imb

    # Merge determinism: two invocations -> byte-identical artifacts AND
    # byte-identical merged record streams.
    a = json.dumps(fleet_view(by_host), sort_keys=True)
    b = json.dumps(fleet_view(
        {h: read_jsonl(p) for h, p in shard_paths(main_path).items()}),
        sort_keys=True)
    assert a == b, "fleet view must be byte-stable across merges"
    ma = "\n".join(json.dumps(r, sort_keys=True)
                   for r in merged_records(by_host))
    mb = "\n".join(json.dumps(r, sort_keys=True)
                   for r in merged_records(by_host))
    assert ma == mb and '"kind": "fleet"' in ma, \
        "merged stream must be byte-stable and carry the fleet record"

    # The fleet trace: one pid per host, lanes as tids, schema basics.
    trace = to_chrome_trace(by_host)
    pnames = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert sorted(pnames.values()) == ["host 0", "host 1"], pnames
    slices = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in slices), slices
    assert any(e["name"].startswith("collective") for e in slices), \
        "the collective lane must render"
    assert trace["otherData"]["fleet_bottleneck"]["verdict"] \
        == "straggler-bound"
    assert json.loads(json.dumps(trace)) == trace

    # Synthesized collective-bound case: negligible skew, fat finish.
    def g(h, sf, disp, ready):
        return {"run_id": "c", "kind": "group", "host": h, "step_first": sf,
                "step_last": sf, "group_bytes": 64, "staged_at": disp - 0.01,
                "dispatched_at": disp, "token_ready_at": ready,
                "retired_at": ready + 0.01}

    def rs(h):
        return {"run_id": "c", "kind": "run_start", "host": h,
                "processes": 2, "clock": {"wall": 50.0, "mono": 0.0}}

    coll = {0: [rs(0), g(0, 0, 1.0, 2.0),
                {"run_id": "c", "kind": "collective", "op": "finish",
                 "strategy": "tree", "started_at": 2.1, "ended_at": 3.6}],
            1: [rs(1), g(1, 0, 1.0, 2.01),
                {"run_id": "c", "kind": "collective", "op": "finish",
                 "strategy": "tree", "started_at": 2.1, "ended_at": 3.6}]}
    cview = fleet_view(coll)
    cbn = cview["fleet_bottleneck"]
    assert cbn["verdict"] == "collective-bound", cbn
    assert cbn["projected_saving_s"] == 1.5, cbn  # the 1.5 s finish
    assert cview["imbalance"]["verdict"] == "balanced", cview["imbalance"]

    # Overlap accounting: the same amount of collective time,
    # but shipped as a window-boundary partial merge that rides INSIDE
    # the map stream — the hidden share charges nothing and the verdict
    # flips to balanced.  Hand arithmetic: device lane 1.0-4.0, partial
    # 1.5-2.8 fully inside it (hidden 1.3), finish 4.05-4.25 exclusive
    # (visible 0.2); span 0.99-4.26 = 3.27, visible 0.2/3.27 = 6% < 10%.
    def co(op, s, e):
        return {"run_id": "o", "kind": "collective", "op": op,
                "strategy": "tree", "step": 0,
                "started_at": s, "ended_at": e}

    def rso(h):
        return {"run_id": "o", "kind": "run_start", "host": h,
                "processes": 2, "clock": {"wall": 50.0, "mono": 0.0}}

    def go(h):
        return {"run_id": "o", "kind": "group", "host": h, "step_first": 0,
                "step_last": 0, "group_bytes": 64, "staged_at": 0.99,
                "dispatched_at": 1.0, "token_ready_at": 4.0 + 0.01 * h,
                "retired_at": 4.01 + 0.01 * h}

    ov = {h: [rso(h), go(h), co("partial", 1.5, 2.8),
              co("finish", 4.05, 4.25)] for h in (0, 1)}
    oview = fleet_view(ov)
    oph = oview["per_host"]["0"]
    assert oph["collective_s"] == 1.5 and oph["collective_hidden_s"] == 1.3 \
        and oph["collective_visible_s"] == 0.2, oph
    assert oview["collective"]["visible_mean_s"] == 0.2 \
        and oview["collective"]["hidden_mean_s"] == 1.3, oview["collective"]
    obn = oview["fleet_bottleneck"]
    assert obn["verdict"] == "balanced", obn
    assert obn["collective_s"] == 1.5 and obn["collective_visible_s"] == 0.2, obn
    assert "overlap hides 1.300s" in obn["detail"], obn
    # The exclusive twin: the SAME 1.5 s of collective time, but the
    # partial fires after the map lanes drain -> all visible, and the
    # old collective-bound verdict comes back.
    ex = {h: [rso(h), go(h), co("partial", 4.3, 5.6),
              co("finish", 4.05, 4.25)] for h in (0, 1)}
    eview = fleet_view(ex)
    ebn = eview["fleet_bottleneck"]
    assert ebn["verdict"] == "collective-bound", ebn
    assert ebn["collective_hidden_s"] == 0.0 \
        and ebn["collective_visible_s"] == 1.5, ebn

    # Balanced: equal hosts, thin collective -> nothing clears 10%.
    bal = {0: [rs(0), g(0, 0, 1.0, 2.0)], 1: [rs(1), g(1, 0, 1.0, 2.0)]}
    bview = fleet_view(bal)
    assert bview["fleet_bottleneck"]["verdict"] == "balanced", bview
    assert bview["straggler"]["total_skew_s"] == 0.0

    # Unaligned degrade: strip one clock -> raw monotonic stamps, flagged.
    unal = {h: [dict(r) for r in recs] for h, recs in bal.items()}
    for r in unal[1]:
        r.pop("clock", None)
    uview = fleet_view(unal)
    assert uview is not None and uview["aligned"] is False, uview

    # Forward compat: the future-versioned fixture merges as one shard
    # (unknown kinds/fields skipped or carried, never an error).
    fut = os.path.join(fdir, "future_ledger.jsonl")
    fview = fleet_view(load_shards([fut]))
    assert fview is not None and fview["hosts"] == [0], fview
    assert fview["fleet_bottleneck"]["verdict"] in (
        "balanced", "collective-bound", "straggler-bound"), fview

    print("fleet selftest ok (2 hosts, skew "
          f"{st['total_skew_s']}s over {st['supersteps']} supersteps, "
          f"verdict {bn['verdict']}, imbalance {imb['verdict']}, "
          f"{len(slices)} trace slices, byte-stable merge, "
          "collective-bound/overlap-hidden/balanced/unaligned/future "
          "cases ok)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-host ledger shards into a "
                    "fleet timeline + straggler/collective verdict")
    ap.add_argument("ledgers", nargs="*",
                    help="main ledger path (shards discovered as "
                         "<ledger>.h*.jsonl) or explicit shard paths")
    ap.add_argument("--run-id", default=None,
                    help="run to merge (default: each shard's last run)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable fleet artifact")
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="also write the pid-per-host Chrome trace JSON")
    ap.add_argument("--merged", default=None, metavar="OUT",
                    help="also write the merged record stream (+ fleet "
                         "record) as JSONL")
    ap.add_argument("--selftest", action="store_true",
                    help="run against the checked-in fixtures and exit")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.ledgers:
        ap.error("a ledger path (or --selftest) is required")
    if len(args.ledgers) == 1 and not _SHARD_RE.search(args.ledgers[0]):
        paths = shard_paths(args.ledgers[0])
        if not paths:
            print(f"no shard files ({args.ledgers[0]}.h*.jsonl) found — "
                  "not a multi-host ledger?", file=sys.stderr)
            return 1
        by_host = {h: read_jsonl(p) for h, p in paths.items()}
    else:
        by_host = load_shards(args.ledgers)
    selected = _select_aligned(by_host, args.run_id)
    view = fleet_view(by_host, args.run_id, selected=selected)
    if view is None:
        print("no usable records in the shards", file=sys.stderr)
        return 1
    if args.merged:
        with open(args.merged, "w", encoding="utf-8") as f:
            for r in merged_records(by_host, args.run_id,
                                    selected=selected, view=view):
                f.write(json.dumps(r, sort_keys=True) + "\n")
    if args.trace:
        trace = to_chrome_trace(by_host, args.run_id,
                                selected=selected, view=view)
        with open(args.trace, "w", encoding="utf-8") as f:
            json.dump(trace, f)
    if args.json:
        print(json.dumps(view, sort_keys=True))
    else:
        render(view, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
