"""Run-history warehouse: ingest many run ledgers into one queryable
longitudinal index, and answer "what did runs like this one do before".

The port's copy of the JAX package's ``obs/history.py`` (stdlib only,
the same rules, keys and output):

* **ingest** a directory, glob or list of append-mode ledgers (unknown
  kinds and fields skip), per-host shard files merged through
  ``obs/fleet.py``, one digest per run INSTANCE (a crash and its
  relaunch under one run_id stay two);
* write a small on-disk index: ``<dir>/history.json`` (one compact row
  per run instance, grouped under its **config key**) plus one digest
  per run under ``<dir>/runs/<id>.json``, byte-stable across re-ingests;
* answer **longitudinal queries**: GB/s series, phase-share series and
  verdict streaks per config key;
* classify **drift**: ``regressing`` / ``improving`` / ``steady`` /
  ``config-drift`` (+ ``no-history``), each flag with its numbers;
* :func:`resolve_prior`, the one prior-run read: ``combiner='auto'``,
  ``geometry='auto'``, ``merge_strategy='auto'`` and the autotuner's
  ``derive_signals`` all resolve through it.

The config key is ``family/backend/corpus/geometry/combiner/map_impl``,
where ``corpus`` is a power-of-two size bucket plus the chunk size
(:func:`corpus_bucket`); drift is judged inside the wider
``family/backend/corpus`` group, where a stamp change between
consecutive runs reads as ``config-drift``.  ``--selftest`` runs the
checked-in fixtures (``tools/fixtures/``, data files read by path)
against hand arithmetic.

Usage::

    python -m mapreduce_tpu_torch.obs.history --index DIR LEDGER...
    python -m mapreduce_tpu_torch.obs.history --index DIR           # report
    python -m mapreduce_tpu_torch.obs.history --index DIR --drift
    python -m mapreduce_tpu_torch.obs.history --index DIR \\
        --series gb_per_s --key wordcount/pallas/b28-c4194304/default/off/split
    python -m mapreduce_tpu_torch.obs.history --selftest
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import hashlib
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from mapreduce_tpu_torch.obs import datahealth, timeline
from mapreduce_tpu_torch.obs import fleet as fleet_mod
from mapreduce_tpu_torch.obs import ledger as ledger_mod

#: Bumped when the index/digest schema changes shape.
HISTORY_VERSION = 1

#: |delta| of the latest run's GB/s vs the same-key baseline median that
#: makes a series ``regressing``/``improving`` (below it: ``steady`` —
#: run-to-run weather, not a trend worth a verdict).
DRIFT_FRAC = 0.10
#: How many prior same-key runs feed the baseline median.
DRIFT_WINDOW = 5

#: The streaming phases whose shares the digest keeps (the obs_report
#: bound-classification set — end-of-stream tails and reduce time the
#: stream END, not the steady state).
_STREAMING_PHASES = ("read_wait", "stage", "dispatch", "retire_wait")

#: Config stamps that participate in the config key beyond the group
#: (family/backend/corpus).  A change in any of them between consecutive
#: group runs is ``config-drift``.
_KEY_STAMPS = ("geometry", "combiner", "map_impl")


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def read_jsonl(path: str) -> List[dict]:
    """One ledger file through the one tolerant reader (unparseable
    lines are crash forensics, not errors), dict records only."""
    return [r for r in ledger_mod.read_ledger(path) if isinstance(r, dict)]


# -- run-instance splitting ---------------------------------------------------

def split_instances(records: Iterable[dict]) \
        -> List[Tuple[Optional[str], int, List[dict]]]:
    """An append-mode record stream -> ``[(run_id, instance, records)]``
    in first-appearance order.  Every ``run_start`` opens a NEW
    instance, so a crash+relaunch appending a second run under a shared
    run_id never fuses with its crashed attempt.  Delegates to the ONE
    canonical splitter in ``obs/fleet.py``."""
    return fleet_mod.split_instances(records)


# -- resolve_prior: the one prior-run read ------------------------------------

def run_view(records: Iterable[dict],
             run_id: Optional[str] = None) -> dict:
    """One run's view of a record stream — the selection
    ``tuning.derive_signals`` used to hand-roll: the chosen run_id (the
    first stamped record's when not given), every record carrying it,
    and — on a merged fleet stream (a synthesized ``fleet`` record
    present) — the records anchored on ONE host (the coordinator when
    present), because reconstructing a timeline from every host's
    records fuses the lanes into a chimera no host ran."""
    records = [r for r in records if isinstance(r, dict)]
    chosen = run_id
    if chosen is None:
        for r in records:
            if r.get("run_id") is not None:
                chosen = r.get("run_id")
                break
    recs = [r for r in records if r.get("run_id") == chosen]
    fleet = next((r for r in recs if r.get("kind") == "fleet"), None)
    if fleet is not None:
        stamped = sorted({r.get("host") for r in recs
                          if isinstance(r.get("host"), int)
                          and not isinstance(r.get("host"), bool)})
        if stamped:
            anchor = 0 if 0 in stamped else stamped[0]
            recs = [r for r in recs if r.get("host") in (anchor, None)]
    return {"run_id": chosen, "run_records": recs, "fleet": fleet}


def freshest_profile_geometry(profile_path: str, family: str = "wordcount",
                              presets=None, geometry_ok=None):
    """The geometry a searched ``tuned.json`` profile warm-starts
    (the ``geometry='auto'`` read): the freshest profile for
    ``family`` whose config carries a non-default geometry — its preset
    label (must be in ``presets`` when given) or spec dict (must pass
    ``geometry_ok`` when given).  No profile / no entry / unreadable
    file resolves to ``'default'`` — the degrade-to-off contract."""
    try:
        with open(profile_path, encoding="utf-8") as f:
            profiles = json.load(f).get("profiles", {})
    except (OSError, ValueError):
        return "default"
    mine = {key: entry for key, entry in profiles.items()
            if isinstance(entry, dict) and key.startswith(family)}
    for _key, entry in sorted(mine.items(),
                              key=lambda kv: kv[1].get("recorded_at") or "",
                              reverse=True):
        geom = (entry.get("config") or {}).get("geometry")
        if geom in (None, "default"):
            continue
        if isinstance(geom, str) and (presets is None or geom in presets):
            return geom
        if isinstance(geom, dict) and (geometry_ok is None
                                       or geometry_ok(geom)):
            return geom
    return "default"


def freshest_profile_merge_strategy(profile_path: str,
                                    mesh_label: Optional[str] = None,
                                    allowed=None,
                                    family: str = "wordcount-redplan"):
    """The merge strategy a planned ``tuned.json`` profile warm-starts
    (the ``merge_strategy='auto'`` read): the freshest
    ``tools/redplan.py --out`` winner — keys
    ``wordcount-redplan/static/<mesh-label>-cap<capacity>`` — whose
    planned mesh geometry matches.  ``mesh_label`` (a
    ``meshcost.MeshSpec.label()`` like ``'2dx4i'``) pins the exact
    geometry; ``allowed`` filters to strategies the RUNTIME mesh can
    execute (a ``hier-*`` winner planned over a 2-D fleet mesh is
    invalid on a 1-D runtime mesh, so a 1-D caller passes the
    single-axis set).  Returns ``(strategy, profile_key)``;
    ``(None, None)`` when nothing matches — the caller owns the loud
    fallback to ``'tree'``, so "no prior" stays distinguishable from
    "the planner picked tree"."""
    try:
        with open(profile_path, encoding="utf-8") as f:
            profiles = json.load(f).get("profiles", {})
    except (OSError, ValueError):
        return None, None
    mine = {key: entry for key, entry in profiles.items()
            if isinstance(entry, dict) and key.startswith(family)}
    for key, entry in sorted(mine.items(),
                             key=lambda kv: kv[1].get("recorded_at") or "",
                             reverse=True):
        label = (entry.get("mesh") or {}).get("label")
        if mesh_label is not None and label != mesh_label:
            continue
        strategy = (entry.get("config") or {}).get("merge_strategy")
        if not isinstance(strategy, str) or strategy == "auto":
            continue
        if allowed is not None and strategy not in allowed:
            continue
        return strategy, key
    return None, None


def resolve_prior(*, records: Optional[Iterable[dict]] = None,
                  run_id: Optional[str] = None,
                  profile_path: Optional[str] = None,
                  family: str = "wordcount",
                  presets=None, geometry_ok=None,
                  mesh_label: Optional[str] = None,
                  merge_allowed=None,
                  index_dir: Optional[str] = None,
                  config_key: Optional[str] = None,
                  group: Optional[str] = None) -> dict:
    """What did runs like this one do before — the ONE prior-run read.
    Three sources, any subset:

    * ``records`` (an append-mode ledger's records): the latest ``data``
      record and the combiner mode it resolves (exactly the old
      ``datahealth.resolve_combiner`` semantics: skew-hot -> hot-cache,
      anything else -> off), plus the single-run view
      (:func:`run_view`) ``derive_signals`` consumes;
    * ``profile_path`` (a searched ``tuned.json``): the geometry it
      warm-starts (exactly the old ``analysis.geometry.resolve_auto``
      semantics — pass ``presets``/``geometry_ok`` for validation),
      plus the merge strategy the static reduction planner's freshest
      profile warm-starts (``mesh_label`` pins the planned
      mesh geometry, ``merge_allowed`` restricts to strategies the
      runtime mesh can execute; no match resolves to ``'tree'`` with
      ``merge_strategy_profile=None``, so callers can announce the
      fallback loudly);
    * ``index_dir`` (+ ``config_key`` or ``group``): the warehouse
      prior — the latest matching index row and the group's drift
      verdict (the serving layer's warm-start / billing read).

    Returns ``{combiner, geometry, run_id, run_records, fleet,
    data_record, data_health, history}`` with every unrequested source's
    keys at their neutral value — absence of a prior is itself
    information, never an error."""
    out: dict = {"combiner": "off", "geometry": "default",
                 "merge_strategy": "tree", "merge_strategy_profile": None,
                 "run_id": run_id, "run_records": [], "fleet": None,
                 "data_record": None, "data_health": None, "history": None}
    if records is not None:
        records = [r for r in records if isinstance(r, dict)]
        out.update(run_view(records, run_id))
        rec = datahealth.latest_data_record(records)
        out["data_record"] = rec
        if rec is not None:
            out["data_health"] = datahealth.classify(rec)
            if out["data_health"]["verdict"] == "skew-hot":
                out["combiner"] = "hot-cache"
    if profile_path is not None:
        out["geometry"] = freshest_profile_geometry(
            profile_path, family, presets=presets, geometry_ok=geometry_ok)
        strategy, key = freshest_profile_merge_strategy(
            profile_path, mesh_label=mesh_label, allowed=merge_allowed)
        if strategy is not None:
            out["merge_strategy"] = strategy
            out["merge_strategy_profile"] = key
    if index_dir is not None:
        index = read_index(index_dir)
        if index is not None:
            rows = rows_for(index, key=config_key, group=group)
            out["history"] = {
                "rows": len(rows),
                "latest": rows[-1] if rows else None,
                "drift": classify_drift(
                    group_rows(index, rows[-1]["group"]) if rows
                    else []),
            }
    return out


# -- per-run digests ----------------------------------------------------------

def corpus_bucket(n_bytes, chunk_bytes=None) -> str:
    """The corpus-shape key component: a power-of-two size bucket
    (``b<k>``: 2^(k-1) < bytes <= 2^k) + the chunk geometry.  Runs "of
    the same shape" must share a bucket for their series to be
    comparable; exact byte counts would shatter every series."""
    n = _num(n_bytes)
    size = f"b{int(n - 1).bit_length()}" if n and n > 0 else "b0"
    c = _num(chunk_bytes)
    return f"{size}-c{int(c)}" if c else f"{size}-c?"


def _geometry_label(geom) -> str:
    """The compact geometry stamp for keying: a label string as-is, a
    spec dict as 'custom', absence as 'default' (pre-v6 ledgers)."""
    if isinstance(geom, str) and geom:
        return geom
    if isinstance(geom, dict):
        return "custom"
    return "default"


def digest_run(recs: List[dict], *, source: str, run_id,
               instance: int, fleet_view: Optional[dict] = None) -> dict:
    """One run instance's records -> the full digest the warehouse
    stores: identity + config stamps, outcome, throughput, phase shares,
    the timeline ``bottleneck``, the data-health classification, window
    stats, the last heartbeat (crashed/in-flight runs keep their cursor,
    ledger v8), and fleet verdicts on sharded runs."""
    view = run_view(recs, run_id)
    recs = view["run_records"]
    start = next((r for r in recs if r.get("kind") == "run_start"), None)
    end = next((r for r in recs if r.get("kind") == "run_end"), None)
    failures = [r for r in recs if r.get("kind") == "failure"]
    # The one completed/crashed/in-flight rule (fleet.run_status),
    # stored as the two booleans the index rows filter on.
    status = fleet_mod.run_status(end is not None, len(failures))
    steps = [r for r in recs if r.get("kind") == "step"]
    progress = [r for r in recs if r.get("kind") == "progress"]
    ts = _num((start or {}).get("ts"))
    if ts is None:
        ts = next((_num(r.get("ts")) for r in recs
                   if _num(r.get("ts")) is not None), 0.0)

    phases: dict = {}
    if end and isinstance(end.get("phases"), dict):
        phases = {k: v for k, v in end["phases"].items()
                  if _num(v) is not None}
    else:  # crashed run: fold the step deltas that DID land
        for r in steps:
            for k, v in (r.get("phases") or {}).items():
                if _num(v) is not None:
                    phases[k] = phases.get(k, 0.0) + float(v)
    stream_total = sum(phases.get(k, 0.0) for k in _STREAMING_PHASES)
    shares = {k: round(phases[k] / stream_total, 4)
              for k in _STREAMING_PHASES
              if phases.get(k) and stream_total > 0}

    bytes_done = _num((end or {}).get("bytes"))
    if bytes_done is None:
        cursors = [_num(r.get("cursor_bytes")) for r in steps + progress]
        cursors = [c for c in cursors if c is not None]
        bytes_done = max(cursors) if cursors else None
    # `or None`: run_end rounds gb_per_s coarsely enough that a slow CPU
    # smoke run reads 0.0 — recompute from bytes/elapsed rather than let
    # a rounded zero pollute the drift baselines.
    gb_per_s = _num((end or {}).get("gb_per_s")) or None
    if gb_per_s is None:
        el = _num((end or {}).get("elapsed_s"))
        if bytes_done and el:
            gb_per_s = round(bytes_done / 1e9 / el, 9)

    art = timeline.reconstruct(recs, run_id=view["run_id"])
    bottleneck = None
    if art is not None:
        bn = art["bottleneck"]
        span = _num(bn.get("span_s"))
        saving = _num(bn.get("projected_saving_s"))
        bottleneck = {"resource": bn.get("resource"),
                      "projected_saving_s": saving,
                      "saving_frac": round(saving / span, 4)
                      if span and saving is not None else None}
    health = datahealth.classify_run(recs, run_id=view["run_id"])

    pipeline = (end or {}).get("pipeline") \
        if isinstance((end or {}).get("pipeline"), dict) else None
    tune = next((r for r in recs if r.get("kind") == "tune"), None)
    fleet_rec = view["fleet"]
    fleet_bn = None
    if fleet_view is not None:
        fleet_bn = (fleet_view.get("fleet_bottleneck") or {}).get("verdict")
    elif fleet_rec is not None:
        fleet_bn = (fleet_rec.get("fleet_bottleneck") or {}).get("verdict")

    last_progress = None
    if progress:
        p = progress[-1]
        last_progress = {k: p.get(k) for k in
                         ("cursor_bytes", "total_bytes", "frac",
                          "gb_per_s", "eta_s", "inflight_depth",
                          "groups_retired")
                         if p.get(k) is not None}

    digest = {
        "history_version": HISTORY_VERSION,
        "source": os.path.basename(source),
        "run_id": run_id,
        "instance": int(instance),
        "ts": round(ts, 6),
        "family": (start or {}).get("job"),
        "driver": (start or {}).get("driver"),
        "backend": (start or {}).get("backend"),
        "devices": (start or {}).get("devices"),
        "chunk_bytes": (start or {}).get("chunk_bytes"),
        "superstep": (start or {}).get("superstep"),
        "map_impl": (start or {}).get("map_impl") or "split",
        "combiner": (start or {}).get("combiner") or "off",
        "geometry": _geometry_label((start or {}).get("geometry")),
        "ledger_version": (start or {}).get("ledger_version"),
        "processes": (start or {}).get("processes"),
        "completed": status == "completed",
        "crashed": status == "crashed",
        "failures": len(failures),
        "steps": sum(int(_num(r.get("steps")) or 1) for r in steps),
        "bytes": int(bytes_done) if bytes_done is not None else None,
        "wall_s": _num((end or {}).get("elapsed_s")),
        "gb_per_s": gb_per_s,
        "phases": {k: round(v, 4) for k, v in sorted(phases.items())},
        "phase_shares": shares,
        "bottleneck": bottleneck,
        "data_verdict": (health or {}).get("verdict"),
        "data_signals": (health or {}).get("signals"),
        "pipeline": {k: pipeline.get(k) for k in
                     ("inflight_groups", "prefetch_depth", "depth_max",
                      "full_frac", "overlap_fraction")} if pipeline else None,
        "tune_rule": (tune or {}).get("rule"),
        "fleet_bottleneck": fleet_bn,
        "progress": last_progress,
    }
    digest["id"] = _digest_id(digest)
    digest["key"] = config_key(digest)
    digest["group"] = group_key(digest)
    return digest


def _digest_id(digest: dict) -> str:
    """Deterministic identity of one ingested run instance: same source
    file + run instance -> same id on every re-ingest (the byte-stable
    dedupe anchor)."""
    ident = [digest.get("source"), digest.get("run_id"),
             digest.get("instance"), digest.get("ts")]
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]


def config_key(digest: dict) -> str:
    """``family/backend/corpus/geometry/combiner/map_impl`` — the "runs
    like this one" key longitudinal series live under."""
    return "/".join([
        str(digest.get("family") or "?"),
        str(digest.get("backend") or "?"),
        corpus_bucket(digest.get("bytes"), digest.get("chunk_bytes")),
        str(digest.get("geometry") or "default"),
        str(digest.get("combiner") or "off"),
        str(digest.get("map_impl") or "split"),
    ])


def group_key(digest: dict) -> str:
    """``family/backend/corpus`` — the drift-comparison group (stamp
    changes inside it read as config-drift, not as a trend)."""
    return "/".join(config_key(digest).split("/")[:3])


# -- ingest + the on-disk index ----------------------------------------------

def expand_sources(sources: Iterable[str]) -> List[str]:
    """Files, directories and globs -> main ledger paths, sorted and
    deduplicated.  Shard files (``*.h<p>.jsonl``) are folded under their
    main ledger (which need not exist — shard-only fleets still ingest);
    non-jsonl files are skipped."""
    out = set()
    for src in sources:
        if os.path.isdir(src):
            paths = glob_mod.glob(os.path.join(glob_mod.escape(src),
                                               "*.jsonl"))
        else:
            paths = glob_mod.glob(src) or [src]
        for p in paths:
            m = fleet_mod._SHARD_RE.search(p)
            out.add(p[:m.start()] if m else p)
    return sorted(out)


def ledger_runs(path: str):
    """One main ledger path -> ``([(run_id, instance, records)], by_host)``.
    Shards next to the path merge through the existing ``obs/fleet.py``
    machinery; a shard-only fleet (no main file) ingests its merged
    stream instead."""
    records = read_jsonl(path) if os.path.exists(path) else []
    shard = fleet_mod.shard_paths(path)
    by_host = {h: read_jsonl(p) for h, p in shard.items()} if shard else {}
    runs = split_instances(records)
    if not runs and by_host:
        runs = split_instances(fleet_mod.merged_records(by_host))
    return runs, by_host


def index_row(digest: dict) -> dict:
    """The compact per-run row ``history.json`` keeps (the full digest
    lives in ``runs/<id>.json``)."""
    row = {k: digest.get(k) for k in
           ("id", "source", "run_id", "instance", "ts", "key", "group",
            "family", "backend", "chunk_bytes", "geometry", "combiner",
            "map_impl", "completed", "crashed", "bytes", "gb_per_s",
            "data_verdict", "fleet_bottleneck")}
    row["bottleneck"] = (digest.get("bottleneck") or {}).get("resource")
    return row


def ingest(sources: Iterable[str], index_dir: str) -> dict:
    """Ingest ledgers into the warehouse at ``index_dir`` and return the
    updated index.  Idempotent and byte-stable: the digest id is a pure
    function of (source basename, run_id, instance, start ts), rows
    merge by id, and both files serialize with sorted keys — re-ingesting
    the same ledgers rewrites identical bytes."""
    index = read_index(index_dir) or {"history_version": HISTORY_VERSION,
                                      "runs": {}, "keys": {}}
    runs_dir = os.path.join(index_dir, "runs")
    os.makedirs(runs_dir, exist_ok=True)
    for path in expand_sources(sources):
        runs, by_host = ledger_runs(path)
        for rid, instance, recs in runs:
            fview = None
            if by_host:
                try:
                    fview = fleet_mod.fleet_view(by_host, rid)
                except Exception:
                    fview = None  # a broken shard must not block ingest
            digest = digest_run(recs, source=path, run_id=rid,
                                instance=instance, fleet_view=fview)
            dpath = os.path.join(runs_dir, digest["id"] + ".json")
            body = json.dumps(digest, sort_keys=True, indent=1) + "\n"
            if not os.path.exists(dpath) \
                    or open(dpath, encoding="utf-8").read() != body:
                with open(dpath, "w", encoding="utf-8") as f:
                    f.write(body)
            index["runs"][digest["id"]] = index_row(digest)
    index["keys"] = _rebuild_keys(index["runs"])
    write_index(index_dir, index)
    return index


def _row_order(row: dict):
    return (row.get("ts") or 0.0, str(row.get("run_id")),
            row.get("instance") or 0, row.get("id"))


def _rebuild_keys(rows: dict) -> dict:
    keys: Dict[str, List[str]] = {}
    for rid in sorted(rows, key=lambda i: _row_order(rows[i])):
        keys.setdefault(rows[rid]["key"], []).append(rid)
    return keys


def index_path(index_dir: str) -> str:
    return os.path.join(index_dir, "history.json")


def read_index(index_dir: str) -> Optional[dict]:
    try:
        with open(index_path(index_dir), encoding="utf-8") as f:
            index = json.load(f)
    except (OSError, ValueError):
        return None
    return index if isinstance(index, dict) else None


def write_index(index_dir: str, index: dict) -> str:
    os.makedirs(index_dir, exist_ok=True)
    p = index_path(index_dir)
    with open(p, "w", encoding="utf-8") as f:
        f.write(json.dumps(index, sort_keys=True, indent=1) + "\n")
    return p


def read_digest(index_dir: str, digest_id: str) -> Optional[dict]:
    try:
        with open(os.path.join(index_dir, "runs", digest_id + ".json"),
                  encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# -- longitudinal queries -----------------------------------------------------

def rows_for(index: dict, key: Optional[str] = None,
             group: Optional[str] = None) -> List[dict]:
    """The compact rows under one config key (exact) or one drift group
    (prefix), in time order."""
    rows = index.get("runs", {})
    if key is not None:
        ids = index.get("keys", {}).get(key, [])
        return [rows[i] for i in ids if i in rows]
    out = [r for r in rows.values()
           if group is None or r.get("group") == group]
    return sorted(out, key=_row_order)


def group_rows(index: dict, group: str) -> List[dict]:
    return rows_for(index, group=group)


def series(index: dict, key: str, metric: str = "gb_per_s") -> List[list]:
    """``[(ts, value)]`` for one metric under one config key — the
    longitudinal throughput/size series.  None values skip (a crashed
    run has no GB/s; its absence is visible in the row count)."""
    return [[row.get("ts"), row.get(metric)]
            for row in rows_for(index, key=key)
            if row.get(metric) is not None]


def phase_share_series(index_dir: str, index: dict, key: str,
                       phase: str) -> List[list]:
    """``[(ts, share)]`` of one streaming phase under one config key —
    read from the full digests (shares are not in the compact rows)."""
    out = []
    for row in rows_for(index, key=key):
        d = read_digest(index_dir, row["id"]) or {}
        v = (d.get("phase_shares") or {}).get(phase)
        if v is not None:
            out.append([row.get("ts"), v])
    return out


def verdict_streak(index: dict, key: str,
                   field: str = "data_verdict") -> dict:
    """The trailing run of identical verdicts under one config key —
    ``{value, length, runs}`` (a skew-hot streak of 4 is a corpus fact;
    a streak of 1 after 3 cleans is weather)."""
    rows = rows_for(index, key=key)
    vals = [r.get(field) for r in rows]
    streak = 0
    for v in reversed(vals):
        if not vals or v != vals[-1]:
            break
        streak += 1
    return {"value": vals[-1] if vals else None, "length": streak,
            "runs": len(vals)}


# -- the drift classifier -----------------------------------------------------

def classify_drift(rows: List[dict]) -> dict:
    """Time-ordered rows of ONE drift group -> ``{verdict, flags,
    signals}`` (the ``datahealth`` rule-table discipline):

    ==============  ========================================================
    verdict         rule (first match wins)
    ==============  ========================================================
    no-history      fewer than 2 runs in the group — nothing to compare
    config-drift    the latest run's config key differs from the previous
                    run's (geometry/combiner/map_impl/chunk stamp moved):
                    the series is not comparable across the boundary
    regressing      latest GB/s < (1 - DRIFT_FRAC) x the median of up to
                    DRIFT_WINDOW prior same-key runs
    improving       latest GB/s > (1 + DRIFT_FRAC) x that baseline median
    steady          neither side clears DRIFT_FRAC (or throughput is
                    missing on either side — absence is not a trend)
    ==============  ========================================================

    Every flag carries the measured numbers, so downstream readers
    (benchwatch rows, the serving layer) read arithmetic, not
    adjectives."""
    rows = sorted(rows, key=_row_order)
    flags: List[dict] = []
    signals: dict = {"runs": len(rows)}

    def done(verdict):
        return {"verdict": verdict, "flags": flags, "signals": signals}

    if len(rows) < 2:
        return done("no-history")
    latest, prev = rows[-1], rows[-2]
    signals["latest_run_id"] = latest.get("run_id")
    signals["latest_key"] = latest.get("key")
    if latest.get("key") != prev.get("key"):
        # Rows come from ONE group (family/backend/corpus pinned by the
        # group key, chunk geometry included in the corpus bucket), so a
        # key change can only be one of the _KEY_STAMPS moving.
        moved = [s for s in _KEY_STAMPS
                 if latest.get(s) != prev.get(s)]
        signals["previous_key"] = prev.get("key")
        flags.append({
            "flag": "config-drift",
            "detail": (f"config moved between the last two runs "
                       f"({', '.join(moved)}): "
                       f"{prev.get('key')} -> {latest.get('key')} — "
                       "the throughput series is not comparable across "
                       "this boundary; judge drift after the new key "
                       "accumulates runs")})
        return done("config-drift")
    base_rows = [r for r in rows[:-1]
                 if r.get("key") == latest.get("key")][-DRIFT_WINDOW:]
    baseline = _median([r.get("gb_per_s") for r in base_rows
                        if _num(r.get("gb_per_s")) is not None])
    latest_gbps = _num(latest.get("gb_per_s"))
    signals["baseline_gbps"] = baseline
    signals["latest_gbps"] = latest_gbps
    signals["window"] = len(base_rows)
    if baseline is None or latest_gbps is None or baseline <= 0:
        return done("steady")
    delta = (latest_gbps - baseline) / baseline
    signals["delta_frac"] = round(delta, 4)
    if delta < -DRIFT_FRAC:
        flags.append({
            "flag": "regressing",
            "detail": (f"latest run {latest.get('run_id')} measured "
                       f"{latest_gbps:.4f} GB/s, {abs(delta):.0%} below "
                       f"the {len(base_rows)}-run baseline median "
                       f"{baseline:.4f} GB/s (gate {DRIFT_FRAC:.0%})")})
        return done("regressing")
    if delta > DRIFT_FRAC:
        flags.append({
            "flag": "improving",
            "detail": (f"latest run {latest.get('run_id')} measured "
                       f"{latest_gbps:.4f} GB/s, {delta:.0%} above the "
                       f"{len(base_rows)}-run baseline median "
                       f"{baseline:.4f} GB/s (gate {DRIFT_FRAC:.0%})")})
        return done("improving")
    return done("steady")


def _median(xs: List) -> Optional[float]:
    xs = sorted(float(x) for x in xs)
    n = len(xs)
    if not n:
        return None
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def drift_report(index: dict) -> dict:
    """Every drift group's verdict — the benchwatch ``history-report``
    payload."""
    groups = sorted({r.get("group") for r in index.get("runs", {}).values()
                     if r.get("group")})
    return {g: classify_drift(group_rows(index, g)) for g in groups}


# -- rendering ----------------------------------------------------------------

def render(index: dict, out, index_dir: Optional[str] = None,
           drift: bool = False) -> None:
    rows = index.get("runs", {})
    keys = index.get("keys", {})
    out.write(f"history: {len(rows)} runs under {len(keys)} config keys"
              + (f" ({index_path(index_dir)})" if index_dir else "") + "\n")
    for key in sorted(keys):
        krows = rows_for(index, key=key)
        gbps = [r.get("gb_per_s") for r in krows
                if r.get("gb_per_s") is not None]
        # %.4g, not %.4f: a CPU smoke run's 3e-06 GB/s must not render
        # as an alarming 0.0000.
        tail = f", latest {gbps[-1]:.4g} GB/s" if gbps else ""
        done = sum(1 for r in krows if r.get("completed"))
        out.write(f"  {key}: {len(krows)} runs ({done} completed){tail}\n")
    if drift:
        for g, verdict in sorted(drift_report(index).items()):
            out.write(f"  drift {g}: {verdict['verdict']}\n")
            for f in verdict["flags"]:
                out.write(f"    {f['flag']}: {f['detail']}\n")


# -- selftest ----------------------------------------------------------------

def _fixture_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, os.pardir, "tools", "fixtures")


def selftest() -> int:
    """Ingest the checked-in fixtures into a temp warehouse and assert
    the hand arithmetic: instance counts, config keys, the drift rule
    table, byte-stable re-ingest, fleet merge, forward compat, and the
    resolve_prior parity contracts."""
    import io
    import shutil
    import tempfile

    fdir = _fixture_dir()
    d = tempfile.mkdtemp(prefix="history_selftest_")
    try:
        # --- ingest the drift fixture: 4 same-key runs + a geometry flip.
        idx = ingest([os.path.join(fdir, "history_ledger.jsonl")], d)
        rows = idx["runs"]
        assert len(rows) == 6, f"6 run instances expected, got {len(rows)}"
        # The pallas series: 4 runs under ONE key (family wordcount,
        # backend pallas, 256 MiB corpus bucket b28 at 4 MiB chunks).
        pkey = "wordcount/pallas/b28-c4194304/default/off/split"
        prows = rows_for(idx, key=pkey)
        assert [r["run_id"] for r in prows] == ["h1", "h2", "h3", "h4"], prows
        s = series(idx, pkey)
        assert [v for _, v in s] == [0.1, 0.098, 0.101, 0.085], s
        # Drift: baseline median of (0.100, 0.098, 0.101) = 0.100;
        # latest 0.085 is 15% below — regressing at the 10% gate.
        dv = classify_drift(group_rows(idx, "wordcount/pallas/b28-c4194304"))
        assert dv["verdict"] == "regressing", dv
        assert dv["signals"]["baseline_gbps"] == 0.1, dv["signals"]
        assert dv["signals"]["delta_frac"] == round(-0.015 / 0.1, 4), dv
        assert "15% below" in dv["flags"][0]["detail"], dv["flags"]
        # The xla pair: g2 flipped geometry default -> tall512, so the
        # group verdict is config-drift and the two runs hold two keys.
        gv = classify_drift(group_rows(idx, "wordcount/xla/b28-c4194304"))
        assert gv["verdict"] == "config-drift", gv
        assert "geometry" in gv["flags"][0]["detail"], gv["flags"]
        assert len(rows_for(idx, group="wordcount/xla/b28-c4194304")) == 2
        # Verdict streak on the pallas key: all four runs classified
        # skew-hot -> a streak of 4.
        st = verdict_streak(idx, pkey)
        assert st == {"value": "skew-hot", "length": 4, "runs": 4}, st

        # --- synthesized rule-table walks (improving / steady /
        # no-history), datahealth-fixture style.
        def row(i, gbps, key="f/b/c/g/o/m"):
            return {"id": f"r{i}", "ts": float(i), "run_id": f"r{i}",
                    "instance": 0, "key": key, "group": "f/b/c",
                    "gb_per_s": gbps}

        up = [row(i, g) for i, g in enumerate([0.10, 0.10, 0.12])]
        assert classify_drift(up)["verdict"] == "improving"
        flat = [row(i, g) for i, g in enumerate([0.10, 0.10, 0.105])]
        assert classify_drift(flat)["verdict"] == "steady"
        assert classify_drift([row(0, 0.1)])["verdict"] == "no-history"
        assert classify_drift([])["verdict"] == "no-history"
        nog = [row(0, 0.1), row(1, None)]
        assert classify_drift(nog)["verdict"] == "steady", \
            "missing throughput is not a trend"

        # --- byte-stable re-ingest: same files in -> identical bytes out.
        before = open(index_path(d), encoding="utf-8").read()
        idx2 = ingest([os.path.join(fdir, "history_ledger.jsonl")], d)
        after = open(index_path(d), encoding="utf-8").read()
        assert before == after, "re-ingest must rewrite identical bytes"
        assert len(idx2["runs"]) == 6
        did = prows[-1]["id"]
        dig = read_digest(d, did)
        assert dig is not None and dig["gb_per_s"] == 0.085, dig
        assert dig["data_verdict"] == "skew-hot", dig
        assert dig["phase_shares"], dig

        # --- the whole fixture zoo ingests: mini (10 instances incl. the
        # in-flight v8 fixture10 and the v9 chaotic fixture11), the clean
        # counterpart, the two-host fleet shards (fleet verdict
        # attached), the future ledger (unknown kinds/fields
        # skip-or-consume, never an error).
        z = tempfile.mkdtemp(prefix="history_zoo_")
        try:
            zidx = ingest([os.path.join(fdir, "mini_ledger.jsonl"),
                           os.path.join(fdir, "mini_ledger_b.jsonl"),
                           os.path.join(fdir, "fleet_ledger.jsonl"),
                           os.path.join(fdir, "future_ledger.jsonl")], z)
            zrows = sorted(zidx["runs"].values(), key=_row_order)
            by_run = {r["run_id"]: r for r in zrows}
            assert len([r for r in zrows
                        if r["source"] == "mini_ledger.jsonl"]) == 10
            assert by_run["fixture10"]["completed"] is False
            # The v9 chaotic run: fault/degrade records skip-
            # or-consume through ingest; the run digests as completed.
            assert by_run["fixture11"]["completed"] is True
            zdig = read_digest(z, by_run["fixture10"]["id"])
            assert zdig["progress"]["frac"] == 0.5, zdig["progress"]
            assert by_run["fleet01"]["fleet_bottleneck"] \
                == "straggler-bound", by_run["fleet01"]
            assert by_run["future01"]["completed"] is True
            assert by_run["fixture05"]["data_verdict"] == "spill-bound"
            # Directory ingest expands the same main ledgers (shards fold
            # under fleet_ledger.jsonl instead of ingesting separately).
            srcs = expand_sources([fdir])
            assert os.path.join(fdir, "fleet_ledger.jsonl") in srcs
            assert not any(".h0." in s or ".h1." in s for s in srcs), srcs
        finally:
            shutil.rmtree(z, ignore_errors=True)

        # --- resolve_prior parity: the three reads it replaced.
        # (1) combiner: latest data record's verdict decides, exactly
        # datahealth.resolve_combiner.
        skew = {"kind": "data", "run_id": "a", "tokens": 1000,
                "top_count": 200, "chunks": 1}
        clean = {"kind": "data", "run_id": "b", "tokens": 1000,
                 "top_count": 10, "chunks": 1}
        for recs in ([skew], [clean], [], [clean, skew], [skew, clean]):
            assert resolve_prior(records=recs)["combiner"] \
                == datahealth.resolve_combiner(recs), recs
        # (2) geometry: freshest non-default profile entry decides.
        prof = os.path.join(d, "tuned.json")
        with open(prof, "w", encoding="utf-8") as f:
            json.dump({"profiles": {
                "wordcount-geometry/zipf": {
                    "recorded_at": "2026-01-01T00:00:00",
                    "config": {"geometry": "tall512"}},
                "wordcount/zipf": {
                    "recorded_at": "2026-02-01T00:00:00",
                    "config": {"geometry": "default"}}}}, f)
        p = resolve_prior(profile_path=prof, presets={"tall512"})
        assert p["geometry"] == "tall512", p
        assert resolve_prior(profile_path=os.path.join(d, "nope.json"))[
            "geometry"] == "default"
        # (2b) merge strategy: freshest redplan profile whose
        # planned mesh matches; mesh-label/allowed misses fall back to
        # 'tree' with a None profile key (the caller's loud-fallback cue).
        with open(prof, "w", encoding="utf-8") as f:
            json.dump({"profiles": {
                "wordcount-redplan/static/2dx4i-cap262144": {
                    "recorded_at": "2026-03-01T00:00:00",
                    "mesh": {"label": "2dx4i"},
                    "config": {"merge_strategy": "hier-kr-tree"}},
                "wordcount-redplan/static/8i-cap262144": {
                    "recorded_at": "2026-02-01T00:00:00",
                    "mesh": {"label": "8i"},
                    "config": {"merge_strategy": "keyrange"}}}}, f)
        mp = resolve_prior(profile_path=prof)
        assert mp["merge_strategy"] == "hier-kr-tree" \
            and mp["merge_strategy_profile"] \
            == "wordcount-redplan/static/2dx4i-cap262144", mp
        mp = resolve_prior(profile_path=prof, mesh_label="8i")
        assert mp["merge_strategy"] == "keyrange", mp
        mp = resolve_prior(profile_path=prof,
                           merge_allowed=("tree", "gather", "keyrange"))
        assert mp["merge_strategy"] == "keyrange", mp  # hier-* filtered
        mp = resolve_prior(profile_path=prof, mesh_label="16i")
        assert mp["merge_strategy"] == "tree" \
            and mp["merge_strategy_profile"] is None, mp
        # (3) the derive_signals run view: first stamped run chosen, and
        # a merged fleet stream anchors on host 0 (never the chimera).
        merged = [
            {"run_id": "m", "kind": "run_start", "host": 0},
            {"run_id": "m", "kind": "run_start", "host": 1},
            {"run_id": "m", "kind": "group", "host": 1, "staged_at": 1.0,
             "dispatched_at": 1.1, "token_ready_at": 2.0,
             "retired_at": 2.1, "step_first": 0},
            {"run_id": "m", "kind": "fleet",
             "fleet_bottleneck": {"verdict": "straggler-bound"}},
        ]
        v = resolve_prior(records=merged)
        assert v["run_id"] == "m" and v["fleet"] is not None
        assert all(r.get("host") in (0, None) for r in v["run_records"]), \
            v["run_records"]
        # (4) the warehouse prior: latest row + group drift for a key.
        wp = resolve_prior(index_dir=d, config_key=pkey)
        assert wp["history"]["rows"] == 4
        assert wp["history"]["latest"]["run_id"] == "h4"
        assert wp["history"]["drift"]["verdict"] == "regressing"

        # --- render path runs clean.
        buf = io.StringIO()
        render(idx, buf, index_dir=d, drift=True)
        body = buf.getvalue()
        assert "6 runs" in body and "drift wordcount/pallas" in body, body
        assert "regressing" in body and "config-drift" in body, body
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print("history selftest ok (6 fixture runs, regressing/config-drift/"
          "improving/steady/no-history verdicts, streak 4, byte-stable "
          "re-ingest, 10-instance mini zoo + fleet + future flow-through, "
          "resolve_prior parity x4 + redplan merge-strategy warm-start)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ingest run ledgers into the run-history "
                    "warehouse and query it")
    ap.add_argument("sources", nargs="*",
                    help="ledger files, directories, or globs to ingest "
                         "(omit to just report on an existing index)")
    ap.add_argument("--index", default=None, metavar="DIR",
                    help="warehouse directory (history.json + runs/)")
    ap.add_argument("--key", default=None,
                    help="config key for --series / resolve-prior queries")
    ap.add_argument("--series", default=None, metavar="METRIC",
                    help="print the [ts, value] series of a row metric "
                         "(e.g. gb_per_s) under --key")
    ap.add_argument("--drift", action="store_true",
                    help="print per-group drift verdicts")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable index/report")
    ap.add_argument("--selftest", action="store_true",
                    help="run against the checked-in fixtures and exit")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.index:
        ap.error("--index DIR is required (or --selftest)")
    if args.sources:
        index = ingest(args.sources, args.index)
    else:
        index = read_index(args.index)
        if index is None:
            print(f"no history index at {index_path(args.index)}",
                  file=sys.stderr)
            return 1
    if args.series:
        if not args.key:
            ap.error("--series requires --key")
        print(json.dumps(series(index, args.key, args.series)))
        return 0
    if args.json:
        payload = {"index": index}
        if args.drift:
            payload["drift"] = drift_report(index)
        print(json.dumps(payload, sort_keys=True))
        return 0
    render(index, sys.stdout, index_dir=args.index, drift=args.drift)
    return 0


if __name__ == "__main__":
    sys.exit(main())
