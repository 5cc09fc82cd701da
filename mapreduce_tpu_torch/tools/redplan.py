"""Static reduction-strategy planner over the link model.

Counterpart of the repository's ``tools/redplan.py``, over the port's link
levels (:mod:`...analysis.meshcost`: ``hbm`` within a card, ``nvlink``
between the cards of a node, ``net`` between nodes):

1. **Enumerate, price, rank** (default): every feasible merge strategy for
   a fleet shape (``--processes`` x ``--local-devices``, ``--capacity``
   table rows), priced over the alpha-beta link hierarchy with the rates
   of ``analysis/baselines/measured_link_rates.json``, printed as one
   ranked JSON artifact.  ``--ledger`` seeds the plan from a real run:
   topology and incumbent strategy from its ``run_start``, the key
   distribution (``top_mass`` derates keyrange past the skew-hot
   threshold, ``table_occupancy`` feeds the budget-spill check) through
   :func:`...obs.history.resolve_prior`, and the ``fleet_bottleneck``
   verdict of :func:`...obs.fleet.fleet_view`, so a fleet bound elsewhere
   is not told to chase the merge first.  Flags win over the ledger.
2. ``--gate``: each ranked strategy through the baseline-free analysis
   passes over a fleet-twin ``WordCountJob`` (``analysis_fleet`` and
   ``analysis_merge_strategy``), traced on rank 0 of an in-process fake
   world of the planned shape, so the collective-cost pass prices the
   finish that strategy builds.
3. ``--check``: the fleet ledger's measured finish-collective seconds
   against the model's price for the same strategy, topology and
   capacity; past :data:`CHECK_RATIO` either way it flags and exits 1: the
   rates file does not describe the links that ledger ran on.

``--out tuned.json`` writes the winner as a profile
(``wordcount-redplan/static/<mesh>-cap<capacity>``, with the port's mesh
labels, e.g. ``2nx4v``), which ``--merge-strategy auto`` resolves.

Usage::

    python -m mapreduce_tpu_torch.tools.redplan --processes 2 \\
        --local-devices 4 --capacity 32768 --top-mass 0.3
    python -m mapreduce_tpu_torch.tools.redplan --ledger runs/fleet.jsonl
    python -m mapreduce_tpu_torch.tools.redplan --gate
    python -m mapreduce_tpu_torch.tools.redplan --check --ledger L

It runs on the card's host (``--gate`` traces there), or with
``--platform cpu`` on the CPU; without a card and without it, it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mapreduce_tpu_torch.analysis import meshcost as mc
from mapreduce_tpu_torch.tools import autotune

#: Modelled-vs-measured disagreement past which ``--check`` flags (either
#: direction): the model is a congestion-free bound, so 2x is honest
#: slack; beyond it the rates file and the links the ledger ran on are
#: different machines.
CHECK_RATIO = 2.0


# -- the measured prior: one fleet ledger -> planner inputs --------------------

def ledger_prior(ledger_path: str) -> dict:
    """A fleet ledger (sharded ``<path>.h<p>.jsonl`` or one file) -> the
    planner's measured inputs: topology and incumbent strategy from
    ``run_start``, the key distribution from the latest ``data`` record
    (``history.resolve_prior``, the one prior-run read), the measured
    collective seconds and the ``fleet_bottleneck`` verdict from
    ``fleet.fleet_view``."""
    from mapreduce_tpu_torch.obs import fleet, history

    paths = fleet.shard_paths(ledger_path)
    if paths:
        by_host = fleet.load_shards(paths[h] for h in sorted(paths))
    elif os.path.exists(ledger_path):
        by_host = {0: fleet.read_jsonl(ledger_path)}
    else:
        raise FileNotFoundError(
            f"no ledger at {ledger_path} (and no {ledger_path}.h*.jsonl "
            "shards next to it)")
    merged = [r for h in sorted(by_host) for r in by_host[h]]
    prior = history.resolve_prior(records=merged)
    start = next((r for r in merged if r.get("kind") == "run_start"), {})
    view = fleet.fleet_view(by_host) or {}
    data = prior.get("data_record") or {}
    bottleneck = view.get("fleet_bottleneck") or {}
    collective = view.get("collective") or {}
    return {
        "ledger": ledger_path,
        "run_id": start.get("run_id"),
        "processes": int(start.get("processes", len(by_host) or 1)),
        "local_devices": int(start.get("local_devices", 1)),
        "incumbent": start.get("merge_strategy"),
        "capacity": data.get("capacity"),
        "top_mass": data.get("top_mass"),
        "table_occupancy": data.get("table_occupancy"),
        "combiner_prior": prior.get("combiner"),
        "measured_collective_s": collective.get("mean_s"),
        "fleet_verdict": bottleneck.get("verdict"),
        "fleet_bottleneck": bottleneck,
    }


def build_plan(args, rates=None) -> dict:
    """Command-line args (and the ledger prior, with ``--ledger``) -> the
    ranked plan artifact.  Flags win over the ledger, the ledger fills the
    gaps, and the defaults are 2 x 4 ranks at capacity 8192.  ``rates``
    replaces the checked-in link rates (``meshcost.load_link_rates``)."""
    prior = ledger_prior(args.ledger) if args.ledger else {}

    def pick(flag, key, default=None):
        if flag is not None:
            return flag
        return prior[key] if prior.get(key) is not None else default

    art = mc.plan(int(pick(args.processes, "processes", 2)),
                  int(pick(args.local_devices, "local_devices", 4)),
                  int(pick(args.capacity, "capacity", 8192)),
                  rates=rates,
                  top_mass=pick(args.top_mass, "top_mass"),
                  table_occupancy=pick(args.occupancy, "table_occupancy"),
                  incumbent=pick(args.incumbent, "incumbent"))
    if prior:
        art["prior"] = {k: prior[k] for k in
                        ("ledger", "run_id", "incumbent", "top_mass",
                         "table_occupancy", "combiner_prior",
                         "measured_collective_s", "fleet_verdict")}
        verdict = prior.get("fleet_verdict")
        if verdict and verdict != "collective-bound":
            art["note"] = (
                f"fleet verdict is {verdict!r}: the measured bottleneck is "
                "NOT the finish collective — the ranking below is the "
                "right strategy for the reduce seam, but fix the "
                "bottleneck the verdict names first")
    return art


# -- --check: modelled vs measured over a real fleet ledger --------------------

def check_disagreement(measured_s, modeled_s, ratio=CHECK_RATIO) -> dict:
    """The one ``--check`` rule: measured/modelled outside
    [1/ratio, ratio] flags."""
    if not measured_s or not modeled_s or modeled_s <= 0:
        return {"measured_s": measured_s, "modeled_s": modeled_s,
                "ratio": None, "flag": False,
                "why": "no measured collective seconds to compare"}
    r = measured_s / modeled_s
    return {"measured_s": round(measured_s, 9),
            "modeled_s": round(modeled_s, 9),
            "ratio": round(r, 3), "flag": r > ratio or r < 1.0 / ratio}


def run_check(args) -> int:
    if not args.ledger:
        print("redplan --check needs --ledger (measured collective seconds "
              "come from a fleet ledger)", file=sys.stderr)
        return 2
    prior = ledger_prior(args.ledger)
    strategy = prior.get("incumbent")
    if strategy not in mc.STRATEGIES:
        print(f"redplan --check: ledger merge_strategy {strategy!r} has no "
              "model; pricing the tree schedule instead", file=sys.stderr)
        strategy = "tree"
    rates = mc.load_link_rates()
    capacity = int(prior.get("capacity") or 8192)
    processes = int(prior.get("processes") or 1)
    local_devices = int(prior.get("local_devices") or 1)
    mesh = mc.MeshSpec.fleet(processes, local_devices) if processes > 1 \
        else mc.MeshSpec.single_host(local_devices)
    priced = mc.price_strategy(strategy, mc.table_bytes(capacity), mesh,
                               rates["levels"],
                               slack=rates["keyrange_slack"])
    res = check_disagreement(prior.get("measured_collective_s"),
                             priced["modeled_s"])
    art = {"check": res, "strategy": strategy,
           "mesh": {"processes": processes, "local_devices": local_devices,
                    "label": mesh.label()},
           "capacity": capacity, "run_id": prior.get("run_id"),
           "fleet_verdict": prior.get("fleet_verdict"),
           "check_ratio": CHECK_RATIO}
    if res["flag"]:
        art["why"] = (
            f"measured finish collective ({res['measured_s']}s mean) is "
            f"{res['ratio']}x the alpha-beta model ({res['modeled_s']}s) "
            f"for {strategy!r} over {mesh.label()}: "
            "analysis/baselines/measured_link_rates.json (its hbm, nvlink "
            "and net levels) does not describe the links this ledger ran "
            "on — remeasure the rates (or stop trusting the plan on this "
            "hardware)")
    print(json.dumps(art, indent=1))
    return 1 if res["flag"] else 0


# -- --gate: analysis certification of each ranked strategy --------------------

def gate_strategies(art, log, device) -> list:
    """Each ranked strategy through the baseline-free analysis passes over
    a fleet-twin ``WordCountJob`` at the planned topology, so the
    collective-cost pass prices the finish each strategy builds.  Returns
    the strategies with no error finding."""
    from mapreduce_tpu_torch import analysis
    from mapreduce_tpu_torch.models import ANALYSIS_CONFIG
    from mapreduce_tpu_torch.models.wordcount import WordCountJob

    passes = autotune.baseline_free_passes()
    mesh = art["mesh"]
    kept = []
    for ranked in art["ranked"]:
        name = ranked["strategy"]
        job = WordCountJob(ANALYSIS_CONFIG, device)
        job.analysis_fleet = {"processes": mesh["processes"],
                              "local_devices": mesh["local_devices"]}
        job.analysis_merge_strategy = name
        report = analysis.analyze_job(job, f"<redplan:{name}>",
                                      passes=passes)
        if report.errors:
            log(f"gate REJECTED {name} over {mesh['label']}:\n"
                + report.format_text("error"))
            continue
        log(f"gate ok: {name} over {mesh['label']} "
            f"(modeled {ranked['modeled_s'] * 1e6:.1f}us)")
        kept.append(name)
    return kept


# -- profile output ------------------------------------------------------------

def write_profile(art, out_path: str, log) -> str:
    """The planner's winner as a ``tuned.json`` profile (the autotuner's
    one-key writer), which ``merge_strategy='auto'`` resolves."""
    key = (f"wordcount-redplan/static/{art['mesh']['label']}"
           f"-cap{art['capacity']}")
    entry = {"config": {"merge_strategy": art["top"]},
             "modeled_s": art["ranked"][0]["modeled_s"],
             "stopped": "planned",
             "mesh": art["mesh"],
             "ranked": [{"strategy": r["strategy"],
                         "modeled_s": r["modeled_s"]}
                        for r in art["ranked"]],
             "fleet_verdict": (art.get("prior") or {}).get("fleet_verdict"),
             "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}
    autotune.write_profile(out_path, key, entry)
    log(f"winner {art['top']} (modeled "
        f"{art['ranked'][0]['modeled_s'] * 1e6:.1f}us) -> {out_path} "
        f"[{key}]")
    return key


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="static reduction-strategy planner: ranked plan over "
                    "the NVLink/network link model, analysis gate, "
                    "modelled-vs-measured ledger check")
    ap.add_argument("--processes", type=int, default=None,
                    help="nodes (outer network axis; default 2 or the "
                         "ledger's)")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="cards a node (inner NVLink axis; default 4 or "
                         "the ledger's)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="CountTable capacity in rows (default 8192 or the "
                         "ledger's): sets the 7-plane payload")
    ap.add_argument("--top-mass", type=float, default=None,
                    help="measured top-key mass (derates keyrange past "
                         "0.05; default: the ledger's data record)")
    ap.add_argument("--occupancy", type=float, default=None,
                    help="measured table occupancy for the keyrange "
                         "budget-spill check (default: the ledger's)")
    ap.add_argument("--incumbent", default=None,
                    help="strategy currently deployed (the artifact says "
                         "whether it stays on top)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="fleet ledger (sharded <path>.h<p>.jsonl or one "
                         "file): topology/incumbent/key-distribution prior "
                         "and fleet verdict")
    ap.add_argument("--gate", action="store_true",
                    help="certify each ranked strategy through the "
                         "analysis passes over a fleet-twin job")
    ap.add_argument("--check", action="store_true",
                    help="modelled vs measured collective seconds over "
                         "--ledger; exit 1 past the 2x disagreement gate")
    ap.add_argument("--out", default=None, metavar="TUNED_JSON",
                    help="also write the winner as a tuned.json profile "
                         "(wordcount-redplan/static/<mesh>-cap<capacity>)")
    autotune.add_platform(ap)
    args = ap.parse_args(argv)
    device = autotune.device_for(args.platform)
    if args.check:
        return run_check(args)
    art = build_plan(args)

    def log(msg: str) -> None:
        print(f"[redplan] {msg}", file=sys.stderr, flush=True)

    if args.gate:
        gated = gate_strategies(art, log, device)
        art["gated"] = gated
        print(json.dumps(art, indent=1))
        return 0 if len(gated) == len(art["ranked"]) else 1
    if args.out:
        art["profile_key"] = write_profile(art, args.out, log)
    print(json.dumps(art, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
