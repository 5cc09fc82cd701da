"""Offline window autotuner: the rule table of :mod:`...tuning` walked over
short streamed probe passes on a synthetic corpus until the config
converges, the oscillation guard trips or the pass budget runs out; the
winner goes into a ``tuned.json`` profile keyed by family, platform and
corpus shape.

Counterpart of the repository's ``tools/autotune.py``, with its names and
file formats.  Each probe pass streams the corpus through
:func:`...runtime.executor.run_job` with telemetry into a ledger of its
own, and the tuner reads what the run recorded (the ``bottleneck`` and
``data_health`` verdicts, the window statistics): the same pure function
the online ``--autotune`` hint uses.  Every config is certified before it
touches the device: the baseline-free analysis passes (reducer-algebra,
overflow-dtype, host-sync, sharding-lint, smem-budget, kernel-race,
collective-cost) over a ``WordCountJob`` built with exactly its knobs; an
error finding stops the walk.  The start config is certified before the
warm-up, whose one run over the first group pays the kernels' build at
first use and their first launches.

Where it differs from the JAX tool: the best-known record
(:func:`record_last_good`) is written only to the path ``--last-good``
names, never by default; ``--out`` defaults to ``./tuned.json``, the file
the command line's ``--geometry-profile`` reads by default.

Usage::

    python -m mapreduce_tpu_torch.tools.autotune            # zipf, 32 MB
    python -m mapreduce_tpu_torch.tools.autotune --corpus natural --mb 64
    python -m mapreduce_tpu_torch.tools.autotune --platform cpu --mb 2 \\
        --chunk-mb 1 --budget 2 --out /tmp/tuned.json

The passes run on the card; ``--platform cpu`` runs them on the CPU, and
without a card and without it the driver raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from mapreduce_tpu_torch.tuning import engine

#: A same-profile regression this deep cannot displace the best-known
#: record (the value-aware discipline of the best-known records).
REGRESSION_FRAC = 0.25

#: The probe passes' table sizes: the running table and a chunk's batch.
PROBE_TABLE_CAPACITY = 1 << 18
PROBE_BATCH_UNIQUES = 1 << 16


def log_to_stderr(tool: str):
    """A ``[tool +seconds] message`` logger on stderr."""
    wall0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[{tool} +{time.perf_counter() - wall0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    return log


def device_for(platform: str):
    """The card for ``gpu`` (raising without one), the CPU for ``cpu``."""
    from mapreduce_tpu_torch.runtime.platform import resolve_device

    return resolve_device("cpu" if platform == "cpu" else None)


def platform_of(device) -> str:
    """The profile key's platform component: ``gpu`` or ``cpu``."""
    return "gpu" if device.type == "cuda" else "cpu"


def write_corpus(corpus: bytes) -> str:
    """The probe corpus as a temporary file (the caller unlinks it)."""
    fd, path = tempfile.mkstemp(suffix=".txt")
    with os.fdopen(fd, "wb") as f:
        f.write(corpus)
    return path


def baseline_free_passes() -> list:
    """The analysis pipeline without its baseline-keyed passes (hbm-cost,
    fusion-opportunity): probe configs are not registry models, so they
    have no checked-in baselines."""
    from mapreduce_tpu_torch import analysis

    return [p for p in analysis.default_pipeline()
            if p.pass_id not in ("hbm-cost", "fusion-opportunity")]


# -- the probe pass ------------------------------------------------------------

def probe_config(knobs: dict):
    """The one knobs -> ``Config`` mapping every probe consumer (certify,
    warm-up, measure) builds from, table sizes included, so the warm-up
    runs the shapes the measured passes run.  A 'hot-cache' combiner runs
    on the fused map, the one path that has the cache."""
    from mapreduce_tpu_torch.config import Config

    combiner = str(knobs.get("combiner", "off"))
    geometry = knobs.get("geometry", "default")
    return Config(chunk_bytes=int(knobs["chunk_bytes"]),
                  superstep=int(knobs["superstep"]),
                  inflight_groups=int(knobs["inflight_groups"]),
                  prefetch_depth=int(knobs["prefetch_depth"]),
                  combiner=combiner,
                  geometry=None if geometry in (None, "default")
                  else geometry,
                  map_impl="fused" if combiner == "hot-cache"
                  else Config.map_impl,
                  merge_strategy=str(knobs.get("merge_strategy", "tree")),
                  merge_overlap=str(knobs.get("merge_overlap",
                                              "off")) == "on",
                  table_capacity=PROBE_TABLE_CAPACITY,
                  batch_unique_capacity=PROBE_BATCH_UNIQUES)


def certify(knobs: dict, device) -> None:
    """The analysis gate for one probe config: the baseline-free passes
    over a ``WordCountJob`` built with these knobs on ``device``.  An error
    finding raises ``SystemExit``: a config the certifier rejects never
    touches the device."""
    from mapreduce_tpu_torch import analysis
    from mapreduce_tpu_torch.models.wordcount import WordCountJob

    report = analysis.analyze_job(WordCountJob(probe_config(knobs), device),
                                  "<autotune-probe>",
                                  passes=baseline_free_passes())
    if report.errors:
        raise SystemExit("autotune: analysis gate REJECTED config "
                         f"{knobs}:\n" + report.format_text("error"))


def _knob_key(knobs: dict) -> str:
    return json.dumps(knobs, sort_keys=True)


def make_measure(corpus_path: str, device, ledger_dir: str, log):
    """The measure function: one telemetered streamed pass a call, which
    returns the pass's ledger records.  ``state`` keeps the pass count,
    the last pass's GB/s (bytes over the wall time of ``run_job``), its
    ledger and its ``RunResult`` (``result``), so a caller can check the
    result; a config is certified once, before its first pass."""
    from mapreduce_tpu_torch.models.wordcount import WordCountJob
    from mapreduce_tpu_torch.obs.ledger import read_ledger
    from mapreduce_tpu_torch.obs.telemetry import Telemetry
    from mapreduce_tpu_torch.runtime import executor

    state = {"pass": 0, "gbps": None, "ledger": None, "result": None,
             "certified": set()}

    def measure(knobs: dict) -> list:
        if _knob_key(knobs) not in state["certified"]:
            certify(knobs, device)
            state["certified"].add(_knob_key(knobs))
        state["pass"] += 1
        cfg = probe_config(knobs)
        ledger = os.path.join(ledger_dir, f"probe{state['pass']:02d}.jsonl")
        tel = Telemetry.create(ledger_path=ledger)
        t0 = time.perf_counter()
        try:
            rr = executor.run_job(WordCountJob(cfg, device), corpus_path,
                                  config=cfg, telemetry=tel)
        finally:
            tel.close()
        dt = time.perf_counter() - t0
        state["gbps"] = round(rr.metrics.bytes_processed / 1e9 / dt, 4)
        state["ledger"] = ledger
        state["result"] = rr
        log(f"pass {state['pass']}: {knobs} -> {state['gbps']} GB/s "
            f"({dt:.2f}s, ledger {ledger})")
        return [r for r in read_ledger(ledger)
                if r.get("run_id") == tel.run_id]

    return measure, state


# -- tuned.json and the best-known record ------------------------------------

def trail_summary(result: dict) -> list:
    """The per-pass decision trail, compacted for the profile/record."""
    return [{"rule": p["rule"], "changed": p["changed"],
             "converged": p["converged"],
             "resource": p["signals"].get("resource"),
             "saving_frac": p["signals"].get("saving_frac"),
             "data_verdict": p["signals"].get("data_verdict")}
            for p in result["trail"]]


def write_profile(out_path: str, key: str, entry: dict) -> None:
    """Merge one (family, platform, corpus shape)-keyed profile into the
    ``tuned.json`` file (other keys kept)."""
    profiles = {}
    try:
        with open(out_path, encoding="utf-8") as f:
            profiles = json.load(f).get("profiles", {})
    except (OSError, ValueError):
        pass
    profiles[key] = entry
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"tuner_version": engine.TUNER_VERSION,
                   "profiles": profiles}, f, indent=1)
        f.write("\n")


def record_last_good(key: str, entry: dict, backend: str,
                     path: str | None = None, slot: str = "tuned") -> bool:
    """Record the winner as a value-aware best-known entry under
    ``best.<slot>`` of the JSON file at ``path`` (nothing is written
    without one): a CPU run is refused (not evidence of the card), a
    same-profile value more than 25 % below the best-known one cannot
    displace it, nor can a smaller one, and every refusal leaves a line on
    stderr.  ``slot`` separates record families that must not displace
    each other (the geometry search's winner rides ``best.geometry``)."""
    def refused(msg: str) -> bool:
        print(f"[autotune] last-good write refused: {msg}", file=sys.stderr,
              flush=True)
        return False

    if path is None:
        return refused("no --last-good path given")
    if backend == "cpu":
        return refused("cpu backend (smoke run, not evidence of the card)")
    try:
        with open(path, encoding="utf-8") as f:
            prev = json.load(f)
    except (OSError, ValueError):
        prev = {}
    best = dict(prev.get("best") or {})
    rec = best.get(slot)
    val = entry.get("measured_gbps")
    if val is None:
        return refused("no measured GB/s for the winner")
    if rec is not None and rec.get("profile") == key:
        old = rec.get("value", 0.0)
        if val < (1.0 - REGRESSION_FRAC) * old:
            return refused(f"tuned profile {key!r} regressed {old} -> {val} "
                           f"(> {REGRESSION_FRAC:.0%}); best-known kept")
        if val < old:
            return refused(f"tuned profile {key!r} below best-known "
                           f"({val} < {old}, within {REGRESSION_FRAC:.0%}); "
                           "best-known kept")
    best[slot] = {"value": val, "profile": key,
                  "recorded_at": entry.get("recorded_at"),
                  "config": entry.get("config"),
                  "stopped": entry.get("stopped"),
                  "trail": entry.get("trail")}
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({**prev, "best": best}, f)
            f.write("\n")
    except OSError:
        return refused(f"{path} not writable")
    return True


# -- the offline search --------------------------------------------------------

def run_search(args) -> int:
    from mapreduce_tpu_torch.models.wordcount import WordCountJob
    from mapreduce_tpu_torch.runtime import executor
    from mapreduce_tpu_torch.tools.corpora import GENERATORS

    device = device_for(args.platform)
    log = log_to_stderr("autotune")
    corpus = GENERATORS[args.corpus](args.mb << 20)
    log(f"corpus ready: {len(corpus) >> 20} MB (synthetic-{args.corpus})")
    backend = platform_of(device)
    ledger_dir = args.keep_ledgers or tempfile.mkdtemp(prefix="autotune_")
    os.makedirs(ledger_dir, exist_ok=True)
    start = {"chunk_bytes": args.chunk_mb << 20,
             "superstep": args.superstep,
             "inflight_groups": args.inflight,
             "prefetch_depth": args.prefetch}
    path = write_corpus(corpus)
    try:
        measure, state = make_measure(path, device, ledger_dir, log)
        # The start config is certified before any device work; the
        # warm-up then pays the kernels' build at first use and their
        # first launches over the first group, so pass 1 measures ingest.
        knobs = {**engine.default_knobs(), **start}
        certify(knobs, device)
        state["certified"].add(_knob_key(knobs))
        warm_cfg = probe_config(knobs)
        warm_hi = min(len(corpus),
                      warm_cfg.chunk_bytes * (warm_cfg.superstep + 1))
        executor.run_job(WordCountJob(warm_cfg, device), path,
                         config=warm_cfg, byte_range=(0, warm_hi))
        log("warm-up done (kernels built, first launches paid)")
        result = engine.search(measure, start, budget=args.budget,
                               backend="auto")
    finally:
        os.unlink(path)
    key = (f"wordcount/{backend}/"
           f"{args.corpus}-{args.mb}mb-chunk{args.chunk_mb}mb")
    # The winner's own pass's throughput (engine.search pairs them); the
    # harness wall-clock figure is the fallback for ledgers that carried
    # no run_end throughput.
    winner_gbps = result.get("winner_gbps")
    entry = {"config": result["winner"],
             "measured_gbps": winner_gbps if winner_gbps is not None
             else state["gbps"],
             "stopped": result["stopped"],
             "passes": result["passes"],
             "backend": backend,
             "devices": 1,
             "corpus": f"synthetic-{args.corpus}",
             "corpus_mb": args.mb,
             "trail": trail_summary(result),
             "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}
    write_profile(args.out, key, entry)
    recorded = record_last_good(key, entry, backend, path=args.last_good)
    log(f"{result['stopped']} after {result['passes']} pass(es); "
        f"winner {result['winner']} @ {entry['measured_gbps']} GB/s -> "
        f"{args.out} [{key}]"
        + ("" if recorded else " (last-good unchanged)"))
    print(json.dumps({"metric": "autotune_winner", "profile": key, **entry}))
    return 0


def add_platform(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                    help="where the passes run (default the card; 'cpu' "
                         "runs the kernels' plain versions on the CPU)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="offline window autotuner: probe-pass search over "
                    "inflight/prefetch/superstep/chunk via the run "
                    "ledger's own verdicts")
    ap.add_argument("--corpus", choices=("zipf", "natural", "webby",
                                         "markup"), default="zipf")
    ap.add_argument("--mb", type=int, default=32,
                    help="corpus size per probe pass (default 32)")
    ap.add_argument("--chunk-mb", type=int, default=2,
                    help="starting chunk size in MB (default 2)")
    ap.add_argument("--superstep", type=int, default=1)
    ap.add_argument("--inflight", type=int, default=4)
    ap.add_argument("--prefetch", type=int, default=4)
    ap.add_argument("--budget", type=int, default=6,
                    help="max probe passes (default 6)")
    ap.add_argument("--out", default="tuned.json",
                    help="tuned-profile JSON path (default ./tuned.json)")
    ap.add_argument("--keep-ledgers", default=None, metavar="DIR",
                    help="keep per-pass ledgers in DIR (default: tmpdir)")
    ap.add_argument("--last-good", default=None, metavar="PATH",
                    help="also record the winner as a value-aware "
                         "best-known entry in PATH (default: none)")
    add_platform(ap)
    return run_search(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
