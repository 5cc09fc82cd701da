"""Certifier-gated kernel-geometry search, in three stages, each cheaper
than the next is allowed to be.

Counterpart of the repository's ``tools/geomsearch.py``, over the port's
launch plans (:mod:`...analysis.geometry`):

1. **Enumerate, certify, rank** (default; no device work): the candidate
   lattice, each candidate held to the card's static limits and priced by
   the port's cost model, printed as one JSON artifact.
2. ``--gate``: the baseline-free analysis passes (reducer-algebra,
   overflow-dtype, host-sync, sharding-lint, smem-budget, kernel-race,
   collective-cost) over a ``WordCountJob`` for each shortlisted
   candidate, in the config that makes the candidate's fields live
   (``map_impl='fused'``, ``combiner='hot-cache'``, ``sort_impl='radix'``)
   at the 64 KB analysis chunk, so smem-budget and kernel-race see its
   cache depth and digit width.  Traced on the device; no measurement.
3. ``--probe``: one telemetered streamed pass per gated candidate, the
   default always among them; the winner (highest GB/s) goes into
   ``tuned.json`` under ``wordcount-geometry/<platform>/<corpus>``, which
   ``--geometry auto`` resolves, and, with ``--last-good PATH``, into the
   best-known record's ``geometry`` slot.

**The probe config.** The port's kernels read two geometry fields,
``combiner_slots`` (the hot-key cache's depth, K1d) and ``radix_bits``
(the radix seam's digit width, K2 and K2s).  The probe passes run the one
config in which both are live: the fused map with ``combiner='hot-cache'``
and ``sort_impl='radix'``, at ``--chunk-mb`` (default 32), table 2**18,
batch 2**16.  (The JAX tool's probe config, the fused map with the
combiner off and the XLA sort, moves no launch of the port at any
candidate.)  A candidate that moves no launch there (``inert``: only the
TPU layout's fields differ) or builds the program of one already probed
(the same ``combiner_slots`` and ``radix_bits``) is skipped with a log
line.

Usage::

    python -m mapreduce_tpu_torch.tools.geomsearch          # the shortlist
    python -m mapreduce_tpu_torch.tools.geomsearch --gate
    python -m mapreduce_tpu_torch.tools.geomsearch --probe --mb 64
    python -m mapreduce_tpu_torch.tools.geomsearch --probe --axis \\
        combiner_slots --platform cpu --mb 1 --chunk-mb 1

Every stage runs on the card, or on the CPU with ``--platform cpu``;
without a card and without it the driver raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from mapreduce_tpu_torch.analysis import geometry as g
from mapreduce_tpu_torch.tools import autotune


def probe_config(geometry, chunk_bytes: int):
    """The probe passes' config: both fields the port reads are live
    (``geometry`` None is the default)."""
    from mapreduce_tpu_torch.config import Config

    return Config(chunk_bytes=chunk_bytes,
                  table_capacity=autotune.PROBE_TABLE_CAPACITY,
                  batch_unique_capacity=autotune.PROBE_BATCH_UNIQUES,
                  map_impl="fused", combiner="hot-cache", sort_impl="radix",
                  geometry=geometry)


def _geometry_of(c):
    return None if c.axis == "default" else c.geometry


# -- stage 2: the analysis gate ------------------------------------------------

def gate_candidates(cands, log, device) -> list:
    """The baseline-free analysis passes over a ``WordCountJob`` for each
    candidate, at ``COMBINER_ANALYSIS_CONFIG``'s chunk with the radix seam
    on.  Returns the candidates whose reports carry no error."""
    from mapreduce_tpu_torch import analysis
    from mapreduce_tpu_torch.models import COMBINER_ANALYSIS_CONFIG
    from mapreduce_tpu_torch.models.wordcount import WordCountJob

    passes = autotune.baseline_free_passes()
    kept = []
    for c in cands:
        cfg = dataclasses.replace(COMBINER_ANALYSIS_CONFIG,
                                  sort_impl="radix",
                                  geometry=_geometry_of(c))
        report = analysis.analyze_job(WordCountJob(cfg, device),
                                      f"<geometry:{c.label}>",
                                      passes=passes)
        if report.errors:
            log(f"gate REJECTED {c.label}:\n"
                + report.format_text("error"))
            continue
        log(f"gate ok: {c.label}")
        kept.append(c)
    return kept


# -- stage 3: measured probe ranking -------------------------------------------

def probe_candidates(top: int, axis) -> list:
    """The shortlist, with the default in front when it did not make it:
    the baseline every candidate is judged against."""
    cands = g.shortlist(g.enumerate_candidates(), top, axis=axis)
    if not any(c.axis == "default" for c in cands):
        cands = [c for c in g.enumerate_candidates()
                 if c.axis == "default"] + cands
    return cands


def probe_filter(cands, log) -> list:
    """Drop each candidate that would measure a program already measured:
    an ``inert`` one (its launches are the default's) and one whose
    ``(combiner_slots, radix_bits)`` equals a kept candidate's.  The
    default is always kept; every skip is logged."""
    kept, built = [], {}
    for c in cands:
        read = (c.geometry.combiner_slots, c.geometry.radix_bits)
        if c.axis != "default" and c.inert:
            log(f"probe skipped {c.label}: inert in the probe config (it "
                "changes only fields the port's kernels do not read)")
            continue
        if c.axis != "default" and read in built:
            log(f"probe skipped {c.label}: the same program as "
                f"{built[read]} (combiner_slots={read[0]}, "
                f"radix_bits={read[1]})")
            continue
        built.setdefault(read, c.label)
        kept.append(c)
    return kept


def probe_pass(cfg, path: str, ledger: str, device):
    """One telemetered streamed pass of ``cfg`` over ``path``: its
    ``RunResult`` and wall seconds."""
    from mapreduce_tpu_torch.models.wordcount import WordCountJob
    from mapreduce_tpu_torch.obs.telemetry import Telemetry
    from mapreduce_tpu_torch.runtime import executor

    tel = Telemetry.create(ledger_path=ledger)
    t0 = time.perf_counter()
    try:
        rr = executor.run_job(WordCountJob(cfg, device), path, config=cfg,
                              telemetry=tel)
    finally:
        tel.close()
    return rr, time.perf_counter() - t0


def run_probe(args, device) -> int:
    from mapreduce_tpu_torch.config import GEOMETRY_PRESETS
    from mapreduce_tpu_torch.models.wordcount import WordCountJob
    from mapreduce_tpu_torch.runtime import executor
    from mapreduce_tpu_torch.tools.corpora import GENERATORS

    log = autotune.log_to_stderr("geomsearch")
    cands = probe_filter(probe_candidates(args.top, args.axis), log)
    cands = gate_candidates(cands, log, device)
    if not cands:
        print("geomsearch: no candidate survived the gate", file=sys.stderr)
        return 1
    corpus = GENERATORS[args.corpus](args.mb << 20)
    backend = autotune.platform_of(device)
    ledger_dir = args.keep_ledgers or tempfile.mkdtemp(prefix="geomsearch_")
    os.makedirs(ledger_dir, exist_ok=True)
    chunk = args.chunk_mb << 20
    path = autotune.write_corpus(corpus)
    measured = []
    try:
        # The warm-up pays the kernels' build at first use and their first
        # launches, so the first candidate is not charged for them.
        warm = probe_config(None, chunk)
        executor.run_job(WordCountJob(warm, device), path, config=warm,
                         byte_range=(0, min(len(corpus), 2 * chunk)))
        for i, c in enumerate(cands):
            ledger = os.path.join(ledger_dir, f"geom{i:02d}.jsonl")
            rr, dt = probe_pass(probe_config(_geometry_of(c), chunk), path,
                                ledger, device)
            gbps = round(rr.metrics.bytes_processed / 1e9 / dt, 4)
            log(f"probe {c.label}: {gbps} GB/s ({dt:.2f}s, "
                f"combiner_slots={c.geometry.combiner_slots}, "
                f"radix_bits={c.geometry.radix_bits}, ledger {ledger})")
            measured.append((gbps, c))
    finally:
        os.unlink(path)
    measured.sort(key=lambda gc: -gc[0])
    best_gbps, best = measured[0]
    key = (f"wordcount-geometry/{backend}/"
           f"{args.corpus}-{args.mb}mb-chunk{args.chunk_mb}mb")
    entry = {"config": {"geometry": best.label
                        if best.label in GEOMETRY_PRESETS
                        else best.geometry.as_dict()},
             "measured_gbps": best_gbps,
             "stopped": "probed",
             "passes": len(measured),
             "backend": backend,
             "devices": 1,
             "corpus": f"synthetic-{args.corpus}",
             "corpus_mb": args.mb,
             "trail": [{"geometry": c.label, "gbps": gb,
                        "modeled_sort_rows": c.sort_rows,
                        "spill_risk": c.spill_risk}
                       for gb, c in measured],
             "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}
    autotune.write_profile(args.out, key, entry)
    recorded = autotune.record_last_good(key, entry, backend,
                                         path=args.last_good,
                                         slot="geometry")
    log(f"winner {best.label} @ {best_gbps} GB/s -> {args.out} [{key}]"
        + ("" if recorded else " (last-good unchanged)"))
    print(json.dumps({"metric": "geomsearch_winner", "profile": key,
                      **entry}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="certifier-gated kernel-geometry search: shortlist, "
                    "analysis gate, measured probe ranking")
    ap.add_argument("--top", type=int, default=5,
                    help="shortlist size (default 5)")
    ap.add_argument("--axis", default=None,
                    help="narrow the lattice to one axis family "
                         "(combiner_slots, radix, ...)")
    ap.add_argument("--gate", action="store_true",
                    help="run the analysis passes over the shortlist "
                         "(traced; no measurement)")
    ap.add_argument("--probe", action="store_true",
                    help="measured ranking of the gated shortlist (one "
                         "streamed probe pass each)")
    ap.add_argument("--corpus", choices=("zipf", "natural", "webby",
                                         "markup"), default="zipf")
    ap.add_argument("--mb", type=int, default=32,
                    help="probe corpus size (default 32)")
    ap.add_argument("--chunk-mb", type=int, default=32,
                    help="probe chunk size in MB (default 32, the pricing "
                         "chunk of the modelled ranking)")
    ap.add_argument("--out", default="tuned.json",
                    help="tuned-profile JSON path (default ./tuned.json)")
    ap.add_argument("--keep-ledgers", default=None, metavar="DIR",
                    help="keep per-probe ledgers in DIR (default: tmpdir)")
    ap.add_argument("--last-good", default=None, metavar="PATH",
                    help="also record the winner as a value-aware "
                         "best-known entry in PATH (default: none)")
    autotune.add_platform(ap)
    args = ap.parse_args(argv)
    device = autotune.device_for(args.platform)
    if args.probe:
        return run_probe(args, device)
    cands = g.enumerate_candidates()
    if args.gate:
        short = g.shortlist(cands, args.top, axis=args.axis)
        kept = gate_candidates(
            short, lambda m: print(f"[geomsearch] {m}", file=sys.stderr),
            device)
        print(json.dumps({**g.search_artifact(cands, args.top),
                          "gated": [c.label for c in kept]}))
        return 0 if len(kept) == len(short) else 1
    print(json.dumps(g.search_artifact(cands, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
