"""Command line of the port: ``python -m mapreduce_tpu_torch file [file...]``.

Counterpart of :mod:`mapreduce_tpu.cli` for word count, n-grams
(``--ngram``), the sketched runs (``--distinct-sketch``,
``--count-sketch``, ``--estimate``), grep (``--grep``, ``--grep-syntax``;
``--grep-records`` prints the matching lines too, a flag of the port's
own), the reservoir sample (``--sample``) and the exact recount
(``--verify-sample``).  Its stdout is byte-identical to the JAX CLI's for
the flags it takes; every other flag of the JAX CLI is refused with a
usage error.  The run goes to the card unless ``--platform cpu`` asks for
the CPU.  Progress logs and ``--stats`` go to stderr.  A preempted
streamed run (SIGINT, or an injected preemption) drains, checkpoints and
exits 75; under a launcher a SIGINT to one rank drains every rank at the
same step, and every rank exits 75.

``--ledger PATH`` appends the run ledger (and, on a failure, dumps
``PATH.flight.json``), ``--metrics-out PATH`` writes the metrics registry
and ``--profile DIR`` a Chrome trace; none of them changes stdout.
``--autotune`` (with ``--stream``) writes the autotuner's recommendation
as a ``tune`` record and prints it to stderr.  The ``auto`` values of
``--combiner``, ``--geometry`` and ``--merge-strategy`` resolve before
the run, from the ``--ledger`` file's latest ``data`` record and from the
``--geometry-profile`` file (:func:`...obs.history.resolve_prior`), each
announced on stderr as ``<knob>: auto -> <value>``.

Under a launcher (``torchrun --nproc-per-node D -m mapreduce_tpu_torch
FILE --stream``) the D processes are one ``torch.distributed`` world and
each streams its row of every step (NCCL on the card, gloo with
``--platform cpu``); ``--merge-strategy`` picks the collective merge,
``--merge-overlap`` merges at window boundaries, ``--retry`` replays a
failed window on every rank, and only the coordinator (rank 0) prints,
writes the ledger and the metrics.  The output does not depend on D.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from mapreduce_tpu_torch.config import Config

_CTRL_ESCAPES = str.maketrans({"\t": "\\t", "\n": "\\n", "\r": "\\r",
                               "\x00": "\\x00", "\x0b": "\\x0b",
                               "\x0c": "\\x0c"})


#: The JAX CLI's collective merge strategies.  The two-level ``hier-*``
#: ones need a two-level mesh, which the CLI's one axis is not (a usage
#: error, as in the JAX CLI); 'auto' resolves through the run-history
#: prior over the single-axis ones.
MERGE_STRATEGIES = ("tree", "gather", "keyrange", "hier-kr-tree",
                    "hier-tree-tree")


def build_parser() -> argparse.ArgumentParser:
    from mapreduce_tpu_torch.version import __version__

    p = argparse.ArgumentParser(
        prog="mapreduce-tpu-torch", allow_abbrev=False,
        description="MapReduce word count on an NVIDIA GPU "
                    "(reference-parity CLI).")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("input", nargs="*", default=["test.txt"],
                   help="input text file(s) (default: test.txt; several "
                        "files count as one corpus)")
    p.add_argument("--top-k", type=int, default=0,
                   help="report only the k most frequent words (0 = all)")
    p.add_argument("--ngram", type=int, default=1, metavar="N",
                   help="count n-token grams instead of single words "
                        "(reported entries are the exact source spans, e.g. "
                        "'Hello World'; --stream counts grams exactly, "
                        "including ones spanning chunk seams)")
    p.add_argument("--chunk-bytes", type=int, default=1 << 25,
                   help="bytes per streaming step (default 32 MB)")
    p.add_argument("--table-capacity", type=int, default=1 << 18)
    p.add_argument("--format", choices=("reference", "json", "tsv"),
                   default="reference",
                   help="'reference' replicates the CUDA program's stdout")
    p.add_argument("--no-echo", action="store_true",
                   help="suppress the 'Input Data:' echo")
    p.add_argument("--stream", action="store_true",
                   help="stream the files chunk by chunk through the "
                        "pipelined executor (large inputs)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="with --stream: checkpoint state to PATH and resume "
                        "from it")
    p.add_argument("--checkpoint-every", type=int, default=25,
                   metavar="STEPS")
    p.add_argument("--superstep", type=int, default=1, metavar="K",
                   help="with --stream: fold K chunks into one dispatch")
    p.add_argument("--inflight", type=int, default=Config.inflight_groups,
                   metavar="W",
                   help="with --stream: keep up to W superstep groups "
                        "dispatched-but-unretired, so reader/staging/H2D "
                        "and device compute of different groups overlap "
                        "(1 = serialized dispatch, the safe fallback and "
                        "A/B control; default %(default)s)")
    p.add_argument("--prefetch-depth", type=int, default=None, metavar="N",
                   help="with --stream: batches the background reader may "
                        "run ahead (default auto: superstep * inflight, "
                        "clamped to [2, 16] — co-tuned with the window)")
    p.add_argument("--autotune", action="store_true",
                   help="with --stream: feed the run's own telemetry "
                        "(timeline bottleneck, data health, window stats) "
                        "through the config autotuner and fold the "
                        "recommended next inflight/prefetch/superstep/"
                        "chunk-bytes into a `tune` ledger record and the "
                        "run summary — the live run is unchanged")
    p.add_argument("--stats", action="store_true",
                   help="print timing/throughput to stderr")
    p.add_argument("--retry", type=int, default=0, metavar="N",
                   help="with --stream: retry a failed step group N times, "
                        "replaying the window from its known-good anchor, "
                        "before surfacing the failure")
    p.add_argument("--fault-plan", default=None, metavar="SPEC",
                   help="with --stream: deterministic fault injection at "
                        "the executor's named seams (runtime/faults.py "
                        "grammar, e.g. 'seed=42,rate=0.02' or "
                        "'at=dispatch:3:resource'); results stay identical "
                        "to the fault-free run when the retry budget "
                        "absorbs the faults")
    p.add_argument("--distinct-sketch", action="store_true",
                   help="with --stream: carry a HyperLogLog so the distinct "
                        "count stays accurate past table capacity "
                        "(distinct_estimate in json output)")
    p.add_argument("--count-sketch", action="store_true",
                   help="with --stream: carry a Count-Min sketch so any "
                        "word's frequency stays queryable past table "
                        "capacity (see --estimate)")
    p.add_argument("--estimate", action="append", default=[], metavar="WORD",
                   help="report the sketch-estimated count of WORD "
                        "(repeatable; implies --count-sketch)")
    p.add_argument("--sketch-flush-every", type=int, default=1, metavar="K",
                   help="sketched runs: stage per-chunk sketch updates and "
                        "apply them once every K steps (results are "
                        "identical)")
    p.add_argument("--grep", action="append", default=None, metavar="PATTERN",
                   help="count occurrences of PATTERN instead of words "
                        "(overlapping matches + exact matching lines; "
                        "composes with --stream for sharded corpora; "
                        "repeatable — P patterns share ONE pass over the "
                        "corpus)")
    p.add_argument("--grep-syntax", choices=("literal", "class"),
                   default="literal",
                   help="pattern syntax for --grep: 'class' enables "
                        "regex-lite byte classes — '.' (any byte but "
                        "newline), '[a-z0-9]', '[^...]', '\\\\x' escapes; "
                        "fixed length, no repetition/alternation")
    p.add_argument("--grep-records", action="store_true",
                   help="with one --grep: print every matching line, in "
                        "file order, before the counts (the streamed "
                        "executor; a pattern that can match LF is "
                        "refused)")
    p.add_argument("--sample", type=int, default=None, metavar="K",
                   help="report a uniform random sample of K token "
                        "occurrences instead of counts (mergeable bottom-k "
                        "sketch; composes with --stream; deterministic for "
                        "a given corpus + chunking)")
    p.add_argument("--merge-every", type=int, default=1, metavar="K",
                   help="with --stream: stage per-chunk batch tables and "
                        "fold them into the running table once every K "
                        "steps, in one build (word-count runs only; "
                        "identical results)")
    p.add_argument("--merge-strategy", choices=MERGE_STRATEGIES + ("auto",),
                   default="tree",
                   help="collective global-reduce strategy for streamed "
                        "word-count runs over several ranks (torchrun): "
                        "butterfly tree (log2(D) rounds), all_gather + "
                        "fold, or key-range all_to_all reduce-scatter (one "
                        "round); identical results.  The hierarchical 2-D "
                        "programs (hier-kr-tree / hier-tree-tree) run on "
                        "fleet meshes only; the CLI's 1-D mesh rejects "
                        "them.  'auto' warm-starts from the freshest "
                        "reduction-planner profile in --geometry-profile "
                        "(no matching profile falls back loudly to tree)")
    p.add_argument("--merge-overlap", action="store_true",
                   help="with --stream: drain the local tables into a "
                        "device-resident merged accumulator at window "
                        "boundaries (one async partial collective per "
                        "--inflight retired groups), overlapping "
                        "interconnect time with map compute; results stay "
                        "bit-identical and each partial lands as an "
                        "op='partial' collective ledger record (v10); "
                        "requires --retry 0")
    p.add_argument("--verify-sample", type=int, default=0, metavar="K",
                   help="after a word-count run, exactly recount K reported "
                        "words host-side (byte-string keyed, no hashing) "
                        "and fail loudly on any mismatch — the detection "
                        "path for the ~n^2/2^65 64-bit key-collision "
                        "envelope (see utils/verify.py); costs one host "
                        "pass over the corpus")
    p.add_argument("--backend", choices=("auto", "xla", "pallas"),
                   default="auto",
                   help="map-phase implementation (identical results): "
                        "'pallas' = the hand-written CUDA kernels, 'xla' = "
                        "the plain PyTorch tokenizer, 'auto' = the kernels "
                        "whenever the chunk fits their envelope")
    p.add_argument("--sort-mode", choices=("sort3", "stable2", "segmin"),
                   default="stable2",
                   help="aggregation sort strategy on the kernel path "
                        "(identical results): 'stable2' = a stable 2-key "
                        "sort over the kernel's byte-ordered stream, "
                        "'sort3' = a 3-key sort, 'segmin' = a 2-key sort "
                        "and a segmented minimum (no overlong rescue; off "
                        "the CPU only with MAPREDUCE_ALLOW_SEGMIN=1, as in "
                        "the JAX CLI)")
    p.add_argument("--compact-slots", type=int, default=None, metavar="S",
                   help="the JAX kernel's slot compaction per window "
                        "(multiple of 8 in [8, 128]; 0 = pair mode; "
                        "stable2 takes only the default or 128).  The "
                        "port's kernel emits one dense stream either way; "
                        "identical results")
    p.add_argument("--max-token-bytes", type=int, default=32, metavar="W",
                   help="kernel path: tokens longer than W bytes go "
                        "through the overlong rescue or into dropped_* "
                        "accounting (xla counts any length)")
    p.add_argument("--rescue-overlong", type=int, default=None, metavar="R",
                   help="kernel path: re-hash up to R >W-byte tokens per "
                        "chunk exactly (default 1024; 0 disables)")
    p.add_argument("--rescue-overlong-max", type=int, default=None,
                   metavar="R2",
                   help="second-tier rescue budget: chunks whose overlong "
                        "count exceeds --rescue-overlong escalate to R2 "
                        "slots (default chunk_bytes/1024 clamped to "
                        "[R, 65536])")
    p.add_argument("--rescue-window", type=int, default=192, metavar="B",
                   help="rescue lookback bound: tokens up to B-1 bytes are "
                        "recovered exactly; longer ones stay accounted")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace (Chrome trace "
                        "JSON, readable in Perfetto) of the run to DIR")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="append a JSONL run ledger to PATH. Streamed runs "
                        "record one step + one group record per dispatch "
                        "group (phase timings, bytes, device memory, "
                        "kernel builds, lifecycle stamps, data-plane "
                        "counters) plus a per-run data summary; a failed "
                        "run also dumps flight-recorder forensics to "
                        "PATH.flight.json. Batch (non---stream) runs emit "
                        "run_start / data / run_end. Summarize with "
                        "tools/obs_report.py")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the end-of-run metrics-registry snapshot "
                        "(executor/reader/checkpoint/data counters, "
                        "gauges, histograms) as JSON to PATH")
    p.add_argument("--sort-impl", choices=("xla", "radix", "radix_partition"),
                   default="xla",
                   help="aggregation sort (identical results): 'xla' = the "
                        "torch sort; 'radix_partition' / 'radix' = the CUDA "
                        "radix partition (1 / 2 digit levels) before a sort "
                        "of the live rows")
    p.add_argument("--map-impl", choices=("split", "fused"), default="split",
                   help="map-phase kernel path (identical results); "
                        "'fused' carries --combiner hot-cache")
    p.add_argument("--combiner", choices=("off", "hot-cache", "salt", "auto"),
                   default="off",
                   help="map-side combiner (identical results): 'hot-cache' "
                        "= with --map-impl fused, the kernel counts each "
                        "chunk segment's first --combiner-slots distinct "
                        "keys in place and leaves them out of the sort; "
                        "'salt' = spread a hot key over salted sort "
                        "segments and de-salt exactly after the build; "
                        "'auto' = resolve from the previous run's "
                        "data-health verdict in --ledger (skew-hot -> "
                        "hot-cache, else off)")
    p.add_argument("--combiner-slots", type=int, default=None, metavar="C",
                   help="hot-key cache entries per segment for --combiner "
                        "hot-cache (multiple of 8 in [8, 32]; default: the "
                        "geometry's, 8)")
    p.add_argument("--geometry", default=None, metavar="G",
                   help="kernel-geometry set: a preset name ('tall512', "
                        "'combiner16'), or omit for the default; the port "
                        "reads its radix digit width and hot-key cache "
                        "depth (identical results); 'auto' resolves from "
                        "the searched profile in --geometry-profile")
    p.add_argument("--geometry-profile", default="tuned.json",
                   metavar="PATH",
                   help="tuned.json searched profiles for --geometry auto "
                        "and --merge-strategy auto (default ./tuned.json; "
                        "a missing file resolves to the defaults)")
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                   help="'gpu' (default) runs on the card and fails without "
                        "one; 'cpu' runs on the host")
    return p


def _decode(words: list[bytes]) -> list[str]:
    """Display decoding that keeps distinct byte words distinct."""
    return [w.decode("utf-8", errors="backslashreplace")
            .translate(_CTRL_ESCAPES) for w in words]


def _echo_file(paths: list[str]) -> None:
    """Stream the input bytes to stdout (the reference's line echo)."""
    sys.stdout.write("Input Data:\n")
    sys.stdout.flush()
    for path in paths:
        last = b"\n"
        with open(path, "rb") as f:
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                sys.stdout.buffer.write(block)
                last = block[-1:]
        if last != b"\n":
            sys.stdout.buffer.write(b"\n")
    sys.stdout.buffer.flush()


def _compact_slots(parser, args):
    """The JAX CLI's ``--compact-slots`` rules, then the port's value: the
    port's kernel has no slots, so any budget is compact mode (None) and
    0 is pair mode."""
    cs = args.compact_slots
    if cs is None:
        return None
    if args.sort_mode == "stable2" and cs != 128:
        parser.error("sort_mode='stable2' requires compact_slots=128 (the "
                     "lane-major kernel layout puts slots in the "
                     "128-divisible block dimension); leave compact_slots "
                     "unset")
    if cs and (cs % 8 or not 8 <= cs <= 128):
        parser.error(f"compact_slots must be a multiple of 8 in [8, 128], "
                     f"got {cs}")
    return None if cs else 0


def _print_result(args, paths, result) -> None:
    out = sys.stdout
    display = _decode(result.words)
    estimates = {w: result.estimate_count(w.encode()) for w in args.estimate} \
        if result.cms is not None else {}
    if args.format == "reference":
        if not args.no_echo:
            _echo_file(paths)
        out.write("--------------------------\n")
        for w, c in zip(display, result.counts):
            out.write(f"{w}\t{c}\n")
        out.write("--------------------------\n")
        out.write(f"Total Count:{result.total}\n")
        for w, e in estimates.items():
            out.write(f"estimate:{w}\t{e}\n")
    elif args.format == "tsv":
        for w, c in zip(display, result.counts):
            out.write(f"{w}\t{c}\n")
        for w, e in estimates.items():
            out.write(f"estimate:{w}\t{e}\n")
    else:
        payload = {
            "counts": [[w, c] for w, c in zip(display, result.counts)],
            "total": result.total,
            "distinct": result.distinct,
            "dropped_uniques": result.dropped_uniques,
            "dropped_count": result.dropped_count,
        }
        if result.distinct_estimate is not None:
            payload["distinct_estimate"] = round(result.distinct_estimate, 1)
        if estimates:
            payload["estimates"] = estimates
        out.write(json.dumps(payload) + "\n")


def _batch_run_start(tel, job: str, paths, config: Config,
                     input_bytes: int) -> None:
    """A telemetered batch (non---stream) run's ``run_start``, as the JAX
    CLI writes it: the single buffer has no steps, so its ledger holds
    ``run_start``, a result-derived ``data`` record and ``run_end``."""
    from mapreduce_tpu_torch.runtime.executor import _geometry_stamp

    tel.ledger_write("run_start", driver="single_buffer", job=job,
                     devices=1, chunk_bytes=input_bytes, superstep=1,
                     backend=config.resolved_backend(),
                     map_impl=config.map_impl,
                     combiner=config.resolved_combiner,
                     **_geometry_stamp(config), merge_strategy="none",
                     input=list(paths), resume_step=0, resume_offset=0,
                     retry=0)


def _wordcount(args, paths, data, config: Config, device, input_bytes: int,
               tel) -> int:
    """Count, print and report one run (the JAX ``_wordcount_main``)."""
    from mapreduce_tpu_torch.runtime import profiling

    batch_tel = tel if not args.stream else None
    if batch_tel is not None:
        job = f"ngram{args.ngram}" if args.ngram > 1 else "wordcount"
        _batch_run_start(batch_tel, job, paths, config, input_bytes)
    t0 = time.perf_counter()
    with profiling.trace(args.profile):
        if args.stream:
            from mapreduce_tpu_torch.runtime.executor import count_file

            result = count_file(
                paths, config, device, top_k=args.top_k or None,
                distinct_sketch=args.distinct_sketch,
                count_sketch=args.count_sketch or bool(args.estimate),
                ngram=args.ngram, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every if args.checkpoint
                else 0, retry=args.retry, telemetry=tel)
        else:
            from mapreduce_tpu_torch.models import wordcount

            result = wordcount.count_ngrams(data, args.ngram, config, device) \
                if args.ngram > 1 \
                else wordcount.count_words(data, config, device)
    elapsed = time.perf_counter() - t0
    if result is None:  # a rank other than the coordinator, which reports
        return 0
    if batch_tel is not None:
        batch_tel.ledger_write(
            "data", groups=1, chunks=1, backend=config.resolved_backend(),
            map_impl=config.map_impl, combiner=config.resolved_combiner,
            capacity=config.table_capacity, tokens=result.total,
            dropped_tokens=result.dropped_count,
            dropped_uniques=result.dropped_uniques,
            table_valid=len(result.words),
            top_count=max(result.counts, default=0),
            table_occupancy=round(
                len(result.words) / max(config.table_capacity, 1), 4))
        batch_tel.ledger_write("run_end", bytes=input_bytes,
                               words=result.total,
                               elapsed_s=round(elapsed, 6))
    if args.top_k and not args.stream:  # the stream applied top-k already
        from mapreduce_tpu_torch.models import wordcount

        result = wordcount.apply_top_k(result, args.top_k)
    _print_result(args, paths, result)
    if args.stats:
        _print_stats(input_bytes, result.total, "words", elapsed)
        if result.run is not None:
            print("[stats] " + json.dumps({
                "phases": result.run.metrics.as_dict()["phases"],
                "pipeline": result.run.pipeline}), file=sys.stderr)
    if args.autotune:
        _print_tune(tel)
    if args.verify_sample:
        return _verify(result, paths, args.verify_sample)
    return 0


def _print_tune(tel) -> None:
    """The run's autotune recommendation on stderr, as the JAX CLI prints
    it; the full record (signals and decision trail) is in the ledger."""
    t = getattr(tel, "last_tune", None)
    if not t:
        print("autotune: no recommendation (hint path unavailable "
              "for this run)", file=sys.stderr)
        return
    changed = t.get("changed") or {}
    moves = ", ".join(f"{k} {v[0]} -> {v[1]}" for k, v in changed.items())
    verdict = "converged" if t.get("converged") else (moves or "no move")
    print(f"autotune: {t.get('rule')} — {verdict}", file=sys.stderr)
    if t.get("reason"):
        print(f"autotune: {t['reason']}", file=sys.stderr)


def _resolve_auto(args, config: Config) -> Config:
    """Resolve the ``auto`` values before any device work, as the JAX CLI
    does, each announced on stderr: the geometry from the searched profile
    (``--geometry-profile``), the combiner from the latest ``data`` record
    of the ``--ledger`` file (no history: 'off'), the merge strategy from
    the freshest reduction-planner profile over the single-axis
    strategies (none: 'tree').  The resolved values are what the run's
    ``run_start`` records."""
    from mapreduce_tpu_torch.obs import history

    if args.geometry == "auto":
        from mapreduce_tpu_torch.analysis.geometry import resolve_auto

        resolved = resolve_auto(args.geometry_profile)
        config = dataclasses.replace(
            config, geometry=None if resolved == "default" else resolved)
        print(f"geometry: auto -> {config.geometry_label}", file=sys.stderr)
    if args.combiner == "auto":
        records = []
        if args.ledger and os.path.exists(args.ledger):
            from mapreduce_tpu_torch.obs.ledger import read_ledger

            records = list(read_ledger(args.ledger))
        resolved = history.resolve_prior(records=records)["combiner"]
        # 'off' drops an explicit cache depth: it sizes the cache only.
        config = dataclasses.replace(
            config, combiner=resolved,
            combiner_slots=config.combiner_slots
            if resolved == "hot-cache" else None)
        print(f"combiner: auto -> {resolved}"
              + ("" if records else " (no ledger history)"), file=sys.stderr)
    if args.merge_strategy == "auto":
        single_axis = tuple(m for m in MERGE_STRATEGIES
                            if not m.startswith("hier-"))
        prior = history.resolve_prior(profile_path=args.geometry_profile,
                                      merge_allowed=single_axis)
        config = dataclasses.replace(config,
                                     merge_strategy=prior["merge_strategy"])
        print(f"merge-strategy: auto -> {config.merge_strategy}"
              + ("" if prior["merge_strategy_profile"]
                 else " (no redplan profile; tree)"), file=sys.stderr)
    return config


def _verify(result, paths, sample: int) -> int:
    """``--verify-sample``: recount ``sample`` reported words exactly on
    the host; exit 4 on a mismatch (a key collision's signature)."""
    from mapreduce_tpu_torch.utils.verify import verify_result

    mismatches = verify_result(result.words, result.counts, paths,
                               sample=sample)
    if mismatches:
        for w, rep, true in mismatches:
            print(f"verify: MISMATCH {w!r}: reported {rep}, exact "
                  f"recount {true} (possible 64-bit key collision — "
                  "see mapreduce_tpu_torch/utils/verify.py)",
                  file=sys.stderr)
        return 4
    print(f"verify: ok ({min(sample, len(result.words))} words "
          "recounted exactly)", file=sys.stderr)
    return 0


def _print_stats(input_bytes: int, count: int, unit: str,
                 elapsed: float) -> None:
    print(f"[stats] {input_bytes} bytes, {count} {unit}, "
          f"{elapsed:.3f}s, {input_bytes / 1e9 / elapsed:.3f} GB/s",
          file=sys.stderr)


def _grep_main(args, paths, data, config: Config, device, input_bytes: int,
               tel) -> int:
    """``--grep``: pattern counts instead of word counts (the JAX
    ``_grep_main``).  Several ``--grep`` flags run as one pass."""
    from mapreduce_tpu_torch.models import grep
    from mapreduce_tpu_torch.parallel import distributed
    from mapreduce_tpu_torch.runtime import profiling

    patterns = [g.encode() for g in args.grep]
    syntax = args.grep_syntax
    kw = dict(config=config, device=device, syntax=syntax,
              checkpoint_path=args.checkpoint,
              checkpoint_every=args.checkpoint_every if args.checkpoint
              else 0, retry=args.retry, telemetry=tel)
    batch_tel = tel if not args.stream else None
    if batch_tel is not None:
        _batch_run_start(batch_tel, "grep", paths, config, input_bytes)
    t0 = time.perf_counter()
    records = None
    try:
        with profiling.trace(args.profile):
            if args.grep_records:  # no snapshot: a usage error
                found = grep.grep_records(paths, patterns[0], **{
                    k: v for k, v in kw.items()
                    if not k.startswith("checkpoint")})
                records = found.records
                results = [grep.GrepResult(found.pattern, found.matches,
                                           found.lines)]
            elif args.stream and len(patterns) == 1:
                results = [grep.grep_file(paths, patterns[0], **kw)]
            elif args.stream:
                results = grep.grep_file_multi(paths, patterns, **kw)
            else:
                # Each file is grepped on its own and the counts summed: a
                # pattern holding the join byte would match across a join.
                per_file = [grep.grep_bytes_multi(c, patterns, syntax,
                                                  device) for c in data]
                results = [grep.GrepResult(
                    p, sum(f[i].matches for f in per_file),
                    sum(f[i].lines for f in per_file))
                    for i, p in enumerate(patterns)]
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0
    if not distributed.is_coordinator():  # the coordinator reports
        return 0
    if batch_tel is not None:
        batch_tel.ledger_write("run_end", bytes=input_bytes,
                               words=sum(r.matches for r in results),
                               elapsed_s=round(elapsed, 6))
    out = sys.stdout
    multi = len(results) > 1
    if records is not None and args.format != "json":
        out.flush()  # the lines go out as their bytes
        out.buffer.write(b"".join(r + b"\n" for r in records))
        out.buffer.flush()
    if records is not None and args.format == "json":
        out.write(json.dumps({
            "pattern": args.grep[0], "matches": results[0].matches,
            "lines": results[0].lines,
            "records": [r.decode("utf-8", errors="backslashreplace")
                        for r in records]}) + "\n")
    elif args.format == "json":
        if multi:
            out.write(json.dumps({"patterns": [
                {"pattern": g, "matches": r.matches, "lines": r.lines}
                for g, r in zip(args.grep, results)]}) + "\n")
        else:
            out.write(json.dumps({"pattern": args.grep[0],
                                  "matches": results[0].matches,
                                  "lines": results[0].lines}) + "\n")
    elif args.format == "tsv":
        if multi:
            for g, r in zip(args.grep, results):
                out.write(f"{g}\t{r.matches}\t{r.lines}\n")
        else:
            out.write(f"matches\t{results[0].matches}\n"
                      f"lines\t{results[0].lines}\n")
    else:
        for g, r in zip(args.grep, results):
            if multi:
                out.write(f"Pattern:{g}\n")
            out.write(f"Matches:{r.matches}\n")
            out.write(f"Matching Lines:{r.lines}\n")
    if args.stats:
        _print_stats(input_bytes, sum(r.matches for r in results),
                     "matches", elapsed)
    return 0


def _sample_main(args, paths, data, config: Config, device,
                 input_bytes: int, tel) -> int:
    """``--sample``: a uniform token sample instead of counts (the JAX
    ``_sample_main``)."""
    from mapreduce_tpu_torch.models import sample as sample_mod
    from mapreduce_tpu_torch.runtime import profiling

    batch_tel = tel if not args.stream else None
    if batch_tel is not None:
        _batch_run_start(batch_tel, "sample", paths, config, input_bytes)
    t0 = time.perf_counter()
    try:
        with profiling.trace(args.profile):
            if args.stream:
                result = sample_mod.sample_file(
                    paths, args.sample, config, device,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every if args.checkpoint
                    else 0, retry=args.retry, telemetry=tel)
            else:
                result = sample_mod.sample_bytes(data, args.sample, config,
                                                 device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0
    if result is None:  # a rank other than the coordinator, which reports
        return 0
    if batch_tel is not None:
        batch_tel.ledger_write("run_end", bytes=input_bytes,
                               words=result.total,
                               elapsed_s=round(elapsed, 6))
    out = sys.stdout
    display = _decode(result.tokens)
    if args.format == "json":
        out.write(json.dumps({"sample": display, "k": args.sample,
                              "total": result.total}) + "\n")
    elif args.format == "tsv":
        for w in display:
            out.write(w + "\n")
    else:
        out.write("--------------------------\n")
        for w in display:
            out.write(w + "\n")
        out.write("--------------------------\n")
        out.write(f"Sampled:{len(display)} of {result.total}\n")
    if args.stats:
        _print_stats(input_bytes, result.total, "tokens", elapsed)
    return 0


def _check_grep_records(parser, args) -> None:
    """``--grep-records``' usage errors: one pattern, no sample, no
    autotune, no snapshot and one rank (records mode's state grows with
    its output)."""
    if args.grep is None:
        parser.error("--grep-records requires --grep")
    if len(args.grep) > 1:
        parser.error("--grep-records takes one --grep pattern, got "
                     f"{len(args.grep)}")
    for flag, present in (("--sample", args.sample is not None),
                          ("--autotune", args.autotune),
                          ("--checkpoint", bool(args.checkpoint))):
        if present:
            parser.error(f"{flag} is not supported with --grep-records")
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world > 1:
        parser.error(f"--grep-records runs on one rank, not {world}")


def main(argv: list[str] | None = None) -> int:
    from mapreduce_tpu_torch.parallel import distributed

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.grep_records:
        _check_grep_records(parser, args)
        args.stream = True  # records mode runs on the streamed executor
    if args.ngram < 1:
        parser.error(f"--ngram must be >= 1, got {args.ngram}")
    if (args.count_sketch or args.estimate) and not args.stream:
        parser.error("--count-sketch/--estimate require --stream")
    if args.distinct_sketch and not args.stream:
        parser.error("--distinct-sketch requires --stream")
    if args.sketch_flush_every != 1 and not (args.distinct_sketch
                                             or args.count_sketch
                                             or args.estimate):
        parser.error("--sketch-flush-every requires a sketch flag "
                     "(--distinct-sketch / --count-sketch / --estimate)")
    if args.checkpoint and not args.stream:
        parser.error("--checkpoint requires --stream")
    if args.autotune and not args.stream:
        parser.error("--autotune requires --stream (the single-buffer path "
                     "has no pipeline knobs to tune)")
    if args.autotune and (args.grep is not None or args.sample is not None):
        parser.error("--autotune applies to word-count runs only")
    if args.retry and not args.stream:
        parser.error("--retry requires --stream (the non-stream path has no "
                     "step dispatch to retry)")
    if args.retry < 0:
        parser.error(f"--retry must be >= 0, got {args.retry}")
    if args.fault_plan is not None and not args.stream:
        parser.error("--fault-plan requires --stream (the injection seams "
                     "exist only on the streamed path)")
    if args.grep_syntax != "literal" and args.grep is None:
        parser.error("--grep-syntax requires --grep")
    if (args.count_sketch or args.estimate) and args.distinct_sketch:
        parser.error("--count-sketch/--estimate and --distinct-sketch are "
                     "mutually exclusive per run")
    if args.sample is not None and args.sample < 1:
        parser.error(f"--sample must be >= 1, got {args.sample}")
    if args.grep is not None or args.sample is not None:
        # Grep and sample count no words: a word-count flag is an error.
        mode = "--grep" if args.grep is not None else "--sample"
        for flag, present in (("--ngram", args.ngram != 1),
                              ("--top-k", bool(args.top_k)),
                              ("--distinct-sketch", args.distinct_sketch),
                              ("--count-sketch", args.count_sketch),
                              ("--estimate", bool(args.estimate)),
                              ("--merge-every", args.merge_every != 1)):
            if present:
                parser.error(f"{flag} is not supported with {mode}")
    if args.grep is not None and args.sample is not None:
        parser.error("--grep and --sample are mutually exclusive")
    if args.verify_sample:
        if args.verify_sample < 0:
            parser.error(f"--verify-sample must be >= 0, got "
                         f"{args.verify_sample}")
        if args.ngram > 1 or args.grep is not None \
                or args.sample is not None:
            # Recounting is word-keyed: gram spans hold separators, and
            # grep and sample report no counts to check.
            parser.error("--verify-sample applies to word-count runs only")
    if args.ngram > 1 and args.merge_every > 1:
        parser.error("--merge-every applies to word-count runs only "
                     "(not --ngram)")
    if args.merge_every != 1 and not args.stream:
        parser.error("--merge-every requires --stream")
    if args.merge_strategy != "tree":
        if not args.stream:
            parser.error("--merge-strategy requires --stream")
        if args.grep is not None or args.sample is not None:
            parser.error("--merge-strategy applies to word-count runs only")
        if args.merge_strategy.startswith("hier-"):
            # The two-level programs place their legs on named mesh axes;
            # the CLI drives one axis of ranks, as the JAX CLI drives a
            # 1-D mesh: the same usage error.
            parser.error(f"--merge-strategy {args.merge_strategy} needs a "
                         "multi-axis device mesh; the CLI drives a 1-D "
                         "mesh (2-D programs run via the fleet registry "
                         "twins / run_job_global)")
    if args.merge_overlap:
        if not args.stream:
            parser.error("--merge-overlap requires --stream")
        if args.retry:
            parser.error("--merge-overlap requires --retry 0 (the replay "
                         "anchor snapshots local state only; an overlapped "
                         "window has shipped counts the anchor cannot "
                         "restore)")
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world > 1 and not args.stream:
        # A world of ranks streams: the single-buffer path has no steps
        # to spread.
        parser.error(f"a world of {world} ranks runs --stream only")
    paths = args.input
    try:
        chunks = []
        input_bytes = 0
        for path in paths:  # one pass, so a failure blames the right file
            input_bytes += os.path.getsize(path)
            with open(path, "rb") as f:
                if not args.stream:
                    chunks.append(f.read())
        # Files are independent token streams: a separator joins them.
        # Grep keeps the list: its patterns may hold the separator, so a
        # join could make a match across two files.
        if args.stream:
            data = None
        elif args.grep is not None:
            data = chunks
        else:
            data = b"\n".join(chunks)
        del chunks
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 2
    try:
        config = Config(chunk_bytes=args.chunk_bytes,
                        table_capacity=args.table_capacity,
                        backend=args.backend,
                        pallas_max_token=args.max_token_bytes,
                        sort_mode=args.sort_mode,
                        compact_slots=_compact_slots(parser, args),
                        rescue_overlong=args.rescue_overlong,
                        rescue_overlong_max=args.rescue_overlong_max,
                        rescue_window=args.rescue_window,
                        sort_impl=args.sort_impl, map_impl=args.map_impl,
                        combiner=args.combiner,
                        combiner_slots=args.combiner_slots,
                        geometry=args.geometry,
                        superstep=args.superstep,
                        inflight_groups=args.inflight,
                        prefetch_depth=args.prefetch_depth,
                        sketch_flush_every=args.sketch_flush_every,
                        merge_every=args.merge_every,
                        fault_plan=args.fault_plan,
                        merge_strategy=args.merge_strategy,
                        merge_overlap=args.merge_overlap,
                        autotune="hint" if args.autotune else "off")
    except ValueError as e:
        parser.error(str(e))
    config = _resolve_auto(args, config)
    if args.sort_mode == "segmin" and args.platform != "cpu":
        from mapreduce_tpu_torch.config import (SEGMIN_TPU_ERROR,
                                                segmin_allowed)

        # The JAX CLI's guard, before any device work.
        if not segmin_allowed():
            print(f"error: {SEGMIN_TPU_ERROR}", file=sys.stderr)
            return 2
    joined = not distributed.initialized()
    try:
        device = distributed.initialize(args.platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    try:
        return _run(args, paths, data, config, device, input_bytes)
    finally:
        if joined:  # a caller's world stays the caller's
            distributed.shutdown()


def _run(args, paths, data, config: Config, device, input_bytes: int) -> int:
    """The run and its report; only the coordinator writes the ledger,
    the metrics and stdout."""
    from mapreduce_tpu_torch.parallel import distributed

    # One telemetry handle for the run: the ledger and flight recorder
    # (--ledger) and the registry snapshot (--metrics-out), written in the
    # finally, so a run that failed leaves them too.  Every rank of a
    # world runs the same stats mode: each gets a handle, the ledger is
    # the coordinator's.  --autotune forces a handle (without a ledger when
    # --ledger is absent): the CLI prints the hint from it.
    coordinator = distributed.is_coordinator()
    tel = None
    if args.ledger or args.metrics_out or args.autotune:
        from mapreduce_tpu_torch.obs.telemetry import Telemetry

        try:
            tel = Telemetry.create(
                ledger_path=args.ledger if coordinator else None)
        except OSError as e:
            print(f"error: cannot open ledger {args.ledger}: {e}",
                  file=sys.stderr)
            return 2
    try:
        if args.grep is not None:
            return _grep_main(args, paths, data, config, device,
                              input_bytes, tel)
        if args.sample is not None:
            return _sample_main(args, paths, data, config, device,
                                input_bytes, tel)
        return _wordcount(args, paths, data, config, device, input_bytes,
                          tel)
    except Exception as e:
        from mapreduce_tpu_torch.runtime import faults

        if not isinstance(e, faults.Preempted):
            raise
        # An orderly shutdown, not a crash: the stream drained and (with
        # --checkpoint) saved its cursor.  Exit 75 (EX_TEMPFAIL): run the
        # same command again to resume.
        print(f"preempted: {e}", file=sys.stderr)
        return 75
    finally:
        if tel is not None:
            if args.metrics_out and coordinator:
                try:
                    with open(args.metrics_out, "w") as f:
                        json.dump(tel.registry.snapshot(), f, indent=1)
                        f.write("\n")
                except OSError as e:
                    print(f"error: cannot write {args.metrics_out}: {e}",
                          file=sys.stderr)
            tel.close()


if __name__ == "__main__":
    raise SystemExit(main())
