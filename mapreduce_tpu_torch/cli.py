"""Command line of the port: ``python -m mapreduce_tpu_torch file [file...]``.

Counterpart of :mod:`mapreduce_tpu.cli` for word count.  Its stdout is
byte-identical to the JAX CLI's for the flags it takes; every other flag
of the JAX CLI is refused with a usage error.  The run goes to the card
unless ``--platform cpu`` asks for the CPU.  Progress logs and ``--stats``
go to stderr.  A preempted streamed run (SIGINT, or an injected
preemption) drains, checkpoints and exits 75.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mapreduce_tpu_torch.config import Config

_CTRL_ESCAPES = str.maketrans({"\t": "\\t", "\n": "\\n", "\r": "\\r",
                               "\x00": "\\x00", "\x0b": "\\x0b",
                               "\x0c": "\\x0c"})


#: Flags of the JAX CLI's streamed executor whose planes (window-boundary
#: merges, autotuner, ledger) are not ported.
_A8B_FLAGS = {"--merge-overlap": {"action": "store_const", "const": True},
              "--autotune": {"action": "store_const", "const": True},
              "--ledger": {"metavar": "PATH"}}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mapreduce-tpu-torch", allow_abbrev=False,
        description="MapReduce word count on an NVIDIA GPU "
                    "(reference-parity CLI).")
    p.add_argument("input", nargs="*", default=["test.txt"],
                   help="input text file(s) (default: test.txt; several "
                        "files count as one corpus)")
    p.add_argument("--top-k", type=int, default=0,
                   help="report only the k most frequent words (0 = all)")
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
    for flag, kw in _A8B_FLAGS.items():
        p.add_argument(flag, default=None,
                       help="not ported yet (ROADMAP.md item A8b)", **kw)
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
                        "'salt' and 'auto' are not ported yet")
    p.add_argument("--combiner-slots", type=int, default=None, metavar="C",
                   help="hot-key cache entries per segment for --combiner "
                        "hot-cache (multiple of 8 in [8, 32]; default 8)")
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


def main(argv: list[str] | None = None) -> int:
    from mapreduce_tpu_torch.runtime.platform import resolve_device

    parser = build_parser()
    args = parser.parse_args(argv)
    for flag in _A8B_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported to the PyTorch package yet "
                         "(ROADMAP.md item A8b)")
    if args.checkpoint and not args.stream:
        parser.error("--checkpoint requires --stream")
    if args.retry and not args.stream:
        parser.error("--retry requires --stream (the non-stream path has no "
                     "step dispatch to retry)")
    if args.retry < 0:
        parser.error(f"--retry must be >= 0, got {args.retry}")
    if args.fault_plan is not None and not args.stream:
        parser.error("--fault-plan requires --stream (the injection seams "
                     "exist only on the streamed path)")
    paths = args.input
    try:
        chunks = []
        for path in paths:  # one pass, so a failure blames the right file
            os.path.getsize(path)
            with open(path, "rb") as f:
                if not args.stream:
                    chunks.append(f.read())
        # Files are independent token streams: a separator joins them.
        data = None if args.stream else b"\n".join(chunks)
        del chunks
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 2
    try:
        config = Config(chunk_bytes=args.chunk_bytes,
                        table_capacity=args.table_capacity,
                        sort_impl=args.sort_impl, map_impl=args.map_impl,
                        combiner=args.combiner,
                        combiner_slots=args.combiner_slots,
                        superstep=args.superstep,
                        inflight_groups=args.inflight,
                        prefetch_depth=args.prefetch_depth,
                        fault_plan=args.fault_plan)
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.platform.replace("gpu", "cuda"))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3

    t0 = time.perf_counter()
    if args.stream:
        from mapreduce_tpu_torch.runtime import faults
        from mapreduce_tpu_torch.runtime.executor import count_file

        try:
            result = count_file(
                paths, config, device, top_k=args.top_k or None,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every if args.checkpoint
                else 0, retry=args.retry)
        except faults.Preempted as e:
            # An orderly shutdown, not a crash: the stream drained and
            # (with --checkpoint) saved its cursor.  Exit 75 (EX_TEMPFAIL):
            # run the same command again to resume.
            print(f"preempted: {e}", file=sys.stderr)
            return 75
    else:
        from mapreduce_tpu_torch.models import wordcount

        result = wordcount.count_words(data, config, device)
        if args.top_k:
            result = wordcount.apply_top_k(result, args.top_k)
    elapsed = time.perf_counter() - t0

    out = sys.stdout
    display = _decode(result.words)
    if args.format == "reference":
        if not args.no_echo:
            _echo_file(paths)
        out.write("--------------------------\n")
        for w, c in zip(display, result.counts):
            out.write(f"{w}\t{c}\n")
        out.write("--------------------------\n")
        out.write(f"Total Count:{result.total}\n")
    elif args.format == "tsv":
        for w, c in zip(display, result.counts):
            out.write(f"{w}\t{c}\n")
    else:
        out.write(json.dumps({
            "counts": [[w, c] for w, c in zip(display, result.counts)],
            "total": result.total,
            "distinct": result.distinct,
            "dropped_uniques": result.dropped_uniques,
            "dropped_count": result.dropped_count,
        }) + "\n")
    if args.stats:
        n_bytes = sum(os.path.getsize(p) for p in paths)
        print(f"[stats] {n_bytes} bytes, {result.total} words, "
              f"{elapsed:.3f}s, {n_bytes / 1e9 / elapsed:.3f} GB/s",
              file=sys.stderr)
        if result.run is not None:
            print("[stats] " + json.dumps({
                "phases": result.run.metrics.as_dict()["phases"],
                "pipeline": result.run.pipeline}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
