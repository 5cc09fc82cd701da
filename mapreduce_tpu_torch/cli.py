"""Command line of the port: ``python -m mapreduce_tpu_torch file [file...]``.

Counterpart of :mod:`mapreduce_tpu.cli` for word count.  Its stdout is
byte-identical to the JAX CLI's for the flags it takes; every other flag
of the JAX CLI is refused with a usage error.  The run goes to the card
unless ``--platform cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mapreduce_tpu_torch.config import Config

_CTRL_ESCAPES = str.maketrans({"\t": "\\t", "\n": "\\n", "\r": "\\r",
                               "\x00": "\\x00", "\x0b": "\\x0b",
                               "\x0c": "\\x0c"})


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
                   help="stream the files chunk by chunk (large inputs)")
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
                        combiner_slots=args.combiner_slots)
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.platform.replace("gpu", "cuda"))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3

    if args.stream:
        from mapreduce_tpu_torch.runtime.executor import count_file

        result = count_file(paths, config, device, top_k=args.top_k or None)
    else:
        from mapreduce_tpu_torch.models import wordcount

        result = wordcount.count_words(data, config, device)
        if args.top_k:
            result = wordcount.apply_top_k(result, args.top_k)

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
