"""The readings that set a reference's limits: sound runs and controls.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 3] [--out chiprun_out/control.jsonl]

For each seed it generates the cell's corpus at the cell's own size, runs
the program's job on it once (the cell's load: one client, one whole job)
and reads the reference's ``readings`` against its answer.  On the first
``--control-seeds`` seeds it also reads each of the reference's
``CONTROLS``, each breaking one guarantee that the configuration states
(for the word count: ``unordered``, a recovery without its ordering
sort, and ``rescue_off``, the program with words past the kernel's
W = 32 bytes dropped).

The sound runs give each number's lower reading, the controls its upper;
the reference's ``LIMITS`` lie between them.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Optional

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import cell, corpus  # noqa: E402


def seed_readings(workload: str, seed: int, device: str, with_controls: bool,
                  corpus_override=None, program_override=None) -> dict:
    """``{"program": readings, <control>: readings, ...}`` for one seed at
    the cell's size (or the overrides')."""
    from mapreduce_tpu_torch.config import Config

    cfg = cell.load_cell(workload)["config"]
    corpus_spec = {**cfg["corpus"], **(corpus_override or {})}
    listed = corpus_spec["listed"]
    program = {**cfg["program"], **(program_override or {})}
    entry, ref = cell.load("jobs", cfg["job"]), cell.load("reference",
                                                           cfg["job"])
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as d:
        path = os.path.join(d, "part.txt")
        part = corpus.generate(corpus_spec, seed)
        cell.write_synced(path, part)
        exp = ref.expected(part, listed)
        del part
        logger = cell.quiet_logger()

        def run(overrides: Optional[dict] = None):
            config = Config(**{**program, **(overrides or {})})
            return entry.run([path] * listed, config, device, logger)[0]

        out = {"program": ref.readings(run(), exp)}
        if with_controls:
            for name, control in ref.CONTROLS.items():
                out[name] = ref.readings(control(exp, run), exp)
    return out


def main(argv: list) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the control needs a CUDA card", file=sys.stderr)
        return 2
    job = cell.load_cell(args.workload)["config"]["job"]
    ref = cell.load("reference", job)
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = seed_readings(args.workload, seed, "cuda",
                          i < args.control_seeds)
        line = {"workload": args.workload, "seed": seed,
                "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0), **r}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "seeds": len(seeds),
               "lower": {k: max(ln["program"][k] for ln in lines)
                         for k in ref.LIMITS}}
    for control in ref.CONTROLS:
        got = [ln[control] for ln in lines if control in ln]
        summary[control] = {k: min(g[k] for g in got) for k in ref.LIMITS}
    summary["limits"] = ref.LIMITS
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
