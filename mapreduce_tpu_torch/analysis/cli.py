"""graphcheck CLI: run the pass pipeline over the built-in models.

Counterpart of :mod:`mapreduce_tpu.analysis.cli`.
``python -m mapreduce_tpu_torch.analysis --all-models`` analyzes every
model of the registry (``models/__init__.py``) on the card and exits
non-zero when any error-severity finding fires; ``--platform cpu`` runs
the same analysis on the host.  Without a card and without
``--platform cpu`` it raises (``runtime/platform.py:resolve_device``),
like every entry point of the port.  ``--write-baselines`` regenerates
the port's cost baselines (``analysis/baselines/<model>.json`` and, for
the fleet twins, ``<model>.collective.json``).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphcheck",
        description="static analyzer for mapreduce_tpu_torch jobs, over "
                    "op traces (reducer algebra, overflow/dtype, "
                    "host-sync, collective groups; costcheck: "
                    "device-memory cost, shared-memory and register "
                    "budgets, kernel cross-block protocols, fusion leads, "
                    "collective cost over the fleet's links).")
    p.add_argument("models", nargs="*",
                   help="built-in model names to analyze "
                        "(default: all; see --list)")
    p.add_argument("--all-models", action="store_true",
                   help="analyze every built-in model")
    p.add_argument("--list", action="store_true",
                   help="list built-in models and registered passes")
    p.add_argument("--corpus-bytes", type=int, default=1 << 40,
                   help="corpus-scale bound for the overflow lint "
                        "(default 1 TiB)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON")
    p.add_argument("--min-severity", choices=("error", "warning", "info"),
                   default="info",
                   help="hide findings below this severity in text output")
    p.add_argument("--write-baselines", action="store_true",
                   help="regenerate the per-model cost baselines "
                        "(analysis/baselines/*.json) instead of gating "
                        "against them; commit the result deliberately")
    p.add_argument("--baselines-dir", default=None, metavar="DIR",
                   help="read/write cost baselines here instead of the "
                        "checked-in analysis/baselines/")
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                   help="'gpu' (default) traces on the card and fails "
                        "without one; 'cpu' traces on the host")
    return p


def analyze_models(names, device, corpus_bytes: int = 1 << 40,
                   baselines_dir=None, write_baselines: bool = False,
                   card_attributes: bool | None = None):
    """The pipeline over each named registry model on ``device``, then the
    shipped kernel plans (and, on the card, what the card reports of each
    kernel).  Returns the :class:`~.core.Report`."""
    from mapreduce_tpu_torch import analysis
    from mapreduce_tpu_torch import models as models_mod
    from mapreduce_tpu_torch.analysis.passes import kernelrace, smem

    report = analysis.Report()
    for name in names:
        job = models_mod.build_model(name, device=device)
        one = analysis.analyze_job(job, model=name, device=device,
                                   corpus_bytes=corpus_bytes,
                                   baselines_dir=baselines_dir,
                                   write_baselines=write_baselines)
        report.models.extend(one.models)
        report.extend(one.findings)
        report.artifacts.update(one.artifacts)
    # The shipped plans are certified once a run, not per model: they
    # cover the production chunk the toy analysis configs never trace.
    report.models.append("<kernels>")
    report.extend(smem.certify_production_kernels())
    report.extend(kernelrace.certify_sources())
    if card_attributes is None:
        card_attributes = device.type == "cuda"
    if card_attributes:
        from mapreduce_tpu_torch.analysis import kernel_info

        report.extend(smem.certify_card_attributes(
            kernel_info.card_attributes()))
    return report


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from mapreduce_tpu_torch import analysis
    from mapreduce_tpu_torch import models as models_mod
    from mapreduce_tpu_torch.runtime.platform import resolve_device

    if args.list:
        print("models:", ", ".join(models_mod.model_names()))
        print("passes:", ", ".join(analysis.pass_ids()))
        return 0
    device = resolve_device(None if args.platform == "gpu" else "cpu")

    names = list(args.models)
    if args.all_models or not names:
        names = models_mod.model_names()
    unknown = [n for n in names if n not in models_mod.model_names()]
    if unknown:
        print(f"graphcheck: unknown model {unknown[0]!r}; known: "
              f"{', '.join(models_mod.model_names())}", file=sys.stderr)
        return 2
    report = analyze_models(names, device, args.corpus_bytes,
                            args.baselines_dir, args.write_baselines)
    if args.json:
        print(report.as_json())
    else:
        print(report.format_text(min_severity=args.min_severity))
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
