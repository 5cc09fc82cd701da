"""Pass: static device-memory cost certifier with a measured cross-check.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.cost` (pass id
``hbm-cost``), over op traces and the port's byte model
(:mod:`..costmodel`: eager PyTorch fuses nothing, so every non-view op
moves its operands and results):

1. **Cost report** (artifact ``cost``): per-program bytes read/written,
   launches and host reads from the step/finish traces, and ``effective
   input passes`` -- the step's device bytes over its chunk's bytes.

2. **Sort cross-check**: on the shipped packed path (kernel backend,
   stable2, the torch sort, no combiner) the map's aggregation sort must
   see EXACTLY the rows the port's stream arithmetic gives -- the live
   rows the map's one host read reported (tokens and overlong poison
   rows) and the dense stream's one dead row.  The measured leg reads the
   card's fixture ``baselines/measured_rates.json`` (written by
   ``chip_smoke.py`` phase 15, with the card's name and power limit): the
   same arithmetic on the card's own 32 MB chunk, and the sort's
   milliseconds there as effective passes of its three planes at the
   card's measured copy rate.

3. **Baseline regression gate**: each model's effective passes is checked
   into ``analysis/baselines/<model>.json`` (the port's own numbers,
   written by ``--write-baselines``).  Growth beyond
   ``REGRESSION_TOLERANCE`` (20 %) is an ERROR; a shrink past the same
   margin is a WARNING nudging a re-baseline.

4. **Twin gates**, the JAX package's three, each in the port's relation
   (see each method): fused against split, combiner against uncombined,
   telemetry within 1 % of the plain program.
"""

from __future__ import annotations

import json
import os

from mapreduce_tpu_torch.analysis import core, costmodel, trace

REGRESSION_TOLERANCE = 0.20

# Fused-map models gated against their split-path twin (same chunk,
# Config.map_impl the only delta).
_SPLIT_COUNTERPART = {"wordcount_fused": "wordcount_pallas",
                      "wordcount_fused_telemetry": "wordcount_telemetry"}

# Combiner models gated against their combiner-off twin (same chunk,
# Config.combiner the only delta); both exempt from the fused gate.
_UNCOMBINED_COUNTERPART = {"wordcount_combiner": "wordcount_nocombiner"}
_FUSED_GATE_EXEMPT = set(_UNCOMBINED_COUNTERPART) \
    | set(_UNCOMBINED_COUNTERPART.values())

# Data-stats models gated against their uninstrumented twin.
_PLAIN_COUNTERPART = {"wordcount_telemetry": "wordcount_pallas",
                      "wordcount_fused_telemetry": "wordcount_fused"}
TELEMETRY_TOLERANCE = 0.01

_BASELINES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "baselines")
RATES_PATH = os.path.join(_BASELINES_DIR, "measured_rates.json")
_REGENERATE = ("python -m mapreduce_tpu_torch.analysis --write-baselines "
               "--platform cpu")


def measured_rates(path: str | None = None) -> dict | None:
    """The card's fixture, or None before a card wrote one."""
    path = path or RATES_PATH
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def baseline_path(model: str, baselines_dir: str | None = None) -> str:
    return os.path.join(baselines_dir or _BASELINES_DIR, f"{model}.json")


def load_baseline(model: str, baselines_dir: str | None = None):
    path = baseline_path(model, baselines_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _usable(base) -> float | None:
    raw = None if base is None else base.get("effective_input_passes")
    if not isinstance(raw, (int, float)) or raw <= 0:
        return None
    return float(raw)


@core.register_pass
class CostPass:
    pass_id = "hbm-cost"
    description = ("static device-memory cost report; the aggregation "
                   "sort held to the stream arithmetic and the card's "
                   "fixture; baseline regression and twin gates")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        chunk_bytes = trace._chunk_bytes_for(ctx.job)
        report: dict = {"traced_chunk_bytes": chunk_bytes, "programs": {}}
        config = getattr(ctx.job, "config", None)
        if config is not None and hasattr(config, "geometry_label"):
            report["geometry"] = config.geometry_label

        step_cost = None
        collective_bytes: dict = {}
        for hook, traced in ctx.engine_traces.items():
            if isinstance(traced, trace.TraceFailure):
                out.append(core.Finding(
                    severity=core.ERROR, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"the {hook} program failed on the sample "
                             f"chunk ({traced.error_type}: {traced.error})"),
                    hint="the Engine must run the job on its mesh"))
                continue
            cost = costmodel.program_cost(traced)
            report["programs"][hook] = cost.as_dict()
            collective_bytes[hook] = cost.collective_bytes
            if hook == "step":
                step_cost = cost
        if step_cost is None:
            return out

        # The collective family, as in the JAX report: interconnect bytes,
        # left out of the device total; ``priced`` stays False here and
        # the collective-cost pass sets it with the modeled seconds.
        total_coll = sum(collective_bytes.values())
        report["collective"] = {
            "per_program_bytes": collective_bytes,
            "total_bytes": total_coll,
            "priced": False,
            "note": "interconnect bytes this rank sends, excluded from the "
                    "device total; priced by the collective-cost pass "
                    "(meshcost link model) over a fleet's mesh"}
        if total_coll:
            out.append(core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="finish" if collective_bytes.get("finish") else "step",
                message=(f"collective family: {total_coll >> 10} KiB "
                         "interconnect traffic ("
                         + ", ".join(f"{h}={b}" for h, b in
                                     sorted(collective_bytes.items()))
                         + " bytes), excluded from the device total"),
                hint="the collective-cost pass prices these bytes per "
                     "link level (NVLink / network) via "
                     "analysis/meshcost.py"))

        passes = step_cost.device_bytes / max(chunk_bytes, 1)
        report["effective_input_passes"] = round(passes, 3)
        out.append(core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=(f"step moves {step_cost.device_bytes >> 10} KiB of "
                     f"device memory for a {chunk_bytes >> 10} KiB chunk = "
                     f"{passes:.2f} effective input passes "
                     f"({step_cost.launches} launches, "
                     f"{step_cost.host_reads} host sync(s))"),
            hint="eager bound: every non-view op reads its operands and "
                 "writes its results (nothing fuses)"))

        out.extend(self._sort_findings(ctx, report))
        out.extend(self._baseline_findings(ctx, report))
        out.extend(self._fused_gate_findings(ctx, report))
        out.extend(self._combiner_gate_findings(ctx, report))
        out.extend(self._telemetry_gate_findings(ctx, report))
        ctx.artifacts["cost"] = report
        return out

    # -- the sort cross-check ------------------------------------------

    def _sort_findings(self, ctx, report) -> list[core.Finding]:
        config = getattr(ctx.job, "config", None)
        step = ctx.engine_traces.get("step")
        if config is None or step is None or \
                isinstance(step, trace.TraceFailure):
            return []
        if config.resolved_backend() != "pallas" or \
                config.sort_mode != "stable2" or config.sort_impl != "xla" \
                or config.resolved_combiner_slots:
            return []
        sort = costmodel.find_aggregation_sort(step)
        expected = costmodel.stream_rows(step)
        if sort is None or expected is None:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message="kernel/stable2/torch-sort config but no host read "
                        "and key sort of the cut stream in the step trace",
                hint="the packed fast path changed shape; update "
                     "costmodel.find_aggregation_sort with it")]
        art = {"traced_rows": sort.rows, "expected_rows": expected,
               "location": sort.location}
        report["aggregation_sort"] = art
        if sort.rows != expected:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"aggregation sort carries {sort.rows} rows but "
                         f"the stream arithmetic gives {expected} (the "
                         "read's tokens + overlong rows + the dead row)"),
                location=sort.location,
                hint="the live cut no longer feeds the sort; fix "
                     "_map_kernel's cut or costmodel.stream_rows")]
        out = [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=(f"aggregation sort sees {sort.rows} rows, the stream "
                     "arithmetic's exactly"),
            location=sort.location)]
        from mapreduce_tpu_torch.config import DEFAULT_GEOMETRY

        if config.resolved_geometry != DEFAULT_GEOMETRY:
            art["measured_leg"] = "skipped: non-default geometry " \
                f"({config.geometry_label}); the fixture is the default's"
            return out
        return out + self._measured_findings(ctx, art)

    def _measured_findings(self, ctx, art) -> list[core.Finding]:
        """The card fixture: its own stream arithmetic must hold, and its
        sort milliseconds become effective passes at its copy rate."""
        rates = measured_rates()
        if rates is None:
            art["measured_leg"] = "no card fixture"
            return [core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message="measured leg: no card fixture "
                        "(baselines/measured_rates.json) yet",
                hint="chip_smoke.py phase 15 writes it on the card")]
        try:
            rows, tokens, over = (int(rates[k]) for k in (
                "sort_rows", "tokens", "overlong"))
            pass_ms = 2 * rows * 3 * 8 / (float(rates["copy_gbps"]) * 1e6)
            passes = float(rates["sort_ms"]) / pass_ms
            card = f"{rates['card']}, {rates['power_limit']}"
        except (KeyError, TypeError, ValueError, ZeroDivisionError) as e:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=f"measured_rates.json is malformed ({e!r})",
                hint="rerun chip_smoke.py phase 15 on the card")]
        art.update({"card": card, "production_rows": rows,
                    "one_pass_ms": round(pass_ms, 4),
                    "measured_passes": round(passes, 3)})
        if rows != tokens + over + 1:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"the card's fixture sorted {rows} rows of a chunk "
                         f"of {tokens} tokens and {over} overlong runs: not "
                         "the stream arithmetic's"),
                hint="the card's live cut differs from the CPU's; rerun "
                     "chip_smoke.py phase 15 and compare the traces")]
        return [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=(f"measured on {card}: the aggregation sort of {rows} "
                     f"rows at the {rates['chunk_bytes'] >> 20} MB chunk "
                     f"takes {rates['sort_ms']:.3f} ms = {passes:.2f} "
                     "effective passes of its three planes"))]

    # -- twin gates -----------------------------------------------------

    def _twin(self, ctx, report, twin: str, what: str):
        """``(twin's passes, None)`` when comparable, else ``(None,
        [ERROR])``."""
        base = load_baseline(twin, ctx.baselines_dir)
        ref = _usable(base)
        if ref is None or base.get("traced_chunk_bytes") \
                != report["traced_chunk_bytes"]:
            got = None if base is None else (
                base.get("effective_input_passes"),
                base.get("traced_chunk_bytes"))
            return None, [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"{what} counterpart {twin!r} has no comparable "
                         f"baseline ({got!r} vs chunk "
                         f"{report['traced_chunk_bytes']}): the gate "
                         "cannot run"),
                hint=f"regenerate with `{_REGENERATE} {twin}` and keep "
                     "the twins on one chunk")]
        return ref, None

    def _fused_gate_findings(self, ctx, report) -> list[core.Finding]:
        """The JAX gate: fused prices STRICTLY below split, because its
        fused kernel deletes the token-plane round trip of the split path.
        In the port both map paths launch the SAME kernel
        (``tokenize_stream``) and emit the same dense stream: only the
        name its launches count under differs.  So the port's relation is
        EQUAL: a fused step that prices other than its split twin means
        the two paths diverged."""
        config = getattr(ctx.job, "config", None)
        passes = report.get("effective_input_passes")
        if config is None or passes is None or config.map_impl != "fused" \
                or config.resolved_backend() != "pallas" \
                or ctx.model in _FUSED_GATE_EXEMPT:
            return []
        split_model = _SPLIT_COUNTERPART.get(ctx.model)
        if split_model is None:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message="fused map path with no declared split counterpart",
                hint="add the pair to cost._SPLIT_COUNTERPART")]
        ref, bad = self._twin(ctx, report, split_model, "split")
        if bad:
            return bad
        report["fused_vs_split"] = {
            "split_model": split_model, "relation": "equal",
            "split_effective_input_passes": ref,
            "fused_effective_input_passes": passes}
        if round(passes, 3) != round(ref, 3):
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"fused map path prices {passes:.3f} effective "
                         f"passes, not the split baseline's {ref:.3f} "
                         f"({split_model}): the one kernel's two paths "
                         "diverged"),
                hint="the fused and split maps must run the same stream "
                     "(models/wordcount.py:_tokenize)")]
        return [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=(f"fused equals split: {passes:.3f} effective passes "
                     f"({split_model}): one kernel, one stream"))]

    def _combiner_gate_findings(self, ctx, report) -> list[core.Finding]:
        """The JAX gate, as it is: a hot-key combiner model must price
        STRICTLY below its combiner-off twin at the same chunk -- the
        cache exists to delete sort rows.  The port's combiner leaves the
        dense stream of the rows it keeps and folds its cache into the
        chunk's table in one kernel pass; a combiner that prices at or
        above its twin is a finding of the port (ROADMAP A15), not a gate
        to loosen."""
        config = getattr(ctx.job, "config", None)
        passes = report.get("effective_input_passes")
        off_model = _UNCOMBINED_COUNTERPART.get(ctx.model)
        if config is None or passes is None or off_model is None:
            return []
        if not config.resolved_combiner_slots:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message="combiner-gated model resolves to NO hot-key cache: "
                        "the gate would compare two identical programs",
                hint="keep COMBINER_ANALYSIS_CONFIG on the fused path with "
                     "combiner='hot-cache'")]
        ref, bad = self._twin(ctx, report, off_model, "combiner-off")
        if bad:
            return bad
        report["combiner_vs_off"] = {
            "off_model": off_model,
            "off_effective_input_passes": ref,
            "combiner_effective_input_passes": passes,
            "passes_saved": round(ref - passes, 3)}
        if passes >= ref:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"hot-key combiner prices {passes:.2f} effective "
                         f"passes, NOT strictly below the combiner-off "
                         f"baseline {ref:.2f} ({off_model}): the windowed "
                         "stream it keeps outweighs the rows it deletes"),
                hint="thin the combiner's stream to its live rows "
                     "(ROADMAP A15), or re-measure deliberately")]
        return [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=(f"combiner certified: {passes:.2f} effective passes "
                     f"vs combiner-off baseline {ref:.2f} ({off_model})"))]

    def _telemetry_gate_findings(self, ctx, report) -> list[core.Finding]:
        """The JAX gate, as it is: a data-stats model must price within
        ``TELEMETRY_TOLERANCE`` of its uninstrumented twin's baseline."""
        plain_model = _PLAIN_COUNTERPART.get(ctx.model)
        passes = report.get("effective_input_passes")
        if plain_model is None or passes is None:
            return []
        ref, bad = self._twin(ctx, report, plain_model, "uninstrumented")
        if bad:
            return bad
        overhead = (passes - ref) / ref
        report["telemetry_overhead"] = {
            "plain_model": plain_model,
            "plain_effective_input_passes": ref,
            "instrumented_effective_input_passes": passes,
            "overhead_frac": round(overhead, 5),
            "tolerance": TELEMETRY_TOLERANCE}
        if abs(overhead) > TELEMETRY_TOLERANCE:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"data-stats instrumentation moves "
                         f"effective_input_passes {overhead:+.2%} "
                         f"({passes:.2f} vs {ref:.2f} {plain_model}), past "
                         f"the {TELEMETRY_TOLERANCE:.0%} gate"),
                hint="keep the counters to values the map already holds")]
        return [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=(f"telemetry overhead certified: {passes:.2f} vs "
                     f"{ref:.2f} uninstrumented ({overhead:+.3%}, gate "
                     f"{TELEMETRY_TOLERANCE:.0%})"))]

    # -- baseline regression gate ---------------------------------------

    def _baseline_findings(self, ctx, report) -> list[core.Finding]:
        passes = report["effective_input_passes"]
        step = report["programs"]["step"]
        if ctx.write_baselines:
            path = baseline_path(ctx.model, ctx.baselines_dir)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({
                    "model": ctx.model,
                    "effective_input_passes": passes,
                    "step_device_bytes": step["device_bytes"],
                    "step_launches": step["launches"],
                    "step_host_reads": step["host_reads"],
                    "traced_chunk_bytes": report["traced_chunk_bytes"],
                    "_regenerate": _REGENERATE,
                }, f, indent=2)
                f.write("\n")
            return [core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="step", message=f"baseline written: {path}")]
        base = load_baseline(ctx.model, ctx.baselines_dir)
        if base is None:
            return [core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="step",
                message="no cost baseline checked in for this model",
                hint=f"regenerate with `{_REGENERATE} {ctx.model}` and "
                     "commit the JSON")]
        ref = _usable(base) or 0.0
        report["baseline_effective_input_passes"] = ref
        if ref <= 0:
            return []
        growth = (passes - ref) / ref
        if growth > REGRESSION_TOLERANCE:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"predicted device passes regressed {growth:+.0%}: "
                         f"{passes:.2f} vs baseline {ref:.2f} "
                         f"(gate: {REGRESSION_TOLERANCE:.0%})"),
                hint="either fix the regression or regenerate baselines "
                     "deliberately (--write-baselines)")]
        if growth < -REGRESSION_TOLERANCE:
            return [core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="step",
                message=(f"predicted device passes improved {growth:+.0%} "
                         f"vs baseline {ref:.2f}"),
                hint="re-baseline (--write-baselines) so the gate "
                     "protects the win")]
        return []
