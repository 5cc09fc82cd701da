"""graphcheck core: findings, the pass registry, and the pipeline runner.

Counterpart of :mod:`mapreduce_tpu.analysis.core`.  The analyzer
certifies a job (:class:`~mapreduce_tpu_torch.parallel.mapreduce.MapReduceJob`
or any object with its hooks) *before* a streamed run: every hook and the
Engine's ``step``/``finish`` are recorded as op traces
(:mod:`mapreduce_tpu_torch.analysis.trace`: each aten op with its shapes
and dtypes, each hand-written kernel and each declared host sync as one
node), and a pipeline of pluggable passes walks those traces for the
hazards the type system cannot see -- a non-commutative merge fed to the
collective reduce, a 32-bit counter on a corpus that overflows it, a host
read hidden in the step, a kernel past the card's shared-memory budget.

Findings are structured (severity, pass id, hook, location, remediation
hint) so CI can gate on them: :meth:`Report.exit_code` is non-zero exactly
when an error-severity finding exists.  ``Finding``, ``Report`` and the
registry are the JAX package's, so the two packages' reports compare as
JSON.

Registering a custom pass::

    from mapreduce_tpu_torch.analysis import core

    @core.register_pass
    class MyPass:
        pass_id = "my-pass"
        description = "what it checks"

        def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
            ...

Passes run in registration order; each receives the shared
:class:`AnalysisContext` and returns findings (never raises -- a pass that
cannot run reports that as a finding).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Optional, Protocol, runtime_checkable

# Severity levels, most severe first.  Ordering is by list position.
ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITIES = (ERROR, WARNING, INFO)


def severity_rank(severity: str) -> int:
    """Lower rank = more severe (for sorting reports)."""
    return _SEVERITIES.index(severity)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured analyzer finding.

    ``location`` is human-oriented (a traced op and its source line, or a
    state-leaf path like ``state.count``); ``hint`` says how to
    fix it.  ``model`` is the registry name (or repr) of the analyzed job.
    """

    severity: str  # one of ERROR/WARNING/INFO
    pass_id: str  # which pass emitted it
    model: str  # which job/model was being analyzed
    hook: str  # which hook/program: init_state/map_chunk/combine/merge/...
    message: str  # what is wrong
    location: str = ""  # where (traced op, leaf path, ...)
    hint: str = ""  # suggested remediation

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return (f"{self.severity.upper():7s} {self.pass_id} "
                f"{self.model}.{self.hook}{loc}: {self.message}{hint}")


@dataclasses.dataclass
class Report:
    """All findings of one pipeline run (possibly over several models).

    ``artifacts`` carries the machine-readable non-finding outputs passes
    compute along the way (per-model cost reports, kernel launch plans)
    keyed ``{model: {artifact_name: jsonable}}`` — surfaced by
    :meth:`as_json` so CI can consume the numbers, not just the verdicts.
    """

    findings: list[Finding] = dataclasses.field(default_factory=list)
    models: list[str] = dataclasses.field(default_factory=list)
    artifacts: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def by_severity(self, severity: str) -> list[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> list[Finding]:
        return self.by_severity(ERROR)

    @property
    def exit_code(self) -> int:
        """CI gate: non-zero exactly when an error-severity finding exists."""
        return 1 if self.errors else 0

    def sorted_findings(self) -> list[Finding]:
        return sorted(self.findings,
                      key=lambda f: (severity_rank(f.severity), f.pass_id,
                                     f.model, f.hook))

    def format_text(self, min_severity: str | None = None) -> str:
        """Human report.  ``min_severity`` hides lower-severity findings
        from the listing but the trailer always counts the FULL report —
        a CI log must never claim zero warnings because they were merely
        hidden."""
        cutoff = severity_rank(min_severity) if min_severity else \
            len(_SEVERITIES) - 1
        lines = [f"graphcheck: analyzed {', '.join(self.models) or 'nothing'}"]
        hidden = 0
        for f in self.sorted_findings():
            if severity_rank(f.severity) <= cutoff:
                lines.append(f.format())
            else:
                hidden += 1
        counts = {s: len(self.by_severity(s)) for s in _SEVERITIES}
        trailer = "graphcheck: " + ", ".join(
            f"{n} {s}(s)" for s, n in counts.items())
        if hidden:
            trailer += f" ({hidden} hidden by --min-severity)"
        lines.append(trailer)
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({
            "models": self.models,
            "findings": [f.as_dict() for f in self.sorted_findings()],
            "artifacts": self.artifacts,
            "exit_code": self.exit_code,
        }, indent=2)


@runtime_checkable
class AnalysisPass(Protocol):
    """A pipeline pass: stateless object with an id and a ``run`` method."""

    pass_id: str
    description: str

    def run(self, ctx: "AnalysisContext") -> list[Finding]: ...


_REGISTRY: dict[str, type] = {}


def register_pass(cls):
    """Class decorator: add a pass to the default pipeline (import order =
    run order).  Re-registering an id replaces the old pass (test idiom)."""
    pid = getattr(cls, "pass_id", None)
    if not pid:
        raise ValueError(f"{cls!r} needs a non-empty pass_id")
    _REGISTRY[pid] = cls
    return cls


def default_pipeline() -> list[AnalysisPass]:
    """Fresh instances of every registered pass, in registration order."""
    return [cls() for cls in _REGISTRY.values()]


def pass_ids() -> list[str]:
    return list(_REGISTRY)


class AnalysisContext:
    """Everything a pass may inspect for ONE job: the job, its per-hook op
    traces, the Engine's step/finish traces, the mesh they ran over, the
    device they ran on and the corpus-scale bound the overflow lint checks
    dtypes against.

    Traces run concretely on ``device`` (default: the job's own, else the
    card) over a seeded sample chunk; they are lazy and memoized, and a
    trace that fails is recorded as a
    :class:`~mapreduce_tpu_torch.analysis.trace.TraceFailure` value rather
    than raising, so one opaque hook cannot take down the whole pipeline.
    A job that declares a fleet (``analysis_fleet``, the ``*_fleet``
    registry twins: ``{"processes": P, "local_devices": L}``) has its step
    and finish recorded on rank 0 of an in-process fake world of P x L
    ranks (:func:`...trace.fake_world`), over the mesh that fleet runs;
    :attr:`mesh_spec` attributes its axes to link levels.  Every other job
    is recorded on one rank with no world.
    """

    def __init__(self, job: Any, model: str, device=None, *,
                 corpus_bytes: int = 1 << 40,
                 property_chunk_bytes: int = 1 << 10,
                 property_samples: int = 3,
                 baselines_dir: Optional[str] = None,
                 write_baselines: bool = False):
        from mapreduce_tpu_torch.runtime.platform import resolve_device

        self.job = job
        self.model = model
        if device is None:
            device = getattr(job, "device", None)
        self.device = resolve_device(device)
        self.fleet = dict(getattr(job, "analysis_fleet", None) or {})
        self.corpus_bytes = int(corpus_bytes)
        self.property_chunk_bytes = int(property_chunk_bytes)
        self.property_samples = int(property_samples)
        self.baselines_dir = baselines_dir  # None -> the checked-in dir
        self.write_baselines = bool(write_baselines)
        self.artifacts: dict = {}  # pass outputs, copied into the Report
        self._hook_traces = None
        self._engine_traces = None
        self._kernel_nodes = None
        self._property_states = None
        self.property_failure = None  # TraceFailure when sampling failed

    # -- corpus-scale arithmetic (shared by the overflow lint) ---------------

    @property
    def corpus_token_bound(self) -> int:
        """Upper bound on total tokens at the configured corpus scale: at
        most one token per two bytes (token + separator)."""
        return self.corpus_bytes // 2 + 1

    # -- lazy traces ---------------------------------------------------------

    @property
    def hook_traces(self) -> dict:
        """hook name -> OpTrace | TraceFailure (see trace.trace_hooks)."""
        if self._hook_traces is None:
            from mapreduce_tpu_torch.analysis import trace

            self._hook_traces = trace.trace_hooks(self.job, self.device)
        return self._hook_traces

    @property
    def engine_traces(self) -> dict:
        """'step'/'finish' -> OpTrace | TraceFailure on an axis of one."""
        if self._engine_traces is None:
            from mapreduce_tpu_torch.analysis import trace

            self._engine_traces = trace.trace_engine(self.job, self.device,
                                                     fleet=self.fleet)
        return self._engine_traces

    @property
    def mesh_spec(self):
        """The traced mesh with its link levels
        (:class:`...meshcost.MeshSpec`): the fleet's (outer axis over the
        network between nodes, inner over NVLink), else one rank."""
        from mapreduce_tpu_torch.analysis import meshcost

        p = int(self.fleet.get("processes", 1))
        ld = int(self.fleet.get("local_devices", 1))
        if ld > 1:
            return meshcost.MeshSpec.fleet(p, ld)
        return meshcost.MeshSpec.from_mesh(("data",), (p,), processes=p)

    @property
    def kernel_nodes(self) -> list:
        """Every kernel node of the step/finish traces, digested once for
        the smem-budget pass (:mod:`..kernel_info`)."""
        if self._kernel_nodes is None:
            from mapreduce_tpu_torch.analysis import kernel_info

            self._kernel_nodes = kernel_info.collect_kernel_nodes(
                self.engine_traces)
        return self._kernel_nodes

    @property
    def state_shape(self):
        """The job's initial state (tensor leaves: their shapes and
        dtypes are what the lint reads), or a TraceFailure when
        init_state itself fails."""
        from mapreduce_tpu_torch.analysis import trace

        return trace.state_shape(self.job)

    def property_states(self) -> list:
        """Concrete, reachable job states for randomized property checks:
        each is init_state folded with one random chunk's map via a
        one-rank Engine step.  Memoized; returns [] when the job cannot
        execute the sample chunk (a chunk its config refuses) --
        ``property_failure`` then carries the exception as data."""
        if self._property_states is None:
            from mapreduce_tpu_torch.analysis import trace

            self._property_states, self.property_failure = \
                trace.sample_states(self.job, self.device,
                                    n=self.property_samples,
                                    chunk_bytes=self.property_chunk_bytes)
        return self._property_states


def run_pipeline(ctx: AnalysisContext,
                 passes: Optional[list[AnalysisPass]] = None) -> Report:
    """Run every pass over one context; a crashing pass becomes an ERROR
    finding (the analyzer must never die less gracefully than the program
    it is vetting)."""
    report = Report(models=[ctx.model])
    for p in passes if passes is not None else default_pipeline():
        try:
            report.extend(p.run(ctx))
        except Exception as e:  # pragma: no cover - defensive
            report.findings.append(Finding(
                severity=ERROR, pass_id=p.pass_id, model=ctx.model,
                hook="<pipeline>",
                message=f"pass crashed: {type(e).__name__}: {e}",
                hint="fix the pass (or report a graphcheck bug)"))
    if ctx.artifacts:
        report.artifacts[ctx.model] = ctx.artifacts
    return report


def analyze_job(job: Any, model: str = "", device=None,
                passes: Optional[list[AnalysisPass]] = None,
                **ctx_kw) -> Report:
    """One-call API: build a context for ``job`` and run the pipeline."""
    ctx = AnalysisContext(job, model or type(job).__name__, device=device,
                          **ctx_kw)
    return run_pipeline(ctx, passes)
