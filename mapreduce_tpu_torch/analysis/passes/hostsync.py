"""Pass: host-sync detector.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.hostsync`.  The JAX
pass ERRORs a host callback inside a jitted step: a device->host->device
round trip per dispatch.  An eager step reads the host wherever Python
asks for a value, so the port's counterpart holds the step and finish
traces to the step's DECLARED syncs
(:func:`...ops.tracepoints.host_read`, the map's one read of its flags;
:func:`...ops.tracepoints.host_scalars`, the pageable copies of host
scalars into the table builds):

* an op that syncs anywhere else (:data:`...trace.SYNCING_OPS`: a scalar
  read, ``nonzero``, a boolean mask index's shape, ...) is an ERROR: a
  hidden wait for the card in the streamed loop;
* the declared syncs and the program's size (nodes, launches) are INFO:
  the static counts a dispatch-bound step is priced in (on the card the
  syncs must equal what CUDA's sync debug mode counts, and the launches
  stand beside the profiler's);
* the streamed driver's completion probe (``runtime/executor.py``:
  ``_PinnedStage.completion`` on the card, ``_HostStage`` on the CPU) must
  issue no op at all: the window may not add a hidden sync per group.
"""

from __future__ import annotations

from mapreduce_tpu_torch.analysis import core, costmodel, trace


@core.register_pass
class HostSyncPass:
    pass_id = "host-sync"
    description = ("undeclared host reads in the step+finish programs; "
                   "declared syncs, launches and the completion probe")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        for hook, traced in ctx.engine_traces.items():
            if isinstance(traced, trace.TraceFailure):
                continue  # the cost pass reports a program that failed
            out.extend(self._program_findings(ctx, hook, traced))
        out.extend(self._branch_findings(ctx))
        out.extend(self._probe_findings(ctx))
        return out

    def _branch_findings(self, ctx) -> list[core.Finding]:
        """An eager trace holds the branches its sample took, where a
        jaxpr ``cond`` holds both: name the word-count map's branches the
        sample chunk did not take (its read's ``spill`` and ``overlong``),
        so a reader knows what the step's trace leaves out."""
        step = ctx.engine_traces.get("step")
        config = getattr(ctx.job, "config", None)
        if step is None or isinstance(step, trace.TraceFailure) \
                or config is None or not step.flags \
                or len(step.flags[0]) < 3:
            return []
        spill, overlong = step.flags[0][:2]
        untaken = []
        if config.resolved_combiner_slots and not spill:
            untaken.append("the combiner-free rerun of a spilled window "
                           "(spill = 0)")
        if config.rescue_slots and not overlong:
            untaken.append("the overlong rescue (overlong = 0)")
        if not untaken:
            return []
        return [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="step",
            message=("branches the sample chunk did not take, so not in "
                     "the step's trace: " + "; ".join(untaken)),
            hint="trace_engine(job, device, chunk=...) with a chunk that "
                 "takes them (dense keys for the spill, tokens longer "
                 "than W for the rescue)")]

    def _program_findings(self, ctx, hook, traced) -> list[core.Finding]:
        out = []
        seen: set[str] = set()
        for node in traced.nodes:
            if node.kind == "op" and node.syncs and node.name not in seen:
                seen.add(node.name)
                out.append(core.Finding(
                    severity=core.ERROR, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"undeclared host read '{node.name}' in the "
                             f"{hook} program: on the card every step waits "
                             "for the device here"),
                    location=f"{node.name} @ {node.location}",
                    hint="keep the value on the device, or make the read "
                         "one of the step's declared ones "
                         "(ops.tracepoints.host_read / host_scalars)"))
        cost = costmodel.program_cost(traced)
        reads = [n for n in traced.host_syncs if n.kind == "host_read"]
        copies = [n for n in traced.host_syncs if n.kind == "host_copy"]
        where = sorted({n.location for n in traced.host_syncs})
        out.append(core.Finding(
            severity=core.INFO, pass_id=self.pass_id,
            model=ctx.model, hook=hook,
            message=(f"{hook} program: {cost.nodes} nodes, {cost.launches} "
                     f"launches ({cost.kernel_nodes} kernel node(s)), "
                     f"{len(reads) + len(copies)} declared host sync(s) "
                     f"({len(reads)} read(s), {len(copies)} host-scalar "
                     f"copy(ies){': ' + ', '.join(where) if where else ''})"),
            hint="per-step host overhead scales with launches and syncs; "
                 "fold both into fewer kernels when dispatch-bound "
                 "(ROADMAP A15)"))
        return out

    def _probe_findings(self, ctx) -> list[core.Finding]:
        """The window's completion token must be pure stream bookkeeping:
        no op, no sync."""
        from mapreduce_tpu_torch.runtime import executor

        try:
            if ctx.device.type == "cuda":
                stage = executor._PinnedStage(ctx.device, 1, 1)
            else:
                stage = executor._HostStage()

            def probe():
                token = stage.completion()
                stage.ready(token)

            _, traced = trace.record("probe", probe)
        except Exception as e:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id,
                model=ctx.model, hook="probe",
                message=f"window completion probe failed: {e!r}",
                hint="the stage's completion token must stay an event")]
        if traced.nodes:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id,
                model=ctx.model, hook="probe",
                message=(f"the window completion probe issues "
                         f"{len(traced.nodes)} op(s) "
                         f"({traced.nodes[0].name} first): every "
                         "dispatched group would pay them, and a sync "
                         "among them serializes the window"),
                location=traced.nodes[0].location,
                hint="keep the completion token a CUDA event recorded on "
                     "the compute stream")]
        return [core.Finding(
            severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
            hook="probe",
            message=("window completion probe issues 0 ops: no host "
                     "coupling -- the async window adds no hidden sync"))]
