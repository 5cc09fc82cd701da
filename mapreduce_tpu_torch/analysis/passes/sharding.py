"""Pass: sharding / collective-group lint.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.sharding` (pass id
``sharding-lint``, the same severities).  The JAX engine binds mesh axes
through ``shard_map``, and a collective that names an axis the mesh does
not carry fails to trace, or reduces over the wrong device group.  The
port's collectives name a ``torch.distributed`` process group instead, so
the eager counterpart of an unknown or unbound axis name is a collective
over a group that is not one of the mesh's: a ``DataAxis``'s group, the
``outer`` and ``inner`` levels of a ``TwoLevelMesh`` and its flattened
(world) group, or a control group of the agreements
(``parallel/mesh.py:control_group``).  A stray default world group on a
sub-axis of a job that builds its own groups is the typical case.  This
pass checks, over the Engine's recorded ``step`` and ``finish`` (a fleet
twin's over its fake world, :func:`...trace.fake_world`):

* each program records at all: a step or finish that fails is an ERROR;
* every collective node runs over one of the mesh's groups: any other
  group is an ERROR, once for each op and group.
"""

from __future__ import annotations

from mapreduce_tpu_torch.analysis import core, trace


@core.register_pass
class ShardingPass:
    pass_id = "sharding-lint"
    description = ("the step and finish record over the mesh; every "
                   "collective runs over one of the mesh's process groups")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        for hook, traced in ctx.engine_traces.items():
            if isinstance(traced, trace.TraceFailure):
                out.append(core.Finding(
                    severity=core.ERROR, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"engine {hook} program failed to record "
                             f"({traced.error_type}: {traced.error}): "
                             "typically a collective over a process group "
                             "the mesh does not hold"),
                    hint=f"the mesh is {ctx.mesh_spec.label()}; run "
                         "collectives over the axis the Engine passes "
                         "(DataAxis.group, a TwoLevelMesh level) instead of "
                         "a group of the job's own"))
                continue
            out.extend(self._group_findings(ctx, hook, traced))
        return out

    def _group_findings(self, ctx, hook, traced) -> list[core.Finding]:
        out = []
        seen: set = set()
        for node in traced.collectives:
            if node.attr("group") != "<unknown>":
                continue
            key = (node.name, node.attr("ranks"))
            if key in seen:
                continue
            seen.add(key)
            out.append(core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook=hook,
                message=(f"collective '{node.name}' runs over a process "
                         f"group of ranks {list(node.attr('ranks'))}, not "
                         f"one of the mesh's ({ctx.mesh_spec.label()})"),
                location=node.location,
                hint="use the group of the axis the Engine passes into "
                     "the job's hooks (parallel/mesh.py)"))
        return out
