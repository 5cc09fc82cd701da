"""Pass: shared-memory and register budgets of the hand-written kernels.

The GPU counterpart of :mod:`mapreduce_tpu.analysis.passes.vmem` (which
certifies each Pallas kernel's VMEM/SMEM footprint): pass id
``smem-budget``.  Each launch plan (:mod:`...ops.cuda.plans`) is held to
Hopper's limits (the hopper-kernels guide):

* static shared memory at most 48 KB a block (227 KB is reachable only
  as opt-in dynamic memory, which no kernel here asks for);
* at most 1,024 threads a block, and a ``__launch_bounds__`` minimum of
  blocks whose threads fit an SM's 2,048 and whose shared memory fits its
  228 KB;
* grids within ``gridDim`` (x < 2**31, y and z < 2**16).

Two static legs: every kernel node of the model's step/finish traces, and
:func:`certify_production_kernels` over ``plans.production_plans()`` (the
32 MB chunk and every geometry preset), run once a pipeline by the CLI.
The card leg (:func:`certify_card_attributes`, the CLI's on the card)
holds what ``cudaFuncGetAttributes`` reports to the plans: static shared
bytes exactly, the block size within the kernel's maximum, registers
within what ``__launch_bounds__`` leaves a thread; it reports registers
and occupancy (INFO) and register spills to local memory (WARNING).
"""

from __future__ import annotations

from mapreduce_tpu_torch.analysis import core
from mapreduce_tpu_torch.ops.cuda import plans

_GRID_LIMITS = ((1 << 31) - 1, 65535, 65535)


def plan_findings(pass_id: str, model: str, hook: str, plan,
                  location: str = "") -> list[core.Finding]:
    """ERRORs of one plan against the Hopper limits (none when it fits)."""
    out = []
    label = f"{plan.wrapper} [{plan.geometry}]"

    def err(msg, hint):
        out.append(core.Finding(
            severity=core.ERROR, pass_id=pass_id, model=model, hook=hook,
            message=f"{label}: {msg}", location=location, hint=hint))

    for launch in plan.launches:
        s = launch.spec
        if s.static_smem > plans.STATIC_SMEM_LIMIT:
            err(f"{s.name} declares {s.static_smem} B of static shared "
                f"memory, over the {plans.STATIC_SMEM_LIMIT >> 10} KB a "
                "block", "move the excess to opt-in dynamic shared memory")
        if s.threads > plans.MAX_THREADS_PER_BLOCK:
            err(f"{s.name} launches {s.threads} threads a block, over "
                f"{plans.MAX_THREADS_PER_BLOCK}", "shrink the block")
        if s.min_blocks and (
                s.threads * s.min_blocks > plans.MAX_THREADS_PER_SM
                or s.static_smem * s.min_blocks > plans.SMEM_PER_SM):
            err(f"{s.name} asks __launch_bounds__ for {s.min_blocks} "
                f"blocks an SM, which do not fit its threads or shared "
                "memory", "lower the minimum blocks")
        for dim, (g, cap) in enumerate(zip(launch.grid, _GRID_LIMITS)):
            if not 1 <= g <= cap:
                err(f"{s.name}'s grid dimension {dim} is {g}, outside "
                    f"[1, {cap}]", "tile the launch")
    return out


@core.register_pass
class SmemPass:
    pass_id = "smem-budget"
    description = ("static shared memory, threads and grids of every "
                   "traced kernel launch vs Hopper's limits")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        kernels = []
        for info in ctx.kernel_nodes:
            out.extend(plan_findings(self.pass_id, ctx.model, info.program,
                                     info.plan, info.location))
            kernels.append({"program": info.program, **info.plan.as_dict()})
        if kernels:
            ctx.artifacts["smem"] = kernels
            smem = max(x["static_smem"] for k in kernels
                       for x in k["launches"])
            out.append(core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"{len(kernels)} kernel node(s) certified under "
                         f"the Hopper budgets (at most {smem} B static "
                         "shared memory a block)")))
        return out


def certify_production_kernels() -> list[core.Finding]:
    """Certify every shipped plan (``plans.production_plans()``) against
    the budgets: once a pipeline run, not per model."""
    out: list[core.Finding] = []
    for plan in plans.production_plans():
        found = plan_findings(SmemPass.pass_id, "<kernels>", "production",
                              plan)
        out.extend(found)
        if not found:
            smem = max(x.spec.static_smem for x in plan.launches)
            out.append(core.Finding(
                severity=core.INFO, pass_id=SmemPass.pass_id,
                model="<kernels>", hook="production",
                message=(f"{plan.wrapper} [{plan.geometry}]: "
                         f"{len(plan.launches)} launch(es), at most {smem} B "
                         "static shared memory a block, within budget")))
    return out


def certify_card_attributes(attributes: dict) -> list[core.Finding]:
    """Hold the card's ``cudaFuncGetAttributes`` of every kernel
    (:func:`...kernel_info.card_attributes`) to its plan."""
    out: list[core.Finding] = []

    def find(severity, name, message, hint=""):
        out.append(core.Finding(
            severity=severity, pass_id=SmemPass.pass_id, model="<kernels>",
            hook="card", message=f"{name}: {message}", hint=hint))

    for name, a in sorted(attributes.items()):
        s = plans.spec_of(name)
        if a["static_smem"] != s.static_smem:
            find(core.ERROR, name,
                 f"the card reports {a['static_smem']} B of static shared "
                 f"memory, the plan {s.static_smem} B",
                 "update ops/cuda/plans.py with the source's __shared__ "
                 "arrays")
        if s.threads > a["max_threads_per_block"]:
            find(core.ERROR, name,
                 f"launched with {s.threads} threads, over the "
                 f"{a['max_threads_per_block']} its registers allow",
                 "lower the register use or the block size")
        if a["registers"] > s.register_cap:
            find(core.ERROR, name,
                 f"{a['registers']} registers a thread, over the "
                 f"{s.register_cap} its __launch_bounds__ leaves",
                 "the compiler ignored the bound; check ptxas")
        if a["local_bytes"]:
            find(core.WARNING, name,
                 f"{a['local_bytes']} B of local memory a thread "
                 "(register spills or local arrays)",
                 "spills go through L1/L2 to device memory")
        find(core.INFO, name,
             f"{a['registers']} registers, {a['static_smem']} B static "
             f"shared, {a['local_bytes']} B local, {a['blocks_per_sm']} "
             f"block(s) of {s.threads} threads an SM")
    return out
