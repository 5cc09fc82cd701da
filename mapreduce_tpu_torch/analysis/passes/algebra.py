"""Pass: reducer-algebra checker.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.algebra`.  The
collective reduce (the tree butterfly, the gather fold, the key-range
exchange) is only correct when ``merge`` is associative AND commutative:
the Engine reorders and re-associates merges freely across ranks.

Two complementary checks:

* **structural**: walk the recorded ops of ``merge``/``combine`` for ops
  that are not commutative or associative when they land on the
  accumulator -- ``aten.sub``/``div``/``remainder``/``fmod``/``pow``
  (INFO: index arithmetic uses them legitimately), and an OVERWRITING
  scatter (``aten.scatter`` without a reduction, ``index_put`` without
  ``accumulate``: the last write wins, so merge order changes results;
  WARNING);
* **randomized property check**, the decider: reachable states are made
  through the job's own map/combine (:func:`...trace.sample_states`) and
  ``merge(a, b) == merge(b, a)`` / ``merge(merge(a, b), c) ==
  merge(a, merge(b, c))`` are checked on them, on the job's
  ``analysis_observables(state)`` where it declares one (grep's line carry
  and the n-gram seam carry are equal only in real collective context).
  A mismatch is an ERROR.
"""

from __future__ import annotations

import torch

from mapreduce_tpu_torch.analysis import core, trace

# Ops that break commutativity/associativity on the accumulated values.
_NONCOMMUTATIVE = {"sub", "rsub", "div", "remainder", "fmod", "pow", "atan2"}
# Scatters that overwrite (last write wins).
_SCATTER_OVERWRITE = {"aten.scatter.src", "aten.scatter.value",
                      "aten.scatter_.src", "aten.scatter_.value",
                      "aten.index_copy.default", "aten.index_copy_.default"}


def _base(name: str) -> str:
    return name.split(".")[1] if name.startswith("aten.") else name


def _overwrites(node) -> bool:
    if node.name in _SCATTER_OVERWRITE:
        return True
    return _base(node.name) in ("index_put", "index_put_") \
        and not dict(node.attrs).get("accumulate", False)


def _structural_findings(ctx: core.AnalysisContext, hook: str,
                         program) -> list[core.Finding]:
    out = []
    seen: set[str] = set()
    for node in program.nodes:
        if node.kind != "op":
            continue
        name = _base(node.name)
        if name in _NONCOMMUTATIVE and name not in seen:
            seen.add(name)
            out.append(core.Finding(
                severity=core.INFO, pass_id=AlgebraPass.pass_id,
                model=ctx.model, hook=hook,
                message=(f"non-commutative op '{name}' reachable in "
                         f"{hook} (advisory: legitimate for index math; the "
                         "randomized property check decides)"),
                location=f"{node.name} @ {node.location}",
                hint="ensure the accumulator fold itself is "
                     "order-independent"))
        elif _overwrites(node) and "scatter" not in seen:
            seen.add("scatter")
            out.append(core.Finding(
                severity=core.WARNING, pass_id=AlgebraPass.pass_id,
                model=ctx.model, hook=hook,
                message=("scatter-OVERWRITE reachable in "
                         f"{hook}: last write wins, so merge order changes "
                         "results on colliding keys"),
                location=f"{node.name} @ {node.location}",
                hint="use index_add_/scatter_add or scatter_reduce "
                     "(amin/amax) for order-independent accumulation"))
    return out


def _observables(job, state):
    fn = getattr(job, "analysis_observables", None)
    return fn(state) if fn is not None else state


def _diff_leaves(job, x, y) -> list[str]:
    """Paths of observable leaves where two states disagree."""
    xs = trace.named_leaves(_observables(job, x))
    ys = trace.named_leaves(_observables(job, y))
    bad = []
    for (px, lx), (_, ly) in zip(xs, ys):
        if isinstance(lx, torch.Tensor):
            ax, ay = lx.cpu(), torch.as_tensor(ly).cpu()
            if ax.is_floating_point():
                ok = ax.shape == ay.shape and torch.allclose(
                    ax, ay, rtol=1e-5, atol=1e-6, equal_nan=True)
            else:
                ok = torch.equal(ax, ay)
        else:
            ok = lx == ly
        if not ok:
            bad.append(px)
    return bad


@core.register_pass
class AlgebraPass:
    pass_id = "reducer-algebra"
    description = ("merge must be associative+commutative for the "
                   "collective reduce (structural walk + randomized "
                   "property check on reachable states)")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        for hook in ("merge", "combine"):
            traced = ctx.hook_traces.get(hook)
            if isinstance(traced, trace.TraceFailure):
                out.append(core.Finding(
                    severity=core.INFO, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"{hook} is opaque to structural analysis "
                             f"({traced.error_type}: {traced.error}); "
                             "relying on the property-check fallback"),
                    hint="make the hook run on the sample chunk's state"))
            elif traced is not None:
                out.extend(_structural_findings(ctx, hook, traced))

        states = ctx.property_states()
        if len(states) < 3:
            why = ctx.property_failure
            detail = f" ({why.error_type}: {why.error})" if why else ""
            out.append(core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="merge",
                message="property check skipped: could not generate "
                        f"reachable states on this host{detail}",
                hint="run graphcheck with a property chunk the job's "
                     "config accepts (the structural findings above are "
                     "all it verified)"))
            return out
        a, b, c = states[:3]
        job = ctx.job
        try:
            ab, ba = job.merge(a, b), job.merge(b, a)
            comm_bad = _diff_leaves(job, ab, ba)
            ab_c = job.merge(job.merge(a, b), c)
            a_bc = job.merge(a, job.merge(b, c))
            assoc_bad = _diff_leaves(job, ab_c, a_bc)
        except Exception as e:
            out.append(core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="merge",
                message=f"property check failed to run ({type(e).__name__}: "
                        f"{e})",
                hint="merge must accept two states of init_state's shape"))
            return out
        if comm_bad:
            out.append(core.Finding(
                severity=core.ERROR, pass_id=self.pass_id,
                model=ctx.model, hook="merge",
                message=("merge is NOT commutative on reachable states: "
                         f"merge(a,b) != merge(b,a) at {comm_bad[:4]}"),
                location=", ".join(comm_bad[:4]),
                hint="the collective tree/gather reduce reorders operands "
                     "freely; rewrite merge as an order-independent fold "
                     "(sum/min/max/union), or declare coordination-only "
                     "leaves via analysis_observables"))
        if assoc_bad:
            out.append(core.Finding(
                severity=core.ERROR, pass_id=self.pass_id,
                model=ctx.model, hook="merge",
                message=("merge is NOT associative on reachable states: "
                         f"merge(merge(a,b),c) != merge(a,merge(b,c)) at "
                         f"{assoc_bad[:4]}"),
                location=", ".join(assoc_bad[:4]),
                hint="tree-merge re-associates across ranks; make the "
                     "fold associative or use the gather strategy with a "
                     "documented fold order"))
        return out
