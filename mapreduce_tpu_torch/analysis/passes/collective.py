"""Pass: collective pricing over the mesh's link levels, and the
divergence lint.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.collective` (pass id
``collective-cost``).  Two jobs, both over the Engine's recorded ``step``
and ``finish`` (a fleet twin's over its fake world of P x L ranks,
:func:`...trace.fake_world`):

1. **Collective cost** (artifact ``collective_cost``, the JAX artifact's
   keys: ``mesh``, ``link_rates``, ``programs``, ``modeled_total_s``,
   ``total_bytes``): every collective node is attributed to its process
   group's mesh axes, each axis to its link level (NVLink within a node,
   the network across nodes: ``parallel/mesh.py:two_level_mesh``'s
   node-major contract), and its payload priced through the alpha-beta
   schedules of :mod:`..meshcost` at the rates of
   ``analysis/baselines/measured_link_rates.json``.  ``total_bytes`` is
   what this rank sends, the bytes ``parallel/collectives.py`` counts in
   ``collectives.bytes_sent``.  The hbm-cost artifact's
   ``collective.priced`` marker is set with the modeled total, and the
   modeled seconds are baseline-gated like effective input passes
   (``analysis/baselines/<model>.collective.json``, the same 20 %
   tolerance and ``--write-baselines`` regeneration).

2. **Divergence lint**: a collective that some ranks reach and others do
   not hangs the fleet.  The JAX pass finds it as a varying-taint dataflow
   over the ``cond``s inside ``shard_map``.  An eager program branches on
   the host, after a declared read (``ops/tracepoints.py``), so the eager
   counterpart is a collective that follows a host branch on a rank-local
   value: a read whose value depends on this rank's own state other than
   through a collective over the whole mesh that every rank shares (an
   agreement through the control group, as ``runtime/executor.py:_Accord``
   makes, is one).  The recorder takes each such read's other branch as
   well (the read's values flipped, :func:`...trace.rank_local_reads`),
   and the pass ERRORs where the two branches run different collectives
   after the read: a collective in one branch only, the same collective
   over other levels, or any other difference.  Branches that agree, and
   reads of uniform values, stay quiet, so the shipped finish programs
   pass.
"""

from __future__ import annotations

import json
import os

from mapreduce_tpu_torch.analysis import core, meshcost, trace
from mapreduce_tpu_torch.analysis.passes.cost import (REGRESSION_TOLERANCE,
                                                      _BASELINES_DIR)

_LINT_CAP = 8  # findings per program before the pass summarizes
_ENTRY_CAP = 32  # per-program priced entries kept in the artifact
_REGENERATE = ("python -m mapreduce_tpu_torch.analysis --write-baselines "
               "--platform cpu")


def collective_baseline_path(model: str,
                             baselines_dir: str | None = None) -> str:
    return os.path.join(baselines_dir or _BASELINES_DIR,
                        f"{model}.collective.json")


def load_collective_baseline(model: str, baselines_dir: str | None = None):
    path = collective_baseline_path(model, baselines_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _op(node) -> str:
    return node.name.split(".")[1]


def _signature(nodes) -> tuple:
    """The collectives a stretch of a program runs: (op, group) each."""
    return tuple((_op(n), n.attr("group")) for n in nodes
                 if n.kind == "collective")


def _after_read(program, r: int) -> list:
    """The program's nodes after its ``r``-th declared host read."""
    seen = -1
    for i, node in enumerate(program.nodes):
        if node.kind == "host_read":
            seen += 1
            if seen == r:
                return program.nodes[i + 1:]
    return []


def _read_location(program, r: int) -> str:
    reads = [n for n in program.nodes if n.kind == "host_read"]
    return reads[r].location if r < len(reads) else ""


@core.register_pass
class CollectivePass:
    pass_id = "collective-cost"
    description = ("price collective bytes per mesh axis / link level "
                   "(NVLink vs network, meshcost schedules) with a "
                   "baseline gate; ERROR on collectives after a host "
                   "branch on a rank-local value (divergence)")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        mesh_spec = ctx.mesh_spec
        rates = meshcost.load_link_rates()
        levels, sources = rates["levels"], rates["sources"]
        art: dict = {
            "mesh": {"axes": [{"name": a.name, "size": a.size,
                               "level": a.level} for a in mesh_spec.axes],
                     "devices": mesh_spec.n_devices,
                     "processes": int(ctx.fleet.get("processes", 1)),
                     "label": mesh_spec.label()},
            "link_rates": {lv.name: {"alpha_s": lv.alpha_s,
                                     "beta_gbps": lv.beta_bps / 1e9,
                                     "source": sources.get(lv.name)}
                           for lv in levels.values()},
            "programs": {},
        }
        total_s = 0.0
        total_bytes = 0
        for hook, traced in ctx.engine_traces.items():
            if isinstance(traced, trace.TraceFailure):
                continue  # the sharding pass owns trace-failure reporting
            entries, unpriced, s, b = self._price(traced, mesh_spec, levels)
            art["programs"][hook] = {
                "modeled_s": round(s, 9), "bytes": b,
                "collectives": entries[:_ENTRY_CAP],
                "truncated": max(0, len(entries) - _ENTRY_CAP),
                "unpriced": unpriced[:_ENTRY_CAP]}
            total_s += s
            total_bytes += b
            if unpriced:
                out.append(core.Finding(
                    severity=core.WARNING, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"{len(unpriced)} collective(s) over a group "
                             "the mesh spec cannot attribute to a link "
                             f"level (e.g. {unpriced[0]['op']} over ranks "
                             f"{unpriced[0]['ranks']}); their bytes are "
                             "tallied but not priced"),
                    hint="groups must be the mesh's (sharding-lint owns "
                         "unknown-group errors)"))
            out.extend(self._lint_program(ctx, hook, traced))
        art["modeled_total_s"] = round(total_s, 9)
        art["total_bytes"] = total_bytes

        if total_bytes or any(p["collectives"]
                              for p in art["programs"].values()):
            ctx.artifacts["collective_cost"] = art
            self._mark_priced(ctx, total_s)
            per_level: dict = {}
            for prog in art["programs"].values():
                for e in prog["collectives"]:
                    for pa in e["per_axis"]:
                        per_level[pa["level"]] = \
                            per_level.get(pa["level"], 0.0) + pa["seconds"]
            levels_txt = ", ".join(f"{k}={v * 1e6:.1f}us"
                                   for k, v in sorted(per_level.items()))
            out.append(core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"collectives modeled at {total_s * 1e6:.1f}us "
                         f"over mesh {art['mesh']['label']} "
                         f"({total_bytes} bytes sent; {levels_txt})"),
                hint="alpha-beta bound from "
                     "analysis/baselines/measured_link_rates.json "
                     "(nvlink and net: data-sheet rates); "
                     "congestion-free, per rank"))
            out.extend(self._baseline_findings(ctx, art))
        return out

    # -- pricing ---------------------------------------------------------

    def _price(self, program, mesh_spec, levels):
        """``(entries, unpriced, modeled seconds, bytes sent)`` of one
        program's collective nodes.  A ``recv_`` is its exchange's second
        half: the round is priced once, at the ``send``."""
        entries, unpriced = [], []
        total_s, total_b = 0.0, 0
        for node in program.collectives:
            op = _op(node)
            sent = int(node.attr("sent_bytes", 0))
            total_b += sent
            prim = meshcost.C10D_PRIMS.get(op)
            if prim is None:
                continue  # recv_: priced at its send
            payload = int(node.attr("payload_bytes", 0))
            axes = tuple(node.attr("axes") or ())
            priced = meshcost.price_eqn(prim, payload, axes, mesh_spec,
                                        levels)
            if priced is None:
                unpriced.append({"op": op, "bytes": payload,
                                 "ranks": list(node.attr("ranks") or ()),
                                 "location": node.location})
                continue
            entries.append({
                "op": op, "prim": prim, "bytes": payload, "sent": sent,
                "group": node.attr("group"), "axes": list(axes),
                "schedule": priced["schedule"],
                "seconds": round(priced["seconds"], 9),
                "per_axis": [dict(pa, seconds=round(pa["seconds"], 9))
                             for pa in priced["per_axis"]],
                "location": node.location})
            total_s += priced["seconds"]
        return entries, unpriced, total_s, total_b

    def _mark_priced(self, ctx, total_s) -> None:
        cost_art = ctx.artifacts.get("cost")
        coll = cost_art.get("collective") if isinstance(cost_art, dict) \
            else None
        if isinstance(coll, dict):
            coll["priced"] = True
            coll["modeled_s"] = round(total_s, 9)
            coll["priced_by"] = self.pass_id

    # -- baseline regression gate (hbm-cost discipline) -------------------

    def _baseline_findings(self, ctx, art) -> list[core.Finding]:
        modeled = art["modeled_total_s"]
        if ctx.write_baselines:
            path = collective_baseline_path(ctx.model, ctx.baselines_dir)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({
                    "model": ctx.model,
                    "modeled_total_s": modeled,
                    "total_bytes": art["total_bytes"],
                    "mesh": art["mesh"]["label"],
                    "_regenerate": _REGENERATE,
                }, f, indent=2)
                f.write("\n")
            return [core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="step", message=f"collective baseline written: {path}")]
        base = load_collective_baseline(ctx.model, ctx.baselines_dir)
        if base is None:
            return [core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="step",
                message="no collective-cost baseline checked in for this "
                        "model",
                hint=f"regenerate with `{_REGENERATE} {ctx.model}` and "
                     "commit the JSON")]
        if base.get("mesh") != art["mesh"]["label"]:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"collective baseline priced mesh "
                         f"{base.get('mesh')!r} but this run traced "
                         f"{art['mesh']['label']!r}: modeled seconds are "
                         "not comparable"),
                hint="re-baseline deliberately (--write-baselines) after "
                     "a topology change")]
        ref = float(base.get("modeled_total_s", 0.0))
        art["baseline_modeled_total_s"] = ref
        if ref <= 0:
            return []
        growth = (modeled - ref) / ref
        if growth > REGRESSION_TOLERANCE:
            return [core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"modeled collective seconds regressed "
                         f"{growth:+.0%}: {modeled * 1e6:.1f}us vs baseline "
                         f"{ref * 1e6:.1f}us (gate: "
                         f"{REGRESSION_TOLERANCE:.0%})"),
                hint="either fix the regression or regenerate baselines "
                     "deliberately (--write-baselines)")]
        if growth < -REGRESSION_TOLERANCE:
            return [core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="step",
                message=(f"modeled collective seconds improved {growth:+.0%}"
                         f" vs baseline {ref * 1e6:.1f}us"),
                hint="re-baseline (--write-baselines) so the gate "
                     "protects the win")]
        return []

    # -- divergence lint ---------------------------------------------------

    def _lint_program(self, ctx, hook, traced) -> list[core.Finding]:
        findings: list[core.Finding] = []
        for r, alt in traced.branches:
            loc = _read_location(traced, r)
            if isinstance(alt, trace.TraceFailure):
                findings.append(core.Finding(
                    severity=core.WARNING, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"the other branch of a rank-local host read "
                             f"did not record ({alt.error_type}: "
                             f"{alt.error}); its collectives are not "
                             "checked"),
                    location=loc))
                continue
            sigs = (_signature(_after_read(traced, r)),
                    _signature(_after_read(alt, r)))
            if sigs[0] != sigs[1]:
                findings.append(self._divergence_finding(ctx, hook, loc,
                                                         sigs))
        if len(findings) > _LINT_CAP:
            kept, dropped = findings[:_LINT_CAP], len(findings) - _LINT_CAP
            kept.append(core.Finding(
                severity=core.ERROR, pass_id=self.pass_id, model=ctx.model,
                hook=hook,
                message=f"... and {dropped} further divergent-collective "
                        "finding(s) suppressed"))
            return kept
        return findings

    def _divergence_finding(self, ctx, hook, loc, sigs) -> core.Finding:
        ops = [tuple(op for op, _ in s) for s in sigs]
        n_empty = sum(1 for s in sigs if not s)
        if 0 < n_empty < len(sigs):
            msg = ("collective(s) "
                   f"{sorted({op for s in sigs for op, _ in s})} run in "
                   f"{len(sigs) - n_empty} of {len(sigs)} branches of a "
                   "host branch on a rank-local value: ranks taking the "
                   "other branch never enter the collective, a "
                   "distributed hang")
            hint = ("hoist the collective out of the branch, or make the "
                    "predicate uniform (agree on it over the control "
                    "group, or all-reduce it first)")
        elif ops[0] == ops[1]:
            groups = sorted({g for s in sigs for _, g in s})
            msg = (f"branches of a host branch on a rank-local value run "
                   f"the same collective(s) over MISMATCHED groups "
                   f"{groups}: ranks disagree on who participates, a "
                   "distributed hang (or a silent wrong-group reduction)")
            hint = ("use one mesh level on every path (the axis the "
                    "Engine passes into the job's hooks)")
        else:
            msg = (f"branches of a host branch on a rank-local value run "
                   f"different collective programs {sorted(set(ops))}: "
                   "ranks diverge at the first mismatched collective, a "
                   "distributed hang")
            hint = ("make every branch run the same collective sequence, "
                    "or branch on a uniform predicate")
        return core.Finding(severity=core.ERROR, pass_id=self.pass_id,
                            model=ctx.model, hook=hook, message=msg,
                            location=loc, hint=hint)
