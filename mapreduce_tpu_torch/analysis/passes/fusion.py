"""Pass: fusion-opportunity finder over the step/finish op traces.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.fusion`.  The JAX pass
looks for adjacent materializing equations XLA leaves unfused; in the
port NOTHING fuses (eager PyTorch launches every op), so the seams worth a
kernel are the chains of elementwise ops whose intermediates round-trip
device memory without being needed anywhere else:

* an elementwise node (:func:`...costmodel.classify`) whose result is
  read only by later elementwise nodes, and is not the program's output,
  joins them in one candidate chain (views pass their input through);
* a chain of k nodes would be one kernel: k - 1 launches saved, and every
  internal intermediate's write and reads saved.

Findings are INFO (leads, not defects), at most
``MAX_FINDINGS_PER_PROGRAM`` a program ranked by saved bytes; the
``fusion`` artifact carries every chain.  These are the leads for the
step's host path (ROADMAP A15): each launch is host time on the card.
Unlike the JAX pass there is no on-chip working-set gate: an elementwise
chain streams, whatever its length.
"""

from __future__ import annotations

from mapreduce_tpu_torch.analysis import core, costmodel, trace

MAX_FINDINGS_PER_PROGRAM = 4


def chains(program) -> list[dict]:
    """The candidate chains of one :class:`~...trace.OpTrace`."""
    root: dict = {}  # value id -> the id it views

    def resolve(v):
        while v in root:
            v = root[v]
        return v

    producer: dict = {}  # value id -> node index
    consumers: dict = {}  # value id -> node indices
    nodes = program.nodes
    for i, node in enumerate(nodes):
        if node.kind == "op" and node.is_view:
            if node.ins:
                for o in node.outs:
                    root[o] = node.ins[0]
            continue
        for v in {resolve(x) for x in node.ins}:
            consumers.setdefault(v, []).append(i)
        for v in node.outs:
            producer[v] = i
    escaped = {resolve(v) for v in program.outputs}
    elementwise = {i for i, n in enumerate(nodes)
                   if n.kind == "op" and not n.is_view
                   and costmodel.classify(n) == "elementwise"}

    parent = {i: i for i in elementwise}

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    internal: dict = {}  # value id -> bytes x (1 write + its reads)
    for v, p in producer.items():
        users = consumers.get(v, [])
        if p not in elementwise or not users or v in escaped \
                or any(u not in elementwise for u in users):
            continue
        meta = dict(zip(nodes[p].outs, nodes[p].results))[v]
        internal[v] = costmodel.meta_bytes([meta]) * (1 + len(users))
        for u in users:
            parent[find(u)] = find(p)
    groups: dict = {}
    for v, saved in internal.items():
        g = find(producer[v])
        entry = groups.setdefault(g, {"saved": 0, "values": 0})
        entry["saved"] += saved
        entry["values"] += 1
    out = []
    for g, entry in groups.items():
        members = sorted(i for i in elementwise if find(i) == g)
        first = nodes[members[0]]
        out.append({
            "ops": len(members),
            "first": first.name, "last": nodes[members[-1]].name,
            "location": first.location,
            "intermediates": entry["values"],
            "device_bytes_saved": entry["saved"],
            "launches_saved": len(members) - 1})
    out.sort(key=lambda c: (-c["device_bytes_saved"], c["location"]))
    return out


@core.register_pass
class FusionPass:
    pass_id = "fusion-opportunity"
    description = ("chains of elementwise ops whose intermediates "
                   "round-trip device memory: candidate kernels and the "
                   "bytes and launches each would save")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        artifact: dict = {"programs": {}}
        total_saved = total_launches = n_candidates = 0
        for hook, traced in ctx.engine_traces.items():
            if isinstance(traced, trace.TraceFailure):
                continue
            cands = chains(traced)
            artifact["programs"][hook] = cands
            n_candidates += len(cands)
            total_saved += sum(c["device_bytes_saved"] for c in cands)
            total_launches += sum(c["launches_saved"] for c in cands)
            for c in cands[:MAX_FINDINGS_PER_PROGRAM]:
                out.append(core.Finding(
                    severity=core.INFO, pass_id=self.pass_id,
                    model=ctx.model, hook=hook,
                    message=(f"candidate fusion of {c['ops']} elementwise "
                             f"ops ({c['first']} .. {c['last']}): "
                             f"{c['intermediates']} intermediate(s) "
                             "round-trip device memory "
                             f"({c['device_bytes_saved'] >> 10} KiB and "
                             f"{c['launches_saved']} launches saved fused)"),
                    location=c["location"],
                    hint="a lead, not a defect: write the fused kernel, "
                         "then certify the win with the hbm-cost "
                         "baseline"))
        artifact["candidates"] = n_candidates
        artifact["total_device_bytes_saved"] = total_saved
        artifact["total_launches_saved"] = total_launches
        ctx.artifacts["fusion"] = artifact
        if n_candidates:
            out.append(core.Finding(
                severity=core.INFO, pass_id=self.pass_id, model=ctx.model,
                hook="step",
                message=(f"{n_candidates} candidate fusion(s), "
                         f"{total_saved >> 10} KiB of device traffic and "
                         f"{total_launches} launches recoverable (see the "
                         "'fusion' artifact)")))
        return out
