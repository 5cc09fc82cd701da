"""The link model: collective schedules priced over a mesh of cards.

Counterpart of :mod:`mapreduce_tpu.analysis.meshcost` (a copy: the port
imports nothing of the JAX package), with the card's link levels in place
of the TPU's.  The model is the alpha-beta decomposition over a THREE-level
link hierarchy -- ``hbm`` within a card, ``nvlink`` between the cards of a
node, ``net`` between nodes -- with each level's latency and bandwidth read
from ``analysis/baselines/measured_link_rates.json``, which names the
source of each level (the card's measured copy rate for ``hbm``; the H100
SXM datasheet's NVLink 4 and a 400 Gb/s NDR port a card for the two links,
which a machine with one card cannot measure).

Like the byte model it completes, this is a stable, auditable BOUND, not a
simulator: every schedule is priced as ``rounds * alpha + bytes/beta`` per
link level, congestion-free.  The schedules priced are the ones the port's
runtime builds (:mod:`mapreduce_tpu_torch.parallel.collectives`: its
``STRATEGIES`` stay in bijection with :data:`STRATEGIES` here, and
:func:`keyrange_budget_rows` equals its ``_block_budget``; tests hold
both):

* **ring all-reduce** -- ``2(D-1) alpha + 2 (D-1)/D * M/beta``;
* **butterfly tree** -- ``log2(D) * (alpha + M/beta)``: ``tree_merge``,
  the full payload every round;
* **all-gather + fold** -- ``alpha + (D-1) M/beta``: ``gather_merge``;
* **reduce-scatter** -- ``alpha + (D-1)/D * M/beta``;
* **keyrange all-to-all** -- ``2 alpha + 2 s M/beta``: one budgeted
  ``all_to_all`` (s*M with slack s) and one all-gather of the reduced
  blocks (``key_range_merge``);
* **two-level** -- the inner (within a node) level first, then the outer
  (across nodes) level with the already-merged payload
  (``hierarchical_merge``).

The ring-vs-tree crossover is closed-form (:func:`ring_tree_crossover_bytes`;
at D=4 it is ``M* = 8 alpha beta``).  Stdlib only: a planner may load this
module by file path.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence

_BASELINES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "baselines")
LINK_RATES_PATH = os.path.join(_BASELINES_DIR, "measured_link_rates.json")

#: CountTable wire footprint: 7 uint32 planes (key_hi/key_lo/count/
#: count_hi/pos_hi/pos_lo/length) per slot; the dropped_* scalars are
#: noise.  The payload unit every strategy moves.
TABLE_PLANES = 7

#: Top single-key mass past which keyrange's hot-owner derating applies
#: (obs/datahealth.TOP_MASS_HOT, kept literal so this module stays
#: loadable by file path with no package import).
TOP_MASS_HOT = 0.05


@dataclasses.dataclass(frozen=True)
class Link:
    """One link level: per-hop latency (seconds) + bandwidth (bytes/s)."""

    name: str
    alpha_s: float
    beta_bps: float

    def time(self, payload_bytes: float, rounds: int = 1) -> float:
        """``rounds * alpha + payload/beta``: the alpha-beta unit."""
        return rounds * self.alpha_s + payload_bytes / self.beta_bps


def load_link_rates(path: Optional[str] = None) -> dict:
    """The link-rate fixture -> ``{"levels": {name: Link},
    "keyrange_slack": float, "sources": {name: source}}`` (a level's
    source: ``measured`` on the card, or ``datasheet``)."""
    with open(path or LINK_RATES_PATH) as f:
        raw = json.load(f)
    levels = {name: Link(name=name, alpha_s=float(spec["alpha_s"]),
                         beta_bps=float(spec["beta_gbps"]) * 1e9)
              for name, spec in raw["levels"].items()}
    return {"levels": levels,
            "keyrange_slack": float(raw.get("keyrange_slack", 2.0)),
            "sources": {name: spec.get("source")
                        for name, spec in raw["levels"].items()}}


#: A level's letter in a mesh label (``2nx4v``: 2 nodes over the network,
#: 4 cards a node over NVLink).
LEVEL_TAGS = {"hbm": "h", "nvlink": "v", "net": "n"}


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One mesh axis with the link level its collectives ride."""

    name: str
    size: int
    level: str  # 'nvlink' | 'net' (hbm is the one-card degenerate case)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh shape with link-level attribution, outermost axis first.

    The runtime contract (``parallel/mesh.two_level_mesh``): ranks are
    node-major, so the OUTER axis crosses the node boundary and rides the
    network, inner axes ride NVLink.  A single-node mesh is all-NVLink.
    """

    axes: tuple  # tuple[MeshAxis, ...]

    @classmethod
    def single_host(cls, n_devices: int, axis: str = "data") -> "MeshSpec":
        return cls(axes=(MeshAxis(axis, int(n_devices), "nvlink"),))

    @classmethod
    def fleet(cls, processes: int, local_devices: int,
              axes: Sequence[str] = ("replica", "data")) -> "MeshSpec":
        return cls(axes=(MeshAxis(axes[0], int(processes), "net"),
                         MeshAxis(axes[1], int(local_devices), "nvlink")))

    @classmethod
    def from_mesh(cls, axis_names: Sequence[str], axis_sizes: Sequence[int],
                  processes: int = 1) -> "MeshSpec":
        """Attribute a traced mesh's axes: with >1 node the outermost axis
        crosses the node boundary (node-major rank order)."""
        axes = []
        for i, (name, size) in enumerate(zip(axis_names, axis_sizes)):
            level = "net" if processes > 1 and i == 0 else "nvlink"
            axes.append(MeshAxis(str(name), int(size), level))
        return cls(axes=tuple(axes))

    @property
    def n_devices(self) -> int:
        return math.prod(a.size for a in self.axes)

    def axis(self, name: str) -> Optional[MeshAxis]:
        for a in self.axes:
            if a.name == name:
                return a
        return None

    def slowest_level(self) -> str:
        return "net" if any(a.level == "net" for a in self.axes) \
            else "nvlink"

    def label(self) -> str:
        return "x".join(f"{a.size}{LEVEL_TAGS[a.level]}" for a in self.axes)


def table_bytes(capacity: int) -> int:
    """CountTable wire bytes at a capacity: 7 uint32 planes."""
    return TABLE_PLANES * 4 * int(capacity)


# -- per-schedule alpha-beta pricing (one level, D participants) -------------


def allreduce_ring(m: float, d: int, link: Link) -> float:
    """Ring all-reduce (reduce-scatter + all-gather rings): 2(D-1) hops,
    each moving M/D: NCCL's ring ``all_reduce`` (``collectives.psum``)."""
    if d <= 1:
        return 0.0
    return link.time(2 * (d - 1) / d * m, rounds=2 * (d - 1))


def allreduce_tree(m: float, d: int, link: Link) -> float:
    """Butterfly (recursive-doubling) all-reduce: log2(D) rounds, FULL
    payload every round: ``collectives.tree_merge``."""
    if d <= 1:
        return 0.0
    rounds = max(1, math.ceil(math.log2(d)))
    return link.time(rounds * m, rounds=rounds)


def allgather(m: float, d: int, link: Link) -> float:
    """One all-gather of every participant's full M: receive (D-1)*M,
    ``collectives.gather_merge``'s wire cost (the fold is local)."""
    if d <= 1:
        return 0.0
    return link.time((d - 1) * m, rounds=1)


def reduce_scatter(m: float, d: int, link: Link) -> float:
    """Ring reduce-scatter: (D-1) hops of M/D."""
    if d <= 1:
        return 0.0
    return link.time((d - 1) / d * m, rounds=d - 1)


def all_to_all(m: float, d: int, link: Link) -> float:
    """One all-to-all: each participant ships (D-1)/D of its M."""
    if d <= 1:
        return 0.0
    return link.time((d - 1) / d * m, rounds=1)


def keyrange(m: float, d: int, link: Link, slack: float = 2.0) -> float:
    """``key_range_merge``: one budgeted all-to-all (s*M with slack s) and
    one all-gather of the already-reduced blocks (s*M), priced at the
    slowest link the flattened axis crosses."""
    if d <= 1:
        return 0.0
    return link.time(slack * m, rounds=1) + link.time(slack * m, rounds=1)


def ring_tree_crossover_bytes(d: int, link: Link) -> float:
    """Payload M* where ring and butterfly all-reduce cost the same:
    ``M* = alpha*beta * (2(D-1) - log2 D) / (log2 D - 2(D-1)/D)``.
    Below M* the butterfly's fewer latency rounds win; above it the
    ring's 2(D-1)/D byte factor wins.  At D=4 this is ``8*alpha*beta``."""
    if d < 4:  # at D=2 both schedules move M in 1-2 rounds; no crossover
        return math.inf
    log_d = math.ceil(math.log2(d))
    num = 2 * (d - 1) - log_d
    den = log_d - 2 * (d - 1) / d
    if den <= 0:
        return math.inf
    return link.alpha_s * link.beta_bps * num / den


#: Collective primitive -> (schedule fn, human schedule name), the JAX
#: package's primitive names: what the collective-cost pass prices each
#: recorded collective with (the port's ops map onto them,
#: :data:`C10D_PRIMS`).  ``ppermute`` is one round of M (a butterfly
#: exchange).
_PRIM_SCHEDULES = {
    "psum": (allreduce_ring, "ring-allreduce"),
    "pmax": (allreduce_ring, "ring-allreduce"),
    "pmin": (allreduce_ring, "ring-allreduce"),
    "pbroadcast": (allreduce_tree, "broadcast-tree"),
    "all_gather": (allgather, "all-gather"),
    "reduce_scatter": (reduce_scatter, "reduce-scatter"),
    "psum_scatter": (reduce_scatter, "reduce-scatter"),
    "all_to_all": (all_to_all, "all-to-all"),
    "ppermute": (lambda m, d, link: link.time(m, rounds=1) if d > 1 else 0.0,
                 "ppermute-round"),
}

COLLECTIVE_PRIMS = frozenset(_PRIM_SCHEDULES) | {"axis_index"}

#: ``torch.distributed``'s ops (the ``c10d`` namespace a dispatch mode
#: sees) as the primitive each prices as.  A point-to-point ``send`` is one
#: round of the butterfly; its ``recv_`` is the same round, priced once.
C10D_PRIMS = {
    "allreduce_": "psum",
    "allreduce_coalesced_": "psum",
    "allgather_": "all_gather",
    "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "alltoall_": "all_to_all",
    "alltoall_base_": "all_to_all",
    "broadcast_": "pbroadcast",
    "send": "ppermute",
}


def price_eqn(prim: str, payload_bytes: int, axis_names: Sequence[str],
              mesh: MeshSpec, levels: dict) -> Optional[dict]:
    """Model one recorded collective: per-axis alpha-beta seconds at the
    axis's link level.  A collective over several axes (the flattened
    mesh) prices each level in turn with the full payload (conservative).
    Returns None for communication-free prims (``axis_index``) or unknown
    axes."""
    if prim not in _PRIM_SCHEDULES:
        return None
    fn, schedule = _PRIM_SCHEDULES[prim]
    per_axis = []
    total = 0.0
    for name in axis_names:
        ax = mesh.axis(name)
        if ax is None:
            return None
        link = levels[ax.level]
        s = fn(float(payload_bytes), ax.size, link)
        per_axis.append({"axis": name, "d": ax.size, "level": ax.level,
                         "seconds": s})
        total += s
    if not per_axis:
        return None
    return {"schedule": schedule, "seconds": total, "per_axis": per_axis}


# -- reduction-strategy descriptors + pricing --------------------------------


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One reduction strategy the planner enumerates, named EXACTLY after
    the runtime builder in ``parallel/collectives.py`` (the Engine's
    ``merge_strategy`` values; a test holds the bijection)."""

    name: str
    builder: str  # dotted runtime location, for the artifact trail
    power_of_two_only: bool = False
    needs_keyrange_hook: bool = False
    description: str = ""


_RUNTIME = "mapreduce_tpu_torch.parallel.collectives"

STRATEGIES = {
    "tree": Strategy(
        name="tree",
        builder=f"{_RUNTIME}.tree_merge",
        power_of_two_only=True,
        description="butterfly exchange all-reduce, log2(D) full-payload "
                    "rounds per axis (innermost level first on two-level "
                    "meshes); axes that are not a power of two fall back "
                    "to gather"),
    "gather": Strategy(
        name="gather",
        builder=f"{_RUNTIME}.gather_merge",
        description="all_gather every state + local fold; any axis size, "
                    "O(D) memory, (D-1)*M wire bytes per axis"),
    "keyrange": Strategy(
        name="keyrange",
        builder=f"{_RUNTIME}.key_range_merge",
        needs_keyrange_hook=True,
        description="key-range reduce-scatter: one budgeted all_to_all + "
                    "owner reduce + all_gather of reduced blocks, over "
                    "the FLATTENED mesh (trades the NVLink/network "
                    "hierarchy for a single scheduled collective)"),
    # The placed two-level compositions: one strategy per link level,
    # priced as the runtime composes them (inner axis first; only on
    # two-level meshes: plan() skips them on a one-node shape with a
    # reason instead of pricing a degenerate).
    "hier-kr-tree": Strategy(
        name="hier-kr-tree",
        builder=f"{_RUNTIME}.hier_kr_tree_merge",
        power_of_two_only=True,
        needs_keyrange_hook=True,
        description="placed two-level reduction: keyrange on the inner "
                    "(NVLink) axis, a budgeted all_to_all + owner reduce "
                    "over the cheap link, then a butterfly tree over the "
                    "outer (network) axis with the already-reduced "
                    "payload"),
    "hier-tree-tree": Strategy(
        name="hier-tree-tree",
        builder=f"{_RUNTIME}.hier_tree_tree_merge",
        power_of_two_only=True,
        description="the named two-level tree composition: butterfly per "
                    "level, innermost first (the schedule 'tree' runs on "
                    "a two-level mesh, as an explicit placement)"),
}


def keyrange_budget_rows(capacity: int, d: int, slack: float) -> int:
    """``key_range_merge``'s per-destination row budget B
    (``collectives._block_budget``, reproduced so the planner's spill-risk
    arithmetic cannot drift from the runtime; a test holds them equal)."""
    if d <= 1:
        return int(capacity)
    return min(int(capacity),
               -(-int(slack * capacity) // d) + 8 + 4 * (d - 1).bit_length())


def _price_tree_leg(ax: MeshAxis, m: float, levels: dict,
                    notes: list) -> dict:
    """One butterfly leg over one axis (with tree_merge's fallback to
    gather on an axis that is not a power of two), shared by 'tree' and
    the two-level compositions so the legs cannot price differently."""
    link = levels[ax.level]
    if ax.size & (ax.size - 1):
        s = allgather(m, ax.size, link)
        sched = "all-gather (non-power-of-two fallback)"
        notes.append(f"axis {ax.name!r} (D={ax.size}) is not a "
                     "power of two: tree_merge falls back to "
                     "gather there")
    else:
        s = allreduce_tree(m, ax.size, link)
        sched = "butterfly-tree"
    return {"axis": ax.name, "d": ax.size, "level": ax.level,
            "schedule": sched, "seconds": s}


def price_strategy(name: str, payload_bytes: int, mesh: MeshSpec,
                   levels: dict, slack: float = 2.0) -> dict:
    """Model one strategy end to end over a mesh: per-level schedule
    seconds, innermost first for the two-level strategies (the
    ``hierarchical_merge`` order), the flattened mesh for keyrange, and
    per-level placement for the hier-* compositions (keyrange priced at
    the INNER axis's link, tree legs over the outer axes)."""
    strat = STRATEGIES[name]
    per_level = []
    total = 0.0
    notes = []
    m = float(payload_bytes)
    if name == "keyrange":
        d = mesh.n_devices
        level = mesh.slowest_level()
        link = levels[level]
        s = keyrange(m, d, link, slack=slack)
        per_level.append({"axis": "<flattened>", "d": d, "level": level,
                          "schedule": "keyrange-a2a", "seconds": s})
        total = s
    elif name == "hier-kr-tree":
        # hier_kr_tree_merge's placement: the budgeted all_to_all round
        # runs over the innermost (fast-link) axis only, then the
        # already-reduced payload crosses the outer level as tree legs.
        inner = mesh.axes[-1]
        link = levels[inner.level]
        s = keyrange(m, inner.size, link, slack=slack)
        per_level.append({"axis": inner.name, "d": inner.size,
                          "level": inner.level, "schedule": "keyrange-a2a",
                          "seconds": s})
        total = s
        for ax in reversed(mesh.axes[:-1]):
            leg = _price_tree_leg(ax, m, levels, notes)
            per_level.append(leg)
            total += leg["seconds"]
    elif name in ("tree", "hier-tree-tree"):
        # hierarchical_merge order: innermost (fast) axis first, so the
        # outer (slow) level moves one already-merged payload a node.
        for ax in reversed(mesh.axes):
            leg = _price_tree_leg(ax, m, levels, notes)
            per_level.append(leg)
            total += leg["seconds"]
    else:
        for ax in reversed(mesh.axes):
            link = levels[ax.level]
            s = allgather(m, ax.size, link)
            per_level.append({"axis": ax.name, "d": ax.size,
                              "level": ax.level,
                              "schedule": "all-gather+fold", "seconds": s})
            total += s
    return {"strategy": name, "builder": strat.builder,
            "modeled_s": total, "per_level": per_level, "notes": notes}


def plan(processes: int, local_devices: int, capacity: int, *,
         rates: Optional[dict] = None, top_mass: Optional[float] = None,
         table_occupancy: Optional[float] = None,
         has_keyrange_hook: bool = True,
         incumbent: Optional[str] = None) -> dict:
    """Enumerate, price and rank every feasible reduction strategy for a
    fleet shape: the planner core.

    ``top_mass``/``table_occupancy`` (a prior run's measured key
    distribution, via ``obs/history.resolve_prior``) derate keyrange:
    past ``TOP_MASS_HOT`` the hot key's owner partition is the reduce's
    critical path (modeled_s scaled by ``1 + top_mass``), and a partition
    load near the budget B flags spill risk (exactness holds, spilled
    keys are fully evicted, but a spilling merge is a different result
    surface than tree/gather's).
    """
    rates = rates or load_link_rates()
    levels, slack = rates["levels"], rates["keyrange_slack"]
    mesh = MeshSpec.fleet(processes, local_devices) if processes > 1 \
        else MeshSpec.single_host(local_devices)
    payload = table_bytes(capacity)
    ranked = []
    skipped = []
    decl_order = {name: i for i, name in enumerate(STRATEGIES)}
    for name, strat in STRATEGIES.items():
        if name.startswith("hier-") and len(mesh.axes) < 2:
            skipped.append({"strategy": name,
                            "why": "needs a two-level mesh (a one-node "
                                   "shape has one link level to place "
                                   "over)"})
            continue
        if strat.needs_keyrange_hook and not has_keyrange_hook:
            skipped.append({"strategy": name,
                            "why": "job has no keyrange_merge hook"})
            continue
        priced = price_strategy(name, payload, mesh, levels, slack=slack)
        if name in ("keyrange", "hier-kr-tree"):
            # hier-kr-tree's keyrange leg runs over the INNER axis only,
            # so its budget/derating arithmetic uses that axis's size.
            d = mesh.n_devices if name == "keyrange" else mesh.axes[-1].size
            budget = keyrange_budget_rows(capacity, d, slack)
            priced["keyrange_budget_rows"] = budget
            if top_mass is not None and top_mass > TOP_MASS_HOT:
                if name == "keyrange":
                    priced["modeled_s"] *= 1.0 + float(top_mass)
                else:
                    inner = priced["per_level"][0]
                    delta = inner["seconds"] * float(top_mass)
                    inner["seconds"] += delta
                    priced["modeled_s"] += delta
                leg = "" if name == "keyrange" \
                    else " (on the inner keyrange leg)"
                priced["notes"].append(
                    f"skew derating x{1 + top_mass:.2f}{leg}: measured "
                    f"top_mass {top_mass:.2f} > {TOP_MASS_HOT} puts the "
                    "hot key's owner partition on the critical path")
            if table_occupancy is not None and d > 1 \
                    and table_occupancy * capacity / d > 0.8 * budget:
                priced["spill_risk"] = True
                priced["notes"].append(
                    f"partition load ~{table_occupancy * capacity / d:.0f} "
                    f"rows nears the budget B={budget}: budget spill "
                    "(exact, but a different result surface) is likely")
        priced["modeled_s"] = round(priced["modeled_s"], 9)
        for lv in priced["per_level"]:
            lv["seconds"] = round(lv["seconds"], 9)
        ranked.append(priced)
    # Ties go to the earlier-declared, simpler strategy (hier-tree-tree
    # prices as tree on every two-level mesh by construction: the
    # incumbent must not be displaced by its own composition's alias).
    ranked.sort(key=lambda p: (p["modeled_s"], decl_order[p["strategy"]]))
    return {
        "mesh": {"processes": int(processes),
                 "local_devices": int(local_devices),
                 "devices": mesh.n_devices, "label": mesh.label()},
        "capacity": int(capacity),
        "payload_bytes": payload,
        "keyrange_slack": slack,
        "ranked": ranked,
        "skipped": skipped,
        "top": ranked[0]["strategy"] if ranked else None,
        "incumbent": incumbent,
        "incumbent_is_top": (incumbent == ranked[0]["strategy"]
                             if ranked and incumbent else None),
    }
