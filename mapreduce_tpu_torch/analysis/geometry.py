"""Kernel geometries: the certifier-gated search and ``'auto'``.

Counterpart of :mod:`mapreduce_tpu.analysis.geometry`, over the port's
launch plans (:mod:`...ops.cuda.plans`) instead of the TPU kernels' VMEM
blocks:

1. :func:`enumerate_candidates` walks the JAX package's lattice
   (:data:`LATTICE_AXES`, one axis off the default at a time), so a
   ``tuned.json`` from either package names the same geometries, and
   ``Geometry``'s own ``ValueError`` drops the off-lattice points;
2. every candidate is **certified** (:func:`certify`): each launch of its
   plan set (:func:`...plans.geometry_plans`) within the card's static
   shared memory a block and a ``__launch_bounds__`` minimum that fits an
   SM, a register cap a thread can work in, and a cache depth within the
   combiner kernels' ``MAX_CACHE``;
3. every certified candidate is **priced** (:func:`price`) with the port's
   cost model: the aggregation sort's rows (the dense stream's live rows
   at the pricing chunk, which no geometry moves), the radix seam's and
   the combiner's bytes from their plans, and the combiner window's spill
   risk at the measured worst density;
4. :func:`shortlist` ranks them.  The port reads two of the geometry's
   fields (``radix_bits``, ``combiner_slots``); a candidate that moves
   only the TPU layout's fields prices equal to the default and is marked
   ``inert``, which the tie-break ranks after the candidates that change a
   launch.

:func:`resolve_auto` resolves ``Config.geometry='auto'`` from a searched
profile.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Iterable, Optional

from mapreduce_tpu_torch.config import (DEFAULT_GEOMETRY, GEOMETRY_PRESETS,
                                        Geometry)
from mapreduce_tpu_torch.obs import history
from mapreduce_tpu_torch.ops.cuda import plans

#: Bumped when the candidate/shortlist artifact schema changes shape.
GEOMETRY_SEARCH_VERSION = 1

#: The pricing chunk: the production default (32 MB).
PRICING_CHUNK_BYTES = 1 << 25

#: The measured worst-case density of token ends (the JAX package's
#: ``tools/density.py`` on its Zipf bench corpus, a property of the data):
#: 114 ends in one 384-byte window.  Scaled to the combiner's window it
#: says whether a window can keep more rows than its budget.
MEASURED_MAX_ENDS = 114
MEASURED_MAX_ENDS_WINDOW = 384

#: Registers a thread needs at the least: ``tokenize_stream`` already
#: spills 16 B at its cap of 32 (the card's report, ``PERF.md``).
REGISTER_FLOOR = 32

#: The geometry fields the port's kernels read; the rest size the TPU
#: kernels' blocks and move no launch here.
READ_FIELDS = ("combiner_slots", "radix_bits")

_RATES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "baselines", "measured_rates.json")


@functools.lru_cache(maxsize=None)
def _measured_rows() -> tuple[int, int]:
    """(sort rows, chunk bytes) of the card's fixture
    (``baselines/measured_rates.json``), read once; a missing or
    malformed fixture raises."""
    with open(_RATES_PATH) as f:
        rates = json.load(f)
    return int(rates["sort_rows"]), int(rates["chunk_bytes"])


def stream_rows(chunk_bytes: int) -> int:
    """The aggregation sort's rows at ``chunk_bytes``: the dense stream's
    live rows and its dead row, scaled from the card's fixture (the rows
    of its 32 MB chunk).  No geometry moves it: the kernel emits one dense
    stream."""
    rows, chunk = _measured_rows()
    return max(1, round(rows * chunk_bytes / chunk))


def radix_amplification(geom: Geometry, rows: int) -> float:
    """The radix seam's bytes over one pass of the sort's three planes:
    its plan's partition levels and segmented passes, each reading and
    writing 12 B a row (24 at the int64 ends), from the candidate's digit
    width.  Priced on ``sort_impl='radix'``, whose two levels decide
    ``2 * radix_bits`` key bits (one level leaves the same segmented
    passes at every width)."""
    plan = plans.radix_sort3(rows, "radix", geom.radix_bits, True)
    passes = dict(plan.sizes)["passes"] + dict(plan.sizes)["levels"]
    return passes * 24 * rows / (2 * rows * 3 * 8)


def combiner_bytes(geom: Geometry, chunk_bytes: int) -> int:
    """What the combiner moves besides its stream, at the candidate's
    cache depth, priced as the cost model prices it: the flushed cache's
    four planes and the scratch its plans declare (its launch's work words,
    count plane and list read back; the fold's unique keys)."""
    c = geom.combiner_slots
    return 4 * 8 * c * plans.SEGMENTS + sum(
        sum(plan.scratch_bytes) for plan in (
            plans.combiner(chunk_bytes, 32, c),
            plans.combiner_fold(c * plans.SEGMENTS, 1 << 18)))


def window_spill_risk() -> bool:
    """Can a combiner window keep more rows than its budget at the
    measured worst density?  Its window (``WINDOW`` bytes) and budget
    (``COMBINER_SLOTS``) are the kernel's own, the same for every
    geometry."""
    worst = -(-MEASURED_MAX_ENDS * plans.WINDOW // MEASURED_MAX_ENDS_WINDOW)
    return worst > plans.COMBINER_SLOTS


def inert(geom: Geometry) -> bool:
    """True when the geometry differs from the default only in fields the
    port's kernels do not read (its plans are the default's)."""
    return geom != DEFAULT_GEOMETRY and all(
        getattr(geom, f) == getattr(DEFAULT_GEOMETRY, f) for f in READ_FIELDS)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One certified, priced geometry candidate."""

    geometry: Geometry
    label: str  # preset name when one matches, else a compact spec
    axis: str  # which lattice axis produced it ('default' for the base)
    #: Aggregation sort rows at the pricing chunk: the primary ranking key.
    sort_rows: int
    #: One full reorder pass over the sort's three int64 planes.
    sort_pass_bytes: int
    #: Peak static shared memory of one block over the plan set.
    smem_peak_bytes: int
    #: The radix seam's bytes over one sort pass's.
    radix_amplification: float
    #: The combiner's bytes besides its stream.
    combiner_bytes: int
    #: The combiner window's spill risk at the measured worst density.
    spill_risk: bool
    #: Moves no launch: only fields the port does not read differ.
    inert: bool

    def as_dict(self) -> dict:
        return {"label": self.label, "axis": self.axis,
                "sort_rows": self.sort_rows,
                "sort_pass_bytes": self.sort_pass_bytes,
                "smem_peak_bytes": self.smem_peak_bytes,
                "radix_amplification": round(self.radix_amplification, 3),
                "combiner_bytes": self.combiner_bytes,
                "spill_risk": self.spill_risk, "inert": self.inert,
                "geometry": self.geometry.as_dict()}


def certify(geom: Geometry) -> list[str]:
    """Static certifier: every launch of the geometry's plan set within
    the card's limits (static shared memory a block, threads, a
    ``__launch_bounds__`` minimum whose blocks fit an SM's threads and
    shared memory, a register cap of at least :data:`REGISTER_FLOOR`) and
    a cache depth within ``MAX_CACHE``.  Returns the reasons it is
    refused: empty means certified."""
    errors: list[str] = []
    if geom.combiner_slots > plans.MAX_CACHE:
        errors.append(f"combiner_slots {geom.combiner_slots} exceeds the "
                      f"combiner kernels' {plans.MAX_CACHE} cache entries "
                      "a segment")
    for plan in plans.geometry_plans(geom, label_for(geom)):
        label = f"{plan.wrapper} [{plan.geometry}]"
        for launch in plan.launches:
            s = launch.spec
            if s.static_smem > plans.STATIC_SMEM_LIMIT:
                errors.append(
                    f"{label}: {s.name} declares {s.static_smem} B of "
                    f"static shared memory, over the "
                    f"{plans.STATIC_SMEM_LIMIT >> 10} KB a block")
            if s.threads > plans.MAX_THREADS_PER_BLOCK:
                errors.append(f"{label}: {s.name} launches {s.threads} "
                              "threads a block")
            blocks = max(1, s.min_blocks)
            if s.threads * blocks > plans.MAX_THREADS_PER_SM \
                    or s.static_smem * blocks > plans.SMEM_PER_SM:
                errors.append(
                    f"{label}: {blocks} blocks of {s.name} do not fit an "
                    "SM's threads or shared memory")
            if s.register_cap < REGISTER_FLOOR:
                errors.append(
                    f"{label}: {s.name}'s __launch_bounds__ leave "
                    f"{s.register_cap} registers a thread, under "
                    f"{REGISTER_FLOOR}")
    return errors


def label_for(geom: Geometry) -> str:
    """A preset name when one matches, else a compact spec string (for
    humans and row labels; the machine-readable form is the dict).  The
    JAX package's labels."""
    for name, preset in GEOMETRY_PRESETS.items():
        if geom == preset:
            return name
    parts = []
    for f in dataclasses.fields(Geometry):
        v = getattr(geom, f.name)
        if v != getattr(DEFAULT_GEOMETRY, f.name):
            parts.append(f"{f.name}={v}")
    return ",".join(parts) or "default"


def price(geom: Geometry, chunk_bytes: int = PRICING_CHUNK_BYTES) -> dict:
    """The port's pricing of one candidate at ``chunk_bytes``: the sort's
    rows and one pass's bytes, the peak static shared memory over its
    plans, the radix seam's amplification and the combiner's bytes at the
    candidate's digit width and cache depth, the spill risk."""
    rows = stream_rows(chunk_bytes)
    return {
        "chunk_bytes": chunk_bytes,
        "sort_rows": rows,
        "sort_pass_bytes": 2 * rows * 3 * 8,
        "smem_peak_bytes": max(launch.spec.static_smem
                               for p in plans.geometry_plans(geom)
                               for launch in p.launches),
        "radix_amplification": radix_amplification(geom, rows),
        "combiner_bytes": combiner_bytes(geom, chunk_bytes),
        "spill_risk": window_spill_risk(),
    }


def _candidate(geom: Geometry, axis: str, chunk_bytes: int) -> Candidate:
    p = price(geom, chunk_bytes)
    return Candidate(geometry=geom, label=label_for(geom), axis=axis,
                     sort_rows=p["sort_rows"],
                     sort_pass_bytes=p["sort_pass_bytes"],
                     smem_peak_bytes=p["smem_peak_bytes"],
                     radix_amplification=p["radix_amplification"],
                     combiner_bytes=p["combiner_bytes"],
                     spill_risk=p["spill_risk"], inert=inert(geom))


#: The candidate lattice, the JAX package's: per-axis values, one axis
#: family off the default at a time.
LATTICE_AXES: dict = {
    "block_rows": (256, 384, 512, 640, 768),
    "aux_rows": (96, 128),
    "combiner_slots": (8, 16, 24, 32),
    "combiner_block_rows": (384, 512, 640),
    "pair_block_rows": (128, 256, 384),
    "sort3": tuple((br, s) for br in (256, 384, 512)
                   for s in (72, 80, 88, 96, 104, 112, 120, 128)
                   if s <= br // 2),
    "radix": tuple((b, sl) for b in (2, 3, 4, 5) for sl in (2, 4)),
}


def enumerate_candidates(chunk_bytes: int = PRICING_CHUNK_BYTES
                         ) -> list[Candidate]:
    """Walk the lattice, certify, price.  Every returned candidate passed
    :func:`certify` (off-lattice or over-budget points are dropped); the
    default geometry is always candidate zero."""
    out: list[Candidate] = []
    seen: set = set()

    def add(axis: str, **fields) -> None:
        try:
            geom = Geometry(**fields)
        except ValueError:
            return  # off the lattice: not a candidate
        if geom in seen:
            return
        seen.add(geom)
        if certify(geom):
            return  # over budget: the certifier is the gate
        out.append(_candidate(geom, axis, chunk_bytes))

    add("default")
    for br in LATTICE_AXES["block_rows"]:
        add("block_rows", block_rows=br)
    for ar in LATTICE_AXES["aux_rows"]:
        add("aux_rows", aux_rows=ar)
    for cs in LATTICE_AXES["combiner_slots"]:
        add("combiner_slots", combiner_slots=cs)
    for cbr in LATTICE_AXES["combiner_block_rows"]:
        add("combiner_block_rows", combiner_block_rows=cbr)
    for pbr in LATTICE_AXES["pair_block_rows"]:
        add("pair_block_rows", pair_block_rows=pbr)
    for sbr, ss in LATTICE_AXES["sort3"]:
        add("sort3", sort3_block_rows=sbr, sort3_slots=ss)
    for bits, slack in LATTICE_AXES["radix"]:
        add("radix", radix_bits=bits, radix_slab_slack=slack)
    return out


def shortlist(candidates: Iterable[Candidate], k: int = 5,
              axis: Optional[str] = None) -> list[Candidate]:
    """Top-K by modeled traffic: sort rows, then the radix seam's
    amplification, the combiner's bytes and the peak shared memory; at
    equal prices a candidate that moves no launch (``inert``) ranks after
    one that does, then by label.  ``axis`` narrows to one lattice family
    plus the default.  Spill-risky candidates rank by the same cost."""
    pool = [c for c in candidates
            if axis is None or c.axis in (axis, "default")]
    ranked = sorted(pool, key=lambda c: (
        c.sort_rows, round(c.radix_amplification, 9), c.combiner_bytes,
        c.smem_peak_bytes, c.inert, c.label))
    return ranked[:k]


def search_artifact(candidates: list[Candidate], k: int = 5) -> dict:
    """The machine-readable search artifact (the JAX package's keys)."""
    return {
        "geometry_search_version": GEOMETRY_SEARCH_VERSION,
        "pricing_chunk_bytes": PRICING_CHUNK_BYTES,
        "candidates": len(candidates),
        "default": next((c.as_dict() for c in candidates
                         if c.axis == "default"), None),
        "shortlist": [c.as_dict() for c in shortlist(candidates, k)],
    }


def resolve_auto(profile_path: str, family: str = "wordcount"):
    """Resolve ``Config.geometry='auto'`` against a searched profile: the
    freshest ``tuned.json`` profile for ``family`` whose config carries a
    non-default geometry decides, as its preset label or spec dict (the
    ``Config`` takes both).  No profile, no geometry entry or an
    unreadable file resolves to ``'default'``.  The read is
    ``history.resolve_prior``'s; this wrapper adds the ``Config``-side
    check of a spec dict (a dict ``Geometry`` refuses is skipped)."""

    def _valid_spec(spec: dict) -> bool:
        try:
            Geometry(**spec)
        except (TypeError, ValueError):
            return False
        return True

    return history.resolve_prior(
        profile_path=profile_path, family=family,
        presets=set(GEOMETRY_PRESETS), geometry_ok=_valid_spec)["geometry"]
