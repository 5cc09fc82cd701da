"""Pass: overflow / dtype lint.

Counterpart of :mod:`mapreduce_tpu.analysis.passes.overflow`.  The port
carries every uint32 plane of the JAX package as an int64 tensor masked to
32 bits (ROADMAP "Rules"), so an int64 counter leaf holds a 32-bit lane,
and a 32-bit count accumulator silently wraps at corpus scale.  The
convention is the lo/hi lane pair with explicit carry
(:func:`...ops.table.add64`); this lint walks the state's leaves against a
configurable corpus-scale bound and flags counter-shaped leaves that are
NOT lane-paired:

* a leaf whose name says it counts (``count``/``total``/``matches``/
  ``lines``/``sum``/``num``...) with an integer dtype and no ``*_hi``
  sibling is an ERROR when the corpus bound exceeds its lane's range
  (uint32 for int64 and uint32 tensors, the dtype's own otherwise), a
  WARNING when it is within one doubling; a host int in the state is
  unbounded and skipped;
* integer downcasts (``aten._to_copy`` to a narrower integer) inside
  ``combine``/``merge`` are WARNINGs: silent truncation on the
  accumulator path;
* the padding-sentinel envelope of the count-table plane is checked
  statically: ``SENTINEL_KEY``/``POS_INF`` must be the maximum uint32 so
  dead rows sort last.

The lane pairs recognized: ``X`` + ``X_hi``, or ``X_lo`` + ``X_hi``, as
NamedTuple siblings.
"""

from __future__ import annotations

import re

import torch

from mapreduce_tpu_torch.analysis import core, trace

_COUNTERISH = re.compile(
    r"(count|total|matches|lines|occurrence|freq|sum|n_|num)", re.IGNORECASE)
_UINT32_MAX = (1 << 32) - 1
_INT_BITS = {"uint8": 8, "int8": 8, "int16": 16, "uint16": 16, "int32": 32,
             "uint32": 32, "int64": 64, "uint64": 64}


def _leaf_field(path: str) -> str:
    """Final field name of a dotted leaf path."""
    return path.rsplit(".", 1)[-1]


def _sibling_fields(path: str, leaves: list[tuple[str, object]]) -> set[str]:
    """Field names sharing the leaf's parent container."""
    parent = path.rsplit(".", 1)[0] if "." in path else ""
    out = set()
    for p, _ in leaves:
        if "." in p and p.rsplit(".", 1)[0] == parent:
            out.add(_leaf_field(p))
    return out


def _lane_paired(field: str, siblings: set[str]) -> bool:
    """True when the field participates in a lo/hi lane pair."""
    if field.endswith("_hi"):
        return True  # it IS a high lane
    if field.endswith("_lo"):
        return (field[:-3] + "_hi") in siblings
    return (field + "_hi") in siblings


def lane_capacity(leaf) -> int | None:
    """The largest count a tensor leaf's lane holds: uint32's for the
    port's int64 lanes, the dtype's own for narrower integers; None for a
    non-integer leaf or a host value."""
    if not isinstance(leaf, torch.Tensor) or leaf.is_floating_point() \
            or leaf.dtype == torch.bool or leaf.is_complex():
        return None
    if leaf.dtype == torch.int64:
        return _UINT32_MAX
    return int(torch.iinfo(leaf.dtype).max)


@core.register_pass
class OverflowPass:
    pass_id = "overflow-dtype"
    description = ("accumulator dtypes vs corpus scale: un-paired 32-bit "
                   "counters, integer downcasts, sentinel envelope")

    def run(self, ctx: core.AnalysisContext) -> list[core.Finding]:
        out: list[core.Finding] = []
        out.extend(self._sentinel_findings(ctx))

        st = ctx.state_shape
        if isinstance(st, trace.TraceFailure):
            out.append(core.Finding(
                severity=core.WARNING, pass_id=self.pass_id,
                model=ctx.model, hook="init_state",
                message=f"state unavailable ({st.error_type}: "
                        f"{st.error}); dtype lint skipped",
                hint="make init_state run on the analysis device"))
            return out
        leaves = trace.named_leaves(st)
        bound = ctx.corpus_token_bound
        # Jobs may exempt leaves (by field name or full path) a name-based
        # lint would misread; the declaration site carries the reason.
        exempt = set(getattr(ctx.job, "analysis_overflow_exempt", ()))
        for path, leaf in leaves:
            cap = lane_capacity(leaf)
            if cap is None:
                continue
            field = _leaf_field(path)
            if path in exempt or field in exempt:
                continue
            if not _COUNTERISH.search(field):
                continue
            if _lane_paired(field, _sibling_fields(path, leaves)):
                continue
            lane = "uint32 lane" if leaf.dtype == torch.int64 \
                else str(leaf.dtype).replace("torch.", "")
            if bound > cap:
                out.append(core.Finding(
                    severity=core.ERROR, pass_id=self.pass_id,
                    model=ctx.model, hook="init_state",
                    message=(f"counter leaf '{path}' is a {lane} "
                             f"(max {cap:,}) but the corpus bound is "
                             f"{bound:,} tokens: silent wrap at scale"),
                    location=path,
                    hint="carry the count as a lo/hi lane pair with "
                         "explicit carry (ops.table.add64, the grep "
                         "accumulator idiom)"))
            elif bound > cap // 2:
                out.append(core.Finding(
                    severity=core.WARNING, pass_id=self.pass_id,
                    model=ctx.model, hook="init_state",
                    message=(f"counter leaf '{path}' is a {lane} "
                             f"(max {cap:,}); the corpus bound {bound:,} is "
                             "within one doubling of overflow"),
                    location=path,
                    hint="promote to a lo/hi lane pair before the next "
                         "corpus scale-up"))

        out.extend(self._downcast_findings(ctx))
        return out

    def _downcast_findings(self, ctx) -> list[core.Finding]:
        out = []
        for hook in ("combine", "merge"):
            traced = ctx.hook_traces.get(hook)
            if traced is None or isinstance(traced, trace.TraceFailure):
                continue
            seen = set()
            for node in traced.nodes:
                if node.kind != "op" or not node.name.startswith(
                        "aten._to_copy") or not node.operands \
                        or not node.results:
                    continue
                old, new = node.operands[0][1], node.results[0][1]
                if old in _INT_BITS and new in _INT_BITS \
                        and _INT_BITS[new] < _INT_BITS[old] \
                        and (old, new) not in seen:
                    seen.add((old, new))
                    out.append(core.Finding(
                        severity=core.WARNING, pass_id=self.pass_id,
                        model=ctx.model, hook=hook,
                        message=(f"integer downcast {old}->{new} on the "
                                 f"{hook} path: high bits are silently "
                                 "dropped"),
                        location=f"{node.name} @ {node.location}",
                        hint="keep accumulator arithmetic at full width"))
        return out

    def _sentinel_findings(self, ctx) -> list[core.Finding]:
        from mapreduce_tpu_torch import constants

        out = []
        if int(constants.SENTINEL_KEY) != _UINT32_MAX:
            out.append(core.Finding(
                severity=core.ERROR, pass_id=self.pass_id,
                model=ctx.model, hook="constants",
                message=(f"SENTINEL_KEY is {int(constants.SENTINEL_KEY):#x}, "
                         "not the maximum uint32: dead table rows would stop "
                         "sorting last and every merge would corrupt"),
                location="mapreduce_tpu_torch/constants.py",
                hint="keep SENTINEL_KEY = 0xFFFFFFFF"))
        if int(constants.POS_INF) != _UINT32_MAX:
            out.append(core.Finding(
                severity=core.ERROR, pass_id=self.pass_id,
                model=ctx.model, hook="constants",
                message=(f"POS_INF is {int(constants.POS_INF):#x}, not the "
                         "maximum uint32: empty-slot positions would win "
                         "first-occurrence minima"),
                location="mapreduce_tpu_torch/constants.py",
                hint="keep POS_INF = 0xFFFFFFFF"))
        return out
