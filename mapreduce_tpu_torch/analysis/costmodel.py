"""Static per-node device-memory accounting over op traces.

Counterpart of :mod:`mapreduce_tpu.analysis.costmodel`, over the port's op
traces (:mod:`.trace`) instead of jaxprs.  Every node is charged from its
operand and result shapes and dtypes alone -- no device, no profiler:

* a non-view aten op reads its operands and writes its results.  This is
  the one deliberate difference from the JAX model
  (``costmodel.py:8-27``), which charges elementwise chains nothing
  because XLA fuses them into their consumers: eager PyTorch fuses
  nothing, so every op moves its operands through device memory;
* a kernel node (a hand-written kernel's wrapper) reads its operands and
  writes its results, moves the scratch its plan declares (work words
  cleared and polled, planes one launch writes and the next reads back:
  :attr:`...ops.cuda.plans.KernelPlan.scratch`), and launches what its
  plan says;
* a view charges nothing and launches nothing;
* a collective (a ``c10d`` op, recorded over a fleet's fake world) is
  tallied in its own family, the bytes this rank sends, and left out of
  device memory: those bytes price the interconnect, which the
  collective-cost pass models (:mod:`.meshcost`); it launches one;
* a declared host sync charges nothing on device memory and counts as a
  host read (so does an undeclared syncing op).

``launches`` counts the device work a program issues: one a non-view op,
and each kernel node's planned launches (a wrapper can launch several
kernels).  It is a static count: an op that launches no kernel on the card
(a scalar read) or several (a library sort) counts as one.

``effective passes`` = device bytes / bytes of one input pass: how many
times the step moves its own chunk's worth of bytes.
"""

from __future__ import annotations

import dataclasses
import math

_DTYPE_BYTES = {"bool": 1, "uint8": 1, "int8": 1, "int16": 2, "float16": 2,
                "bfloat16": 2, "int32": 4, "float32": 4, "int64": 8,
                "float64": 8, "uint16": 2, "uint32": 4, "uint64": 8}


def meta_bytes(meta) -> int:
    """Bytes of ``(shape, dtype)`` pairs."""
    return sum(int(math.prod(shape)) * _DTYPE_BYTES.get(dtype, 8)
               for shape, dtype in meta)


@dataclasses.dataclass
class Cost:
    """Additive cost of a program."""

    bytes_read: int = 0
    bytes_written: int = 0
    nodes: int = 0
    launches: int = 0
    host_reads: int = 0
    kernel_nodes: int = 0
    collective_bytes: int = 0
    families: dict = dataclasses.field(default_factory=dict)

    @property
    def device_bytes(self) -> int:
        return self.bytes_read + self.bytes_written

    def charge(self, family: str, read: int, written: int) -> None:
        self.bytes_read += read
        self.bytes_written += written
        self.families[family] = self.families.get(family, 0) + read + written

    def as_dict(self) -> dict:
        return {"read_bytes": self.bytes_read,
                "written_bytes": self.bytes_written,
                "device_bytes": self.device_bytes,
                "nodes": self.nodes, "launches": self.launches,
                "kernel_nodes": self.kernel_nodes,
                "host_reads": self.host_reads,
                "collective_bytes": self.collective_bytes,
                "family_bytes": dict(sorted(self.families.items()))}


def classify(node) -> str:
    """The family a node's bytes are charged to."""
    if node.kind in ("kernel", "collective"):
        return node.kind
    if node.kind != "op":
        return "host"
    name = node.name.split(".")[1] if node.name.startswith("aten.") \
        else node.name
    if name in ("sort", "argsort", "topk", "kthvalue"):
        return "sort"
    if "scatter" in name or name.startswith("index_put") \
            or name in ("index_add", "index_add_", "index_copy"):
        return "scatter"
    if "gather" in name or name in ("index", "index_select", "take",
                                    "searchsorted"):
        return "gather"
    if name in ("cat", "stack", "slice_scatter", "select_scatter",
                "constant_pad_nd", "clone", "_to_copy", "copy_", "flip",
                "roll", "repeat", "expand_copy", "_unsafe_view"):
        return "layout/copy"
    if name in ("cumsum", "cummax", "cummin", "cumprod", "_cummax_helper",
                "_cummin_helper", "sum", "amax", "amin", "max", "min",
                "any", "all", "bincount", "mean", "prod", "argmax",
                "argmin", "count_nonzero"):
        return "scan/reduce"
    if name in ("full", "zeros", "ones", "empty", "arange", "scalar_tensor",
                "full_like", "zeros_like", "ones_like", "empty_like",
                "new_full", "new_zeros", "new_empty", "fill_", "zero_"):
        return "alloc/fill"
    return "elementwise"


def program_cost(program) -> Cost:
    """Charge every node of one :class:`~.trace.OpTrace` per the module
    model."""
    cost = Cost()
    for node in program.nodes:
        cost.nodes += 1
        if node.syncs:
            cost.host_reads += 1
        if node.kind in ("host_read", "host_copy") or node.is_view:
            continue
        if node.kind == "collective":
            sent = int(node.attr("sent_bytes", 0))
            cost.collective_bytes += sent
            cost.families["collective"] = \
                cost.families.get("collective", 0) + sent
            cost.launches += 1
            continue
        read, written = meta_bytes(node.operands), meta_bytes(node.results)
        if node.kind == "kernel" and node.plan:
            scratch_read, scratch_written = node.plan.scratch_bytes
            read, written = read + scratch_read, written + scratch_written
        cost.charge(classify(node), read, written)
        if node.kind == "kernel":
            cost.kernel_nodes += 1
            cost.launches += len(node.plan.launches) if node.plan else 1
        else:
            cost.launches += 1
    return cost


# -- the aggregation sort ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SortInfo:
    rows: int  # rows sorted
    kind: str  # 'torch' (aten.sort of the 64-bit key) or the kernel's name
    location: str


def find_aggregation_sort(program) -> SortInfo | None:
    """The map's aggregation sort in a step trace: the first sort after
    the map's host read (the read gives the live cut the sort sees) -- a
    one-operand int64 ``aten.sort`` (stable2's key sort; sort3's lexsort
    starts with ``packed``) or the radix seam's kernel node.  The combine's
    table merge sorts later.  None when the step has no such sort."""
    after_read = not any(n.kind == "host_read" for n in program.nodes)
    for node in program.nodes:
        if node.kind == "host_read":
            after_read = True
            continue
        if not after_read:
            continue
        if node.kind == "op" and node.name.startswith("aten.sort") \
                and len(node.operands) == 1 \
                and node.operands[0][1] == "int64" \
                and len(node.operands[0][0]) == 1:
            return SortInfo(node.operands[0][0][0], "torch", node.location)
        if node.kind == "kernel" and node.name.startswith("radix_sort3"):
            return SortInfo(node.operands[0][0][0], node.name,
                            node.location)
    return None


def stream_rows(program) -> int | None:
    """The rows the port's stream arithmetic gives the aggregation sort,
    from the step's first declared read (``_map_kernel``'s flags:
    ``[spill, overlong, tokens, ...]``): the live rows (tokens and poison
    rows) and the one dead row after them.  None without a read."""
    if not program.flags:
        return None
    spill, overlong, tokens = program.flags[0][:3]
    return int(tokens) + int(overlong) + 1


