"""Collective reductions of job states over the data axis or a
two-level mesh.

Counterpart of :mod:`mapreduce_tpu.parallel.collectives` over axes of
``torch.distributed`` ranks (:class:`...parallel.mesh.DataAxis`), in the
JAX package's three single-axis strategies and its two-level
compositions:

* :func:`tree_merge` -- the butterfly: log2(D) rounds, each exchanging
  the whole state with partner ``rank ^ bit`` and computing
  ``merge(state, partner)``; an axis that is not a power of two takes
  :func:`gather_merge`, as in the JAX package;
* :func:`gather_merge` -- every state gathered, folded left in rank order;
* :func:`key_range_merge` -- the count table's reduce-scatter by
  ``key_lo % D``: one ``all_to_all`` of fixed ``[D, B]`` blocks, an owner
  build at capacity B, one ``all_gather`` of the reduced blocks and a
  final build at capacity C (exactness: the JAX docstring);
* :func:`hierarchical_merge` -- tree or gather level by level over a
  :class:`...parallel.mesh.TwoLevelMesh`, innermost (within a host)
  first, so the outer level (across hosts) moves one merged state a host;
  :func:`hier_tree_tree_merge` is its named tree form and
  :func:`hier_kr_tree_merge` runs the job's keyrange hook on the inner
  axis, then a tree over the outer axis on the result shape.

:func:`psum` and :func:`psum64` sum additive leaves (the 64-bit totals
exactly).  Every result is the same on every rank, and equals the JAX
function's on ``data_mesh(D)``: operands keep the JAX order, which
matters for the jobs whose merge keeps operand ``a``'s coordination
leaves (grep's line carry, the n-gram seam carry).

Transport.  A state travels as one int64 vector (:func:`_pack`).  NCCL
moves CUDA tensors; a gloo world moves CPU tensors, so a gloo rank whose
job runs on the card copies through the host around each collective (the
kernels stay on the card).  Each call adds the bytes this rank sends to
the registry counter ``collectives.bytes_sent`` (labels ``op`` and
``level``, the axis's mesh name: ``data``, ``replica``, or ``world`` for
the flattened mesh), and each
Engine build counts ``collectives.builds`` (``strategy``, ``axis_size``)
as the JAX package does at trace time.
"""

from __future__ import annotations

from typing import Callable, Optional, TypeVar

import torch
import torch.distributed as dist

from mapreduce_tpu_torch.obs import registry as obs_registry
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.parallel.mesh import DataAxis

T = TypeVar("T")
MergeFn = Callable[[T, T], T]

#: The merge strategies, the JAX package's names, builders and flags.
STRATEGIES: dict[str, dict] = {
    "tree": {
        "builder": f"{__name__}.tree_merge",
        "power_of_two_only": True,  # other axis sizes take gather
        "needs_keyrange_hook": False,
        "per_axis": True,  # hierarchical_merge runs it innermost first
    },
    "gather": {
        "builder": f"{__name__}.gather_merge",
        "power_of_two_only": False,
        "needs_keyrange_hook": False,
        "per_axis": True,
    },
    "keyrange": {
        "builder": f"{__name__}.key_range_merge",
        "power_of_two_only": False,
        "needs_keyrange_hook": True,  # the Engine requires job.keyrange_merge
        "per_axis": False,  # one collective over the flattened mesh
    },
    "hier-kr-tree": {
        "builder": f"{__name__}.hier_kr_tree_merge",
        "power_of_two_only": True,  # the outer tree legs (gather otherwise)
        "needs_keyrange_hook": True,  # the inner leg is the job's hook
        "per_axis": False,  # keyrange inner, tree outer
    },
    "hier-tree-tree": {
        "builder": f"{__name__}.hier_tree_tree_merge",
        "power_of_two_only": True,
        "needs_keyrange_hook": False,
        "per_axis": False,  # the named two-level composition
    },
}


def _count_build(strategy: str, axis_size: int) -> None:
    """One Engine's collective strategy and axis width, into the registry
    (the JAX package counts each at trace time, once per program)."""
    obs_registry.get_registry().counter(
        "collectives.builds", strategy=strategy, axis_size=axis_size).inc()


def resolved_strategy(strategy: str, axis_size: int) -> Optional[str]:
    """The strategy that runs: ``tree`` on an axis that is not a power of
    two is ``gather``; keyrange on one rank runs nothing (None)."""
    if strategy == "tree" and axis_size & (axis_size - 1):
        return "gather"
    if strategy == "keyrange" and axis_size == 1:
        return None
    return strategy


def _sent(op: str, nbytes: int, axis: DataAxis) -> None:
    obs_registry.get_registry().counter(
        "collectives.bytes_sent", op=op, level=axis.name).inc(nbytes)


def _wire(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """``x`` as the backend carries it: gloo moves CPU tensors."""
    x = x.contiguous()
    return x.cpu() if axis.backend == "gloo" and x.is_cuda else x


def all_gather(x: torch.Tensor, axis: Optional[DataAxis]) -> torch.Tensor:
    """``[D, *x.shape]``: every rank's ``x`` in rank order, on ``x``'s
    device.  Without a process group (a world of one) ``x[None]``."""
    if axis is None or axis.group is None:
        return x[None]
    w = _wire(x.reshape(-1), axis)
    out = [torch.empty_like(w) for _ in range(axis.size)]
    dist.all_gather(out, w, group=axis.group)
    _sent("all_gather", (axis.size - 1) * w.numel() * w.element_size(), axis)
    return torch.stack(out).to(x.device).reshape(axis.size, *x.shape)


def all_to_all(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """Block ``j`` of ``x`` (``[D, ...]``) goes to rank ``j``; row ``s`` of
    the result is the block rank ``s`` sent here."""
    w = _wire(x, axis)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=axis.group)
    _sent("all_to_all", (axis.size - 1) * w[0].numel() * w.element_size(),
          axis)
    return out.to(x.device)


def exchange(x: torch.Tensor, axis: DataAxis, partner: int) -> torch.Tensor:
    """Send ``x`` to the axis's member ``partner`` and receive its tensor
    of the same shape: one round of the butterfly.  A point-to-point op
    addresses its peer by world rank, in a subgroup too."""
    w = _wire(x, axis)
    buf = torch.empty_like(w)
    peer = axis.world_rank(partner)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, w, peer, axis.group),
        dist.P2POp(dist.irecv, buf, peer, axis.group)])
    for r in reqs:
        r.wait()
    _sent("exchange", w.numel() * w.element_size(), axis)
    return buf.to(x.device)


def _leaves(state) -> list:
    if isinstance(state, tuple):
        return [leaf for x in state for leaf in _leaves(x)]
    return [state]


def _pack(state) -> torch.Tensor:
    """A state's tensor leaves as one int64 vector (the JAX pytree's
    flatten order)."""
    return torch.cat([leaf.reshape(-1).to(torch.int64)
                      for leaf in _leaves(state)
                      if isinstance(leaf, torch.Tensor)])


def _unpack(flat: torch.Tensor, like):
    """The state of ``like``'s structure whose tensor leaves ``flat``
    holds (:func:`_pack`'s inverse).  A host leaf (a batched sketch's
    combine cursor) is ``like``'s own: every rank runs the same combines,
    so it is the same on every rank."""
    pos = 0

    def build(t):
        nonlocal pos
        if isinstance(t, tuple):
            parts = [build(x) for x in t]
            return type(t)(*parts) if hasattr(t, "_fields") \
                else type(t)(parts)
        if not isinstance(t, torch.Tensor):
            return t
        n = t.numel()
        out = flat[pos:pos + n].reshape(t.shape).to(t.dtype)
        pos += n
        return out

    return build(like)


def tree_merge(state: T, merge: MergeFn, axis: DataAxis) -> T:
    """Butterfly all-reduce: after log2(D) rounds every rank holds the
    merge of all D states, as ``merge(own, partner)`` each round.  An axis
    that is not a power of two takes :func:`gather_merge`."""
    n = axis.size
    if n & (n - 1):
        return gather_merge(state, merge, axis)
    for r in range(n.bit_length() - 1):
        partner = _unpack(exchange(_pack(state), axis, axis.rank ^ (1 << r)),
                          state)
        state = merge(state, partner)
    return state


def gather_merge(state: T, merge: MergeFn, axis: DataAxis) -> T:
    """Gather every state, then fold left in rank order."""
    gathered = all_gather(_pack(state), axis)
    acc = _unpack(gathered[0], state)
    for i in range(1, gathered.shape[0]):
        acc = merge(acc, _unpack(gathered[i], state))
    return acc


def psum(state: T, axis: DataAxis) -> T:
    """Additive all-reduce of a state's tensor leaves."""
    if axis.group is None:
        return state
    flat = _pack(state)
    w = _wire(flat, axis)
    dist.all_reduce(w, group=axis.group)
    _sent("all_reduce", (axis.size - 1) * w.numel() * w.element_size(),
          axis)
    return _unpack(w.to(flat.device), state)


def psum64(lo: torch.Tensor, hi: torch.Tensor, axis: Optional[DataAxis]):
    """Exact 64-bit sum over the axis of ``(lo, hi)`` uint32 lane-pair
    scalars: the D values gathered (a few bytes) and summed."""
    g = all_gather(table_ops._join64(lo, hi).reshape(()), axis)
    return table_ops.sum64(g)


def _block_budget(cap: int, d: int, slack: float) -> int:
    """B: a destination block's rows (the JAX package's formula)."""
    return min(cap, -(-int(slack * cap) // d) + 8 + 4 * (d - 1).bit_length())


def key_range_merge(table: table_ops.CountTable, axis: DataAxis,
                    slack: float = 2.0) -> table_ops.CountTable:
    """Key-range reduce of every rank's table: each row goes to its owner
    ``key_lo % D`` in one all_to_all of fixed ``[D, B]`` blocks, owners
    reduce at capacity B, and one all_gather of the reduced blocks feeds a
    final build at capacity C.  A partition past its budget B spills its
    largest keys, accounted in ``dropped_*`` (such a key is evicted
    everywhere, never reported with a partial count; the JAX docstring
    gives the argument).  Bit-identical to the tree merge when nothing
    spills."""
    d = axis.size
    cap = table.capacity
    if d == 1:
        return table
    b = _block_budget(cap, d, slack)
    dev = table.key_hi.device

    # 1. Pack: rows sorted by (owner, key); dead rows get owner D (last,
    #    never sent).  Keys are unique within a table: a total order.
    owner = torch.where(table.occupied(), table.key_lo % d, d)
    order = table_ops._lexsort(owner, table_ops._key64(table.key_hi,
                                                       table.key_lo))
    own_s = owner[order]
    planes = [x[order] for x in (table.key_hi, table.key_lo, table.pos_hi,
                                 table.pos_lo, table.count, table.count_hi,
                                 table.length)]
    heads = table_ops._segment_heads(own_s, d)  # first row with owner >= q

    # Destination slot t of block j holds partition j's rank-t row.
    slot = torch.arange(d * b, dtype=torch.int64, device=dev)
    j, r = slot // b, slot % b
    src = heads[j] + r
    valid = src < heads[j + 1]
    srcc = src.clamp(max=cap - 1)
    fills = (table_ops.SENT, table_ops.SENT, table_ops.INF, table_ops.INF,
             0, 0, 0)
    sent = torch.stack([torch.where(valid, p[srcc], f)
                        for p, f in zip(planes, fills)])  # [7, d*b]

    # Budget spill: rank within the partition >= B (its largest keys).
    rank = torch.arange(cap, dtype=torch.int64, device=dev) \
        - heads[own_s.clamp(max=d)]
    spilled = (own_s < d) & (rank >= b)
    sp_u = spilled.sum()
    sp_c = torch.where(spilled,
                       table_ops._join64(planes[4], planes[5]), 0).sum()

    # 2. Exchange: block j goes to rank j, block s comes from rank s.
    recv = all_to_all(sent.reshape(7, d, b).transpose(0, 1).contiguous(),
                      axis)  # [d, 7, b]
    recv = recv.transpose(0, 1).reshape(7, d * b)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    # 3. Owner reduce: every rank's rows of my partition -> capacity B.
    mine = table_ops._build(*recv, b, zero, zero, zero, zero)

    # 4. Replicate: gather the reduced blocks, final reduce to C; the
    #    dropped totals (carried, spilled, owner-evicted) summed exactly.
    du = table_ops._join64(table.dropped_uniques, table.dropped_uniques_hi) \
        + sp_u + table_ops._join64(mine.dropped_uniques,
                                   mine.dropped_uniques_hi)
    dc = table_ops._join64(table.dropped_count, table.dropped_count_hi) \
        + sp_c + table_ops._join64(mine.dropped_count, mine.dropped_count_hi)
    ag = all_gather(torch.cat([torch.stack(
        [mine.key_hi, mine.key_lo, mine.pos_hi, mine.pos_lo, mine.count,
         mine.count_hi, mine.length]).reshape(-1),
        torch.stack([du, dc])]), axis)  # [d, 7*b + 2]
    blocks = ag[:, :7 * b].reshape(d, 7, b).transpose(0, 1).reshape(7, d * b)
    gdu_lo, gdu_hi = table_ops.sum64(ag[:, 7 * b])
    gdc_lo, gdc_hi = table_ops.sum64(ag[:, 7 * b + 1])
    return table_ops._build(*blocks, cap, gdu_lo, gdu_hi, gdc_lo, gdc_hi)


def hierarchical_merge(state: T, merge: MergeFn, axes: tuple,
                       strategy: str = "tree") -> T:
    """Level-by-level merge over a mesh's ``axes`` (outermost first, as
    the mesh is built), innermost axis first: within a host, then across
    hosts, so the slow link moves one merged state a host.  Each level
    runs :func:`tree_merge` or :func:`gather_merge`, in the JAX operand
    order."""
    if strategy == "hier-tree-tree":
        strategy = "tree"
    if strategy not in ("tree", "gather"):
        raise ValueError(f"unknown strategy {strategy!r}")
    fn = tree_merge if strategy == "tree" else gather_merge
    for axis in reversed(axes):
        state = fn(state, merge, axis)
    return state


def hier_tree_tree_merge(state: T, merge: MergeFn, axes: tuple) -> T:
    """The named two-level tree (``hier-tree-tree``): exactly
    :func:`hierarchical_merge` with ``strategy='tree'``."""
    return hierarchical_merge(state, merge, axes, strategy="tree")


def hier_kr_tree_merge(state: T, keyrange_fn, result_merge: MergeFn,
                       axes: tuple) -> T:
    """The placed two-level reduction (``hier-kr-tree``): the job's
    keyrange hook ``keyrange_fn(state, axis)`` on the innermost axis (one
    host's ranks), then a tree over the outer axes on the hook's result
    shape with ``result_merge`` (the job's ``keyrange_result_merge``)."""
    if len(axes) < 2:
        raise ValueError(
            f"hier-kr-tree composes two mesh levels; got {len(axes)} axis")
    merged = keyrange_fn(state, axes[-1])
    for axis in reversed(axes[:-1]):
        merged = tree_merge(merged, result_merge, axis)
    return merged
