"""The data axis and the two-level mesh: the ranks a streamed run spreads
its chunks over.

Counterpart of :mod:`mapreduce_tpu.parallel.mesh`.  A JAX run shards each
step's ``[D, chunk_bytes]`` batch over a mesh of D devices; here the D
devices are D processes of one ``torch.distributed`` world, one rank a
card (or a CPU rank in the tests).  :class:`DataAxis` names the process
group, this rank's index and the axis size, and the backend that carries
the collectives.  A process that never initialised ``torch.distributed``
is a world of one.

:func:`two_level_mesh` is the JAX package's 2-D mesh for several hosts:
``(replica, data)`` with the outer axis at the host boundary (the slow
link) and the inner axis within a host.  Ranks are process-major (a
launcher numbers one node's ranks contiguously), so rank ``r`` is
``(replica = r // L, data = r % L)``: the JAX mesh's row-major order.  A
:class:`TwoLevelMesh` is itself the flattened axis of all R·L ranks (the
world group, rank order), which the maps' per-step gathers and the
keyrange merge run over, and holds one :class:`DataAxis` a level, which
the hierarchical merges reduce innermost first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """One axis of ``size`` ranks; this process is ``rank`` on it.

    ``group`` is the process group the collectives run in (None for an
    axis of one) and ``backend`` its backend (``'nccl'`` or ``'gloo'``;
    None for a world of one).  ``device`` is where this rank's job runs.
    ``ranks`` are the world ranks of the axis's members in axis order
    (None: the identity, the world's own axis), which a point-to-point
    exchange addresses; ``name`` is the axis's mesh name, the level the
    collectives' byte counter is labelled with.
    """

    rank: int = 0
    size: int = 1
    group: Any = None
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    ranks: Optional[tuple] = None
    name: str = "data"

    @property
    def coordinator(self) -> bool:
        """Rank 0 owns the singleton side effects: the checkpoint write,
        the run ledger and the printed result."""
        return self.rank == 0

    def world_rank(self, axis_rank: int) -> int:
        """The world rank of the member at ``axis_rank`` on this axis."""
        return axis_rank if self.ranks is None else self.ranks[axis_rank]


@dataclasses.dataclass(frozen=True)
class TwoLevelMesh(DataAxis):
    """An ``(n_replicas, n_data)`` mesh of the world's ranks.

    As a :class:`DataAxis` it is the flattened mesh: ``rank`` is the
    linear rank, ``size`` R·L and ``group`` the world's.  ``outer`` is
    this rank's replica axis (the ranks of its data index, one a host)
    and ``inner`` its data axis (the ranks of its replica, one host's);
    ``axes`` lists the levels outermost first, as the JAX mesh orders
    them; each level's ``name`` is its mesh axis name."""

    outer: DataAxis = DataAxis()
    inner: DataAxis = DataAxis()

    @property
    def axes(self) -> tuple:
        return (self.outer, self.inner)


def _world() -> tuple[int, int, Optional[str]]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), \
            str(dist.get_backend())
    return 0, 1, None


def data_mesh(n_devices: Optional[int] = None, device=None) -> DataAxis:
    """The axis of the initialised ``torch.distributed`` world, or a world
    of one when it is not initialised.  ``n_devices``, when given, must be
    the world's size: a rank runs one device, so the axis cannot be a part
    of the world.  ``device`` is recorded as the ranks' device."""
    rank, size, backend = _world()
    dev = None if device is None else torch.device(device)
    axis = DataAxis(rank=rank, size=size,
                    group=dist.group.WORLD if backend else None,
                    backend=backend, device=dev)
    if n_devices is not None and n_devices != axis.size:
        raise ValueError(f"requested {n_devices} devices, the world has "
                         f"{axis.size} rank(s): start one process a device "
                         "(torchrun --nproc-per-node N)")
    return axis


#: The subgroups of each ``(R, L)`` layout of the current world, made
#: once: ``new_group`` is collective over the whole world.
_GROUPS: dict = {}


def _subgroups(n_replicas: int, n_data: int, world: int) -> tuple:
    """``(inner groups by replica, outer groups by data index)``.  Every
    rank creates every group of more than one rank, in one fixed order
    (the inner groups by replica, then the outer by data index), or the
    world would deadlock in ``new_group``; a group of the whole world is
    the world's own, and an axis of one has none."""
    key = (n_replicas, n_data)
    if key not in _GROUPS:
        def group(ranks: list):
            if len(ranks) == 1:
                return None
            if len(ranks) == world:
                return dist.group.WORLD
            return dist.new_group(ranks)

        inner = [group([i * n_data + j for j in range(n_data)])
                 for i in range(n_replicas)]
        outer = [group([i * n_data + j for i in range(n_replicas)])
                 for j in range(n_data)]
        _GROUPS[key] = (inner, outer)
    return _GROUPS[key]


def two_level_mesh(n_replicas: int, n_data: Optional[int] = None,
                   axes: tuple[str, str] = ("replica", "data"),
                   device=None) -> TwoLevelMesh:
    """A 2-D mesh for several hosts: ``axes[0]`` (outer) at the host
    boundary, ``axes[1]`` (inner) within a host; pair with
    :func:`...collectives.hierarchical_merge`, which reduces the inner
    axis first.  ``n_data`` defaults to the world's size over
    ``n_replicas``.  Every rank of the world calls it alike (it makes the
    levels' process groups).  The mesh holds every rank: a rank runs one
    device, so the mesh cannot be a part of the world."""
    rank, world, backend = _world()
    if n_data is None:
        if world % n_replicas:
            raise ValueError(
                f"{world} devices do not divide into {n_replicas} replicas")
        n_data = world // n_replicas
    need = n_replicas * n_data
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}")
    if need < world:
        raise ValueError(f"requested {need} devices, the world has {world} "
                         "rank(s): a rank runs one device, so the mesh "
                         "holds every rank")
    dev = None if device is None else torch.device(device)
    rep, dat = divmod(rank, n_data)
    if backend is None:
        inner_g, outer_g = [None], [None]
    else:
        inner_g, outer_g = _subgroups(n_replicas, n_data, world)
    inner = DataAxis(rank=dat, size=n_data, group=inner_g[rep],
                     backend=backend, device=dev,
                     ranks=tuple(rep * n_data + j for j in range(n_data)),
                     name=axes[1])
    outer = DataAxis(rank=rep, size=n_replicas, group=outer_g[dat],
                     backend=backend, device=dev,
                     ranks=tuple(i * n_data + dat
                                 for i in range(n_replicas)),
                     name=axes[0])
    return TwoLevelMesh(rank=rank, size=need,
                        group=dist.group.WORLD if backend else None,
                        backend=backend, device=dev, name="world",
                        outer=outer, inner=inner)


#: The gloo groups of control words, by member ranks, made once.
_CONTROL: dict = {}


def control_group(axis: DataAxis):
    """A gloo group over ``axis``'s ranks for the streamed run's control
    words (its start-up and step agreements): small host tensors, kept
    apart from the group that carries the job's own collectives, so an
    agreement never pairs with a map's gather and never waits on the card.
    None for an axis of one.  Every rank of the world calls it alike:
    for an axis of part of the world (a host's ranks, whose blocks are
    contiguous), every block's group is made, in rank order."""
    if axis.group is None:
        return None
    members = tuple(axis.ranks) if axis.ranks is not None \
        else tuple(range(axis.size))
    if members not in _CONTROL:
        world = dist.get_world_size()
        n = len(members)
        if world % n or members != tuple(range(members[0],
                                                members[0] + n)):
            raise ValueError(f"no control group for ranks {members}: an "
                             "axis of part of the world is a host's block")
        for lo in range(0, world, n):
            _CONTROL[tuple(range(lo, lo + n))] = dist.new_group(
                list(range(lo, lo + n)), backend="gloo")
    return _CONTROL[members]


def axes_of(mesh: DataAxis) -> tuple:
    """The levels of ``mesh`` outermost first: a two-level mesh's two
    axes, or the one axis itself."""
    return mesh.axes if isinstance(mesh, TwoLevelMesh) else (mesh,)
