"""The data axis: the ranks a streamed run spreads its chunks over.

Counterpart of :mod:`mapreduce_tpu.parallel.mesh` for one axis.  A JAX
run shards each step's ``[D, chunk_bytes]`` batch over a 1-D mesh of D
local devices; here the D devices are D processes of one
``torch.distributed`` world, one rank a card (or a CPU rank in the
tests).  :class:`DataAxis` names the process group, this rank's index
and the axis size, and the backend that carries the collectives.  A
process that never initialised ``torch.distributed`` is a world of one.

The two-level meshes (``two_level_mesh``) are not ported yet (ROADMAP.md
item A9 (ii)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """One axis of ``size`` ranks; this process is ``rank``.

    ``group`` is the process group the collectives run in (None for a
    world of one) and ``backend`` its backend (``'nccl'`` or ``'gloo'``;
    None for a world of one).  ``device`` is where this rank's job runs.
    """

    rank: int = 0
    size: int = 1
    group: Any = None
    backend: Optional[str] = None
    device: Optional[torch.device] = None

    @property
    def coordinator(self) -> bool:
        """Rank 0 owns the singleton side effects: the checkpoint write,
        the run ledger and the printed result."""
        return self.rank == 0


def data_mesh(n_devices: Optional[int] = None, device=None) -> DataAxis:
    """The axis of the initialised ``torch.distributed`` world, or a world
    of one when it is not initialised.  ``n_devices``, when given, must be
    the world's size: a rank runs one device, so the axis cannot be a part
    of the world.  ``device`` is recorded as the ranks' device."""
    if dist.is_available() and dist.is_initialized():
        axis = DataAxis(rank=dist.get_rank(), size=dist.get_world_size(),
                        group=dist.group.WORLD,
                        backend=str(dist.get_backend()),
                        device=None if device is None
                        else torch.device(device))
    else:
        axis = DataAxis(device=None if device is None
                        else torch.device(device))
    if n_devices is not None and n_devices != axis.size:
        raise ValueError(f"requested {n_devices} devices, the world has "
                         f"{axis.size} rank(s): start one process a device "
                         "(torchrun --nproc-per-node N)")
    return axis
