"""Bringing processes into one ``torch.distributed`` world, which hosts
they run on, and which bytes of a corpus a host reads.

Counterpart of :mod:`mapreduce_tpu.parallel.distributed`.  A JAX process
is a host that reaches every local chip; the port runs one process a
card, started by a launcher (``torchrun --nnodes N --nproc-per-node L``)
that exports ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``GROUP_RANK`` (the node's index), ``MASTER_ADDR``
and ``MASTER_PORT``.  A JAX host is therefore a node: the
``LOCAL_WORLD_SIZE`` ranks one machine runs.  :func:`process_index` is
``RANK // LOCAL_WORLD_SIZE`` and :func:`process_count` ``WORLD_SIZE //
LOCAL_WORLD_SIZE``; ranks are process-major, as the JAX device order is.
:func:`initialize` joins the world (a no-op for a world of one without a
launcher), so the same program runs unmodified at every size.

Two multi-host modes, as in the JAX package::

    from mapreduce_tpu_torch.parallel import distributed as dist

    device = dist.initialize("gpu")        # cuda:LOCAL_RANK over NCCL

    # (a) per-host-driven: each host runs the executor over its OWN ranks
    #     (a host-local mesh) and its own byte range, then the partial
    #     tables are merged (table_ops.merge on the host, or any transport).
    lo, hi = dist.host_byte_range(os.path.getsize(path))
    lo, hi = dist.align_range_to_separator(path, lo, hi)
    rr = executor.run_job(job, path, mesh=dist.local_data_mesh(),
                          byte_range=(lo, hi))

    # (b) one global program over every rank of every host: every process
    #     calls executor.run_job_global with the same arguments; the
    #     collective finish replicates the result, checkpoints are the
    #     coordinator's to write and every host's to resume, and each host
    #     keeps its own ledger shard.
    rr = executor.run_job_global(job, path, config=cfg, checkpoint_path=ck)
    if dist.is_coordinator():
        print(...)
    dist.shutdown()

The backend follows the device: NCCL when each rank has its own card,
gloo for CPU ranks.  A caller may ask for gloo explicitly on the card
(several ranks on one card, which NCCL refuses): the kernels still run on
the card and only the collectives' transport goes through the host.
A process group gets a timeout, and NCCL's asynchronous error handling is
on, so a rank that dies ends its peers' runs with an error instead of
leaving them blocked.

The byte-range helpers (:func:`host_byte_range`,
:func:`align_range_to_separator`, :func:`host_shards`) are pure, and
default to this process's host.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.obs import registry as obs_registry
from mapreduce_tpu_torch.parallel import mesh as mesh_mod
from mapreduce_tpu_torch.runtime.logging import get_logger, log_event
from mapreduce_tpu_torch.runtime.platform import resolve_device

#: Seconds a rank waits in a collective (and at start-up) for its peers.
DEFAULT_TIMEOUT_S = 300


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def local_device(platform: str = "gpu") -> torch.device:
    """This rank's device: the CPU for ``platform='cpu'``; without a
    launcher the card; under one card ``LOCAL_RANK`` when the host has a
    card a rank, and card 0 for every rank when it has fewer (which only a
    gloo world accepts).  Raises when there is no card: nothing falls back
    to the CPU."""
    if platform not in ("gpu", "cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}")
    dev = resolve_device("cpu" if platform == "cpu" else "cuda")
    if dev.type == "cpu" or "LOCAL_RANK" not in os.environ:
        return dev
    local = _env_int("LOCAL_RANK", 0)
    return torch.device("cuda", local if local < torch.cuda.device_count()
                        else 0)


def initialize(platform: str = "gpu", backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the launcher's world and return this rank's device.

    Without a launcher (no ``WORLD_SIZE``) nothing is initialised and the
    process is a world of one; a launcher's world of one is joined, so its
    collectives run through the backend.
    ``backend`` defaults to NCCL on the card and gloo on the CPU; gloo on
    the card is the caller's explicit choice.  NCCL needs a card a rank:
    a host with fewer cards than local ranks raises before any rank
    blocks.  The start-up's seconds land in the metrics registry
    (``distributed.init_seconds``), a failure in
    ``distributed.init_failures``."""
    device = local_device(platform)
    world = _env_int("WORLD_SIZE", 0)
    if world < 1 or dist.is_initialized():
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL carries CUDA tensors only: use gloo for "
                             "CPU ranks")
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        if torch.cuda.device_count() < local_world:
            raise RuntimeError(
                f"NCCL needs a card a rank: {local_world} local ranks, "
                f"{torch.cuda.device_count()} card(s) (gloo runs several "
                "ranks on one card)")
        # A failed or dead rank must end its peers' collectives with an
        # error, not block them until the timeout or forever.
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        torch.cuda.set_device(device)
    reg = obs_registry.get_registry()
    t0 = time.perf_counter()
    try:
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        reg.counter("distributed.init_failures").inc()
        log_event(get_logger(), "distributed initialization failed",
                  rank=os.environ.get("RANK"), backend=backend,
                  error=repr(e))
        raise
    init_s = time.perf_counter() - t0
    _stamp_epoch()
    reg.counter("distributed.inits").inc()
    reg.gauge("distributed.init_seconds").set(init_s)
    log_event(get_logger(), "distributed runtime up", rank=dist.get_rank(),
              world=dist.get_world_size(), backend=backend,
              device=str(device), init_s=round(init_s, 3))
    return device


def initialized() -> bool:
    """Has this process joined a world?"""
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    """Leave the world (a no-op when none was joined)."""
    if dist.is_initialized():
        mesh_mod._GROUPS.clear()
        mesh_mod._CONTROL.clear()
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """True on the process that owns the singleton side effects
    (checkpoint writes, the run ledger, the printed report)."""
    return not dist.is_initialized() or dist.get_rank() == 0


#: {wall, mono} sampled together when the world came up (lazily on a
#: world of one): the clock-alignment pair of the JAX package.
_RUN_EPOCH: Optional[dict] = None


def _stamp_epoch() -> dict:
    global _RUN_EPOCH
    if _RUN_EPOCH is None:
        _RUN_EPOCH = {"wall": round(time.time(), 6),
                      "mono": round(time.perf_counter(), 6)}
    return _RUN_EPOCH


def run_epoch() -> dict:
    """This process's wall-clock and monotonic seconds sampled together:
    stamped once at :func:`initialize`, lazily on first use otherwise."""
    return dict(_stamp_epoch())


def _topology() -> tuple[int, int, int]:
    """``(process_index, process_count, local ranks)`` of this process's
    world: a host is a node of ``LOCAL_WORLD_SIZE`` ranks (the whole world
    without a launcher's value).  Raises when the nodes would hold
    different numbers of ranks, or when the launcher's node rank
    (``GROUP_RANK``) disagrees with the rank's place."""
    if not dist.is_initialized():
        return 0, 1, 1
    rank, world = dist.get_rank(), dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE", world)
    if local < 1 or world % local:
        raise ValueError(
            f"a world of {world} ranks does not split into hosts of "
            f"LOCAL_WORLD_SIZE={local} ranks: every node must run the "
            "same number of ranks")
    p = rank // local
    node = os.environ.get("GROUP_RANK")
    if node not in (None, "") and int(node) != p:
        raise ValueError(
            f"rank {rank} of hosts of {local} ranks is on host {p}, but the "
            f"launcher says node {node}: ranks must be numbered node by node")
    return p, world // local, local


def process_index() -> int:
    """This process's host: its node, ``RANK // LOCAL_WORLD_SIZE``."""
    return _topology()[0]


def process_count() -> int:
    """The number of hosts: ``WORLD_SIZE // LOCAL_WORLD_SIZE``."""
    return _topology()[1]


def local_device_count() -> int:
    """The ranks (cards) of this process's host."""
    return _topology()[2]


def global_data_mesh(device=None) -> mesh_mod.DataAxis:
    """The 1-D axis over every rank of every host, in rank order
    (process-major, so a host's rows are contiguous): the world's."""
    return mesh_mod.data_mesh(device=device)


def local_data_mesh(device=None) -> mesh_mod.DataAxis:
    """The axis of this host's ranks, a subgroup of the world: what mode
    (a) runs each host's partial over.  Every rank of the world calls it
    alike (the hosts' groups are made together)."""
    _, n, local = _topology()
    if n == 1:
        return global_data_mesh(device)
    return mesh_mod.two_level_mesh(n, local, device=device).inner


def _world(process_index: Optional[int],
           process_count: Optional[int]) -> tuple[int, int]:
    """The given host index and count, each defaulting to this process's
    host and the world's hosts."""
    if process_index is None or process_count is None:
        p, n, _ = _topology()
        process_index = p if process_index is None else process_index
        process_count = n if process_count is None else process_count
    return process_index, process_count


def host_byte_range(file_size: int, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> tuple[int, int]:
    """The half-open byte range of the corpus host ``process_index`` of
    ``process_count`` (default: this process's host) ingests: an even
    split by bytes, the last host taking the remainder (see
    :func:`align_range_to_separator`)."""
    p, n = _world(process_index, process_count)
    if not 0 <= p < n:
        raise ValueError(f"process_index {p} outside [0, {n})")
    per = file_size // n
    lo = p * per
    hi = file_size if p == n - 1 else (p + 1) * per
    return lo, hi


def align_range_to_separator(path: str, lo: int, hi: int,
                             max_token_bytes: int = 1 << 16,
                             separators: bytes | None = None
                             ) -> tuple[int, int]:
    """Snap a byte range so both ends sit just after a separator byte.

    Every host applies the same rule to its own ends, so adjacent ranges
    stay adjacent: a token spanning a raw cut belongs to the host whose
    range holds its first byte.  ``max_token_bytes`` bounds the scan past
    the cut (a separator-free window keeps the raw offset, force-splitting
    the token as the reader does); ``separators`` overrides the boundary
    bytes (``b"\\n"`` keeps lines whole for grep)."""
    sep = bytes(constants.SEPARATOR_BYTES) if separators is None \
        else separators
    size = os.path.getsize(path)

    def snap(off: int) -> int:
        if off <= 0 or off >= size:
            return max(0, min(off, size))
        with open(path, "rb") as f:
            f.seek(off - 1)
            window = f.read(max_token_bytes + 1)
        if window[0] in sep:  # byte off-1 is a separator: aligned
            return off
        for i, b in enumerate(window[1:]):  # window[1+i] is byte off+i
            if b in sep:
                return off + i + 1
        return off
    return snap(lo), snap(hi)


def host_shards(n_global_shards: int, process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> Sequence[int]:
    """The global shard indices host ``process_index`` (default: this
    process's host) owns: contiguous, process-major, the order of
    :func:`global_data_mesh`."""
    p, n = _world(process_index, process_count)
    if n_global_shards % n:
        raise ValueError(
            f"{n_global_shards} shards do not divide over {n} processes")
    per = n_global_shards // n
    return range(p * per, (p + 1) * per)
