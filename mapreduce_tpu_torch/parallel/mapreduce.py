"""The MapReduce engine over the data axis.

Counterpart of :class:`mapreduce_tpu.parallel.mapreduce.Engine` for one
axis of D ranks (:class:`...parallel.mesh.DataAxis`; a process outside a
``torch.distributed`` world is an axis of one).  A job supplies
``init_state``, ``map_chunk(chunk, chunk_id)`` (or the streamed
``map_chunk_sharded(chunk, chunk_id, axis, device_index)``), ``combine``,
``merge`` and ``finalize``.  Each step maps this rank's chunk with
``chunk_id = step * D + rank``, the JAX numbering on ``data_mesh(D)``;
:meth:`Engine.finish` merges the D states with the configured collective
strategy (:mod:`...parallel.collectives`) and finalizes, the same result
on every rank.  With ``data_stats`` (a telemetered streamed run) a step
also gives the chunk's data-plane statistics, as the JAX stats-mode
engine does.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.parallel import collectives
from mapreduce_tpu_torch.parallel.mesh import DataAxis, data_mesh
from mapreduce_tpu_torch.runtime.platform import resolve_device


def check_strategy(job, merge_strategy: str) -> None:
    """The JAX Engine's strategy checks, on a one-axis run."""
    if merge_strategy == "auto":
        raise ValueError(
            "merge_strategy='auto' reaches the Engine unresolved: "
            "resolution is the driver's job - pass the resolved strategy "
            "name")
    if merge_strategy.startswith("hier-"):
        raise ValueError(
            f"merge_strategy={merge_strategy!r} composes two mesh levels, "
            "which is not ported to the PyTorch package yet (ROADMAP.md "
            "item A9 (ii)); use 'tree'/'gather'/'keyrange' on one axis")
    if merge_strategy not in collectives.STRATEGIES:
        raise ValueError(f"unknown merge_strategy {merge_strategy!r}")
    if merge_strategy == "keyrange" \
            and getattr(job, "keyrange_merge", None) is None:
        raise ValueError(
            f"merge_strategy={merge_strategy!r} needs a job with a "
            "keyrange_merge hook (the CountTable wordcount family); "
            f"use 'tree'/'gather' for {type(job).__name__}")


class Engine:
    """Runs a job over a stream of chunks, one chunk a rank a step.

    Usage (on every rank)::

        eng = Engine(job, merge_strategy="tree")
        state = eng.init_states()
        for step, batch in enumerate(reader):  # batch.data: uint8[D, C]
            state = eng.step(state, batch.data[eng.rank], step)
        result = eng.finish(state)             # the same on every rank
    """

    def __init__(self, job, device=None, data_stats: bool = False,
                 axis: Optional[DataAxis] = None,
                 merge_strategy: str = "tree"):
        check_strategy(job, merge_strategy)
        self.job = job
        self.device = resolve_device(device)
        self.data_stats = data_stats
        self.axis = data_mesh() if axis is None else axis
        self.n_devices = self.axis.size
        self.rank = self.axis.rank
        self.merge_strategy = merge_strategy
        self._strategy = collectives.resolved_strategy(merge_strategy,
                                                       self.n_devices)
        if self._strategy is not None:
            collectives._count_build(self._strategy, self.n_devices)

    def init_states(self) -> Any:
        return self.job.init_state()

    def step(self, state: Any, chunk, step_index: int) -> Any:
        """One map + combine step over this rank's ``chunk`` (uint8,
        ``[1, C]`` or ``[C]``).  A host array is copied to the device; a
        tensor already on the device is used as it is.  With
        ``data_stats``, ``(state, the chunk's ops.datastats.DataStats)``."""
        t = torch.as_tensor(chunk).reshape(-1)
        if t.dtype != torch.uint8:
            raise TypeError(f"chunks must be uint8, got {t.dtype}")
        if t.device != self.device:
            t = t.to(self.device)
        chunk_id = step_index * self.n_devices + self.rank
        if self.data_stats:
            update, stats = self.job.map_chunk_stats(
                t, chunk_id, self.axis, self.rank)
            return self.job.combine(state, update), stats
        # A job whose update needs the step's other chunks (the n-gram and
        # grep seam summaries) has the axis-aware hook and gathers them.
        fn = getattr(self.job, "map_chunk_sharded", None)
        update = fn(t, chunk_id, self.axis, self.rank) if fn is not None \
            else self.job.map_chunk(t, chunk_id)
        return self.job.combine(state, update)

    def merged(self, state: Any) -> Any:
        """The D states merged with the configured strategy (the same
        value on every rank; the keyrange family gives its result shape,
        which ``finalize`` accepts)."""
        if self._strategy is None:
            return state
        if self._strategy == "keyrange":
            return self.job.keyrange_merge(state, self.axis)
        if self._strategy == "tree":
            return collectives.tree_merge(state, self.job.merge, self.axis)
        return collectives.gather_merge(state, self.job.merge, self.axis)

    def finish(self, state: Any) -> Any:
        """Collective merge + finalize; the result is the same on every
        rank."""
        return self.job.finalize(self.merged(state))

    def replicate_to_host(self, state: Any) -> list[np.ndarray]:
        """Every rank's state as a checkpoint's leaves: one uint32 array a
        leaf with a leading axis of D, rank order (one all_gather)."""
        local = convert.state_to_leaves(state)
        if self.axis.group is None:
            return local
        flat = np.concatenate([leaf.reshape(-1).astype(np.int64)
                               for leaf in local])
        dev = self.device if self.axis.backend == "nccl" \
            else torch.device("cpu")
        g = collectives.all_gather(torch.from_numpy(flat).to(dev),
                                   self.axis).cpu().numpy()
        out, pos = [], 0
        for leaf in local:
            n = leaf.size
            out.append(g[:, pos:pos + n].astype(np.uint32)
                       .reshape(self.n_devices, *leaf.shape[1:]))
            pos += n
        return out

    def run(self, batches) -> Any:
        """Fold an iterable of ``[D, C]`` batches (this rank's row of each)
        and finish."""
        state = self.init_states()
        for i, batch in enumerate(batches):
            rows = np.asarray(batch)
            state = self.step(state, rows.reshape(self.n_devices, -1)
                              [self.rank], i)
        return self.finish(state)
