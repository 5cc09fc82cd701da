"""The MapReduce engine over the data axis or a two-level mesh.

Counterpart of :class:`mapreduce_tpu.parallel.mapreduce.Engine` over a
mesh of one axis of D ranks (:class:`...parallel.mesh.DataAxis`; a
process outside a ``torch.distributed`` world is an axis of one) or two
(:class:`...parallel.mesh.TwoLevelMesh`, R·L ranks).  A job supplies
``init_state``, ``map_chunk(chunk, chunk_id)`` (or the streamed
``map_chunk_sharded(chunk, chunk_id, axis, device_index)``), ``combine``,
``merge`` and ``finalize``.  Each step maps this rank's chunk with
``chunk_id = step * D + linear_rank`` (row-major over the mesh's axes),
the JAX numbering; the maps' gathers run over the flattened mesh, the
world in rank order.  :meth:`Engine.finish` merges the D states with the
configured collective strategy (:mod:`...parallel.collectives`) and
finalizes, the same result on every rank.  On a two-level mesh every
per-axis strategy (tree and gather) merges level by level, innermost
first, as the JAX Engine does, which decides the operand order of the
jobs that keep one operand's coordination leaves (grep's line carry, the
n-gram seam carry); keyrange flattens the mesh into one round.  The
window-boundary overlap (``Config.merge_overlap``) merges the local
states into a replicated accumulator as it goes
(:meth:`Engine.partial_merge`, :meth:`Engine.partial_reset`) and ends
with :meth:`Engine.finish_residual`.  With
``data_stats`` (a telemetered streamed run) a step also gives the chunk's
data-plane statistics, as the JAX stats-mode engine does.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.parallel import collectives
from mapreduce_tpu_torch.parallel.mesh import DataAxis, axes_of, data_mesh
from mapreduce_tpu_torch.runtime.platform import resolve_device


def check_strategy(job, merge_strategy: str, n_axes: int = 1) -> None:
    """The JAX Engine's strategy checks, on a mesh of ``n_axes`` axes."""
    if merge_strategy == "auto":
        raise ValueError(
            "merge_strategy='auto' reaches the Engine unresolved: "
            "resolution is the driver's job - pass the resolved strategy "
            "name")
    if merge_strategy not in collectives.STRATEGIES:
        raise ValueError(f"unknown merge_strategy {merge_strategy!r}")
    if merge_strategy in ("keyrange", "hier-kr-tree") \
            and getattr(job, "keyrange_merge", None) is None:
        raise ValueError(
            f"merge_strategy={merge_strategy!r} needs a job with a "
            "keyrange_merge hook (the CountTable wordcount family); "
            f"use 'tree'/'gather' for {type(job).__name__}")
    if merge_strategy.startswith("hier-") and n_axes < 2:
        raise ValueError(
            f"merge_strategy={merge_strategy!r} composes two mesh "
            "levels; the mesh has one axis ('data') - use "
            "'tree'/'gather'/'keyrange' on single-axis meshes")


class Engine:
    """Runs a job over a stream of chunks, one chunk a rank a step.

    Usage (on every rank)::

        eng = Engine(job, merge_strategy="tree")
        state = eng.init_states()
        for step, batch in enumerate(reader):  # batch.data: uint8[D, C]
            state = eng.step(state, batch.data[eng.rank], step)
        result = eng.finish(state)             # the same on every rank

    ``mesh`` is a :class:`DataAxis` or a two-level mesh (default: the
    world's axis); ``axis`` is the flattened mesh the maps gather over.
    """

    def __init__(self, job, device=None, data_stats: bool = False,
                 mesh: Optional[DataAxis] = None,
                 merge_strategy: str = "tree"):
        self.axis = data_mesh() if mesh is None else mesh
        self.axes = axes_of(self.axis)
        check_strategy(job, merge_strategy, len(self.axes))
        self.job = job
        self.device = resolve_device(device)
        self.data_stats = data_stats
        self.n_devices = self.axis.size
        self.rank = self.axis.rank
        self.merge_strategy = merge_strategy
        self._kr_family = merge_strategy in ("keyrange", "hier-kr-tree")
        self._result_merge = getattr(job, "keyrange_result_merge", None) \
            if self._kr_family else None
        if self._kr_family and self._result_merge is None:
            self._result_merge = job.merge
        if len(self.axes) > 1:
            self._strategy = merge_strategy
        else:
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
        job, s = self.job, self._strategy
        if s is None:
            # Keyrange on one rank merges nothing, but gives the result
            # shape all the same (the n-gram job's is its table alone).
            return job.keyrange_merge(state, self.axis) if self._kr_family \
                else state
        if s == "keyrange":
            return job.keyrange_merge(state, self.axis)
        if s == "hier-kr-tree":
            return collectives.hier_kr_tree_merge(
                state, job.keyrange_merge, self._result_merge, self.axes)
        if len(self.axes) > 1:
            return collectives.hierarchical_merge(state, job.merge,
                                                  self.axes, strategy=s)
        if s == "tree":
            return collectives.tree_merge(state, job.merge, self.axis)
        return collectives.gather_merge(state, job.merge, self.axis)

    def finish(self, state: Any) -> Any:
        """Collective merge + finalize; the result is the same on every
        rank."""
        return self.job.finalize(self.merged(state))

    def _fold_merged(self, latest: Any, accum: Any) -> Any:
        """Fold the latest merged window into the accumulator: the result
        merge for the keyrange family, the job's merge otherwise.  The
        latest value is operand ``a``, as in the JAX Engine: the jobs that
        keep one operand's coordination leaves (grep's line carry, the
        n-gram seam carry) keep its, the stream-end value a monolithic
        finish would report."""
        return self._result_merge(latest, accum) if self._kr_family \
            else self.job.merge(latest, accum)

    def partial_merge(self, accum: Any, state: Any) -> Any:
        """The window-boundary partial merge: the local states merged with
        the configured strategy, folded into ``accum`` (None for the
        first window).  The new accumulator is the same on every rank."""
        latest = self.merged(state)
        return latest if accum is None else self._fold_merged(latest, accum)

    def finish_residual(self, accum: Any, state: Any) -> Any:
        """The stream's end under overlap: merge the residual states, fold
        ``accum`` in and finalize; with ``accum=None`` exactly
        :meth:`finish`."""
        if accum is None:
            return self.finish(state)
        return self.job.finalize(self._fold_merged(self.merged(state),
                                                   accum))

    def partial_reset(self, state: Any) -> Any:
        """The local state after a partial merge shipped it: the job's
        initial state, or its ``partial_reset`` hook's, which keeps the
        cross-step context (the n-gram seam carry, grep's line carry)."""
        hook = getattr(self.job, "partial_reset", None)
        return hook(state) if hook is not None else self.job.init_state()

    def accum_template(self) -> Any:
        """A state of the accumulator's structure and shapes (a snapshot's
        template): the initial state, or for the keyrange family its
        result shape, computed on an axis of one (no collective)."""
        init = self.job.init_state()
        if not self._kr_family:
            return init
        return self.job.keyrange_merge(init, DataAxis(device=self.device))

    def replicate_to_host(self, state: Any) -> list[np.ndarray]:
        """Every rank's state as a checkpoint's leaves: one uint32 array a
        leaf with a leading axis of D, in the flattened mesh's rank order
        (row-major over two levels; one all_gather)."""
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
