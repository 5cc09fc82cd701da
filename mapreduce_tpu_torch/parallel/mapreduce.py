"""The MapReduce engine on one device.

Counterpart of :class:`mapreduce_tpu.parallel.mapreduce.Engine` for a single
card: no mesh, no collectives.  A job supplies ``init_state``,
``map_chunk(chunk, chunk_id)`` (or the streamed ``map_chunk_sharded``),
``combine``, ``merge`` and ``finalize``; the
engine feeds it one chunk per step with ``chunk_id`` = the step index, the
JAX package's numbering on one device.  With ``data_stats`` (a telemetered
streamed run) a step also gives the chunk's data-plane statistics, as the
JAX stats-mode engine does.
"""

from __future__ import annotations

from typing import Any

import torch

from mapreduce_tpu_torch.runtime.platform import resolve_device


class Engine:
    """Runs a job over a stream of chunks on one device.

    Usage::

        eng = Engine(job)
        state = eng.init_states()
        for step, batch in enumerate(reader):   # batch: uint8[1, chunk_bytes]
            state = eng.step(state, batch, step)
        result = eng.finish(state)
    """

    n_devices = 1

    def __init__(self, job, device=None, data_stats: bool = False):
        self.job = job
        self.device = resolve_device(device)
        self.data_stats = data_stats

    def init_states(self) -> Any:
        return self.job.init_state()

    def step(self, state: Any, chunk, step_index: int) -> Any:
        """One map + combine step over ``chunk`` (uint8, ``[1, C]`` or
        ``[C]``).  A host array is copied to the device; a tensor already
        on the device is used as it is.  With ``data_stats``,
        ``(state, the chunk's ops.datastats.DataStats)``."""
        t = torch.as_tensor(chunk).reshape(-1)
        if t.dtype != torch.uint8:
            raise TypeError(f"chunks must be uint8, got {t.dtype}")
        if t.device != self.device:
            t = t.to(self.device)
        if self.data_stats:
            update, stats = self.job.map_chunk_stats(t, step_index)
            return self.job.combine(state, update), stats
        # A job whose update needs the step's other chunks (the n-gram
        # seam summaries) has the JAX package's axis-aware hook; on one
        # card its gather is a leading axis of 1.
        fn = getattr(self.job, "map_chunk_sharded", None)
        update = fn(t, step_index) if fn is not None \
            else self.job.map_chunk(t, step_index)
        return self.job.combine(state, update)

    def finish(self, state: Any) -> Any:
        """Finalize the state (one device: there is nothing to merge)."""
        return self.job.finalize(state)

    def run(self, batches) -> Any:
        """Fold an iterable of chunks and finish."""
        state = self.init_states()
        for i, batch in enumerate(batches):
            state = self.step(state, batch, i)
        return self.finish(state)
