"""Profiler hooks: a Chrome trace of a run.

Counterpart of :mod:`mapreduce_tpu.runtime.profiling`.  :func:`trace`
runs ``torch.profiler.profile`` around a block, with CPU activity and, on
a machine with a card, CUDA activity, and writes one Chrome trace
(``trace-<pid>.json``, readable in Perfetto) into a directory, also when
the block raises.  The
executor's phase spans (:func:`...obs.spans.span`, the one way to mark a
region) are ``record_function`` regions, so the trace shows
``read_wait``, ``stage``, ``dispatch``, ``host_read`` and ``retire_wait``
beside the kernels they launch or wait for.

Usage::

    with profiling.trace("/tmp/trace"):     # no-op when the path is falsy
        with span("step"):
            state = engine.step(state, chunk, step)

There is no compile cache to enable: the port's kernel builds are cached
by source hash (``ops/cuda/_build.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(path: Optional[str]) -> Iterator[None]:
    """Profile the block and export its Chrome trace into the directory
    ``path`` (created if needed).  A falsy path is a no-op, so call sites
    pass the flag through."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:  # a run that failed leaves its trace too
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(path, f"trace-{os.getpid()}.json"))

