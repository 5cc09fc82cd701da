"""Span-based tracing: one context manager times a phase and marks it in
the profiler.

Counterpart of :mod:`mapreduce_tpu.obs.spans`.  A :func:`span` adds the
section's wall-clock to a :class:`...runtime.metrics.PhaseTimer` and opens
a ``torch.profiler.record_function`` of the same name, so a profile of a
streamed run shows ``read_wait``, ``stage``, ``dispatch`` and
``retire_wait`` beside the kernels they wait for or launch.  With no
profiler running, ``record_function`` costs a few microseconds.

Code below the executor (a job's map) opens its spans without a timer;
inside :func:`timing_into` they add to the run's timer.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator

import torch

_ambient: contextvars.ContextVar = contextvars.ContextVar("phase_timer",
                                                          default=None)


@contextlib.contextmanager
def timing_into(timer) -> Iterator[None]:
    """Spans opened without a timer in this context add to ``timer``."""
    token = _ambient.set(timer)
    try:
        yield
    finally:
        _ambient.reset(token)


@contextlib.contextmanager
def span(name: str, timer=None) -> Iterator[None]:
    """Time a section as ``name`` into ``timer`` (default: the one of the
    enclosing :func:`timing_into`, if any) and mark it on the profiler
    timeline."""
    if timer is None:
        timer = _ambient.get()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if timer is not None:
            timer.phases[name] = timer.phases.get(name, 0.0) \
                + time.perf_counter() - t0
