"""The step's trace points: kernel launches and declared host syncs.

Two kinds of work in a step leave no aten op a dispatch mode could see,
or leave ops that differ between the CPU and the card:

* the hand-written kernels, reached through ctypes (on the CPU their
  wrappers run the plain PyTorch version instead: dozens of aten ops);
* the host syncs the step means to make: the map's one read of its flags
  (``models/wordcount.py:_read_flags``; ``.tolist()`` reaches no aten op
  on the CPU and an ``aten._to_copy`` on the card) and the pageable copies
  of host scalars to the device (``ops/table.py``).

Each goes through one function here, which the static analysis's recorder
(:mod:`...analysis.trace`) logs as ONE node: :func:`kernel_scope` around a
kernel wrapper's launch (or its plain version), :func:`host_read` and
:func:`host_scalars` for the syncs.  With no recorder active
(:data:`RECORDER` is None, always outside the analysis) each is one branch
and then exactly the call it replaces, and each sync adds one to the
process registry's ``executor.host_syncs{site=flags|scalars|emit}`` (the
streamed loop counts the steps it runs as ``executor.chunks``, so the two
give the syncs a chunk).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from mapreduce_tpu_torch.obs import registry as obs_registry

#: The active recorder (``analysis.trace.Recorder``), or None.
RECORDER = None

#: How the declared host reads are made (see :func:`host_read_by`); None is
#: a blocking ``tolist``.
_HOST_READ: contextvars.ContextVar = contextvars.ContextVar("host_read",
                                                           default=None)

#: ``site -> (registry generation, executor.host_syncs counter)``: looked
#: up once, and again only after the registry's reset.
_SYNCS: dict = {}


def _count_sync(site: str) -> None:
    reg = obs_registry.get_registry()
    held = _SYNCS.get(site)
    if held is None or held[0] != reg.generation:
        held = _SYNCS[site] = (reg.generation,
                               reg.counter("executor.host_syncs", site=site))
    held[1].inc()


class _Idle:
    """The scope a kernel wrapper enters when nothing records."""

    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def result(self, out):
        return out


_IDLE = _Idle()


def kernel_scope(name: str, plan, *operands):
    """The scope of one kernel wrapper's launch: ``with kernel_scope(name,
    plan, *operands) as k: ...; return k.result(out)``.  ``plan`` is a
    callable giving the launch's :class:`...ops.cuda.plans.KernelPlan`
    (built only when recorded).  Inside an active recorder the ops the
    wrapper issues (the plain version's, or the kernel's allocations) are
    not logged: the node stands for them."""
    rec = RECORDER
    if rec is None:
        return _IDLE
    return rec.kernel_scope(name, plan, operands)


@contextlib.contextmanager
def host_read_by(read):
    """Within, a step's declared host read is ``read(flags)`` (a list)
    instead of a blocking ``flags.tolist()``.  On the card that read waits
    for every kernel queued before it, a hung one included: the streamed
    driver puts it under its completion deadline this way."""
    token = _HOST_READ.set(read)
    try:
        yield
    finally:
        _HOST_READ.reset(token)


def host_read(flags: torch.Tensor, read=None, site: str = "flags") -> list:
    """The step's declared device-to-host read: ``flags`` as a list, by
    ``read(flags)`` when given, else by the reader :func:`host_read_by`
    set (the streamed driver's deadline reader), else a blocking
    ``tolist``.  ``site`` names it in the registry: the word count's
    flags, or grep's ``emit`` (the records mode's count)."""
    if read is None:
        read = _HOST_READ.get()
    rec = RECORDER
    if rec is None:
        _count_sync(site)
        return flags.tolist() if read is None else read(flags)
    return rec.host_read(flags, read)


def host_scalars(values, device) -> torch.Tensor:
    """The step's declared host-to-device copy: the host ints ``values``
    (an int or a list) as an int64 tensor on ``device``.  On the card a
    pageable copy, which waits for the host."""
    rec = RECORDER
    if rec is None:
        _count_sync("scalars")
        return torch.tensor(values, dtype=torch.int64, device=device)
    return rec.host_copy(values, device)
