"""Kernel time a chunk: every device kernel in the profiler's window over
the traced chunks (layer: map step on the device)."""

from portbench.trace import is_kernel


def read(run):
    if run.trace is None:
        return None
    chunks = sum(j.chunks for j in run.traced_jobs)
    return run.trace.op_seconds(is_kernel) / chunks * 1e3
