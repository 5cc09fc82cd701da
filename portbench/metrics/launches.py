"""Device kernels a chunk: kernels in the profiler's window over the
chunks of its jobs (layer: streamed driver).  A count: it repeats exactly
for one input."""

from portbench.trace import is_kernel


def read(run):
    if run.trace is None:
        return None
    chunks = sum(j.chunks for j in run.traced_jobs)
    return run.trace.op_count(is_kernel) / chunks
