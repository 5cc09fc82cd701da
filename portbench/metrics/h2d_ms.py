"""Host-to-device copy time a chunk: the profiler's ``Memcpy HtoD`` device
time over the traced chunks (layer: staging and H2D)."""


def read(run):
    if run.trace is None:
        return None
    chunks = sum(j.chunks for j in run.traced_jobs)
    s = run.trace.op_seconds(lambda name: name.startswith("Memcpy HtoD"))
    return s / chunks * 1e3 if s else None
