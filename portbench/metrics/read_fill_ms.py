"""The reader's fill a chunk: the ``read_fill`` phase (the native
chunker's pass over the memmap, timed on the reader thread and carried by
each batch) over the chunks (layer: ingest).  None where no job has the
phase."""

PHASE = "read_fill"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) \
        / sum(j.chunks for j in jobs) * 1e3
