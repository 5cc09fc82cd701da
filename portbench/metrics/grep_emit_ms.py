"""The records emit a chunk: the ``grep.emit`` phase (the count's host
read, the compaction of the matching lines' positions and their copy to
the host) over the chunks (layer: grep map on the device).  None where no
job has the phase."""

PHASE = "grep.emit"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) \
        / sum(j.chunks for j in jobs) * 1e3
