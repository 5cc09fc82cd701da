"""Host time in the overlong rescue a chunk: the ``rescue`` phase (the
rescue's table and its merge, inside ``dispatch``) over the chunks
(layer: streamed driver).  None where no job has the phase."""

PHASE = "rescue"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) \
        / sum(j.chunks for j in jobs) * 1e3
