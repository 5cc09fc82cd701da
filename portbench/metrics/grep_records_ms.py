"""The records' recovery a job: the ``grep.records`` phase (the lines'
bounds from the file, their bytes and the result), inside ``recover``
(layer: job entry and host recovery).  None where no job has the
phase."""

PHASE = "grep.records"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) / len(jobs) * 1e3
