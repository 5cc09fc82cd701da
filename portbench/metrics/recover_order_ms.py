"""Recovery's ordering a job: the ``recover.order`` phase (valid rows and
their offsets, the seam scan, the file-order ``argsort`` and the span
list), a part of ``recover`` (layer: job entry and host recovery).  None
where no job has the phase."""

PHASE = "recover.order"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) / len(jobs) * 1e3
