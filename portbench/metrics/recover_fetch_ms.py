"""Recovery's reads of the card a job: the ``recover.fetch`` phase (the
table's host copies and its totals), a part of ``recover`` (layer: job
entry and host recovery).  None where no job has the phase."""

PHASE = "recover.fetch"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) / len(jobs) * 1e3
