"""Recovery's assembly a job: the ``recover.assemble`` phase (the count
list, distinct, top-k, sketches and the result), a part of ``recover``
(layer: job entry and host recovery).  None where no job has the
phase."""

PHASE = "recover.assemble"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) / len(jobs) * 1e3
