"""The pinned pool a job: the ``stage_pin`` phase (the staging's new
pinned buffers, allocated as the reader first asks for them) (layer:
staging and H2D).  None where no job has the phase: a stage with no
pinned memory (the CPU's) or a program without the phase."""

PHASE = "stage_pin"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) / len(jobs) * 1e3
