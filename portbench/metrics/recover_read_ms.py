"""Recovery's reads of the words' bytes a job: the ``recover.read`` phase
(``read_words_at_multi``), a part of ``recover`` (layer: job entry and
host recovery).  None where no job has the phase."""

PHASE = "recover.read"


def read(run):
    jobs = run.host_jobs
    if not any(PHASE in j.phases for j in jobs):
        return None
    return sum(j.phases.get(PHASE, 0.0) for j in jobs) / len(jobs) * 1e3
