"""Host string recovery a job: the ``recover`` phase of ``count_file``'s
``RunResult.metrics.phases`` (layer: job entry and host recovery)."""


def read(run):
    jobs = run.host_jobs
    return sum(j.phases.get("recover", 0.0) for j in jobs) / len(jobs) * 1e3
