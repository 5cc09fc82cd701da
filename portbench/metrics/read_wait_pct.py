"""Share of a job's wall the driver waited on the reader: the
``read_wait`` phase over the jobs' host-clock walls (layer: ingest)."""


def read(run):
    jobs = run.host_jobs
    return 100.0 * sum(j.phases.get("read_wait", 0.0) for j in jobs) \
        / sum(j.end - j.start for j in jobs)
