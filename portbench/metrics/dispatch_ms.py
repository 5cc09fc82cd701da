"""Host time dispatching a chunk: the streamed driver's ``dispatch`` phase
(the map's launches and its one flags read) over the chunks (layer:
streamed driver)."""


def read(run):
    jobs = run.host_jobs
    return sum(j.phases.get("dispatch", 0.0) for j in jobs) \
        / sum(j.chunks for j in jobs) * 1e3
