"""One client in a closed loop: a job starts when the last one's recovered
result is back."""

import time


def window(timed, seconds: float, traffic: dict, traced) -> list:
    jobs = []
    t0 = time.perf_counter()
    if traced is not None:
        with traced:
            while not traced.enough(jobs):
                jobs.append(timed(True))
    while not jobs or jobs[-1].end - t0 < seconds:
        jobs.append(timed(False))
    return jobs
