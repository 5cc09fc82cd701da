"""The comparison that decides ``correct``.

Each job's result is held to the plain reference's answer by the
reference's own ``readings`` and ``LIMITS`` (``reference/<job>.py``);
a number over its limit makes the job failed.  The line reports each
number's worst over the jobs compared.
"""

from __future__ import annotations


def judge(results: list, ref, exp) -> dict:
    """Every result against the reference module ``ref``'s answer ``exp``:
    ``{"failed": jobs outside a limit, "checks": {name: {"value": worst,
    "limit": limit}}}``."""
    limits = ref.LIMITS
    worst = dict.fromkeys(limits, 0)
    failed = 0
    for result in results:
        r = ref.readings(result, exp)
        failed += any(r[k] > limits[k] for k in limits)
        for k in limits:
            worst[k] = max(worst[k], r[k])
    return {"failed": failed,
            "checks": {k: {"value": worst[k], "limit": limits[k]}
                       for k in limits}}
