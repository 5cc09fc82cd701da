"""The grep map's share of its bytes bound (layer: grep map on the
device).

The bound is fixed here, from the input, whatever implements the scan:
every corpus byte read once, at the card's HBM rate from ``peaks.json``
(stated at the full 700 W; the run's line gives the card's power limit
beside it), over the device time of every kernel of the traced jobs (a
grep job launches only its map and its emit).
"""

from portbench.trace import is_kernel


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.op_seconds(is_kernel)
    if not seconds:
        return None
    work = sum(j.bytes for j in run.traced_jobs)
    peak = run.peaks["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]
    return 100.0 * work / peak / seconds
