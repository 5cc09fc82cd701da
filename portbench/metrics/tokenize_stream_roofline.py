"""``tokenize_stream``'s share of its bytes bound (layer: tokenize kernel).

The bound is fixed here, from the input, whatever implements the kernel:
every corpus byte read once, and one output row a token written once at
``ROW_BYTES`` (the dense stream's three int64 planes: key_hi, key_lo,
packed), over the card's HBM rate from ``peaks.json`` (stated at the full
700 W; the run's line gives the card's power limit beside it).  The
tokens are the reference's count of the input.
"""

ROW_BYTES = 24
KERNEL = "tokenize_stream"


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.op_seconds(lambda name: KERNEL in name)
    if not seconds:
        return None
    jobs = run.traced_jobs
    work = sum(j.bytes for j in jobs) \
        + ROW_BYTES * run.expected.total * len(jobs)
    peak = run.peaks["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]
    return 100.0 * work / peak / seconds
