"""What the traced run reads from the profiler.

:func:`summarize` reduces the profiler's events over one traced window to
a :class:`Trace`: every device operation (kernel, copy, set) with its
time, the seconds in which any ran (``busy_s``), and the device's idle
time split by the innermost host region open during it.  Host regions are
``record_function`` annotations: the executor's phase spans (``dispatch``,
``read_wait``, ``recover`` and the rest, ``runtime/profiling.py``) and the
benchmark's own ``job`` around each job.
"""

from __future__ import annotations

import collections
import dataclasses

#: The benchmark's region around the traced jobs: the traced window.
WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list  # (name, seconds) of every device operation in the window
    idle_by_region: dict  # innermost open host region -> idle seconds

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(s for name, s in self.ops if match(name))

    def op_count(self, match) -> int:
        return sum(1 for name, _ in self.ops if match(name))

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict = collections.defaultdict(float)
        for name, s in self.ops:
            by_name[name] += s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_region.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:96], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summarize(events) -> Trace:
    """``events``: the profiler's kineto events
    (``prof.profiler.kineto_results.events()``)."""
    device, regions, window = [], [], None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if on_device:
                continue  # the regions' echo on the device timeline
            if e.name() == WINDOW:
                window = (start, end)
            else:
                regions.append((start, end, e.name()))
        elif on_device:
            device.append((start, end, e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} region")
    w0, w1 = window
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    device.sort()
    busy, idle, cursor = 0, [], w0
    for start, end, _ in device:
        start, end = max(start, w0), min(end, w1)
        if start > cursor:
            idle.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if cursor < w1:
        idle.append((cursor, w1))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 ops=[(name, (end - start) / 1e9)
                      for start, end, name in device],
                 idle_by_region=_label_idle(idle, regions))


def _label_idle(idle: list, regions: list) -> dict:
    """Idle seconds by the innermost (latest started) host region open
    during them, ``none`` where no region was open."""
    points = []  # (time, order, kind, payload): ends sort before starts
    for i, (start, end, name) in enumerate(regions):
        points.append((start, 1, "open", i))
        points.append((end, 0, "close", i))
    for start, end in idle:
        points.append((start, 1, "idle", 1))
        points.append((end, 0, "idle", -1))
    points.sort()
    out: dict = collections.defaultdict(float)
    stack: list = []
    idle_depth, last = 0, None
    for t, _, kind, payload in points:
        if idle_depth and last is not None and t > last:
            label = regions[stack[-1]][2] if stack else "none"
            out[label] += (t - last) / 1e9
        last = t
        if kind == "open":
            stack.append(payload)
        elif kind == "close":
            stack.remove(payload)
        else:
            idle_depth += payload
    return dict(out)
