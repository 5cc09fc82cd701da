"""Flight recorder: a bounded ring of recent events, dumped on failure.

The port's copy of :mod:`mapreduce_tpu.obs.flight`.  The executor records
a small host-side event per dispatch, retry and checkpoint into a ring of
fixed size; the failure path dumps the ring, a summary of the state, the
metrics registry and the latest data-plane summary to one JSON file, so a
run that dies leaves forensics.  Recording is one ``deque.append``.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Bounded event ring and a one-shot dump."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.events_recorded = 0  # total, evicted ones included
        self.dumped_to: Optional[str] = None

    def record(self, kind: str, **fields) -> None:
        self._ring.append({"ts": round(time.time(), 6), "kind": kind,
                           **fields})
        self.events_recorded += 1

    def dump(self, path: str, context: Optional[dict] = None,
             state_summary: Optional[dict] = None,
             registry_snapshot: Optional[dict] = None,
             data: Optional[dict] = None,
             data_health: Optional[dict] = None) -> Optional[str]:
        """Write the forensics file; returns its path, or None when the
        write failed (a failure record must not name a dump that does not
        exist).  The first dump of a run that lands owns the file; later
        calls return its path.  A failed dump never masks the failure."""
        if self.dumped_to is not None:
            return self.dumped_to
        payload = {
            "dumped_at": round(time.time(), 6),
            "context": context or {},
            "events_recorded": self.events_recorded,
            "events_kept": len(self._ring),
            "events": list(self._ring),
        }
        if state_summary is not None:
            payload["state"] = state_summary
        if registry_snapshot is not None:
            payload["metrics"] = registry_snapshot
        if data is not None:
            payload["data"] = data
        if data_health is not None:
            payload["data_health"] = data_health
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, default=repr)
                f.write("\n")
        except OSError:
            return None
        self.dumped_to = path
        return path


def summarize_state(state) -> dict:
    """Leaf summary of a state for the dump: each tensor's shape, dtype,
    device and bytes, from its metadata only (never a read of the card).
    A state is a tensor or a (named) tuple, list or dict of them."""
    leaves: list = []

    def walk(x) -> None:
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            leaves.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(state)
    out: dict = {"n_leaves": len(leaves), "leaves": []}
    total = 0
    for i, leaf in enumerate(leaves):
        nbytes = int(leaf.nbytes)
        total += nbytes
        if i < 64:  # the detail list is capped; the total covers every leaf
            out["leaves"].append({"shape": list(leaf.shape),
                                  "dtype": str(leaf.dtype),
                                  "device": str(getattr(leaf, "device",
                                                        "cpu")),
                                  "nbytes": nbytes})
    out["total_nbytes"] = total
    return out
