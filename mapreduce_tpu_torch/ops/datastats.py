"""Data-plane statistics of word count: what the data did to the map.

Counterpart of :mod:`mapreduce_tpu.ops.datastats`.  A telemetered streamed
run (``run_job(..., telemetry=...)``) runs its job in stats mode: each
chunk's map also gives a :class:`DataStats` of counters, folded over the
group, and after the group's last combine the running table's gauges fill
in.  :class:`DataAggregator` folds the groups on the host into each
``group`` record's ``data`` dict and the run's one ``data`` record, in the
JAX package's field names.

No new sync.  The counters the host already knows come from the map's one
host read of a chunk (``models/wordcount.py:_map_kernel``; under stats it
also reads the combiner's cold-entry count in the same copy): ``chunks``,
``overlong``, ``rescue_invocations``, ``rescue_escalations``,
``fallback_chunks``, ``spill_rows`` and the combiner's. The rest are small
tensors on the card: ``rescued`` and ``dropped_*`` (known only after the
rescue and the build) and the gauges (reductions of the post-group table).
:class:`StatsFetch` stacks them into one vector, enqueued on the compute
stream after the group's last combine and copied ``non_blocking`` into
pinned memory before the group's completion event; the executor reads it
at retirement, once that event proved it ready.

Deliberate differences from the JAX package:

* ``fallback_chunks`` and ``spill_rows`` count the TPU kernel's
  compact-window spill there.  The port's dense stream cannot spill, so on
  the default path both are 0; under ``combiner='hot-cache'`` they count
  the chunks that took the combiner-free rerun (``BRANCHES
  ["spill_fallbacks"]``) and the combiner kernel's spill scalar.
* The port has no compact windows, so there is no window slot capacity:
  the ``data`` record has no ``window_slot_capacity`` and no
  ``window_occupancy``, as on the JAX package's ``xla`` backend.
* The 64-bit gauges are single int64 values (``tokens``, ``top_count``,
  ``dropped``), not lo/hi uint32 pairs.

Every other counter and gauge equals the JAX package's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class DataStats(NamedTuple):
    """A chunk's (or a group's) data-plane statistics.  A field is an int
    or a 0-dim int64 tensor; see the JAX ``DataStats`` for each counter.

    Counters (summed over a group): ``chunks``, ``overlong``, ``rescued``,
    ``dropped_tokens``, ``dropped_uniques``, ``rescue_invocations``,
    ``rescue_escalations``, ``fallback_chunks``, ``spill_rows``,
    ``combiner_hits``, ``combiner_flushes``, ``combiner_evicted``.

    Gauges (the running table after the group's last combine): occupied
    slots, total tokens including dropped ones, the largest count (the
    key-skew proxy) and the cumulative dropped tokens.
    """

    chunks: Any = 0
    overlong: Any = 0
    rescued: Any = 0
    dropped_tokens: Any = 0
    dropped_uniques: Any = 0
    rescue_invocations: Any = 0
    rescue_escalations: Any = 0
    fallback_chunks: Any = 0
    spill_rows: Any = 0
    combiner_hits: Any = 0
    combiner_flushes: Any = 0
    combiner_evicted: Any = 0
    table_valid: Any = 0
    tokens: Any = 0
    top_count: Any = 0
    dropped: Any = 0


#: The counter fields (everything before the gauges).
COUNTERS = DataStats._fields[:12]


def map_stats(**counters) -> DataStats:
    """One chunk's counters (``chunks`` is 1; the gauges stay 0 until
    :func:`with_table_gauges`)."""
    return DataStats(chunks=1, **counters)


def add(a: DataStats, b: DataStats) -> DataStats:
    """Fold two chunks' counters (the gauges add too, harmlessly:
    :func:`with_table_gauges` overwrites them)."""
    return DataStats(*(x + y for x, y in zip(a, b)))


def with_table_gauges(stats: DataStats, table) -> DataStats:
    """Fill the gauges from the running :class:`...ops.table.CountTable`:
    a few reductions over its capacity-sized lanes, on its device."""
    counts = table.count + (table.count_hi << 32)
    dropped = table.dropped_count + (table.dropped_count_hi << 32)
    return stats._replace(table_valid=table.n_valid(),
                          tokens=counts.sum() + dropped,
                          top_count=counts.max(), dropped=dropped)


def supports(job) -> bool:
    """Does this job give data-plane statistics?"""
    return (callable(getattr(job, "map_chunk_stats", None))
            and callable(getattr(job, "state_stats", None)))


class StatsFetch:
    """A group's :class:`DataStats` on its way to the host.

    Made at dispatch, right after the group's last combine: the tensor
    fields go into one int64 vector, which on the card is copied
    ``non_blocking`` into pinned memory on the current stream.  Read
    :meth:`result` only once the group's completion event (recorded after
    this) has completed; on the CPU the vector is already there.

    Across ranks (an ``axis`` with a process group) every field goes into
    the vector, one all_gather (enqueued on the stream under NCCL) brings
    the D ranks' vectors, and :meth:`result` folds them as the JAX
    aggregator folds its ``[D]`` leaves: counters and the table gauges
    summed, the largest count the maximum."""

    def __init__(self, stats: DataStats, axis=None):
        self._host = {}
        self._fields = []
        values = []
        gather = axis is not None and axis.group is not None
        dev = next((v.device for v in stats if isinstance(v, torch.Tensor)),
                   torch.device("cpu"))
        for name, v in zip(DataStats._fields, stats):
            if isinstance(v, torch.Tensor):
                self._fields.append(name)
                values.append(v.reshape(()).to(torch.int64))
            elif gather:  # a fill on the device: no copy, no sync
                self._fields.append(name)
                values.append(torch.full((), int(v), dtype=torch.int64,
                                         device=dev))
            else:
                self._host[name] = int(v)
        self._buf = None
        self._ranks = 1
        if values:
            vec = torch.stack(values)
            if gather:
                from mapreduce_tpu_torch.parallel import collectives

                vec = collectives.all_gather(vec, axis).reshape(-1)
                self._ranks = axis.size
            if vec.is_cuda:
                self._buf = torch.empty(vec.shape, dtype=torch.int64,
                                        pin_memory=True)
                self._buf.copy_(vec, non_blocking=True)
            else:
                self._buf = vec

    def result(self) -> DataStats:
        values = self._buf.tolist() if self._buf is not None else []
        n = len(self._fields)
        rows = [values[i * n:(i + 1) * n] for i in range(self._ranks)]
        folded = [max(col) if f == "top_count" else sum(col)
                  for f, col in zip(self._fields, zip(*rows))] if rows \
            else []
        return DataStats(**self._host, **dict(zip(self._fields, folded)))


class DataAggregator:
    """Host-side fold of the retired groups' :class:`DataStats`:
    :meth:`group_data` gives a ``group`` record's ``data`` dict and
    accumulates the run's totals; :meth:`run_record` gives the run's
    ``data`` record."""

    def __init__(self, *, capacity: int, backend: str, map_impl: str,
                 combiner: str = "off", devices: int = 1):
        self.capacity = int(capacity) * int(devices)  # every rank's table
        self.backend = backend
        self.map_impl = map_impl
        self.combiner = combiner
        self.groups = 0
        self.totals = {k: 0 for k in COUNTERS}
        self.final: dict = {}

    @classmethod
    def for_run(cls, config, devices: int = 1) -> "DataAggregator":
        return cls(capacity=config.table_capacity,
                   backend=config.resolved_backend(),
                   map_impl=config.map_impl,
                   combiner=config.resolved_combiner, devices=devices)

    def group_data(self, stats: DataStats) -> dict:
        """One retired group's statistics (ints) -> its ``data`` dict
        (the nonzero counters, ``chunks``, the running occupancy and
        top-key mass), folding the counters into the run's totals."""
        out: dict = {}
        for k in COUNTERS:
            v = int(getattr(stats, k))
            self.totals[k] += v
            if k != "chunks" and v:
                out[k] = v
        out["chunks"] = int(stats.chunks)
        valid, total = int(stats.table_valid), int(stats.tokens)
        self.final = {"table_valid": valid, "tokens": total,
                      "top_count": int(stats.top_count),
                      "dropped_cumulative": int(stats.dropped)}
        out["occupancy"] = round(valid / max(self.capacity, 1), 4)
        if total:
            out["top_mass"] = round(int(stats.top_count) / total, 6)
        self.groups += 1
        return out

    def snapshot(self) -> dict:
        """The run summary as of the last retired group."""
        return self.run_record()

    def run_record(self) -> dict:
        """The run's ``data`` ledger record."""
        rec: dict = {"groups": self.groups, "backend": self.backend,
                     "map_impl": self.map_impl, "combiner": self.combiner,
                     "capacity": self.capacity}
        rec.update(self.totals)
        f = self.final
        tokens = f.get("tokens", 0)
        rec["tokens"] = tokens
        rec["table_valid"] = f.get("table_valid", 0)
        rec["top_count"] = f.get("top_count", 0)
        rec["dropped_cumulative"] = f.get("dropped_cumulative", 0)
        rec["table_occupancy"] = round(
            rec["table_valid"] / max(rec["capacity"], 1), 4)
        if tokens:
            rec["top_mass"] = round(rec["top_count"] / tokens, 6)
            rec["distinct_ratio"] = round(rec["table_valid"] / tokens, 6)
            rec["dropped_frac"] = round(rec["dropped_tokens"] / tokens, 6)
            if rec["combiner_hits"]:
                rec["combiner_hit_rate"] = round(
                    rec["combiner_hits"] / tokens, 6)
                rec["combiner_rows_deleted"] = \
                    rec["combiner_hits"] - rec["combiner_flushes"]
        return rec
