"""Runtime configuration of the port.

Counterpart of :mod:`mapreduce_tpu.config`: the fields the word-count main
path reads, at the JAX package's defaults and with its names, so a JAX
``Config`` maps across one to one (:func:`...convert.config_from_dict`).
The backend names stay ``'pallas'`` and ``'xla'``: here ``'pallas'`` means
the hand-written CUDA kernel path and ``'xla'`` the plain PyTorch
tokenizer.  Values the port does not run yet raise ``ValueError`` naming
the ``ROADMAP.md`` item that will port them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mapreduce_tpu_torch.runtime import faults


#: The JAX package's merge strategies (``mapreduce_tpu.config``).
MERGE_STRATEGIES = ("tree", "gather", "keyrange", "hier-kr-tree",
                    "hier-tree-tree")


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not ported to the PyTorch package yet "
                      f"(ROADMAP.md item {item})")


@dataclasses.dataclass(frozen=True)
class Config:
    """Sizing knobs for a run (see the JAX package's ``Config`` for each).

    Attributes:
      chunk_bytes: bytes per streaming step (default 32 MB).
      table_capacity: distinct keys the running table holds.
      batch_unique_capacity: distinct keys one chunk's table holds (None:
        ``min(chunk_bytes // 2 + 1, table_capacity)``).
      backend: 'pallas' (the CUDA kernel path; tokens longer than
        ``pallas_max_token`` go through the overlong rescue), 'xla' (the
        plain tokenizer, any token length) or 'auto' (pallas whenever
        ``pallas_min_chunk <= chunk_bytes <= 2**26``).
      pallas_max_token: W, the kernel's lookback bound (1..63).
      sort_mode: 'stable2' (default: stable 2-key sort over the kernel's
        byte-ordered stream) or 'sort3' (3-key sort).
      sort_impl: 'xla' (default: the torch sort) or 'radix_partition' /
        'radix' (the CUDA radix partition, one or two digit levels, then a
        torch sort of the live rows; identical tables).
      radix_bits: digit bits per radix level (1..5, default 3).
      map_impl: 'split' (default) or 'fused'.  The port's kernel emits the
        same one stream either way; 'fused' is what carries the combiner.
      combiner: 'off' (default) or 'hot-cache': under ``map_impl='fused'``
        on the kernel path in compact mode, the kernel counts each
        segment's first ``combiner_slots`` distinct keys in place and
        leaves them out of the stream (identical results); elsewhere a
        no-op, as in the JAX package.
      combiner_slots: cache entries per segment (multiple of 8 in [8, 32];
        None: 8).
      compact_slots: None (compact mode) or 0 (pair mode).  Both give the
        kernel's one dense stream; pair mode carries no combiner.
      rescue_overlong / rescue_overlong_max / rescue_window: the overlong
        rescue budgets (None: 1024, then ``chunk_bytes >> 10`` clamped to
        [1024, 65536]) and its lookback in bytes.
      superstep: chunks per group of the streamed executor, the unit its
        window holds and retires (one ``Engine.step`` each; identical
        results).
      sketch_flush_every: sketched runs (HLL/CMS) stage each chunk's keys
        and update the sketch once every K combines (identical results;
        K * batch_uniques rows of extra state).  1: update every combine.
      inflight_groups: superstep groups the streamed executor keeps
        dispatched but unretired (1: serial, the A/B control).
      prefetch_depth: batches the reader thread may run ahead (None:
        ``superstep * inflight_groups`` clamped to [2, 16]).
      fault_plan: a fault-injection spec for the streamed executor
        (:class:`...runtime.faults.FaultPlan` grammar, e.g.
        ``'seed=42,rate=0.02'`` or ``'at=dispatch:3:resource'``), parsed
        here so a bad spec fails at construction.  None: no injection.
      merge_strategy: the streamed run's collective merge across ranks:
        'tree' (default: the butterfly, log2(D) rounds), 'gather' (gather
        and fold) or 'keyrange' (the count table's reduce-scatter by key;
        word-count family only), or 'auto', which the driver resolves and
        which behaves as 'tree' unresolved; on a two-level mesh
        (``parallel/mesh.py:two_level_mesh``) also 'hier-tree-tree' (a
        tree a level, within a host first) and 'hier-kr-tree' (keyrange
        within a host, a tree across hosts).  The Engine checks that a
        'hier-*' strategy has two mesh levels and the keyrange family a
        job with a keyrange hook.
      failure_policy: the streamed executor's per-class retry budgets,
        backoff, completion timeout and degradation ladder (None, a
        :class:`...runtime.faults.FailurePolicy` or a dict of its fields,
        stored as the frozen policy so the config stays hashable).  None:
        the executor's ``retry`` count gives the transient and resource
        budgets.
      merge_overlap: window-boundary merges: every ``inflight_groups``
        retired groups (and at checkpoint, file and preemption boundaries)
        the streamed run merges the ranks' local states into one
        replicated accumulator and resets them, and the stream's end
        merges only the residual (identical results).  Requires
        ``retry=0`` (an explicit failure policy keeps its budgets, with
        window replay disarmed); each partial is an ``op='partial'``
        ``collective`` ledger record.
    """

    chunk_bytes: int = 1 << 25
    table_capacity: int = 1 << 18
    batch_unique_capacity: Optional[int] = None
    backend: str = "auto"
    pallas_max_token: int = 32
    sort_mode: str = "stable2"
    sort_impl: str = "xla"
    radix_bits: int = 3
    map_impl: str = "split"
    compact_slots: Optional[int] = None
    rescue_overlong: Optional[int] = None
    rescue_overlong_max: Optional[int] = None
    rescue_window: int = 192
    merge_every: int = 1
    combiner: str = "off"
    combiner_slots: Optional[int] = None
    geometry: object = None
    superstep: int = 1
    sketch_flush_every: int = 1
    inflight_groups: int = 4
    prefetch_depth: Optional[int] = None
    fault_plan: Optional[str] = None
    failure_policy: object = None
    merge_strategy: str = "tree"
    merge_overlap: bool = False

    def __post_init__(self) -> None:
        if self.chunk_bytes % 128 != 0:
            raise ValueError(f"chunk_bytes must be a multiple of 128, got "
                             f"{self.chunk_bytes}")
        if self.table_capacity < 2:
            raise ValueError("table_capacity must be >= 2")
        if self.sketch_flush_every < 1:
            raise ValueError(f"sketch_flush_every must be >= 1, got "
                             f"{self.sketch_flush_every}")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.sort_mode == "segmin":
            raise _not_ported("sort_mode='segmin'", "A14")
        if self.sort_mode not in ("sort3", "stable2"):
            raise ValueError(f"unknown sort_mode {self.sort_mode!r}")
        if self.sort_impl not in ("xla", "radix", "radix_partition"):
            raise ValueError(f"unknown sort_impl {self.sort_impl!r}")
        if not 1 <= self.radix_bits <= 5:
            raise ValueError(f"radix_bits must be in [1, 5], got "
                             f"{self.radix_bits}")
        if self.map_impl not in ("split", "fused"):
            raise ValueError(f"unknown map_impl {self.map_impl!r}")
        if self.combiner in ("salt", "auto"):
            raise _not_ported(f"combiner={self.combiner!r}", "A10")
        if self.combiner not in ("off", "hot-cache"):
            raise ValueError(f"unknown combiner {self.combiner!r}")
        if self.combiner_slots is not None:
            if self.combiner_slots % 8 or not 8 <= self.combiner_slots <= 32:
                raise ValueError(f"combiner_slots must be a multiple of 8 in "
                                 f"[8, 32], got {self.combiner_slots}")
            if self.combiner != "hot-cache":
                raise ValueError("combiner_slots sizes the hot-key cache; set "
                                 "combiner='hot-cache' to use it")
        if self.merge_every > 1:
            raise _not_ported("merge_every > 1", "A14")
        if self.merge_every < 1:
            raise ValueError(f"merge_every must be >= 1, got "
                             f"{self.merge_every}")
        if self.geometry is not None:
            raise _not_ported("a kernel geometry preset", "A14")
        if not isinstance(self.merge_overlap, bool):
            raise ValueError(
                f"merge_overlap must be a bool, got "
                f"{type(self.merge_overlap).__name__}")
        if self.compact_slots not in (None, 0):
            raise ValueError(
                "compact_slots must be None (compact mode) or 0 (pair mode): "
                "the kernel's dense stream has no slots to size, got "
                f"{self.compact_slots}")
        for name in ("rescue_overlong", "rescue_overlong_max"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if self.rescue_slots:
            if self.backend != "xla" \
                    and self.rescue_window <= self.pallas_max_token + 1:
                raise ValueError(
                    f"rescue_window ({self.rescue_window}) must exceed "
                    f"pallas_max_token + 1 ({self.pallas_max_token + 1}) "
                    "to rescue anything")
            if self.rescue_window > 4096:
                raise ValueError(f"rescue_window must be <= 4096, got "
                                 f"{self.rescue_window}")
        if self.superstep < 1:
            raise ValueError(f"superstep must be >= 1, got {self.superstep}")
        if self.inflight_groups < 1:
            raise ValueError(
                f"inflight_groups must be >= 1, got {self.inflight_groups}")
        if self.prefetch_depth is not None and self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.backend != "xla" and not 1 <= self.pallas_max_token <= 63:
            raise ValueError(f"pallas_max_token must be in [1, 63], got "
                             f"{self.pallas_max_token}")
        if self.backend == "pallas" \
                and not self.pallas_min_chunk <= self.chunk_bytes <= (1 << 26):
            raise ValueError(
                f"pallas backend needs {self.pallas_min_chunk} <= "
                f"chunk_bytes <= {1 << 26}, got {self.chunk_bytes}")
        if self.merge_strategy != "auto" \
                and self.merge_strategy not in MERGE_STRATEGIES:
            raise ValueError(
                f"unknown merge_strategy {self.merge_strategy!r} (expected "
                f"'auto' or one of {list(MERGE_STRATEGIES)})")
        if self.fault_plan is not None:
            if not isinstance(self.fault_plan, str):
                raise ValueError(
                    f"fault_plan must be a spec string (or None), got "
                    f"{type(self.fault_plan).__name__}")
            faults.FaultPlan.from_spec(self.fault_plan)
        if isinstance(self.failure_policy, dict):
            object.__setattr__(self, "failure_policy",
                               faults.FailurePolicy(**self.failure_policy))
        elif self.failure_policy is not None and not isinstance(
                self.failure_policy, faults.FailurePolicy):
            raise ValueError(
                f"failure_policy must be None, a FailurePolicy or a dict of "
                f"its fields, got {type(self.failure_policy).__name__}")

    @property
    def resolved_merge_strategy(self) -> str:
        """The strategy the engine builds: an unresolved 'auto' behaves as
        'tree' (resolving it is the driver's job, never the engine's)."""
        return "tree" if self.merge_strategy == "auto" \
            else self.merge_strategy

    @property
    def rescue_slots(self) -> int:
        """The resolved overlong-rescue budget (see ``rescue_overlong``)."""
        return 1024 if self.rescue_overlong is None else self.rescue_overlong

    @property
    def rescue_slots_max(self) -> int:
        """The resolved second-tier rescue budget (>= rescue_slots; 0 when
        rescue is off)."""
        if not self.rescue_slots:
            return 0
        if self.rescue_overlong_max is not None:
            return max(self.rescue_overlong_max, self.rescue_slots)
        return max(min(self.chunk_bytes >> 10, 1 << 16), self.rescue_slots)

    @property
    def resolved_prefetch_depth(self) -> int:
        """The reader's prefetch depth: deep enough to feed a full window,
        bounded so host memory stays O(window)."""
        if self.prefetch_depth is not None:
            return self.prefetch_depth
        return min(16, max(2, self.superstep * self.inflight_groups))

    @property
    def compact(self) -> bool:
        """Compact mode (else pair mode): the same stream, launched under
        its mode's name; only compact mode carries the combiner."""
        return self.compact_slots is None

    @property
    def resolved_combiner_slots(self) -> int:
        """Hot-key cache entries per segment (0: no cache).  Nonzero only
        where the cache exists: the kernel path, ``map_impl='fused'``,
        compact mode, ``combiner='hot-cache'``."""
        if self.combiner != "hot-cache" or self.map_impl != "fused" \
                or not self.compact \
                or self.resolved_backend() != "pallas":
            return 0
        return 8 if self.combiner_slots is None else self.combiner_slots

    @property
    def pallas_min_chunk(self) -> int:
        """Smallest buffer the kernel path pads to, as in the JAX package."""
        return 128 * (2 * self.pallas_max_token + 2)

    def resolved_backend(self) -> str:
        """'auto' resolves to the kernel path whenever the chunk fits its
        envelope; nothing here looks at the device."""
        if self.backend != "auto":
            return self.backend
        if self.pallas_min_chunk <= self.chunk_bytes <= (1 << 26):
            return "pallas"
        return "xla"

    @property
    def batch_uniques(self) -> int:
        if self.batch_unique_capacity is not None:
            return self.batch_unique_capacity
        return min(self.chunk_bytes // 2 + 1, self.table_capacity)


DEFAULT_CONFIG = Config()
