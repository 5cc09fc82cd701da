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
import os
from typing import Optional

from mapreduce_tpu_torch.runtime import faults


#: The JAX package's merge strategies (``mapreduce_tpu.config``).
MERGE_STRATEGIES = ("tree", "gather", "keyrange", "hier-kr-tree",
                    "hier-tree-tree")

#: Salt width of ``combiner='salt'``: the packed build XORs this many low
#: position bits into ``key_lo``, so one hot key spreads over 2**3 sort
#: segments (the JAX package's value).
COMBINER_SALT_BITS = 3

#: The command line's refusal of ``--sort-mode segmin`` off the CPU (the
#: JAX CLI's guard, kept so both command lines accept the same runs).
SEGMIN_TPU_ERROR = (
    "sort_mode='segmin' is disabled off the CPU on the command line, as "
    "in the JAX CLI, where its stream-sized associative_scan wedged the "
    "TPU for >30 min (BENCHMARKS.md round 4).  Use sort_mode='sort3' "
    "(bit-identical results), run the A/B with --platform cpu, or set "
    "MAPREDUCE_ALLOW_SEGMIN=1 to run it on the card deliberately.")

#: What the autotuner resolves, which is not ported yet.
_AUTOTUNER = "A8b (ii), the autotuner"


def segmin_allowed() -> bool:
    """The ``MAPREDUCE_ALLOW_SEGMIN`` override: only an explicit yes
    (``1``, ``true``, ``yes``) opts in, so ``0`` keeps the guard."""
    return os.environ.get("MAPREDUCE_ALLOW_SEGMIN", "").lower() \
        in ("1", "true", "yes")


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not ported to the PyTorch package yet "
                      f"(ROADMAP.md item {item})")


def radix_slab_cap(bits: int, block_rows: int, slab_slack: int) -> int:
    """The JAX radix kernel's slab rows per (block, lane, bucket): the
    slack multiple of the uniform share, clamped to the block (validated
    here as in the JAX package; no launch of the port reads it)."""
    return min(slab_slack * block_rows // (1 << bits), block_rows)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A set of kernel geometries: the JAX package's ``Geometry``, with its
    fields, defaults and validation, so the same dicts are accepted and
    refused in both packages.

    The port reads two fields: ``radix_bits``, the radix seam's digit
    width (``sort_impl='radix*'``), and ``combiner_slots``, the hot-key
    cache depth of the fused kernel (``combiner='hot-cache'``).  Both are
    runtime arguments of the same CUDA kernels.  The others (window
    heights, slot budgets, the seam-carry rows, the radix slab sizes)
    size the TPU kernels' VMEM blocks, a layout the port's kernels do not
    have (they emit one dense stream and size their own tiles): they
    change no launch here, and no result in either package.
    """

    block_rows: int = 384
    compact_slots: int = 128
    sort3_block_rows: int = 256
    sort3_slots: int = 88
    pair_block_rows: int = 256
    combiner_block_rows: int = 512
    #: Hot-key cache entries per segment (K1d's ``cslots``).
    combiner_slots: int = 8
    aux_rows: int = 96
    #: Radix digit width: 2**bits buckets per partition level (K2).
    radix_bits: int = 3
    radix_block_rows: int = 256
    radix_slab_slack: int = 4

    def __post_init__(self) -> None:
        for name in ("block_rows", "combiner_block_rows", "pair_block_rows"):
            v = getattr(self, name)
            if v % 128 or not 128 <= v <= (1 << 20):
                raise ValueError(
                    f"{name} must be a multiple of 128 in [128, 2**20] "
                    f"(the fused lane-view block puts rows in the "
                    f"128-divisible minor dim), got {v}")
        if self.compact_slots != 128:
            raise ValueError(
                "compact_slots must be 128 (the only chip-validated "
                "lane-major slot count: the transposed output block puts "
                f"slots in the 128-divisible minor dim), got "
                f"{self.compact_slots}")
        if self.block_rows < 2 * self.compact_slots:
            raise ValueError(
                f"block_rows {self.block_rows} must be >= 2 * "
                f"compact_slots ({2 * self.compact_slots}): the kernel's "
                "pairwise fold emits at most block_rows/2 live rows")
        if self.combiner_block_rows < 2 * self.compact_slots:
            raise ValueError(
                f"combiner_block_rows {self.combiner_block_rows} must be "
                f">= 2 * compact_slots ({2 * self.compact_slots})")
        if self.sort3_block_rows % 32 \
                or not 64 <= self.sort3_block_rows <= (1 << 20):
            raise ValueError(
                f"sort3_block_rows must be a multiple of 32 in "
                f"[64, 2**20] (uint8 sublane tile), got "
                f"{self.sort3_block_rows}")
        if self.sort3_slots % 8 \
                or not 8 <= self.sort3_slots <= self.sort3_block_rows // 2:
            raise ValueError(
                f"sort3_slots must be a multiple of 8 in [8, "
                f"sort3_block_rows/2={self.sort3_block_rows // 2}], got "
                f"{self.sort3_slots}")
        if self.combiner_slots % 8 or not 8 <= self.combiner_slots <= 32:
            raise ValueError(
                f"combiner_slots must be a multiple of 8 in [8, 32], got "
                f"{self.combiner_slots}")
        if self.aux_rows % 32 or not 96 <= self.aux_rows <= 512:
            raise ValueError(
                f"aux_rows must be a multiple of 32 in [96, 512] (the "
                "pinned head row at 64 needs the plane past it), got "
                f"{self.aux_rows}")
        if not 1 <= self.radix_bits <= 5:
            raise ValueError(
                f"radix_bits must be in [1, 5] (B output-ref triples are "
                f"unrolled in the kernel), got {self.radix_bits}")
        if self.radix_block_rows % 8 \
                or not 64 <= self.radix_block_rows <= (1 << 20):
            raise ValueError(
                f"radix_block_rows must be a multiple of 8 in [64, 2**20], "
                f"got {self.radix_block_rows}")
        if self.radix_slab_slack < 1:
            raise ValueError(
                f"radix_slab_slack must be >= 1, got {self.radix_slab_slack}")
        cap = radix_slab_cap(self.radix_bits, self.radix_block_rows,
                             self.radix_slab_slack)
        if cap < 8 or cap % 8:
            raise ValueError(
                f"radix slab cap {cap} (= slack*block_rows/B, clamped to "
                "block_rows) must be a multiple of 8 and >= 8; adjust "
                "radix_block_rows/radix_bits/radix_slab_slack")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_GEOMETRY = Geometry()

#: The JAX package's named geometries: 'tall512' (taller stable2 windows,
#: TPU layout only here, so the default's launches) and 'combiner16' (a
#: hot-key cache twice as deep).
GEOMETRY_PRESETS = {
    "default": DEFAULT_GEOMETRY,
    "tall512": Geometry(block_rows=512),
    "combiner16": Geometry(combiner_slots=16),
}


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
        byte-ordered stream), 'sort3' (3-key sort) or 'segmin' (a 2-key
        sort, then the minimum position of each key segment by one
        ``scatter_reduce``; identical tables, no overlong rescue: its
        budget resolves to 0 and an explicit one is refused).
      sort_impl: 'xla' (default: the torch sort) or 'radix_partition' /
        'radix' (the CUDA radix partition, one or two digit levels of
        ``resolved_geometry.radix_bits``, then a segmented sort of the
        live rows; identical tables; not with segmin).
      map_impl: 'split' (default) or 'fused'.  The port's kernel emits the
        same one stream either way; 'fused' is what carries the combiner.
      combiner: 'off' (default), 'hot-cache' or 'salt'.  'hot-cache':
        under ``map_impl='fused'`` on the kernel path in compact mode, the
        kernel counts each segment's first ``resolved_combiner_slots``
        distinct keys in place and leaves them out of the stream
        (identical results); elsewhere a no-op, as in the JAX package.
        'salt': the packed table build XORs ``COMBINER_SALT_BITS`` low
        position bits into ``key_lo`` before its sort and de-salts after
        it (:func:`...ops.table.from_packed_rows`; identical results while
        the distinct keys fit the batch table; not with segmin).  'auto'
        resolves through the autotuner's data-health prior, which is not
        ported (ROADMAP.md item A8b (ii)).
      combiner_slots: cache entries per segment (multiple of 8 in [8, 32];
        None: the geometry's, 8 by default).
      merge_every: fold the chunks' batch tables into the running table
        once every K combines (``models/wordcount.py:BufferedTableState``
        stages them; one build over the table and the K batches replaces
        K merges).  Identical results, except that ``dropped_uniques``
        can be a tighter bound under spill, as in the JAX package.
        Word-count family only.
      geometry: None (the default geometry), a preset name of
        ``GEOMETRY_PRESETS``, a :class:`Geometry` or a dict of its fields
        (stored as the frozen ``Geometry``).  The port reads its
        ``radix_bits`` and ``combiner_slots`` (see :class:`Geometry`);
        results do not depend on it.  'auto' resolves through a searched
        profile, which is not ported (ROADMAP.md item A8b (ii)).
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
        if self.sort_mode not in ("sort3", "stable2", "segmin"):
            raise ValueError(f"unknown sort_mode {self.sort_mode!r}")
        if self.sort_impl not in ("xla", "radix", "radix_partition"):
            raise ValueError(f"unknown sort_impl {self.sort_impl!r}")
        if self.map_impl not in ("split", "fused"):
            raise ValueError(f"unknown map_impl {self.map_impl!r}")
        if self.sort_impl != "xla" and self.sort_mode == "segmin":
            raise ValueError(
                "sort_impl='radix'/'radix_partition' requires sort_mode "
                "'sort3' or 'stable2': segmin recovers first occurrence "
                "with a segmented scan over packed-as-payload, an order "
                "the radix path's tie-by-packed contract replaces")
        if self.compact_slots not in (None, 0):
            raise ValueError(
                "compact_slots must be None (compact mode) or 0 (pair mode): "
                "the kernel's dense stream has no slots to size, got "
                f"{self.compact_slots}")
        if self.merge_every < 1:
            raise ValueError(f"merge_every must be >= 1, got "
                             f"{self.merge_every}")
        for name in ("rescue_overlong", "rescue_overlong_max"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if self.rescue_overlong and self.sort_mode == "segmin":
            raise ValueError(
                "rescue_overlong requires sort_mode='sort3' or "
                "'stable2' (poison extraction needs the poison segment "
                "position-ordered); set rescue_overlong=0 to use segmin")
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
        if self.combiner == "auto":
            raise _not_ported("combiner='auto'", _AUTOTUNER)
        if self.combiner not in ("off", "hot-cache", "salt"):
            raise ValueError(f"unknown combiner {self.combiner!r} (expected "
                             "'off', 'hot-cache', 'salt' or 'auto')")
        if self.combiner == "salt" and self.sort_mode == "segmin":
            raise ValueError(
                "combiner='salt' requires sort_mode='sort3' or 'stable2' "
                "(the de-salt reads each kept row's own position; segmin "
                "keeps packed as an unordered payload)")
        if self.combiner_slots is not None:
            if self.combiner_slots % 8 or not 8 <= self.combiner_slots <= 32:
                raise ValueError(f"combiner_slots must be a multiple of 8 in "
                                 f"[8, 32], got {self.combiner_slots}")
            if self.combiner != "hot-cache":
                raise ValueError("combiner_slots sizes the hot-key cache; set "
                                 "combiner='hot-cache' to use it")
        if isinstance(self.geometry, dict):
            # Stored as the frozen dataclass, so the config stays hashable.
            object.__setattr__(self, "geometry", Geometry(**self.geometry))
        if self.geometry == "auto":
            raise _not_ported("geometry='auto'", _AUTOTUNER)
        if isinstance(self.geometry, str):
            if self.geometry not in GEOMETRY_PRESETS:
                raise ValueError(
                    f"unknown geometry {self.geometry!r} (expected 'auto', "
                    f"a preset name {sorted(GEOMETRY_PRESETS)}, a Geometry, "
                    "or a dict of its fields)")
        elif self.geometry is not None \
                and not isinstance(self.geometry, Geometry):
            raise ValueError(
                f"geometry must be None, 'auto', a preset name, a Geometry "
                f"or a dict, got {type(self.geometry).__name__}")
        if not isinstance(self.merge_overlap, bool):
            raise ValueError(
                f"merge_overlap must be a bool, got "
                f"{type(self.merge_overlap).__name__}")
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
        """The resolved overlong-rescue budget (see ``rescue_overlong``):
        1024 by default, 0 under segmin."""
        if self.rescue_overlong is None:
            return 0 if self.sort_mode == "segmin" else 1024
        return self.rescue_overlong

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
    def resolved_geometry(self) -> Geometry:
        """The :class:`Geometry` this config runs (None: the default)."""
        g = self.geometry
        if g is None:
            return DEFAULT_GEOMETRY
        if isinstance(g, str):
            return GEOMETRY_PRESETS[g]
        return g

    @property
    def geometry_label(self) -> str:
        """The name ledgers carry: 'default', a preset name, or 'custom'
        for a non-preset ``Geometry``."""
        g = self.geometry
        if g is None:
            return "default"
        if isinstance(g, str):
            return g
        return "default" if g == DEFAULT_GEOMETRY else "custom"

    @property
    def resolved_combiner(self) -> str:
        """The combiner the map runs: the JAX property, whose unresolved
        'auto' runs as 'off'; the port refuses 'auto', so it is
        ``combiner``."""
        return self.combiner

    @property
    def resolved_salt_bits(self) -> int:
        """Position bits the packed build XORs into ``key_lo`` (0: none)."""
        return COMBINER_SALT_BITS if self.resolved_combiner == "salt" else 0

    @property
    def resolved_combiner_slots(self) -> int:
        """Hot-key cache entries per segment (0: no cache).  Nonzero only
        where the cache exists: the kernel path, ``map_impl='fused'``,
        compact mode, ``combiner='hot-cache'``.  An explicit
        ``combiner_slots`` wins over the geometry's."""
        if self.resolved_combiner != "hot-cache" or self.map_impl != "fused" \
                or not self.compact \
                or self.resolved_backend() != "pallas":
            return 0
        return self.combiner_slots if self.combiner_slots is not None \
            else self.resolved_geometry.combiner_slots

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

#: A small config for tests and the bundled fixture, as in the JAX package.
SMALL_CONFIG = Config(chunk_bytes=1 << 10, table_capacity=1 << 10)
