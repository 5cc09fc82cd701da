"""Fault injection and the failure policy of the streamed executor.

The port's own copy of :mod:`mapreduce_tpu.runtime.faults` (stdlib only,
like the JAX module; the port imports nothing of the JAX package):

* an **error taxonomy** (:func:`classify`): every exception that crosses a
  named seam of the streamed executor is ``transient``, ``resource``,
  ``permanent`` or ``preemption``, and the class, not the exception type,
  decides what the policy does;
* a :class:`FailurePolicy`: per-class retry budgets with exponential
  backoff and deterministic jitter, a wall-clock bound on completion
  waits, and the **degradation ladder** for resource-classed failures
  (:data:`DEGRADATION_LADDER`);
* a :class:`FaultPlan`: seeded, deterministic fault injection at the named
  seams (:data:`SEAMS`), which :meth:`FaultPlan.from_ledger` rebuilds
  fault for fault from a run's ``fault`` records.

Every decision (does crossing ``(seam, index)`` fire, which class, how much
jitter) is the SHA-256 of the same parts as in the JAX package, so one plan
fires at the same crossings in both packages.

One deliberate difference from the JAX module, in :func:`classify` only:
the CUDA runtime's *sticky* errors (an illegal memory access, a device-side
assert, ...) poison the process's CUDA context, so every later call fails
the same way; they classify as ``permanent`` and the run fails at once with
the real error, instead of spending its budget on replays that cannot
succeed.  A CUDA out-of-memory error (``torch.cuda.OutOfMemoryError``,
"CUDA out of memory. ...") matches the ``out of memory`` marker and is
``resource``, as XLA's ``RESOURCE_EXHAUSTED`` is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Iterable, Optional

#: The named seams of a streamed run.  The executor checks the active
#: :class:`FaultPlan` at each crossing; the plan counts crossings per seam,
#: so ``(seam, index)`` names one moment of the run.  The port crosses all
#: but ``checkpoint-load`` (real faults only); ``ledger-append`` when a
#: ledger is attached (``runtime/executor.py``, before each group's
#: ``step`` record, where an append fault is absorbed).
SEAMS = (
    "reader-read",       # a batch leaving the prefetching reader
    "stage-acquire",     # host staging of a group
    "h2d",               # host->device placement of the staged group
    "dispatch",          # the group's Engine.step launches
    "token-wait",        # waiting on a group's completion token
    "checkpoint-save",   # the atomic snapshot write
    "checkpoint-load",   # resume-time snapshot read (real faults only)
    "ledger-append",     # a telemetry ledger record write
    "collective-finish", # the finish (merge + finalize)
    "process-kill",      # whole-process kill (os._exit)
)

#: The error taxonomy: every exception at a seam classifies to exactly one.
FAULT_CLASSES = ("transient", "resource", "permanent", "preemption")

#: The degradation ladder: each step names the config change a
#: resource-classed failure storm buys, the cheapest capability first.
#: Every knob on it gives identical results, so a degraded run is slower,
#: never wrong.  ``(step name, config field, degraded value)``: a step
#: applies when the field's value differs from the degraded one.
DEGRADATION_LADDER = (
    ("revert-geometry", "geometry", "default"),
    ("combiner-off", "combiner", "off"),
    ("map-split", "map_impl", "split"),
    ("sort-xla", "sort_impl", "xla"),
)


# ---------------------------------------------------------------------------
# typed faults
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """A typed fault at a named seam.  ``injected=True`` marks faults the
    :class:`FaultPlan` fired; real exceptions are classified
    (:func:`classify`), not wrapped, so their tracebacks survive."""

    fault_class = "transient"

    def __init__(self, message: str, *, seam: str = "",
                 index: Optional[int] = None, injected: bool = False):
        super().__init__(message)
        self.seam = seam
        self.index = index
        self.injected = injected


class TransientFault(FaultError):
    """Worth retrying as it is: flaky I/O, a dropped dispatch, a one-off."""

    fault_class = "transient"


class ResourceFault(FaultError):
    """The configuration is too hungry for the hardware right now (out of
    memory): retrying the same program tends to fail the same way, and the
    degradation ladder is the cure."""

    fault_class = "resource"


class PermanentFault(FaultError):
    """Retrying is useless (bad config, corrupt input, programming error,
    a poisoned CUDA context): fail loudly and at once."""

    fault_class = "permanent"


class PreemptionFault(FaultError):
    """The platform is taking the machine back: drain the in-flight
    window, checkpoint, and exit cleanly with a resumable cursor."""

    fault_class = "preemption"


class TokenTimeout(FaultError):
    """A completion wait exceeded ``FailurePolicy.token_timeout_s``: the
    device is hung or slow.  Transient: the replay re-dispatches from the
    window's anchor."""

    fault_class = "transient"


class Preempted(Exception):
    """Clean preemption exit (not a failure): the stream drained, the
    snapshot (if configured) was saved, and ``cursor_bytes``/``step`` say
    where a relaunch resumes."""

    def __init__(self, *, step: int, cursor_bytes: int,
                 checkpoint_path: Optional[str] = None,
                 checkpointed: bool = False):
        self.step = int(step)
        self.cursor_bytes = int(cursor_bytes)
        self.checkpoint_path = checkpoint_path
        self.checkpointed = bool(checkpointed)
        where = f"step {step}, cursor {cursor_bytes}"
        how = (f"checkpointed to {checkpoint_path}; relaunch to resume"
               if checkpointed else
               "no checkpoint configured; relaunch restarts the stream")
        super().__init__(f"preempted at {where} ({how})")


#: Exception types that classify as permanent whatever their message says:
#: config and programming errors, where a retry reruns the same bug.
_PERMANENT_TYPES = (ValueError, TypeError, KeyError, IndexError,
                    AttributeError, AssertionError, NotImplementedError)

#: Lowercased substrings of the CUDA runtime's sticky errors: after one,
#: the process's CUDA context is unusable, so the error is permanent.
_STICKY_CUDA_MARKERS = ("an illegal memory access was encountered",
                        "unspecified launch failure",
                        "device-side assert triggered",
                        "misaligned address",
                        "uncorrectable ecc error",
                        "an illegal instruction was encountered",
                        "hardware stack error")

#: Lowercased substrings that mark a resource-classed failure.  A CUDA
#: out-of-memory error ("CUDA out of memory. Tried to allocate ...")
#: matches ``out of memory``.
_RESOURCE_MARKERS = ("resource_exhausted", "resource exhausted",
                     "out of memory", "vmem", "allocation failure",
                     "failed to allocate")

#: 'OOM' only as a whole word ('OOM when allocating'), never inside
#: 'bloom', 'room' or 'zoom'.
_OOM_RE = re.compile(r"\boom\b")

_PREEMPTION_MARKERS = ("preempt", "maintenance event", "sigterm")


def classify(exc: BaseException) -> str:
    """Exception -> taxonomy class.  Typed faults carry their class; real
    exceptions classify by type, then by message markers (a sticky CUDA
    error before the others); anything unrecognised is ``transient``, so
    the plain ``retry=N`` budget retries any exception."""
    if isinstance(exc, FaultError):
        return exc.fault_class
    if isinstance(exc, KeyboardInterrupt):
        return "preemption"
    # Type beats message: a ValueError('bad bloom_bits') is a programming
    # error whatever its message contains.
    if isinstance(exc, _PERMANENT_TYPES):
        return "permanent"
    msg = str(exc).lower()
    if any(marker in msg for marker in _STICKY_CUDA_MARKERS):
        return "permanent"
    if any(marker in msg for marker in _RESOURCE_MARKERS) \
            or _OOM_RE.search(msg):
        return "resource"
    for marker in _PREEMPTION_MARKERS:
        if marker in msg:
            return "preemption"
    return "transient"


_FAULT_TYPES = {"transient": TransientFault, "resource": ResourceFault,
                "permanent": PermanentFault, "preemption": PreemptionFault}


def make_fault(fault_class: str, seam: str, index: int) -> FaultError:
    """The injected fault the plan fires."""
    cls = _FAULT_TYPES[fault_class]
    return cls(f"injected {fault_class} fault at seam {seam!r} "
               f"(crossing {index})", seam=seam, index=index, injected=True)


def peer_fault(fault_class: str, seam: str) -> FaultError:
    """What a rank acts on when another rank of its run failed at
    ``seam`` with ``fault_class`` and it did not: a typed fault of that
    class, not injected here (the ranks of one run agree on every
    failure, so every rank replays, degrades or stops alike)."""
    return _FAULT_TYPES[fault_class](
        f"a peer rank failed with a {fault_class} fault at seam {seam!r}",
        seam=seam)


# ---------------------------------------------------------------------------
# deterministic randomness
# ---------------------------------------------------------------------------


def unit_hash(*parts) -> float:
    """Deterministic uniform in [0, 1) from the SHA-256 of the joined
    parts: the one source of randomness here (firing decisions, class
    draws, backoff jitter), so a replay reproduces every decision."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


# ---------------------------------------------------------------------------
# failure policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """Per-class retry budgets and the backoff schedule.

    ``retry=N`` resolves to a policy with transient and resource budgets of
    N; permanent failures never retry, and preemption drains and
    checkpoints instead of retrying.

    Backoff before retry ``attempt`` (1-based) of a ``fault_class`` at a
    ``seam``::

        base   = min(backoff_max_s, backoff_base_s * backoff_factor**(attempt-1))
        jitter = 1 + jitter_frac * (2 * u - 1)      # u = unit_hash(...)
        sleep  = base * jitter

    with ``u`` from :func:`unit_hash` over ``(seed, seam, fault_class,
    attempt)``, so two runs of one plan back off identically.

    ``token_timeout_s``: wall-clock bound on a completion wait; a wait past
    it raises :class:`TokenTimeout` (transient) instead of stalling.
    ``None`` (default) waits as long as it takes.

    ``degrade``: whether a resource-classed exhaustion steps down the
    :data:`DEGRADATION_LADDER` before giving up.
    """

    transient_retries: int = 0
    resource_retries: int = 0
    permanent_retries: int = 0
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    jitter_frac: float = 0.1
    token_timeout_s: Optional[float] = None
    degrade: bool = True
    seed: int = 0

    def __post_init__(self) -> None:
        for name in ("transient_retries", "resource_retries",
                     "permanent_retries"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError(
                f"jitter_frac must be in [0, 1), got {self.jitter_frac}")
        if self.token_timeout_s is not None and self.token_timeout_s <= 0:
            raise ValueError(
                f"token_timeout_s must be > 0 (or None), "
                f"got {self.token_timeout_s}")

    @classmethod
    def resolve(cls, obj, retry: int = 0) -> "FailurePolicy":
        """Normalise ``Config.failure_policy`` (None, a dict or a policy):
        ``None`` maps the plain ``retry`` count onto the transient and
        resource budgets."""
        if obj is None:
            return cls(transient_retries=int(retry),
                       resource_retries=int(retry))
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(**obj)
        raise ValueError(
            f"failure_policy must be None, a FailurePolicy or a dict of "
            f"its fields, got {type(obj).__name__}")

    def budget(self, fault_class: str) -> int:
        """Retries allowed for one group or operation failing with this
        class.  Preemption never retries."""
        return {"transient": self.transient_retries,
                "resource": self.resource_retries,
                "permanent": self.permanent_retries,
                "preemption": 0}.get(fault_class, self.transient_retries)

    @property
    def dispatch_budget(self) -> int:
        """Window replay is armed when any retryable class has budget."""
        return max(self.transient_retries, self.resource_retries,
                   self.permanent_retries)

    def backoff_s(self, fault_class: str, attempt: int,
                  seam: str = "") -> float:
        """Deterministic backoff seconds before retry ``attempt``
        (1-based); see the class docstring."""
        if attempt < 1:
            return 0.0
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** (attempt - 1))
        if not self.jitter_frac:
            return round(base, 6)
        u = unit_hash(self.seed, seam, fault_class, attempt)
        return round(base * (1.0 + self.jitter_frac * (2.0 * u - 1.0)), 6)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def next_degrade(current: dict) -> Optional[tuple[str, str, str]]:
    """The first :data:`DEGRADATION_LADDER` step still applicable to a
    config summary ``{geometry, combiner, map_impl, sort_impl}`` (label
    values), or None when the ladder is exhausted:
    ``(step_name, field, degraded_value)``."""
    for step, field, degraded in DEGRADATION_LADDER:
        value = current.get(field)
        if value is not None and value != degraded:
            return (step, field, degraded)
    return None


def ladder_walk(current: dict) -> list:
    """Every step the ladder would take from ``current``, in order."""
    cur = dict(current)
    steps = []
    while True:
        nxt = next_degrade(cur)
        if nxt is None:
            return steps
        step, field, degraded = nxt
        cur[field] = degraded
        steps.append(step)


# ---------------------------------------------------------------------------
# fault plan
# ---------------------------------------------------------------------------


class FaultPlan:
    """A seeded, deterministic injection schedule over the named seams.

    Spec grammar (comma-separated ``key=value`` tokens)::

        seed=42,rate=0.05                      # random: 5% of crossings
        seed=7,rate=1.0,seams=dispatch,max=3   # only dispatch, 3 faults
        classes=transient+resource             # classes the draw picks from
        at=dispatch:3:resource                 # explicit one-shot events
        at=token-wait:1:preemption             # (repeatable)

    Random firing decides per crossing by ``unit_hash(seed, seam, index) <
    rate``; the class is a second deterministic draw.  Explicit ``at=``
    events fire at their ``(seam, crossing index)`` whatever the rate.
    ``process-kill`` and ``checkpoint-load`` never fire from the random rate
    unless named in ``seams=``.

    The plan carries run-time state (per-seam crossing counts, the fired
    events); a ``Config`` stores only the spec string, and
    :meth:`resolve` builds a fresh plan for each run.
    """

    def __init__(self, *, seed: int = 0, rate: float = 0.0,
                 seams: Optional[Iterable[str]] = None,
                 classes: Iterable[str] = ("transient",),
                 max_faults: int = 0,
                 events: Iterable[tuple[str, int, str]] = ()):
        self.seed = int(seed)
        self.rate = float(rate)
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        default_seams = tuple(s for s in SEAMS
                              if s not in ("process-kill", "checkpoint-load"))
        self.seams = tuple(seams) if seams is not None else default_seams
        for s in self.seams:
            if s not in SEAMS:
                raise ValueError(f"unknown seam {s!r} (expected one of "
                                 f"{', '.join(SEAMS)})")
        self.classes = tuple(classes)
        for c in self.classes:
            if c not in FAULT_CLASSES:
                raise ValueError(f"unknown fault class {c!r} (expected one "
                                 f"of {', '.join(FAULT_CLASSES)})")
        if not self.classes:
            raise ValueError("classes must not be empty")
        self.max_faults = int(max_faults)
        self.events: dict[tuple[str, int], str] = {}
        for seam, index, cls in events:
            if seam not in SEAMS:
                raise ValueError(f"unknown seam {seam!r} in event")
            if cls not in FAULT_CLASSES:
                raise ValueError(f"unknown fault class {cls!r} in event")
            self.events[(seam, int(index))] = cls
        # run-time state
        self.counts: dict[str, int] = {}
        self.fired: list[dict] = []

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the spec grammar (see the class docstring)."""
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(f"fault plan spec must be a non-empty string, "
                             f"got {spec!r}")
        kw: dict = {"events": []}
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(f"bad fault-plan token {token!r} "
                                 "(expected key=value)")
            key, value = token.split("=", 1)
            key, value = key.strip(), value.strip()
            try:
                if key == "seed":
                    kw["seed"] = int(value)
                elif key == "rate":
                    kw["rate"] = float(value)
                elif key == "max":
                    kw["max_faults"] = int(value)
                elif key == "seams":
                    kw["seams"] = tuple(value.split("+"))
                elif key == "classes":
                    kw["classes"] = tuple(value.split("+"))
                elif key == "at":
                    seam, index, fcls = value.split(":")
                    kw["events"].append((seam, int(index), fcls))
                else:
                    raise ValueError(f"unknown fault-plan key {key!r}")
            except ValueError:
                raise
            except Exception as e:  # split() shape errors
                raise ValueError(f"bad fault-plan token {token!r}: {e}")
        return cls(**kw)

    @classmethod
    def resolve(cls, spec) -> "Optional[FaultPlan]":
        """``Config.fault_plan`` -> a fresh plan; None stays None (the
        executor guards every seam check with one ``is not None``)."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        return cls.from_spec(spec)

    @classmethod
    def from_ledger(cls, records: Iterable[dict],
                    run_id: Optional[str] = None) -> "FaultPlan":
        """The plan a run executed, rebuilt from its ``fault`` records
        (``injected: true`` only: classified real faults are
        observations, not schedule)."""
        events = []
        for rec in _iter_injected_faults(records, run_id):
            seam, index = rec.get("seam"), rec.get("index")
            fcls = rec.get("fault_class")
            if seam in SEAMS and index is not None and fcls in FAULT_CLASSES:
                events.append((seam, int(index), fcls))
        return cls(events=events)

    @property
    def spec(self) -> str:
        """Canonical spec string (round-trips through :meth:`from_spec`)."""
        parts = [f"seed={self.seed}"]
        if self.rate:
            parts.append(f"rate={self.rate}")
            parts.append("seams=" + "+".join(self.seams))
            parts.append("classes=" + "+".join(self.classes))
        if self.max_faults:
            parts.append(f"max={self.max_faults}")
        for (seam, index), fcls in sorted(self.events.items()):
            parts.append(f"at={seam}:{index}:{fcls}")
        return ",".join(parts)

    def decide(self, seam: str, index: int) -> Optional[str]:
        """The fault class crossing ``(seam, index)`` fires, or None (no
        state change).  Explicit events win; then the seeded rate over the
        plan's seams, bounded by ``max_faults``."""
        explicit = self.events.get((seam, index))
        if explicit is not None:
            return explicit
        if not self.rate or seam not in self.seams:
            return None
        if self.max_faults and len(self.fired) >= self.max_faults:
            return None
        if unit_hash(self.seed, seam, index) >= self.rate:
            return None
        draw = unit_hash(self.seed, "class", seam, index)
        return self.classes[int(draw * len(self.classes)) % len(self.classes)]

    def check(self, seam: str) -> Optional[FaultError]:
        """One seam crossing: count it, and return the typed fault to raise
        when the plan says this crossing fails (None otherwise)."""
        index = self.counts.get(seam, 0)
        self.counts[seam] = index + 1
        fcls = self.decide(seam, index)
        if fcls is None:
            return None
        self.fired.append({"seam": seam, "index": index,
                           "fault_class": fcls})
        return make_fault(fcls, seam, index)


def _iter_injected_faults(records: Iterable[dict],
                          run_id: Optional[str]) -> Iterable[dict]:
    """The injected ``fault`` records of one run, in order: the named
    ``run_id``, or the first run found (records without a ``run_id`` ride
    along)."""
    chosen = run_id
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "fault" \
                or not rec.get("injected"):
            continue
        if chosen is None:
            chosen = rec.get("run_id")
        if chosen is not None and rec.get("run_id") not in (None, chosen):
            continue
        yield rec


def fired_sequence(records: Iterable[dict],
                   run_id: Optional[str] = None) -> list:
    """The ``(seam, index, fault_class)`` of a run's injected ``fault``
    records, in order."""
    return [(rec.get("seam"), rec.get("index"), rec.get("fault_class"))
            for rec in _iter_injected_faults(records, run_id)]
