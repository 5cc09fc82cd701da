"""Op traces: a job's hooks and the Engine's step/finish, as recorded ops.

Counterpart of :mod:`mapreduce_tpu.analysis.trace`.  Where the JAX package
traces each hook to a jaxpr under abstract inputs, eager PyTorch has no
program before it runs: the port RUNS each hook once, concretely, over a
seeded sample chunk (:func:`random_text`, the JAX package's generator) on
the analysis device, under a :class:`Recorder` (a ``TorchDispatchMode``)
that logs every aten op with its name, its operand and result shapes and
dtypes, and whether it is a view.  Three things an eager recording does
not see the way a jaxpr does, and what the recorder does about each:

* **kernels**: the hand-written CUDA kernels are reached through ctypes,
  and on the CPU their wrappers run the plain version (dozens of aten
  ops).  Each wrapper enters :func:`...ops.tracepoints.kernel_scope`, and
  the recorder logs ONE kernel node (operands, results, launch plan) and
  drops the ops inside, so a CPU trace is the program the card runs;
* **host syncs**: ``.tolist()`` reaches no aten op on the CPU.  The step's
  intended syncs go through :func:`...ops.tracepoints.host_read` and
  :func:`...ops.tracepoints.host_scalars`, logged as host-read and
  host-copy nodes; an op that syncs anywhere else
  (:data:`SYNCING_OPS`) is an undeclared host read (the host-sync pass);
* **branches**: a jaxpr ``cond`` holds both branches; an eager trace holds
  the one the sample took.  The values every host read returned are kept
  (:attr:`OpTrace.flags`), so a pass can name the branches not taken.

A hook that raises is recorded as a :class:`TraceFailure` value instead of
propagating, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mapreduce_tpu_torch.ops import tracepoints

#: Ops that wait for the card to hand the host a value (or a shape): on the
#: card each is a device-to-host sync.
SYNCING_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.nonzero.default",
    "aten.masked_select.default", "aten.repeat_interleave.Tensor",
    "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default", "aten.bincount.default",
    "aten.equal.default", "aten.is_nonzero.default",
    "aten.allclose.default"})

_DETACH = torch.ops.aten.detach.default
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_DIRS = (os.path.join(_PACKAGE, "analysis"),)
_SKIP_FILES = (os.path.join(_PACKAGE, "ops", "tracepoints.py"),)


@dataclasses.dataclass(frozen=True)
class TraceFailure:
    """A hook that raised during tracing: the exception, preserved as data."""

    hook: str
    error_type: str
    error: str

    @classmethod
    def of(cls, hook: str, e: Exception) -> "TraceFailure":
        return cls(hook=hook, error_type=type(e).__name__, error=str(e))


@dataclasses.dataclass(frozen=True)
class Node:
    """One recorded node.

    ``kind`` is ``'op'`` (an aten op, ``name`` its overload), ``'kernel'``
    (a kernel wrapper's launch, ``name`` the wrapper, ``plan`` its
    :class:`...ops.cuda.plans.KernelPlan`), ``'host_read'`` or
    ``'host_copy'`` (a declared sync).  ``operands`` and ``results`` are
    ``(shape, dtype)`` pairs of the tensors in and out; ``attrs`` the
    arguments a pass reads (``index_put``'s ``accumulate``); ``ins`` and
    ``outs`` are the tensors' value ids (dataflow, not part of
    :meth:`signature`)."""

    kind: str
    name: str
    operands: tuple
    results: tuple
    is_view: bool = False
    plan: Any = None
    attrs: tuple = ()
    ins: tuple = ()
    outs: tuple = ()
    location: str = ""

    @property
    def syncs(self) -> bool:
        """Waits for the card: a declared sync or a syncing op."""
        return self.kind in ("host_read", "host_copy") \
            or (self.kind == "op" and self.name in SYNCING_OPS)

    def signature(self) -> tuple:
        """What a CPU trace and a card trace must agree on."""
        plan = None if self.plan is None else repr(self.plan.as_dict())
        return (self.kind, self.name, self.operands, self.results,
                self.is_view, plan, self.attrs)


@dataclasses.dataclass
class OpTrace:
    """One program's recording: its nodes in order, the host values its
    declared reads returned (``flags``, one list a read), and the value
    ids of what it returned (``outputs``)."""

    hook: str
    nodes: list
    flags: list
    outputs: tuple = ()

    def signature(self) -> list:
        return [n.signature() for n in self.nodes]

    @property
    def kernels(self) -> list:
        return [n for n in self.nodes if n.kind == "kernel"]

    @property
    def host_syncs(self) -> list:
        return [n for n in self.nodes if n.kind in ("host_read",
                                                     "host_copy")]


def _tensors(tree) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    out = []

    def rec(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for v in x:
                rec(v)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                rec(x[k])

    rec(tree)
    return out


def _meta(ts) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in ts)


def _location() -> str:
    """The innermost frame of the port outside the analysis itself."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE) and not path.startswith(_SKIP_DIRS) \
                and path not in _SKIP_FILES:
            return f"{os.path.basename(path)}:{f.f_lineno}"
        f = f.f_back
    return ""


class _KernelScope:
    """An active recorder's scope of one kernel wrapper."""

    def __init__(self, rec: "Recorder", name: str, plan, operands):
        self.rec, self.name, self.plan, self.operands = rec, name, plan, \
            operands
        self.recording = False

    def __enter__(self):
        # A wrapper called from inside another's scope is part of it.
        self.recording = self.rec._quiet == 0
        self.rec._quiet += 1
        return self

    def __exit__(self, *exc) -> bool:
        self.rec._quiet -= 1
        return False

    def result(self, out):
        if self.recording:
            ins = _tensors(self.operands)
            outs = _tensors(out)
            self.rec.nodes.append(Node(
                "kernel", self.name, _meta(ins), _meta(outs),
                plan=self.plan(), ins=self.rec._ids(ins),
                outs=self.rec._fresh(outs), location=_location()))
        return out


class Recorder(TorchDispatchMode):
    """Logs every aten op dispatched while active (see the module note);
    install it with :func:`record`."""

    def __init__(self):
        super().__init__()
        self.nodes: list = []
        self.flags: list = []
        self._quiet = 0
        self._next = 0
        self._vids: dict = {}

    # -- value ids -----------------------------------------------------------

    def _fresh(self, ts) -> tuple:
        """New value ids for tensors a node defines.  The tensors are
        tracked by weak reference: the recorder keeps no tensor alive and
        changes none."""
        ids = []
        for t in ts:
            self._next += 1
            self._vids[id(t)] = (weakref.ref(t), self._next)
            ids.append(self._next)
        return tuple(ids)

    def _ids(self, ts) -> tuple:
        """The value ids of tensors a node reads (fresh for a tensor made
        outside the recording)."""
        ids = []
        for t in ts:
            tag = self._vids.get(id(t))
            if tag is None or tag[0]() is not t:
                ids.extend(self._fresh([t]))
            else:
                ids.append(tag[1])
        return tuple(ids)

    # -- the dispatch mode ---------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # A detach is Python-object bookkeeping (a factory's result handed
        # back through the mode) and a profiler op marks a span: neither is
        # device work, so both are left out.
        if self._quiet or func is _DETACH or func.namespace == "profiler":
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = str(func)
        attrs = ()
        if name.startswith("aten.index_put"):
            attrs = (("accumulate", bool(
                args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                         False))),)
        self.nodes.append(Node("op", name, _meta(ins), _meta(outs),
                       is_view=bool(getattr(func, "is_view", False)),
                       attrs=attrs, ins=self._ids(ins),
                       outs=self._fresh(outs), location=_location()))
        return out

    # -- the trace points (ops/tracepoints.py) -------------------------------

    def kernel_scope(self, name: str, plan, operands) -> _KernelScope:
        return _KernelScope(self, name, plan, operands)

    def host_read(self, flags: torch.Tensor, read) -> list:
        quiet = self._quiet
        self._quiet += 1
        try:
            values = flags.tolist() if read is None else read(flags)
        finally:
            self._quiet -= 1
        if not quiet:
            self.flags.append(list(values))
            self.nodes.append(Node("host_read", "host_read", _meta([flags]), (),
                           ins=self._ids([flags]), location=_location()))
        return values

    def host_copy(self, values, device) -> torch.Tensor:
        quiet = self._quiet
        self._quiet += 1
        try:
            t = torch.tensor(values, dtype=torch.int64, device=device)
        finally:
            self._quiet -= 1
        if not quiet:
            self.nodes.append(Node("host_copy", "host_scalars", (), _meta([t]),
                           outs=self._fresh([t]), location=_location()))
        return t


def record(hook: str, fn, *args) -> tuple[Any, OpTrace]:
    """Run ``fn(*args)`` under a fresh recorder: ``(its value, its
    OpTrace)``.  Only one recorder is active at a time."""
    if tracepoints.RECORDER is not None:
        raise RuntimeError("a recorder is already active")
    rec = Recorder()
    tracepoints.RECORDER = rec
    try:
        with rec:
            out = fn(*args)
    finally:
        tracepoints.RECORDER = None
    return out, OpTrace(hook, rec.nodes, rec.flags,
                        rec._ids(_tensors(out)))


# -- the sample input ---------------------------------------------------------


def _chunk_bytes_for(job: Any, default: int = 1 << 10) -> int:
    """A chunk size the job's backend accepts (the kernel path needs its
    minimum chunk), the JAX package's rule."""
    config = getattr(job, "config", None)
    if config is None:
        return default
    n = min(int(config.chunk_bytes), 1 << 16)
    if getattr(config, "backend", None) == "pallas":
        n = max(n, config.pallas_min_chunk)
    return max(128, (n // 128) * 128)


def random_text(rng: np.random.Generator, n_bytes: int) -> np.ndarray:
    """Random word-ish bytes (lowercase tokens, space/newline separated),
    with a random NUL-padded tail -- chunks of a real stream end padded,
    and unequal payload sizes keep sampled states distinguishable (a
    property check on three identical states proves nothing).  The JAX
    package's generator, draw for draw."""
    out = np.full((n_bytes,), 0x20, dtype=np.uint8)
    i = 0
    while i < n_bytes:
        length = int(rng.integers(1, 9))
        word = rng.integers(97, 123, size=length, dtype=np.uint8)
        end = min(i + length, n_bytes)
        out[i:end] = word[: end - i]
        i = end + 1
        if i - 1 < n_bytes and rng.random() < 0.2:
            out[i - 1] = 0x0A
    tail = int(rng.integers(0, max(n_bytes // 4, 2)))
    if tail:
        out[n_bytes - tail:] = 0
    return out


#: The sample chunk's seed (the JAX package's ``sample_states`` seed).
SEED = 20260803


def sample_chunk(job: Any, device, n_bytes: int | None = None,
                 seed: int = SEED) -> torch.Tensor:
    """The traces' input: a seeded :func:`random_text` chunk of the job's
    analysis size, on ``device``."""
    n = _chunk_bytes_for(job) if n_bytes is None else n_bytes
    return torch.from_numpy(random_text(np.random.default_rng(seed), n)) \
        .to(device)


def _device_of(job: Any, device):
    from mapreduce_tpu_torch.runtime.platform import resolve_device

    return resolve_device(device if device is not None
                          else getattr(job, "device", None))


def state_shape(job: Any):
    """The job's initial state (its tensor leaves carry the shapes and
    dtypes), or a :class:`TraceFailure`."""
    try:
        return job.init_state()
    except Exception as e:
        return TraceFailure.of("init_state", e)


def trace_hooks(job: Any, device=None, chunk: torch.Tensor | None = None
                ) -> dict:
    """Record each protocol hook over the sample chunk.

    Returns ``{hook: OpTrace | TraceFailure}`` for ``init_state``,
    ``map_chunk``, ``combine``, ``merge``, ``finalize``: ``combine`` folds
    ``map_chunk``'s update into the initial state, ``merge`` merges that
    state with itself and ``finalize`` finalizes it.  Axis-aware maps
    (``map_chunk_sharded``) are recorded as part of the engine step
    instead (:func:`trace_engine`)."""
    dev = _device_of(job, device)
    if chunk is None:
        chunk = sample_chunk(job, dev)
    out: dict[str, Any] = {}

    def attempt(hook, fn, *args):
        try:
            value, out[hook] = record(hook, fn, *args)
            return value
        except Exception as e:
            out[hook] = TraceFailure.of(hook, e)
            return None

    init = attempt("init_state", job.init_state)
    if isinstance(out["init_state"], TraceFailure):
        for hook in ("map_chunk", "combine", "merge", "finalize"):
            out[hook] = TraceFailure.of(hook, RuntimeError(
                f"init_state failed: {out['init_state'].error}"))
        return out
    upd = attempt("map_chunk", job.map_chunk, chunk, 0)
    if isinstance(out["map_chunk"], TraceFailure):
        out["combine"] = TraceFailure.of("combine", RuntimeError(
            f"map_chunk failed: {out['map_chunk'].error}"))
        st = init
    else:
        st = attempt("combine", job.combine, init, upd)
        if isinstance(out["combine"], TraceFailure):
            st = init
    attempt("merge", job.merge, st, st)
    attempt("finalize", job.finalize, st)
    return out


#: The one-axis strategy a two-level merge runs as on one rank.
_FLAT = {"hier-tree-tree": "tree", "hier-kr-tree": "keyrange"}


def engine_for(job: Any, device):
    """The Engine the analysis records: one rank, no world; the job's
    declared stats mode (``analysis_data_stats``) and merge strategy
    (``analysis_merge_strategy``, a two-level one flattened)."""
    from mapreduce_tpu_torch.parallel.mapreduce import Engine
    from mapreduce_tpu_torch.parallel.mesh import DataAxis

    strategy = getattr(job, "analysis_merge_strategy", "tree")
    return Engine(job, device, mesh=DataAxis(device=device),
                  data_stats=getattr(job, "analysis_data_stats", False),
                  merge_strategy=_FLAT.get(strategy, strategy))


def trace_engine(job: Any, device=None, chunk: torch.Tensor | None = None
                 ) -> dict:
    """Record the Engine's ``step`` (map + combine of the sample chunk into
    the initial state, as chunk 0) and ``finish`` (merge + finalize of the
    stepped state) on an axis of one rank.  Returns ``{'step'|'finish':
    OpTrace | TraceFailure}``."""
    dev = _device_of(job, device)
    try:
        eng = engine_for(job, dev)
        state = eng.init_states()
        if chunk is None:
            chunk = sample_chunk(job, dev)
    except Exception as e:
        f = TraceFailure.of("engine", e)
        return {"step": f, "finish": f}
    out: dict[str, Any] = {}
    try:
        stepped, out["step"] = record("step", eng.step, state, chunk, 0)
    except Exception as e:
        out["step"] = TraceFailure.of("step", e)
        out["finish"] = TraceFailure.of("finish", RuntimeError(
            f"step failed: {e}"))
        return out
    if eng.data_stats:
        stepped = stepped[0]
    try:
        out["finish"] = record("finish", eng.finish, stepped)[1]
    except Exception as e:
        out["finish"] = TraceFailure.of("finish", e)
    return out


def _check_chunk(job: Any, n_bytes: int) -> None:
    """Refuse a sample chunk the job's config refuses (the kernel path's
    minimum chunk), as the job's own streamed run would."""
    config = getattr(job, "config", None)
    if config is not None and dataclasses.is_dataclass(config):
        dataclasses.replace(config, chunk_bytes=n_bytes)


def sample_states(job: Any, device=None, n: int = 3,
                  chunk_bytes: int = 1 << 10, seed: int = SEED
                  ) -> tuple[list, TraceFailure | None]:
    """Concrete, *reachable* states for randomized property checks: each
    is ``init_state`` folded with one random text chunk through a one-rank
    Engine step.  Merge must be associative and commutative only on states
    the map/combine machinery can produce.  Returns ``(states, None)``, or
    ``([], TraceFailure)`` when the job cannot run the sample chunk."""
    rng = np.random.default_rng(seed)
    cb = max(128, (int(chunk_bytes) // 128) * 128)
    try:
        dev = _device_of(job, device)
        _check_chunk(job, cb)
        eng = engine_for(job, dev)
        states = []
        for i in range(n):
            chunk = torch.from_numpy(random_text(rng, cb)).to(dev)
            st = eng.step(eng.init_states(), chunk, i)
            states.append(st[0] if eng.data_stats else st)
        return states, None
    except Exception as e:
        return [], TraceFailure.of("sample_states", e)


# -- state-leaf walking -----------------------------------------------------


def named_leaves(tree: Any, prefix: str = "state") -> list[tuple[str, Any]]:
    """Flatten a state to ``(dotted.path, leaf)`` pairs, keeping NamedTuple
    field names (the overflow lint's lane-pair matching needs them)."""
    out: list[tuple[str, Any]] = []

    def rec(x, path):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for name in x._fields:
                rec(getattr(x, name), f"{path}.{name}")
        elif isinstance(x, dict):
            for k in sorted(x):
                rec(x[k], f"{path}[{k!r}]")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                rec(v, f"{path}[{i}]")
        else:
            out.append((path, x))

    rec(tree, prefix)
    return out
