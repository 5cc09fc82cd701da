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
  (:attr:`OpTrace.flags`), so a pass can name the branches not taken, and
  a read can be given other values (:func:`record`'s ``overrides``) to
  record the branch it did not take.

Collectives (the ``c10d`` ops of ``torch.distributed``) are ``collective``
nodes: the op, the process group as the mesh names it
(:class:`GroupInfo`), the link level it rides and the bytes this rank
sends.  A fleet twin (``analysis_fleet``) is traced on rank 0 of an
in-process world of ``processes x local_devices`` ranks over
``torch.distributed``'s ``fake`` backend (:func:`fake_world`): its
collectives record and move nothing, so their outputs are zeros and a
trace holds the branch those zeros take.

A hook that raises is recorded as a :class:`TraceFailure` value instead of
propagating, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import weakref
from typing import Any, Optional

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
    :class:`...ops.cuda.plans.KernelPlan`), ``'collective'`` (a ``c10d``
    op; ``attrs`` name its group, level, size and bytes), ``'host_read'``
    or ``'host_copy'`` (a declared sync).  ``operands`` and ``results`` are
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

    def attr(self, key: str, default=None):
        return dict(self.attrs).get(key, default)


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """A process group as the mesh names it: ``label`` its axis name
    (``data``, ``replica``, ``world`` for the flattened mesh, ``control``
    for the agreements' gloo groups, ``<unknown>`` for a group the mesh
    does not hold), the mesh axes it spans (outermost first), its size
    and the link level it rides (``nvlink`` within a node, ``net``
    across nodes)."""

    label: str
    axes: tuple
    size: int
    level: str


@dataclasses.dataclass
class OpTrace:
    """One program's recording: its nodes in order, the host values its
    declared reads returned (``flags``, one list a read), and the value
    ids of what it returned (``outputs``)."""

    hook: str
    nodes: list
    flags: list
    outputs: tuple = ()
    #: ``collectives.bytes_sent`` counted while the program ran.
    bytes_sent: int = 0
    #: The branches of its rank-local reads: ``(read index, the program
    #: recorded with that read's values flipped)`` (see
    #: :func:`rank_local_reads`).
    branches: tuple = ()

    def signature(self) -> list:
        return [n.signature() for n in self.nodes]

    @property
    def kernels(self) -> list:
        return [n for n in self.nodes if n.kind == "kernel"]

    @property
    def host_syncs(self) -> list:
        return [n for n in self.nodes if n.kind in ("host_read",
                                                     "host_copy")]

    @property
    def collectives(self) -> list:
        return [n for n in self.nodes if n.kind == "collective"]


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


#: Where a ``c10d`` op keeps its output and input tensors: argument
#: positions ``(outputs, inputs)`` (None: none).  An op not listed reads
#: and writes every tensor it is given.
_C10D_ARGS = {
    "allreduce_": (0, 0), "allreduce_coalesced_": (0, 0),
    "allgather_": (0, 1), "_allgather_base_": (0, 1),
    "allgather_into_tensor_coalesced_": (0, 1),
    "reduce_scatter_": (0, 1), "_reduce_scatter_base_": (0, 1),
    "alltoall_": (0, 1), "alltoall_base_": (0, 1),
    "broadcast_": (0, 0), "send": (None, 0), "recv_": (0, None),
}


def sent_bytes(op: str, payload: int, size: int) -> int:
    """The bytes this rank sends for one collective of ``payload`` input
    bytes over ``size`` ranks: what ``parallel/collectives.py`` adds to
    ``collectives.bytes_sent`` for it."""
    if size <= 1 or op == "recv_":
        return 0
    if op in ("alltoall_", "alltoall_base_", "reduce_scatter_",
              "_reduce_scatter_base_"):
        return (size - 1) * (payload // size)
    if op in ("send", "broadcast_"):
        return payload
    return (size - 1) * payload


class Recorder(TorchDispatchMode):
    """Logs every aten op dispatched while active (see the module note);
    install it with :func:`record`.  ``groups`` maps each process group
    of the mesh to its :class:`GroupInfo`; ``overrides`` maps the index of
    a declared host read to a function of the values it read, whose
    result the program sees instead; with ``zero_collectives`` a
    collective's outputs are zeroed (a fake world's collectives write
    nothing)."""

    def __init__(self, groups: Optional[dict] = None,
                 overrides: Optional[dict] = None,
                 zero_collectives: bool = False):
        super().__init__()
        self.nodes: list = []
        self.flags: list = []
        self.groups = groups or {}
        self.overrides = overrides or {}
        self.zero_collectives = zero_collectives
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
        if func.namespace == "c10d":
            self._collective(func, args)
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

    def _collective(self, func, args) -> None:
        """One ``collective`` node for a ``c10d`` op: its process group as
        the mesh names it and the bytes this rank sends."""
        import torch.distributed as dist

        op = str(func).split(".")[1]
        pg = next((torch._C._distributed_c10d.ProcessGroup.unbox(a)
                   for a in args if isinstance(a, torch._C.ScriptObject)),
                  None)
        info = self.groups.get(pg) if pg is not None else None
        if info is None:
            size = pg.size() if pg is not None else 1
            info = GroupInfo("<unknown>", (), size, "")
        where = _C10D_ARGS.get(op)
        if where is None:
            outs = ins = _tensors(args)
        else:
            outs = [] if where[0] is None else _tensors(args[where[0]])
            ins = [] if where[1] is None else _tensors(args[where[1]])
        payload = sum(t.numel() * t.element_size() for t in ins)
        ranks = tuple(dist.get_process_group_ranks(pg)) \
            if pg is not None and info.label == "<unknown>" else ()
        if self.zero_collectives:
            self._quiet += 1
            try:
                for t in outs:
                    t.zero_()
            finally:
                self._quiet -= 1
        self.nodes.append(Node(
            "collective", str(func), _meta(ins), _meta(outs),
            attrs=(("group", info.label), ("axes", info.axes),
                   ("size", info.size), ("level", info.level),
                   ("ranks", ranks), ("payload_bytes", payload),
                   ("sent_bytes", sent_bytes(op, payload, info.size))),
            ins=self._ids(ins), outs=self._fresh(outs),
            location=_location()))

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
            change = self.overrides.get(len(self.flags))
            if change is not None:
                values = change(values)
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


def _bytes_sent() -> int:
    from mapreduce_tpu_torch.obs import registry

    return int(sum(v for k, v in registry.get_registry().snapshot()[
        "counters"].items() if k.startswith("collectives.bytes_sent")))


def record(hook: str, fn, *args, groups: Optional[dict] = None,
           overrides: Optional[dict] = None,
           zero_collectives: bool = False) -> tuple[Any, OpTrace]:
    """Run ``fn(*args)`` under a fresh recorder: ``(its value, its
    OpTrace)``.  Only one recorder is active at a time.  ``groups``,
    ``overrides`` and ``zero_collectives`` are :class:`Recorder`'s."""
    if tracepoints.RECORDER is not None:
        raise RuntimeError("a recorder is already active")
    rec = Recorder(groups, overrides, zero_collectives)
    sent0 = _bytes_sent()
    tracepoints.RECORDER = rec
    try:
        with rec:
            out = fn(*args)
    finally:
        tracepoints.RECORDER = None
    return out, OpTrace(hook, rec.nodes, rec.flags,
                        rec._ids(_tensors(out)), _bytes_sent() - sent0)


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


def engine_for(job: Any, device, mesh=None):
    """The Engine the analysis records: the job's declared stats mode
    (``analysis_data_stats``) and merge strategy
    (``analysis_merge_strategy``), on ``mesh`` (a fleet's fake world), or
    on one rank with no world (a two-level strategy flattened)."""
    from mapreduce_tpu_torch.parallel.mapreduce import Engine
    from mapreduce_tpu_torch.parallel.mesh import DataAxis

    strategy = getattr(job, "analysis_merge_strategy", "tree")
    if mesh is None:
        mesh = DataAxis(device=device)
        strategy = _FLAT.get(strategy, strategy)
    return Engine(job, device, mesh=mesh,
                  data_stats=getattr(job, "analysis_data_stats", False),
                  merge_strategy=strategy)


def _level(outer: bool, processes: int) -> str:
    return "net" if outer and processes > 1 else "nvlink"


@contextlib.contextmanager
def fake_world(processes: int, local_devices: int, device, rank: int = 0):
    """An in-process world of ``processes x local_devices`` ranks over
    ``torch.distributed``'s ``fake`` backend, as rank ``rank``: yields
    ``(mesh, groups)``, the mesh a fleet of that shape runs
    (``parallel/mesh.py``: a ``DataAxis`` of P ranks for P x 1, a
    ``two_level_mesh(P, L)`` otherwise) and each of its process groups'
    :class:`GroupInfo`.  Collectives over it record and move nothing.  The
    world is torn down after, and the mesh module's group caches
    cleared.  Refuses to run beside a real world."""
    import torch.distributed as dist

    from mapreduce_tpu_torch.parallel import mesh as mesh_mod

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "a torch.distributed world is already initialised in this "
            "process: the fleet's fake world is not built beside it "
            "(analyse the fleet twins in a process of their own)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = processes * local_devices
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        dev = torch.device(device)
        if local_devices > 1:
            mesh = mesh_mod.two_level_mesh(processes, local_devices,
                                           device=dev)
            names = (mesh.outer.name, mesh.inner.name)
            groups = {
                mesh.outer.group: GroupInfo(names[0], names[:1], processes,
                                            _level(True, processes)),
                mesh.inner.group: GroupInfo(names[1], names[1:],
                                            local_devices,
                                            _level(False, processes)),
                mesh.group: GroupInfo("world", names, world,
                                      _level(True, processes))}
        else:
            mesh = mesh_mod.data_mesh(processes, device=dev)
            groups = {mesh.group: GroupInfo(mesh.name, (mesh.name,),
                                            processes,
                                            _level(True, processes))}
        groups.pop(None, None)
        for ranks, group in mesh_mod._CONTROL.items():
            groups[group] = GroupInfo("control", (), len(ranks), "net")
        yield mesh, groups
    finally:
        dist.destroy_process_group()
        mesh_mod._GROUPS.clear()
        mesh_mod._CONTROL.clear()


def trace_engine(job: Any, device=None, chunk: torch.Tensor | None = None,
                 fleet: Optional[dict] = None) -> dict:
    """Record the Engine's ``step`` (map + combine of the sample chunk into
    the initial state, as chunk 0) and ``finish`` (merge + finalize of the
    stepped state).  On one rank with no world; with ``fleet``
    (``{"processes": P, "local_devices": L}``) on rank 0 of a
    :func:`fake_world` of that shape.  Returns ``{'step'|'finish': OpTrace
    | TraceFailure}``."""
    dev = _device_of(job, device)
    if not fleet:
        return _trace_engine(job, dev, chunk, None, {})
    try:
        world = fake_world(int(fleet.get("processes", 1)),
                           int(fleet.get("local_devices", 1)), dev)
        with world as (mesh, groups):
            return _trace_engine(job, dev, chunk, mesh, groups)
    except Exception as e:
        f = TraceFailure.of("engine", e)
        return {"step": f, "finish": f}


def _trace_engine(job, dev, chunk, mesh, groups: dict) -> dict:
    kw = {"groups": groups, "zero_collectives": mesh is not None}
    try:
        eng = engine_for(job, dev, mesh)
        state = eng.init_states()
        if chunk is None:
            chunk = sample_chunk(job, dev)
    except Exception as e:
        f = TraceFailure.of("engine", e)
        return {"step": f, "finish": f}
    out: dict[str, Any] = {}
    try:
        stepped, out["step"] = record("step", eng.step, state, chunk, 0,
                                      **kw)
    except Exception as e:
        out["step"] = TraceFailure.of("step", e)
        out["finish"] = TraceFailure.of("finish", RuntimeError(
            f"step failed: {e}"))
        return out
    if eng.data_stats:
        stepped = stepped[0]
    try:
        out["finish"] = record("finish", eng.finish, stepped, **kw)[1]
    except Exception as e:
        out["finish"] = TraceFailure.of("finish", e)
        return out
    if mesh is None:
        return out
    # The other branch of each rank-local read that a collective follows
    # (the collective-cost pass's divergence lint), recorded while the
    # world stands.
    runs = {"step": (eng.step, state, chunk, 0), "finish": (eng.finish,
                                                           stepped)}
    for hook, program in out.items():
        branches = []
        for r in rank_local_reads(program, mesh.size):
            try:
                alt = record(hook, *runs[hook], overrides={r: flipped},
                             **kw)[1]
            except Exception as e:
                alt = TraceFailure.of(hook, e)
            branches.append((r, alt))
        out[hook] = dataclasses.replace(program, branches=tuple(branches))
    return out


def flipped(values: list) -> list:
    """A read's values on the branch it did not take: each zero one, each
    nonzero zero."""
    return [0 if v else 1 for v in values]


#: Collectives whose outputs are the same on every rank they cover.
_UNIFORMING = frozenset({"allreduce_", "allreduce_coalesced_", "allgather_",
                         "_allgather_base_",
                         "allgather_into_tensor_coalesced_", "broadcast_"})


def rank_local_reads(program: OpTrace, world: int) -> list:
    """Indices of the program's declared host reads whose value is this
    rank's own and that a collective follows: a rank may branch on such a
    value where its peers take the other branch.  A value is this rank's
    own when it depends on an input the program did not make (the job's
    state, the chunk) other than through a collective over the whole mesh
    (``world`` ranks) whose result every rank shares (an all-reduce, an
    all-gather, a broadcast; an agreement over the control group is one)."""
    varying: set = set()
    made: set = set()
    reads = []
    n_read = 0
    for i, node in enumerate(program.nodes):
        own = any(v in varying or v not in made for v in node.ins)
        if node.kind == "host_read":
            if own and any(n.kind == "collective"
                           for n in program.nodes[i + 1:]):
                reads.append(n_read)
            n_read += 1
            continue
        made.update(node.outs)
        if node.kind == "collective" and node.name.split(".")[1] in \
                _UNIFORMING and node.attr("size") == world \
                and node.attr("group") != "<unknown>":
            continue
        if own:
            varying.update(node.outs)
    return reads


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
