"""Carry state across from the JAX package: count tables, job states,
combiner caches and configs.

A JAX ``CountTable`` is a NamedTuple of uint32 arrays; the port holds the
same fields as int64 tensors with values in ``[0, 2**32)``.  These helpers
move one across as numpy arrays, so both packages can start from one state
and their results compare field by field; :func:`state_from_numpy` and
:func:`state_to_numpy` do the same for the composite states of the n-gram
and sketch jobs (``NGramState``, ``GramCarry``, registers, Count-Min
sketches, ``BatchedSketchState``), the staged word count's
``BufferedTableState``, grep's ``GrepState`` and the sample's
``ReservoirState``.  :func:`state_to_leaves` gives a state the layout of a
one-device JAX engine state (the checkpoint's leaves), so a snapshot from
either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from mapreduce_tpu_torch.config import Config, _not_ported
from mapreduce_tpu_torch.ops.cuda.tokenize import CombinerCache
from mapreduce_tpu_torch.ops.table import CountTable
from mapreduce_tpu_torch.runtime.platform import resolve_device


def table_from_numpy(fields: Mapping[str, Any], device=None) -> CountTable:
    """A port table from a JAX table's fields (``{name: uint32 array}``,
    e.g. ``{f: np.asarray(getattr(t, f)) for f in t._fields}``)."""
    dev = resolve_device(device)
    missing = set(CountTable._fields) - set(fields)
    if missing:
        raise ValueError(f"table fields missing: {sorted(missing)}")
    return CountTable(**{
        f: torch.as_tensor(np.asarray(fields[f], dtype=np.uint32)
                           .astype(np.int64), device=dev)
        for f in CountTable._fields})


def table_to_numpy(table: CountTable) -> dict[str, np.ndarray]:
    """The table's fields as uint32 numpy arrays (the JAX layout)."""
    return {f: getattr(table, f).cpu().numpy().astype(np.uint32)
            for f in CountTable._fields}


def table_to_leaves(table: CountTable) -> list[np.ndarray]:
    """The table as a one-device JAX engine state's leaves: one uint32
    array per field, in ``CountTable`` field order, each with a leading
    device axis of 1 (:func:`state_to_leaves` of a table)."""
    return state_to_leaves(table)


def leaves_to_table(leaves, device=None) -> CountTable:
    """A port table from a one-device engine state's leaves (see
    :func:`table_to_leaves`)."""
    if len(leaves) != len(CountTable._fields):
        raise ValueError(f"a CountTable has {len(CountTable._fields)} "
                         f"leaves, got {len(leaves)}")
    return table_from_numpy({f: np.asarray(leaf)[0] for f, leaf
                             in zip(CountTable._fields, leaves)}, device)


def _state_classes() -> dict:
    """The port's state NamedTuples by name, the JAX package's names."""
    from mapreduce_tpu_torch.models import grep, sample
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.ops import ngram

    return {cls.__name__: cls for cls in (
        CountTable, ngram.GramCarry, ngram.ChunkSummary, wc.NGramState,
        wc.TopKTable, wc.SketchedState, wc.FreqSketchedState,
        wc.BatchedSketchState, wc.BufferedTableState, grep.GrepState,
        sample.ReservoirState)}


def state_from_numpy(state, device=None):
    """A port state from a JAX one of the same structure: a ``CountTable``,
    ``GramCarry``, ``NGramState``, ``SketchedState``, ``FreqSketchedState``,
    ``BatchedSketchState``, ``BufferedTableState``, ``GrepState`` or
    ``ReservoirState`` (matched by class name, nested as in the JAX
    pytree), or a bare array (registers, a Count-Min sketch).  Every array
    becomes an int64 tensor holding its uint32 values; the cursor of a
    ``BatchedSketchState`` or ``BufferedTableState`` becomes the host int
    the port keeps."""
    dev = resolve_device(device)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        cls = _state_classes()[type(state).__name__]
        out = {f: state_from_numpy(getattr(state, f), dev)
               for f in state._fields}
        if cls.__name__ in ("BatchedSketchState", "BufferedTableState"):
            out["cursor"] = int(np.asarray(state.cursor))
        return cls(**out)
    return torch.as_tensor(np.asarray(state, dtype=np.uint32)
                           .astype(np.int64), device=dev)


def state_to_numpy(state):
    """A port state with every tensor as a uint32 numpy array (and a host
    int as a uint32 scalar), in the same NamedTuple structure: the JAX
    package's layout, field for field."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(state_to_numpy(x) for x in state))
    if isinstance(state, torch.Tensor):
        return state.cpu().numpy().astype(np.uint32)
    return np.uint32(state)


def state_to_leaves(state) -> list[np.ndarray]:
    """A state as a one-device JAX engine state's leaves, in the JAX
    pytree's flatten order (NamedTuple fields in order, depth first): one
    uint32 array per leaf with a leading device axis of 1.  Casts run on
    the device, before the copy."""
    if isinstance(state, tuple):
        return [leaf for x in state for leaf in state_to_leaves(x)]
    if isinstance(state, torch.Tensor):
        return [state.to(torch.int32).cpu().numpy().view(np.uint32)
                .reshape(1, *state.shape)]
    return [np.asarray([state], dtype=np.uint32)]


def leaves_to_state(leaves, template, device=None):
    """The state a :func:`state_to_leaves` list holds, in the structure
    of ``template`` (the running job's initial state): tensors on
    ``device``, host ints (the cursor of a batched sketch or of a staged
    word count) as ints."""
    dev = resolve_device(device)
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            return type(t)(*(build(x) for x in t))
        leaf = np.asarray(next(it))[0]
        if isinstance(t, torch.Tensor):
            return torch.as_tensor(leaf.astype(np.uint32).astype(np.int64),
                                   device=dev)
        return int(leaf)

    state = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the state's template holds")
    return state


def combiner_cache_to_numpy(cache: CombinerCache) -> dict[str, np.ndarray]:
    """The flushed cache's planes as ``(C, 128)`` uint32 numpy arrays, the
    layout of the JAX package's ``CombinerCache``."""
    return {f: getattr(cache, f).cpu().numpy().astype(np.uint32)
            for f in CombinerCache._fields}


def combiner_cache_from_numpy(fields: Mapping[str, Any],
                              device=None) -> CombinerCache:
    """A port cache from a JAX ``CombinerCache``'s fields."""
    dev = resolve_device(device)
    return CombinerCache(**{
        f: torch.as_tensor(np.asarray(fields[f], dtype=np.uint32)
                           .astype(np.int64), device=dev)
        for f in CombinerCache._fields})


#: JAX ``Config`` fields of the streamed executor's tuning plane, not
#: ported yet: the value the port behaves as, and the ROADMAP.md item that
#: ports each.
_UNPORTED_DEFAULTS = {"autotune": ("off", "A8b (ii), the autotuner")}


def config_from_dict(d: Mapping[str, Any]) -> Config:
    """A port Config from a JAX Config's fields (``dataclasses.asdict``).

    Fields the port has are taken as they are, so a value the port does not
    run yet raises.  An explicit JAX ``compact_slots`` > 0 sizes the TPU
    kernel's window; it maps to compact mode (None): the port's dense
    stream has no slots, and no result depends on them.  A JAX kernel
    geometry carries across as it is: a preset name, or a dict of its
    fields (``asdict`` makes a ``Geometry`` one), which the port's
    ``Config`` stores as its own :class:`...config.Geometry`.  The
    pipeline knobs (superstep, in-flight groups, prefetch), the fault plan
    and the failure policy (``asdict`` makes it a dict of its fields) and
    ``merge_overlap`` carry across; an autotuner away from its default
    raises, naming its ROADMAP item.
    """
    for name, (default, item) in _UNPORTED_DEFAULTS.items():
        if d.get(name, default) != default:
            raise _not_ported(f"{name}={d[name]!r}", item)
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in d.items() if k in names}
    if kw.get("compact_slots"):
        kw["compact_slots"] = None
    return Config(**kw)
