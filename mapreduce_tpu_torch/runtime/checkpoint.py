"""Checkpoint / resume for streamed runs.

Counterpart of :mod:`mapreduce_tpu.runtime.checkpoint`, with the same file
layout (format 2), so a snapshot from either package resumes in the other:
one ``.npz`` (atomic rename on write) holding the job state as positional
leaves ``__leaf_i`` (a one-device engine state: each leaf has a leading
device axis of 1, in the JAX pytree's order, see
:func:`...convert.state_to_leaves`), the ingest cursor
(``__step``, ``__offset``), the row base offsets of every step so far
(``__bases``), the corpus member of the last folded batch
(``__file_index``) and the run's fingerprint as JSON (``__meta``).  A
``.sum`` sidecar holds the snapshot's SHA-256; the previous good snapshot
is kept as ``.prev``, and a corrupt snapshot falls back to it.

Loading validates the leaves against a template of the running job's
state and the fingerprint against the running configuration, so a
different job, capacity, chunk size or input raises
:class:`CheckpointMismatch` instead of corrupting counts.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from mapreduce_tpu_torch.obs import registry as obs_registry


class CheckpointMismatch(RuntimeError):
    """The checkpoint was produced by an incompatible run configuration."""


class CheckpointCorrupt(RuntimeError):
    """The checkpoint file is torn or fails its integrity checksum: the
    bytes on disk are not the bytes that were written.  Distinct from
    :class:`CheckpointMismatch` (a different run's valid snapshot):
    corruption falls back to the previous good snapshot
    (:func:`load_resilient`), a mismatch never does."""


def run_fingerprint(input_path, n_devices: int, chunk_bytes: int,
                    backend: str = "xla", pallas_max_token: int = 0,
                    byte_range: Optional[tuple[int, int]] = None,
                    job_identity: str = "") -> dict:
    """Identity of a run: resuming under a different identity is an error.

    The input is fingerprinted by size and a head/tail content hash of
    every member of the corpus, so a replaced or appended corpus is
    detected without rehashing it.  The backend and its token-length
    envelope change what is counted, so they are part of the identity.
    Capacities are not: they are checked against the saved leaves' shapes.
    The keys and values are the JAX package's.
    """
    paths = [input_path] if isinstance(input_path, (str, bytes, os.PathLike)) \
        else list(input_path)
    multi = len(paths) > 1
    size = 0
    h = hashlib.sha256()
    for p in paths:
        psize = os.path.getsize(p)
        size += psize
        if multi:  # member boundaries matter; one file hashes as before
            h.update(str(psize).encode())
        with open(p, "rb") as f:
            h.update(f.read(1 << 16))
            if psize > (1 << 16):
                f.seek(max(0, psize - (1 << 16)))
                h.update(f.read(1 << 16))
    return {"input_size": size, "input_hash": h.hexdigest(),
            "n_devices": n_devices, "chunk_bytes": chunk_bytes,
            "backend": backend,
            "pallas_max_token": pallas_max_token if backend == "pallas" else 0,
            "byte_range": list(byte_range) if byte_range else None,
            "job": job_identity}


# Values assumed for fingerprint keys absent from an older snapshot's meta.
_FINGERPRINT_DEFAULTS = {"backend": "xla", "pallas_max_token": 0,
                         "byte_range": None}

# Snapshot format, written into __meta: v1 stored leaves under field names,
# v2 stores them as positional __leaf_i.
_FORMAT = 2


def save(path: str, leaves: Sequence[np.ndarray], step: int, offset: int,
         bases: np.ndarray, fingerprint: Optional[dict] = None,
         file_index: Optional[int] = None) -> None:
    """Atomically persist a run snapshot.

    Args:
      leaves: the job state's host leaves, in order.
      step: next step index to execute.
      offset: corpus offset ingest resumes from.
      bases: int64[steps_done, D] absolute row base offsets so far.
      fingerprint: run identity from :func:`run_fingerprint`.
      file_index: corpus member of the last batch folded into the state.

    Each save lands in the metrics registry (``checkpoint.saves``,
    ``checkpoint.save_seconds``, ``checkpoint.bytes_written``).
    """
    t0 = time.perf_counter()
    payload = {f"__leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    payload["__step"] = np.int64(step)
    payload["__offset"] = np.int64(offset)
    payload["__bases"] = np.asarray(bases, dtype=np.int64)
    payload["__file_index"] = np.int64(-1 if file_index is None else file_index)
    payload["__meta"] = np.frombuffer(
        json.dumps({**(fingerprint or {}), "format": _FORMAT}).encode(),
        dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        # Checksum the snapshot as written, before it becomes the live
        # checkpoint, and keep the previous good one as `.prev`.
        digest, nbytes = _file_sha256(tmp)
        if os.path.exists(path):
            _rotate_previous(path)
        os.replace(tmp, path)
        _write_integrity(path, digest, nbytes)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    reg = obs_registry.get_registry()
    reg.counter("checkpoint.saves").inc()
    reg.observe("checkpoint.save_seconds", time.perf_counter() - t0)
    reg.counter("checkpoint.bytes_written").inc(nbytes)


def load(path: str, template: Optional[Sequence] = None,
         expect_fingerprint: Optional[dict] = None
         ) -> tuple[list, int, int, np.ndarray, Optional[int]]:
    """Load a snapshot; returns ``(leaves, step, offset, bases,
    file_index)`` (``file_index`` None when the snapshot has none).

    ``template`` is the running job's state leaves (anything with
    ``shape`` and ``dtype``): the snapshot's leaves must match them in
    number, shape and dtype.  ``expect_fingerprint`` must match the
    snapshot's meta key by key.  Either mismatch raises
    :class:`CheckpointMismatch`.  ``template=None`` skips the leaf check.
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta"]).decode() or "{}") \
            if "__meta" in z else {}
        fmt = meta.get("format", 1)
        if fmt > _FORMAT:
            raise CheckpointMismatch(
                f"checkpoint {path} was written by a newer version of this "
                f"framework (snapshot format {fmt}, this build reads up to "
                f"{_FORMAT}); upgrade, or delete the checkpoint")
        legacy_keys = [k for k in z.files if not k.startswith("__")]
        if legacy_keys:
            raise CheckpointMismatch(
                f"checkpoint {path} was written by an older version of this "
                f"framework (format {fmt}: field-named leaves "
                f"{sorted(legacy_keys)[:4]}); delete it and restart the run")
        if expect_fingerprint:
            for key, want in expect_fingerprint.items():
                got = meta.get(key, _FINGERPRINT_DEFAULTS.get(key))
                if got != want:
                    raise CheckpointMismatch(
                        f"checkpoint {path} was written with {key}={got!r}, "
                        f"this run has {key}={want!r}; delete the checkpoint "
                        f"or rerun with the original configuration")
        n_saved = sum(1 for k in z.files if k.startswith("__leaf_"))
        fi = int(z["__file_index"]) if "__file_index" in z.files else -1
        leaves = [z[f"__leaf_{i}"] for i in range(n_saved)]
        if template is not None:
            if n_saved != len(template):
                raise CheckpointMismatch(
                    f"checkpoint {path} holds a different state structure "
                    f"({n_saved} leaves vs this job's {len(template)}: a "
                    f"different job kind); delete the checkpoint or rerun "
                    f"with the original configuration")
            for i, (got, want) in enumerate(zip(leaves, template)):
                if tuple(got.shape) != tuple(want.shape) \
                        or got.dtype != np.dtype(want.dtype):
                    raise CheckpointMismatch(
                        f"checkpoint {path} leaf {i} is {got.dtype}"
                        f"{got.shape}, this run expects "
                        f"{np.dtype(want.dtype)}{tuple(want.shape)} (changed "
                        f"capacity or device count); delete the checkpoint "
                        f"or rerun with the original configuration")
        return (leaves, int(z["__step"]), int(z["__offset"]), z["__bases"],
                None if fi < 0 else fi)


def exists(path: str) -> bool:
    """True when a resumable snapshot is present: the live ``path``, or
    only the previous good ``.prev`` (a crash inside the rotation)."""
    return os.path.exists(path) or os.path.exists(previous_path(path))


def integrity_path(path: str) -> str:
    """The checksum sidecar of a snapshot: ``ck.npz`` -> ``ck.npz.sum``."""
    return path + ".sum"


def previous_path(path: str) -> str:
    """The previous good snapshot, rotated aside by :func:`save`."""
    return path + ".prev"


def _rotate_previous(path: str) -> None:
    """Rotate the live snapshot (and its sidecar) aside to ``.prev``
    without leaving ``path`` empty: hard-link it to a temp name and rename
    the link over ``.prev``, so the caller's rename of the new snapshot is
    the only change to ``path``.  Where hard links are refused, rename
    (:func:`exists` and :func:`load_resilient` cover that window).  The
    sidecar moves by rename: a missing sidecar is safe, a stale one would
    make a good snapshot read as corrupt."""
    prev = previous_path(path)
    tmp_link = prev + ".tmp"
    try:
        if os.path.exists(tmp_link):
            os.unlink(tmp_link)
        os.link(path, tmp_link)
        os.replace(tmp_link, prev)
    except OSError:
        os.replace(path, prev)
    if os.path.exists(integrity_path(path)):
        os.replace(integrity_path(path), integrity_path(prev))


def _file_sha256(path: str) -> tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            h.update(block)
            n += len(block)
    return h.hexdigest(), n


def _write_integrity(path: str, digest: str, nbytes: int) -> None:
    """Atomic sidecar write (tmp + rename, like the snapshot itself)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".sum.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump({"sha256": digest, "bytes": nbytes,
                       "format": _FORMAT}, f)
        os.replace(tmp, integrity_path(path))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def verify(path: str) -> Optional[bool]:
    """Checksum a snapshot against its sidecar: True (intact), False
    (torn or corrupt), or None when there is no sidecar."""
    sp = integrity_path(path)
    if not os.path.exists(sp):
        return None
    try:
        with open(sp, encoding="utf-8") as f:
            want = json.load(f)
        digest, nbytes = _file_sha256(path)
        return digest == want.get("sha256") and nbytes == want.get("bytes")
    except (OSError, ValueError):
        return False


def load_verified(path: str, template=None, expect_fingerprint=None):
    """:func:`load` behind the integrity check: a failing checksum, or a
    file too torn to parse, raises :class:`CheckpointCorrupt`; semantic
    rejections stay :class:`CheckpointMismatch`."""
    if verify(path) is False:
        raise CheckpointCorrupt(
            f"checkpoint {path} fails its integrity checksum "
            f"({integrity_path(path)}): the file on disk is not the file "
            "that was saved")
    try:
        return load(path, template=template,
                    expect_fingerprint=expect_fingerprint)
    except CheckpointMismatch:
        raise
    except Exception as e:  # torn zip/npz, short read, bad member
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e}); "
            "likely torn by a crash mid-save") from e


def load_resilient(path: str, template=None, expect_fingerprint=None):
    """Resume read with the previous-good fallback: returns
    ``(load result, fallback)``, ``fallback`` None on the happy path or a
    dict naming the corrupt file and the ``.prev`` snapshot loaded.
    Raises :class:`CheckpointCorrupt` only when ``.prev`` is missing or
    corrupt too."""
    try:
        return (load_verified(path, template=template,
                              expect_fingerprint=expect_fingerprint), None)
    except CheckpointCorrupt as e:
        prev = previous_path(path)
        if not os.path.exists(prev):
            raise
        result = load_verified(prev, template=template,
                               expect_fingerprint=expect_fingerprint)
        obs_registry.get_registry().counter(
            "checkpoint.corrupt_fallbacks").inc()
        return (result, {"corrupt": path, "loaded": prev, "error": str(e)})
