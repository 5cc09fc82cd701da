"""The host chunker (``chunker.cpp``), built with g++ and loaded via ctypes.

The library compiles at first use into the git-ignored
``mapreduce_tpu_torch/_build/``, named by a hash of the source and the
flags, so an edited source rebuilds.  ctypes releases the GIL for the
length of each call, so the reader's prefetch thread fills batches while
the main thread launches kernels.  There is no fallback: a failed build or
load raises.  A build reports its seconds to the telemetry plane
(``gxx_chunker``, :func:`...obs.telemetry.record_build`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.obs import telemetry

SOURCE = Path(__file__).resolve().parent / "chunker.cpp"
BUILD_DIR = SOURCE.parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

SEP_LUT = np.zeros(256, dtype=np.uint8)
SEP_LUT[list(constants.SEPARATOR_BYTES)] = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library of the current ``chunker.cpp`` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"chunker-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The chunker library, built on first call; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                from mapreduce_tpu_torch.ops.cuda._build import build_lock

                with build_lock():  # the ranks of a run start together
                    if not path.exists():
                        t0 = time.perf_counter()
                        _build(path)
                        telemetry.record_build("gxx_chunker",
                                               time.perf_counter() - t0)
            lib = ctypes.CDLL(str(path))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.mr_fill_batch.restype = ctypes.c_int64
            lib.mr_fill_batch.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, u8p, u8p, i64p, i64p]
            lib.mr_token_count.restype = ctypes.c_int64
            lib.mr_token_count.argtypes = [u8p, ctypes.c_int64, u8p]
            _lib = lib
        return _lib


def fill_batch(buf: np.ndarray, at_eof: bool, n_shards: int,
               chunk_bytes: int, max_token_bytes: int, out_data: np.ndarray,
               out_bases: np.ndarray, out_lengths: np.ndarray) -> int:
    """Fill one ``[n_shards, chunk_bytes]`` batch from ``buf`` (the corpus
    from the current offset); returns the bytes consumed.  ``out_bases``
    are relative to ``buf``."""
    if out_data.size != n_shards * chunk_bytes \
            or not out_data.flags.c_contiguous \
            or out_bases.shape != (n_shards,) \
            or out_lengths.shape != (n_shards,):
        raise ValueError("batch buffers do not match n_shards x chunk_bytes")
    buf = np.ascontiguousarray(buf)
    return int(load().mr_fill_batch(
        buf, buf.shape[0], int(at_eof), n_shards, chunk_bytes,
        max_token_bytes, SEP_LUT, out_data.reshape(-1), out_bases,
        out_lengths))


def token_count(buf: np.ndarray) -> int:
    """Exact token count of a buffer (runs of non-separator bytes)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    return int(load().mr_token_count(buf, buf.shape[0], SEP_LUT))
