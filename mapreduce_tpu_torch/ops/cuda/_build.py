"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with :mod:`ctypes`.  The build runs at first use
into ``mapreduce_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import: the CPU tests import every module.
Each build reports its seconds to the telemetry plane
(:func:`...obs.telemetry.record_build`, as ``nvcc_<name>``), so a run
that pays a build shows it as a compile event.  Builds take a file lock
(:func:`build_lock`): the D ranks of one run start together, and one of
them builds while the others wait for its library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from mapreduce_tpu_torch.obs import telemetry

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then the
    toolkit's usual install directory."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels build on a machine with the CUDA toolkit")


@contextlib.contextmanager
def build_lock():
    """Hold the build directory's lock (``_build/.lock``, an exclusive
    ``flock``) for the block: one process builds, the others wait."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current text."""
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def sources() -> list[str]:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names=None) -> dict[str, tuple[Path, str]]:
    """Compile each ``csrc/<name>.cu`` (default: all of them) whose library
    does not exist, one ``nvcc`` per source, all started together.  Returns
    ``{name: (library path, compiler report)}``; the report (ptxas
    registers and shared memory) is empty for a library that was there."""
    names = sources() if names is None else list(names)
    done = {name: (library_path(name), "") for name in names}
    if all(out.exists() for out, _ in done.values()):
        return done
    with build_lock():
        return _build_missing(done)


def _build_missing(done: dict) -> dict:
    """:func:`build_all`'s builds, under the lock: a library another
    process built while this one waited is taken as it is."""
    todo = [name for name, (out, _) in done.items() if not out.exists()]
    if todo:
        compiler = nvcc()
    running = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, done[name][0], time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        report = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed on {name}.cu:\n{report}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
            done[name] = (out, report)
            telemetry.record_build(f"nvcc_{name}", time.perf_counter() - t0)
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists (see
    :func:`build_all`)."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        _loaded[name] = lib
    return lib
