"""Kernel nodes of a trace, and what the card says of each kernel.

Counterpart of :mod:`mapreduce_tpu.analysis.pallas_info`, which digests
every ``pallas_call`` binding of a jaxpr into its BlockSpecs.  Here:

* :func:`collect_kernel_nodes` digests every kernel node of a model's
  step/finish traces into its wrapper and launch plan
  (:mod:`...ops.cuda.plans`);
* :func:`card_attributes` asks the card, for every ``__global__`` function
  of every kernel library, what ``cudaFuncGetAttributes`` reports (static
  shared bytes, registers, local bytes -- register spills --, the most
  threads a block may have, constant bytes) and how many blocks of the
  kernel's own block size ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
  fits on an SM.  Each library exports ``mr_<lib>_kernel_count``,
  ``mr_<lib>_kernel_name`` and ``mr_<lib>_kernel_attrs`` for this.
"""

from __future__ import annotations

import ctypes
import dataclasses

from mapreduce_tpu_torch.analysis import trace

#: The fields ``mr_<lib>_kernel_attrs`` fills, in order.
ATTR_FIELDS = ("static_smem", "registers", "local_bytes",
               "max_threads_per_block", "const_bytes", "blocks_per_sm")


@dataclasses.dataclass(frozen=True)
class KernelNodeInfo:
    program: str  # 'step' | 'finish'
    wrapper: str
    plan: object
    location: str


def collect_kernel_nodes(traces: dict) -> list:
    """Every kernel node of the step/finish traces (a failed trace has
    none)."""
    out = []
    for program, t in traces.items():
        if isinstance(t, trace.TraceFailure):
            continue
        for node in t.kernels:
            out.append(KernelNodeInfo(program, node.name, node.plan,
                                      node.location))
    return out


def _library_attributes(lib_name: str) -> dict:
    from mapreduce_tpu_torch.ops.cuda import _build

    lib = _build.load(lib_name)
    count = getattr(lib, f"mr_{lib_name}_kernel_count")
    name = getattr(lib, f"mr_{lib_name}_kernel_name")
    attrs = getattr(lib, f"mr_{lib_name}_kernel_attrs")
    count.restype = ctypes.c_int
    name.restype = ctypes.c_char_p
    name.argtypes = [ctypes.c_int]
    attrs.restype = ctypes.c_int
    attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    out = {}
    for i in range(count()):
        buf = (ctypes.c_longlong * len(ATTR_FIELDS))()
        err = attrs(i, buf)
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed for kernel {i} "
                               f"of {lib_name}.cu: CUDA error {err}")
        out[name(i).decode()] = dict(zip(ATTR_FIELDS, (int(x) for x in buf)))
    return out


def card_attributes() -> dict:
    """``{kernel: {field: value}}`` for every ``__global__`` function of
    every ``csrc/*.cu`` library (template instances by their instance
    name, ``sort_hist<int64,drop>``).  Needs the card: it builds and loads
    the libraries."""
    from mapreduce_tpu_torch.ops.cuda import _build

    out = {}
    for lib_name in _build.sources():
        out.update(_library_attributes(lib_name))
    return out
