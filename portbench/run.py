"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``mapreduce_tpu_torch``)
on a machine with the CUDA cards the cell asks for.  Without them it exits
with 2 and prints no result.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``;
with ``--trace 1`` also ``breakdown``; ``checks`` last); the numbers
compared, each beside its limit, are also the last lines of standard
error.  See ``cell.py`` for what one run does.

The process keeps to few threads: ``OMP_NUM_THREADS=1`` (PyTorch's
intra-op pool; the port's host work is the reader thread, the chunker and
numpy, none of which uses the pool).  On the card's shared host the
default pool of one thread a core ran the same jobs 8-12 % slower.

Build caches stay at fixed directories inside the checkout: the port's
kernels build into ``mapreduce_tpu_torch/_build/``; Triton's and PyTorch's
extension caches, which the port does not use today, are pointed into
``portbench/.cache/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(_HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_HERE, ".cache",
                                                  "torch_extensions")
sys.path.insert(0, _ROOT)

if __name__ == "__main__":
    from portbench import cell

    sys.exit(cell.main(sys.argv[1:], T_START))
