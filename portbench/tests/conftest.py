"""Small sizes for the benchmark's CPU tests: each configuration's corpus
and the program's chunk cut down so a run takes seconds on the CPU."""

import json
import os

import pytest

from portbench import cell

# One intra-op thread, as run.py sets it: the CPU tests share the cores.
os.environ.setdefault("OMP_NUM_THREADS", "1")

#: Corpus keys replaced in the tests, by configuration file.
SMALL = {
    "wordcount-text8": {"tokens": 30_000, "distinct": 4_000,
                        "bytes": 170_000, "long_words": 20},
}
PROGRAM = {"chunk_bytes": 1 << 16}

BENCH = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w["config"] for w in BENCH["workloads"]}


def config(name: str) -> dict:
    """A configuration file of ``portbench/configs/``."""
    return json.loads((cell.HERE / "configs" / f"{name}.json").read_text())


def small_corpus(name: str) -> dict:
    return {**config(name)["corpus"], **SMALL[name]}


@pytest.fixture(params=sorted(SMALL))
def config_name(request):
    return request.param


@pytest.fixture(params=sorted(CELLS))
def workload(request):
    return request.param


def small(workload: str) -> dict:
    """The corpus override of a cell's tests."""
    return SMALL[CELLS[workload]]
