"""The spans and counters of a job's host time, on the CPU.

One small streamed ``count_file`` (4 KB chunks, every chunk with a run
longer than W, so the rescue runs on each) under a CPU ``torch.profiler``
serves every check: recovery's four parts nest in ``recover``, the rescue
and the reader's fill are phases of the run, the registry's host syncs a
chunk equal the declared syncs of one step on the same chunk (the static
analysis's trace of it), and every profiler region is opened on the
thread that runs the job, none on the prefetch thread.
"""

import threading

import numpy as np
import pytest
import torch

from mapreduce_tpu_torch.analysis import trace
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.obs import registry
from mapreduce_tpu_torch.runtime import executor

CPU = torch.device("cpu")
CHUNK = 4096
CFG = Config(backend="pallas", chunk_bytes=CHUNK, table_capacity=4096,
             pallas_max_token=8)
PARTS = ("recover.fetch", "recover.order", "recover.read",
         "recover.assemble")


def _text(n_words: int, long_every: int) -> bytes:
    """Zipf words of 2-3 bytes; with ``long_every`` one word in that many
    longer than W = 8 (several a 4 KB chunk)."""
    rng = np.random.default_rng(21)
    vocab = [b"w%x" % i for i in range(250)]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]
    if long_every:
        for i in range(50, n_words, long_every):
            words[i] = b"overlong_%d" % (i % 5)
    return b" ".join(words)


def _counters() -> dict:
    return dict(registry.get_registry().snapshot()["counters"])


class _Regions(torch.profiler.record_function):
    """``record_function`` that notes the thread of every region it
    opens."""

    opened: list = []

    def __enter__(self):
        _Regions.opened.append((self.name, threading.get_ident()))
        return super().__enter__()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "c.txt"
    path.write_bytes(_text(4000, 300))
    before = _counters()
    _Regions.opened = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _Regions)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            result = executor.count_file(str(path), CFG, device="cpu")
    after = _counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    regions = {e.name() for e in prof.profiler.kineto_results.events()
               if e.is_user_annotation()}
    return {"path": str(path), "result": result, "delta": delta,
            "regions": regions, "opened": list(_Regions.opened),
            "thread": threading.get_ident()}


def test_recovery_parts_nest_in_recover(job):
    phases = job["result"].run.metrics.phases
    assert all(phases[p] > 0 for p in PARTS)
    assert sum(phases[p] for p in PARTS) <= phases["recover"]


def test_rescue_and_fill_are_phases_of_the_run(job, tmp_path):
    phases = job["result"].run.metrics.phases
    assert job["result"].dropped_count == 0
    assert 0 < phases["rescue"] <= phases["dispatch"]
    assert phases["read_fill"] > 0
    assert "stage_pin" not in phases  # the CPU's stage pins nothing
    path = tmp_path / "short.txt"
    path.write_bytes(_text(1500, 0))
    plain = executor.count_file(str(path), CFG, device="cpu")
    assert "rescue" not in plain.run.metrics.phases
    assert "read_fill" in plain.run.metrics.phases


def test_host_syncs_a_chunk_are_the_steps_declared_ones(job):
    delta = job["delta"]
    chunks = delta["executor.chunks"]
    assert chunks == job["result"].run.bases.shape[0] >= 3
    syncs = delta["executor.host_syncs{site=flags}"] \
        + delta["executor.host_syncs{site=scalars}"]
    first = next(reader_mod.iter_batches(job["path"], 1, CHUNK))
    step = trace.trace_engine(wc.WordCountJob(CFG, "cpu"), CPU,
                              chunk=torch.from_numpy(first.data[0]))["step"]
    assert step.flags[0][1] > 0  # the chunk has an overlong run
    declared = step.host_syncs
    # The read, the packed build's four copies, the rescue table's three.
    assert len(declared) == 8
    assert syncs == chunks * len(declared)
    assert delta["executor.host_syncs{site=flags}"] == chunks * sum(
        n.kind == "host_read" for n in declared)


def test_regions_only_on_the_jobs_thread(job):
    assert {"recover", "dispatch", "rescue", *PARTS} <= job["regions"]
    assert not {"read_fill", "stage_pin"} & job["regions"]
    names = {name for name, _ in job["opened"]}
    assert {"recover", "rescue", *PARTS} <= names
    assert {t for _, t in job["opened"]} == {job["thread"]}


def test_sync_counter_is_found_again_after_a_registry_reset():
    from mapreduce_tpu_torch.ops import tracepoints

    reg = registry.get_registry()
    tracepoints.host_scalars([1], CPU)
    before = _counters()["executor.host_syncs{site=scalars}"]
    tracepoints.host_scalars([1], CPU)
    assert _counters()["executor.host_syncs{site=scalars}"] == before + 1
    reg.reset()
    tracepoints.host_scalars([1], CPU)
    assert _counters()["executor.host_syncs{site=scalars}"] == 1
