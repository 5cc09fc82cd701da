"""The control and the planted faults: each must come out not correct.

The control (``control.py``) at small sizes on the CPU; the faults are
planted in the program underneath a whole run of the harness, which skips
only its look for a card.  The exchange between chips has no fault to
plant: every cell runs on one card.
"""

import dataclasses

import pytest
import torch

from portbench import cell, control
from portbench.tests.conftest import PROGRAM, small


def test_sound_runs_pass_and_every_control_fails(workload):
    ref = cell.load("reference", cell.load_cell(workload)["config"]["job"])

    def failing(readings: dict) -> set:
        return {k for k, v in readings.items() if v > ref.LIMITS[k]}

    r = control.seed_readings(workload, 2**31 + 3, "cpu", True,
                              small(workload), PROGRAM)
    assert failing(r["program"]) == set()
    assert set(r) == {"program", *ref.CONTROLS}
    for name in ref.CONTROLS:
        assert failing(r[name]), name
    if ref.__name__.endswith(".wordcount"):
        assert "word_mismatch" in failing(r["unordered"])
        # The text8 stand-in has words past W = 32 bytes.
        assert {"word_mismatch", "dropped"} <= failing(r["rescue_off"])


def _state_unchanged(monkeypatch):
    from mapreduce_tpu_torch.parallel.mapreduce import Engine

    monkeypatch.setattr(Engine, "step", lambda self, state, chunk, i: state)


def _half_the_batch(monkeypatch):
    from mapreduce_tpu_torch.parallel.mapreduce import Engine

    step = Engine.step

    def half(self, state, chunk, i):
        t = torch.as_tensor(chunk).reshape(-1).clone()
        t[t.shape[0] // 2:] = 0
        return step(self, state, t, i)

    monkeypatch.setattr(Engine, "step", half)


def _token_altered(monkeypatch):
    from mapreduce_tpu_torch.models import wordcount

    map_stream = wordcount._map_stream

    def altered(*args, **kw):
        t = map_stream(*args, **kw)
        count = t.count.clone()
        first = int(torch.nonzero(count > 0)[0, 0])
        count[first] += 1
        return t._replace(count=count)

    monkeypatch.setattr(wordcount, "_map_stream", altered)


def _answer_altered(monkeypatch):
    from mapreduce_tpu_torch.runtime import executor

    recover = executor.recover_from_file

    def altered(*args, **kw):
        r = recover(*args, **kw)
        return dataclasses.replace(r, counts=[r.counts[0] + 1] + r.counts[1:])

    monkeypatch.setattr(executor, "recover_from_file", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _token_altered, _answer_altered])
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    line = cell.run_cell(workload, 2**31 + 9, 0.0, False, "cpu",
                         corpus_override=small(workload),
                         program_override=PROGRAM)
    assert line["correct"] is False
    assert line["failed"] == line["compared"] >= 1
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
