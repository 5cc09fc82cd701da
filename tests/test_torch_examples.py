"""The port's examples (``examples/torch_*.py``) on the CPU.

Each runs as a user runs it, in its own process with ``--platform cpu``.
``torch_basic_wordcount`` and ``torch_custom_job`` (a ``MapReduceJob``
subclass on the port's ``Engine``) print what their JAX counterparts
print, which run here in-process; ``torch_streaming_topk`` and
``torch_analytics`` drive the streamed executor, whose JAX runs would cost
a compile each, so they are held to the numpy oracle
(``mapreduce_tpu_torch/utils/oracle.py``) and to counts taken here.
"""

import ast
import contextlib
import io
import os
import pathlib
import re
import runpy
import subprocess
import sys

import pytest

from mapreduce_tpu_torch.utils import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _port(name: str, *args: str) -> str:
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / f"torch_{name}.py"), *args,
         "--platform", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _jax(name: str) -> str:
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py")]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


@pytest.mark.parametrize("name", ["basic_wordcount", "custom_job"])
def test_example_prints_what_the_jax_one_prints(name):
    want = _jax(name)
    assert want and _port(name) == want


def test_custom_job_subclasses_the_exported_base():
    import mapreduce_tpu_torch as port
    from mapreduce_tpu_torch.parallel import mapreduce

    assert port.MapReduceJob is mapreduce.MapReduceJob
    assert "class ByteClassHistogramJob(MapReduceJob)" \
        in (EXAMPLES / "torch_custom_job.py").read_text()
    job = mapreduce.MapReduceJob()
    assert job.identity() == "mapreducejob"
    assert job.finalize(3) == 3
    with pytest.raises(NotImplementedError):
        job.init_state()


def _top(counts: dict, k: int) -> list:
    """The k most frequent words, ties by first occurrence."""
    return sorted(counts.items(), key=lambda kv: -kv[1])[:k]


def test_streaming_topk_equals_the_oracle(tmp_path):
    path = tmp_path / "corpus.txt"
    data = b"the quick brown fox jumps over the lazy dog " * 5000
    path.write_bytes(data)
    lines = _port("streaming_topk", str(path)).splitlines()
    counts = oracle.word_counts(data)
    assert lines[:5] == [f"{w.decode()}\t{c}" for w, c in _top(counts, 5)]
    assert lines[5] == (f"total={oracle.total_count(data)} "
                        f"distinct~={len(counts)} "
                        f"(exact-table distinct={len(counts)})")


def test_analytics_equals_the_oracle(tmp_path):
    path = tmp_path / "corpus.txt"
    data = (b"the quick brown fox jumps over the lazy dog\n" * 200
            + b"the quick red fox naps\n" * 50)
    path.write_bytes(data)
    out = _port("analytics", str(path))
    words = oracle.split_words(data)
    spans = [m.span() for m in re.finditer(rb"[^ \n]+", data)]
    bigrams: dict = {}  # source span -> count, in first-occurrence order
    for (a, _), (_, b) in zip(spans, spans[1:]):
        bigrams[data[a:b]] = bigrams.get(data[a:b], 0) + 1
    got_top = re.findall(r"^  ('.*')\t(\d+)$", out, re.M)
    assert [(ast.literal_eval(s).encode(), int(c)) for s, c in got_top] \
        == _top(bigrams, 5)
    lines = data.split(b"\n")
    counts = oracle.word_counts(data)
    for q in ("the", "fox"):
        est = int(re.search(rf"estimate '{q}': (\d+)", out).group(1))
        assert est >= counts[q.encode()]
    assert "estimate 'not-in-corpus': 0" in out
    n_lines = sum(1 for ln in lines if b"quick" in ln)
    assert f"grep 'quick': {data.count(b'quick')} matches on {n_lines} " \
           f"lines" in out
    assert "multigrep 'zebra': 0 matches on 0 lines" in out
    assert f"multigrep 'fox': {data.count(b'fox')} matches" in out
    tails = len(re.findall(rb"(?=[a-z]o[gx])", data))
    assert f"grep class '[a-z]o[gx]': {tails} matches" in out
    sample = re.search(r"uniform sample of (\d+) from (\d+) tokens: (.*)",
                       out)
    assert (int(sample.group(1)), int(sample.group(2))) == (8, len(words))
    assert set(sample.group(3).encode().split()) <= set(words)
