"""Streamed n-gram counts over D CPU ranks against the JAX package on
``data_mesh(D)``.

Bigrams cross the join between every two ranks' rows of a step: each
rank's map gathers the step's D seam summaries (one ``all_gather``) and
composes its incoming carry in chunk order.  A world of D gloo ranks
(``tests/torch_world.py``) runs ``run_job(NGramCountJob(2))`` and
``count_file(ngram=2)`` with each merge strategy, D = 2 and 4; the JAX
package runs the same on a CPU mesh of D devices, backend pallas (the
Pallas kernel interpreted), 4 KB chunks.  The finished table (carry
included), the bases and the recovered grams equal the JAX ones exactly,
on every rank, and the grams do not depend on D.
"""

import dataclasses

import numpy as np
import pytest

import torch_world
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import convert

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=4096, table_capacity=4096,
               rescue_overlong=4)
CFG = {k: getattr(convert.config_from_dict(dataclasses.asdict(JCFG)), k)
       for k in ("backend", "map_impl", "combiner", "pallas_max_token",
                 "chunk_bytes", "table_capacity", "rescue_overlong")}
STRATEGIES = ("tree", "gather", "keyrange")
SIZES = (2, 4)
FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Zipf words over mixed separators, a token longer than W = 8 now and
    then (its grams are poisoned and accounted), ~9 chunks."""
    rng = np.random.default_rng(8)
    vocab = [b"g%x" % i for i in range(120)]
    seps = [b" ", b"\n", b"  ", b"\t"]
    parts = []
    for i, w in enumerate(rng.zipf(1.3, 7000)):
        parts.append(b"long_gram_word" if i % 900 == 450
                     else vocab[int(w) % len(vocab)])
        parts.append(seps[int(rng.integers(0, len(seps)))])
    p = tmp_path_factory.mktemp("ngram") / "c.txt"
    p.write_bytes(b"".join(parts))
    return str(p)


@pytest.fixture(scope="module")
def worlds(corpus, tmp_path_factory):
    cases = []
    for s in STRATEGIES:
        cases.append({"name": f"value-{s}", "kind": "run_job",
                      "args": {"job": "ngram", "n": 2, "path": corpus,
                               "config": CFG, "merge_strategy": s}})
        cases.append({"name": f"count-{s}", "kind": "count_file",
                      "args": {"path": corpus, "config": CFG, "ngram": 2,
                               "merge_strategy": s}})
    # Spawned in the background while ``jax_runs`` computes the references.
    tmp = {d: tmp_path_factory.mktemp(f"w{d}") for d in SIZES}
    return torch_world.Later(lambda: {
        d: torch_world.spawn_world(d, cases, tmp[d]) for d in SIZES})


@pytest.fixture(scope="module")
def jax_runs(corpus):
    out = {}
    with torch_world.shared_jax_engines():
        for d in SIZES:
            mesh = data_mesh(d)
            for s in STRATEGIES:
                out[d, "value", s] = jexecutor.run_job(
                    jwc.NGramCountJob(2, JCFG), corpus, JCFG, mesh=mesh,
                    merge_strategy=s)
                out[d, "count", s] = jexecutor.count_file(
                    corpus, JCFG, mesh=mesh, merge_strategy=s, ngram=2)
    return out


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ngram_value_matches_jax(worlds, jax_runs, d, strategy):
    """The finalized gram table, leaf for leaf, and the bases, on every
    rank."""
    want = jax_runs[d, "value", strategy]
    for rank in range(d):
        got = _ok(worlds[d][rank][f"value-{strategy}"])
        w, g = _leaves(want.value), _leaves(got["value"])
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(w, g)):
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
        np.testing.assert_array_equal(got["bases"], want.bases)


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ngram_count_file_matches_jax(worlds, jax_runs, d, strategy):
    got = _ok(worlds[d][0][f"count-{strategy}"])
    want = jax_runs[d, "count", strategy]
    for f in FIELDS:
        assert getattr(want, f) == got[f], f
    assert got["dropped_count"] > 0  # the poisoned grams are accounted
    assert worlds[d][1][f"count-{strategy}"] is None


def test_grams_do_not_depend_on_d(worlds):
    want = worlds[2][0]["count-tree"]
    for d in SIZES:
        for s in STRATEGIES:
            assert worlds[d][0][f"count-{s}"] == want, (d, s)
