"""Streamed sketched word counts over D CPU ranks against the JAX package
on ``data_mesh(D)``.

The HyperLogLog and the Count-Min wrappers over D gloo ranks
(``tests/torch_world.py``): the table merges with each strategy (under
keyrange its key-range reduce, with the sketch array tree-merged beside
it), and the sketch with its own monoid.  For D = 2 and 4, and tree,
gather and keyrange, ``count_file(distinct_sketch=)`` and
``count_file(count_sketch=)`` equal the JAX package's runs on a CPU mesh
of D devices (backend pallas, the Pallas kernel interpreted, 4 KB
chunks): the recovered result, the HLL estimate and every Count-Min cell;
the HLL registers also at ``sketch_flush_every`` 3.  Neither depends on
D (but for the ``dropped_uniques`` bound, which each merge order bounds
its own way).
"""

import dataclasses

import numpy as np
import pytest

import torch_world
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.parallel.mesh import data_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch import convert

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=4096, table_capacity=1024,
               rescue_overlong=4)
CFG = {k: getattr(convert.config_from_dict(dataclasses.asdict(JCFG)), k)
       for k in ("backend", "map_impl", "combiner", "pallas_max_token",
                 "chunk_bytes", "table_capacity", "rescue_overlong")}
STRATEGIES = ("tree", "gather", "keyrange")
SIZES = (2, 4)
FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count", "distinct_estimate")
SKETCHES = {"hll": {"distinct_sketch": True},
            "cms": {"count_sketch": True}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """~2,000 distinct words (past the 1,024-slot table, so keys spill and
    the sketches see what the table drops), ~8 chunks."""
    rng = np.random.default_rng(9)
    vocab = [b"s%x" % i for i in range(2000)]
    words = [vocab[int(i)] for i in rng.integers(0, len(vocab), 6000)]
    p = tmp_path_factory.mktemp("sketch") / "c.txt"
    p.write_bytes(b" ".join(words))
    return str(p)


@pytest.fixture(scope="module")
def worlds(corpus, tmp_path_factory):
    cases = [{"name": f"{k}-{s}", "kind": "count_file",
              "args": {"path": corpus, "config": CFG, "merge_strategy": s,
                       **kw}}
             for k, kw in SKETCHES.items() for s in STRATEGIES]
    cases.append({"name": "hll-flush3", "kind": "count_file",
                  "args": {"path": corpus, "distinct_sketch": True,
                           "config": dict(CFG, sketch_flush_every=3),
                           "merge_strategy": "keyrange"}})
    # Spawned in the background while ``jax_runs`` computes the references.
    tmp = {d: tmp_path_factory.mktemp(f"w{d}") for d in SIZES}
    return torch_world.Later(lambda: {
        d: torch_world.spawn_world(d, cases, tmp[d]) for d in SIZES})


@pytest.fixture(scope="module")
def jax_runs(corpus):
    out = {}
    with torch_world.shared_jax_engines():
        for d in SIZES:
            for k, kw in SKETCHES.items():
                for s in STRATEGIES:
                    out[d, k, s] = jexecutor.count_file(
                        corpus, JCFG, mesh=data_mesh(d), merge_strategy=s,
                        **kw)
    return out


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("sketch", sorted(SKETCHES))
def test_sketched_count_file_matches_jax(worlds, jax_runs, d, strategy,
                                         sketch):
    got = _ok(worlds[d][0][f"{sketch}-{strategy}"])
    want = jax_runs[d, sketch, strategy]
    for f in FIELDS:
        assert getattr(want, f) == got[f], f
    assert got["dropped_uniques"] > 0  # the table spilled
    if sketch == "cms":
        np.testing.assert_array_equal(got["cms"], np.asarray(want.cms))
    else:
        assert got["distinct_estimate"] is not None
    assert worlds[d][1][f"{sketch}-{strategy}"] is None


def test_sketches_do_not_depend_on_d(worlds):
    for sketch in SKETCHES:
        want = worlds[2][0][f"{sketch}-tree"]
        for d in SIZES:
            for s in STRATEGIES:
                got = worlds[d][0][f"{sketch}-{s}"]
                for f in FIELDS:  # dropped_uniques is a bound, per merge
                    if f != "dropped_uniques":
                        assert got[f] == want[f], (sketch, d, s, f)
                if sketch == "cms":
                    np.testing.assert_array_equal(got["cms"], want["cms"])


@pytest.mark.parametrize("d", SIZES)
def test_batched_hll_flush_equals_every_combine(worlds, d):
    assert _ok(worlds[d][0]["hll-flush3"]) == worlds[d][0]["hll-keyrange"]
