"""Streamed grep and the reservoir sample over D CPU ranks against the JAX
package on ``data_mesh(D)``.

Grep's exact matching-line count crosses the join between every two
ranks' rows of a step: each rank's map gathers the step's D row
summaries (one ``all_gather``) and composes its incoming line carry in
row order; the merge keeps operand ``a``'s carry, in the JAX order.  The
sample's priorities hash the chunk id ``step * D + rank``, so a D-rank
run draws the JAX ``data_mesh(D)`` run's sample.  A world of D gloo
ranks (``tests/torch_world.py``) runs ``grep_file`` (one pattern),
``grep_file_multi`` (four, one of them holding a newline) and
``sample_file`` (k = 64), D = 2 and 4, with the tree and gather merges;
the JAX package runs the same on a CPU mesh of D devices, 4 KB chunks
(the sample's map is the Pallas kernel, interpreted).  Every count, line
count and sampled token equals the JAX one, and grep does not depend on
D.
"""

import numpy as np
import pytest

import torch_world
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import grep as jgrep
from mapreduce_tpu.models import sample as jsample
from mapreduce_tpu.parallel.mesh import data_mesh

JCFG = JConfig(backend="pallas", pallas_max_token=8, chunk_bytes=4096,
               table_capacity=4096, rescue_overlong=4)
CFG = {"backend": "pallas", "pallas_max_token": 8, "chunk_bytes": 4096,
       "table_capacity": 4096, "rescue_overlong": 4}
STRATEGIES = ("tree", "gather")
SIZES = (2, 4)
ONE = ["ab"]
FOUR = ["ab", "b\nc", "cab", "q"]
K = 64


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Short words over a small alphabet, so matches cross words and
    lines; many lines span a chunk join; a token longer than W = 8 now and
    then (out of the sample's population); ~9 chunks."""
    rng = np.random.default_rng(11)
    letters = np.frombuffer(b"abcq", np.uint8)
    parts = []
    for i in range(6000):
        n = int(rng.integers(1, 6))
        parts.append(b"abcabcabcab" if i % 700 == 350
                     else letters[rng.integers(0, 4, n)].tobytes())
        parts.append(b"\n" if rng.random() < 0.02 else b" ")
    p = tmp_path_factory.mktemp("grep") / "c.txt"
    p.write_bytes(b"".join(parts))
    return str(p)


@pytest.fixture(scope="module")
def worlds(corpus, tmp_path_factory):
    cases = []
    for s in STRATEGIES:
        for name, pats in (("one", ONE), ("four", FOUR)):
            cases.append({"name": f"grep-{name}-{s}", "kind": "grep_file",
                          "args": {"path": corpus, "patterns": pats,
                                   "config": CFG, "merge_strategy": s}})
        cases.append({"name": f"sample-{s}", "kind": "sample_file",
                      "args": {"path": corpus, "k": K, "config": CFG,
                               "merge_strategy": s}})
    cases.append({"name": "grep-keyrange", "kind": "grep_file",
                  "args": {"path": corpus, "patterns": ONE, "config": CFG,
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
            mesh = data_mesh(d)
            for s in STRATEGIES:
                r = jgrep.grep_file(corpus, ONE[0].encode(), JCFG, mesh=mesh,
                                    merge_strategy=s)
                out[d, "one", s] = [(r.matches, r.lines)]
                out[d, "four", s] = [
                    (r.matches, r.lines) for r in jgrep.grep_file_multi(
                        corpus, [p.encode() for p in FOUR], JCFG, mesh=mesh,
                        merge_strategy=s)]
                r = jsample.sample_file(corpus, K, JCFG, mesh=mesh,
                                        merge_strategy=s)
                out[d, "sample", s] = (list(r.tokens), r.total)
    return out


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("patterns", ("one", "four"))
def test_grep_matches_jax(worlds, jax_runs, d, strategy, patterns):
    want = jax_runs[d, patterns, strategy]
    for rank in range(d):  # grep's counts are every rank's
        assert worlds[d][rank][f"grep-{patterns}-{strategy}"] == want
    assert all(lines for _, lines in want)


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sample_matches_jax(worlds, jax_runs, d, strategy):
    want = jax_runs[d, "sample", strategy]
    assert worlds[d][0][f"sample-{strategy}"] == want
    assert len(want[0]) == K
    assert worlds[d][1][f"sample-{strategy}"] is None


def test_grep_does_not_depend_on_d_and_refuses_keyrange(worlds):
    for patterns in ("one", "four"):
        want = worlds[2][0][f"grep-{patterns}-tree"]
        for d in SIZES:
            for s in STRATEGIES:
                assert worlds[d][0][f"grep-{patterns}-{s}"] == want
    for d in SIZES:
        err = worlds[d][0]["grep-keyrange"]
        assert err[0] == "error" and "keyrange_merge hook" in err[1], err
