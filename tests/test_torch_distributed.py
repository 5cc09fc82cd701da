"""Streamed word count over D CPU ranks against the JAX package on
``data_mesh(D)``.

A world of D gloo ranks (``tests/torch_world.py``) runs the port's
``run_job`` and ``count_file`` with each merge strategy; the JAX package
runs ``run_job``/``count_file`` on a CPU mesh of D devices, backend
pallas (the Pallas kernel interpreted), 4 KB chunks.  The finished table,
the row bases and the recovered result (words, counts, order, total,
distinct, ``dropped_*``) equal the JAX ones exactly, for D = 2 and 4 with
tree, gather and keyrange, D = 3 with gather and keyrange (and tree,
which takes gather there), on one file with overlong tokens and on a
3-file corpus, and for the top-k job; every rank holds the same value and
only the coordinator returns a result.  The result does not depend on D.
Across ranks window replay and preemption run: a ``retry`` run equals
the fault-free one, an injected preemption ends every rank with the same
cursor, and a fault plan under an explicit policy runs exact.
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
from mapreduce_tpu_torch.utils import oracle

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=4096, table_capacity=4096,
               rescue_overlong=4)
CFG = {k: v for k, v in dataclasses.asdict(
    convert.config_from_dict(dataclasses.asdict(JCFG))).items()
    if k in ("backend", "map_impl", "combiner", "pallas_max_token",
             "chunk_bytes", "table_capacity", "rescue_overlong")}
STRATEGIES = ("tree", "gather", "keyrange")
TOPK = 20


def _text(seed: int, n_words: int) -> bytes:
    """Zipf words with a token longer than W = 8 now and then."""
    rng = np.random.default_rng(seed)
    vocab = [b"w%x" % i for i in range(300)] + [b"abcdefgh"]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, n_words)]
    for i in range(150, len(words), 1100):
        words[i] = b"spread_over_ranks%d" % (i % 3)
    return b" ".join(words)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    one = d / "one.txt"
    one.write_bytes(_text(5, 9000))  # ~11 chunks
    three = []
    for i, n in enumerate((2500, 400, 3000)):
        p = d / f"part{i}.txt"
        p.write_bytes(_text(20 + i, n))
        three.append(str(p))
    return {"one": str(one), "three": three}


def _cases(d: int, corpus) -> list:
    cases = []
    for s in STRATEGIES:
        cases.append({"name": f"value-{s}", "kind": "run_job",
                      "args": {"job": "wordcount", "path": corpus["one"],
                               "config": CFG, "merge_strategy": s}})
        cases.append({"name": f"count-{s}", "kind": "count_file",
                      "args": {"path": corpus["one"], "config": CFG,
                               "merge_strategy": s}})
        cases.append({"name": f"topk-{s}", "kind": "count_file",
                      "args": {"path": corpus["one"], "config": CFG,
                               "merge_strategy": s, "top_k": TOPK}})
    if d == 2:
        cases.append({"name": "three-tree", "kind": "count_file",
                      "args": {"path": corpus["three"], "config": CFG}})
        cases.append({"name": "merge-every-tree", "kind": "count_file",
                      "args": {"path": corpus["one"],
                               "config": dict(CFG, merge_every=3)}})
        cases.append({"name": "merge-every-keyrange", "kind": "run_job",
                      "args": {"job": "wordcount", "path": corpus["one"],
                               "config": dict(CFG, merge_every=3),
                               "merge_strategy": "keyrange"}})
        cases.append({"name": "retry", "kind": "count_file",
                      "args": {"path": corpus["one"], "config": CFG,
                               "retry": 1}})
        cases.append({"name": "preempt", "kind": "count_file",
                      "args": {"path": corpus["one"],
                               "config": dict(CFG, fault_plan=(
                                   "at=token-wait:1:preemption"))}})
        policy = {"transient_retries": 1, "backoff_base_s": 0.0,
                  "jitter_frac": 0.0}
        cases.append({"name": "seam-faults", "kind": "count_file",
                      "args": {"path": corpus["one"],
                               "config": dict(CFG, failure_policy=policy,
                                              fault_plan=(
                                   "at=collective-finish:0:transient,"
                                   "at=reader-read:2:transient"))}})
        cases.append({"name": "disagree", "kind": "run_job",
                      "args": {"job": "wordcount", "path": corpus["one"],
                               "config": CFG, "telemetered_ranks": [0],
                               "ledger": corpus["one"] + ".ledger"}})
        cases.append({"name": "dispatch-fault", "kind": "count_file",
                      "args": {"path": corpus["one"],
                               "config": dict(CFG, failure_policy=policy,
                                              fault_plan=(
                                   "at=dispatch:1:transient"))}})
    return cases


@pytest.fixture(scope="module")
def worlds(corpus, tmp_path_factory):
    """The port's worlds, spawned in the background while ``jax_runs``
    computes the references."""
    tmp = {d: tmp_path_factory.mktemp(f"w{d}") for d in (2, 3, 4)}
    return torch_world.Later(lambda: {
        d: torch_world.spawn_world(d, _cases(d, corpus), tmp[d])
        for d in (2, 3, 4)})


@pytest.fixture(scope="module")
def jax_runs(corpus):
    """The JAX references, each computed once (one step program a mesh
    size, shared by the strategies)."""
    out = {}
    with torch_world.shared_jax_engines():
        for d in (2, 3, 4):
            mesh = data_mesh(d)
            for s in STRATEGIES:
                rr = jexecutor.run_job(jwc.WordCountJob(JCFG), corpus["one"],
                                       JCFG, mesh=mesh, merge_strategy=s)
                out[d, "value", s] = rr
                out[d, "count", s] = jexecutor.count_file(
                    corpus["one"], JCFG, mesh=mesh, merge_strategy=s)
                out[d, "topk", s] = jexecutor.count_file(
                    corpus["one"], JCFG, mesh=mesh, merge_strategy=s,
                    top_k=TOPK)
        out[2, "three", "tree"] = jexecutor.count_file(
            corpus["three"], JCFG, mesh=data_mesh(2))
    return out


FIELDS = ("words", "counts", "total", "distinct", "dropped_uniques",
          "dropped_count")


def _assert_result(want, got: dict):
    for f in FIELDS:
        assert getattr(want, f) == got[f], f


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


@pytest.mark.parametrize("d", (2, 3, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_job_value_matches_jax(worlds, jax_runs, d, strategy):
    """The finished table and the row bases, every field exactly, on every
    rank."""
    want = jax_runs[d, "value", strategy]
    for rank in range(d):
        got = _ok(worlds[d][rank][f"value-{strategy}"])
        for f in want.value._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got["value"], f)),
                np.asarray(getattr(want.value, f)), err_msg=f)
        np.testing.assert_array_equal(got["bases"], want.bases)
        assert got["bases"].shape[1] == d
        assert got["bytes"] == want.metrics.bytes_processed


@pytest.mark.parametrize("d", (2, 3, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ("count", "topk"))
def test_count_file_matches_jax(worlds, jax_runs, corpus, d, strategy,
                                kind):
    got = _ok(worlds[d][0][f"{kind}-{strategy}"])
    _assert_result(jax_runs[d, kind, strategy], got)
    assert all(w[f"{kind}-{strategy}"] is None for w in worlds[d][1:])
    if kind == "count":
        with open(corpus["one"], "rb") as f:
            assert dict(zip(got["words"], got["counts"])) \
                == oracle.word_counts(f.read())


def test_result_does_not_depend_on_d(worlds):
    for kind in ("count", "topk"):
        want = worlds[2][0][f"{kind}-tree"]
        for d in (3, 4):
            for s in STRATEGIES:
                assert worlds[d][0][f"{kind}-{s}"] == want, (kind, d, s)


def test_multi_file_corpus_matches_jax(worlds, jax_runs):
    _assert_result(jax_runs[2, "three", "tree"],
                   _ok(worlds[2][0]["three-tree"]))


def test_staged_merges_across_ranks_match_jax(worlds, jax_runs):
    """``merge_every=3`` on 2 ranks: the tree finish flushes both operands'
    staged batches, the keyrange finish flushes first; the result and the
    finished table equal the JAX package's (nothing spills here, so the
    staging changes no field)."""
    _assert_result(jax_runs[2, "count", "tree"],
                   _ok(worlds[2][0]["merge-every-tree"]))
    assert worlds[2][1]["merge-every-tree"] is None
    want = jax_runs[2, "value", "keyrange"]
    for rank in range(2):
        got = _ok(worlds[2][rank]["merge-every-keyrange"])
        for f in want.value._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got["value"], f)),
                np.asarray(getattr(want.value, f)), err_msg=f)


def test_replay_and_preemption_refused_across_ranks(worlds):
    """Once refused (naming A9 (ii)), now run: ``retry`` > 0 arms window
    replay on every rank, and an injected preemption drains every rank
    and ends each with the same ``Preempted`` cursor."""
    assert _ok(worlds[2][0]["retry"]) == worlds[2][0]["count-tree"]
    assert worlds[2][1]["retry"] is None
    errs = [worlds[2][rank]["preempt"] for rank in (0, 1)]
    for err in errs:
        assert err[0] == "error" and err[1].startswith("Preempted("), err
    assert errs[0] == errs[1]


def test_ranks_that_disagree_on_the_run_are_refused(worlds):
    """One rank telemetered, the other not: their stats modes differ, so
    their collectives would pair up wrongly; the start-up agreement
    refuses the run on both ranks instead of letting them hang."""
    for rank in (0, 1):
        err = worlds[2][rank]["disagree"]
        assert err[0] == "error" and "disagree" in err[1], err


def test_fault_plan_on_seams_that_never_replay(worlds):
    """An explicit failure policy keeps its budgets on the seams that
    never replay: a transient fault at the collective finish and at a
    reader read is retried on every rank alike, and the result is the
    fault-free one.  Its dispatch budget arms window replay across the
    ranks too, so a dispatch fault is replayed and the result is exact."""
    assert _ok(worlds[2][0]["seam-faults"]) == worlds[2][0]["count-tree"]
    assert _ok(worlds[2][0]["dispatch-fault"]) == worlds[2][0]["count-tree"]
    assert worlds[2][1]["dispatch-fault"] is None
