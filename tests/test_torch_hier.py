"""Streamed runs over a two-level mesh of CPU ranks against the JAX package
on ``two_level_mesh``.

A world of 4 gloo ranks laid out as 2 hosts of 2 (``tests/torch_world.py``,
``hosts=2``: ``LOCAL_WORLD_SIZE`` 2, ``GROUP_RANK`` the node) runs the
port's ``run_job`` over ``two_level_mesh(2, 2)``; the JAX package runs the
same on ``two_level_mesh(2, 2)`` of 4 CPU devices (backend pallas, the
Pallas kernel interpreted, 4 KB chunks).  Every field of the finished
state equals the JAX one as uint32, on every rank, with the row bases:
the word count under tree, gather, keyrange, hier-tree-tree and
hier-kr-tree (a two-level mesh merges tree and gather level by level,
within a host first, as the JAX Engine does), bigrams, whose seam carry
and grep, whose line carry keep one operand's leaves through that order.
A 4 x 1 world (4 hosts of one rank) equals ``two_level_mesh(4, 1)``.
Snapshots at 2 x 2 (leaves ``[4, ...]``) resume across packages both
ways.  The world's helpers map a host to a node: ``process_index`` is
``RANK // LOCAL_WORLD_SIZE``, so ``host_byte_range`` and ``host_shards``
give the JAX package's values for 2 hosts, and the levels' groups hold
the ranks of ``(replica = r // L, data = r % L)``.
"""

import json
import shutil

import numpy as np
import pytest

import torch_world
from mapreduce_tpu.config import Config as JConfig
from mapreduce_tpu.models import grep as jgrep
from mapreduce_tpu.models import wordcount as jwc
from mapreduce_tpu.parallel import distributed as jdist
from mapreduce_tpu.parallel.mesh import two_level_mesh
from mapreduce_tpu.runtime import executor as jexecutor
from mapreduce_tpu_torch.runtime import checkpoint as ckpt

JCFG = JConfig(backend="pallas", map_impl="split", combiner="off",
               pallas_max_token=8, chunk_bytes=4096, table_capacity=2048,
               rescue_overlong=4)
CFG = {"backend": "pallas", "map_impl": "split", "combiner": "off",
       "pallas_max_token": 8, "chunk_bytes": 4096, "table_capacity": 2048,
       "rescue_overlong": 4}
STRATEGIES = ("tree", "gather", "keyrange", "hier-tree-tree", "hier-kr-tree")
FOUR = ["ab", "b\ncd", "cab", "q"]
SIZE, SHARDS = 1_000_003, 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Short words over a small alphabet (matches cross words and lines,
    lines cross chunk joins), a few hundred distinct words and a token
    longer than W = 8 now and then; ~3 steps of 4 rows."""
    rng = np.random.default_rng(41)
    letters = np.frombuffer(b"abcdq", np.uint8)
    parts = []
    for i in range(9000):
        n = int(rng.integers(1, 5))
        parts.append(b"abcabcabcab" if i % 900 == 450
                     else letters[rng.integers(0, 5, n)].tobytes())
        parts.append(b"\n" if rng.random() < 0.02 else b" ")
    p = tmp_path_factory.mktemp("hier") / "c.txt"
    p.write_bytes(b"".join(parts))
    return str(p)


def _run(name, job, corpus, strategy="tree", mesh=(2, 2), **kw):
    return {"name": name, "kind": "run_job",
            "args": {"job": job, "path": corpus, "config": CFG,
                     "merge_strategy": strategy, "mesh": list(mesh), **kw}}


def _jjob(kind):
    if kind == "wordcount":
        return jwc.WordCountJob(JCFG)
    if kind == "ngram":
        return jwc.NGramCountJob(2, JCFG)
    return jgrep.MultiGrepJob([p.encode() for p in FOUR])


def _copy(src, dst) -> str:
    shutil.copy(src, dst)
    shutil.copy(ckpt.integrity_path(str(src)), ckpt.integrity_path(str(dst)))
    return str(dst)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX references (one step program a job kind and mesh shape),
    the 2 x 2 and 4 x 1 worlds, and the JAX package resuming the port's
    snapshot."""
    d = tmp_path_factory.mktemp("snap")
    out = {"dir": d}
    jobs = {"ngram": {"n": 2}, "grep_multi": {"patterns": FOUR}}
    with torch_world.shared_jax_engines():
        m22, m41 = two_level_mesh(2, 2), two_level_mesh(4, 1)
        # The JAX snapshot the port's world resumes comes first; then the
        # worlds run in the background while the JAX references compute.
        out["jax-count"] = jexecutor.count_file(
            corpus, JCFG, mesh=m22, merge_strategy="hier-kr-tree",
            checkpoint_path=str(d / "jax.npz"), checkpoint_every=1)
        _copy(d / "jax.npz.prev", d / "from-jax.npz")

        cases = [{"name": "topology", "kind": "topology",
                  "args": {"size": SIZE, "shards": SHARDS, "mesh": [2, 2]}}]
        cases += [_run(f"wordcount-{s}", "wordcount", corpus, s)
                  for s in STRATEGIES]
        cases += [_run("ngram-tree", "ngram", corpus, **jobs["ngram"])]
        cases += [_run(f"grep_multi-{s}", "grep_multi", corpus, s,
                       **jobs["grep_multi"]) for s in ("tree", "gather")]
        snap = {"path": corpus, "config": CFG,
                "merge_strategy": "hier-kr-tree", "mesh": [2, 2]}
        cases += [{"name": "count-run", "kind": "count_file",
                   "args": dict(snap, checkpoint_path=str(d / "port.npz"),
                                checkpoint_every=1)},
                  {"name": "count-resume", "kind": "count_file",
                   "args": dict(snap,
                                checkpoint_path=str(d / "from-jax.npz"))},
                  {"name": "hier-one-axis", "kind": "run_job",
                   "args": {"job": "wordcount", "path": corpus,
                            "config": CFG,
                            "merge_strategy": "hier-tree-tree"}},
                  {"name": "bad-mesh", "kind": "topology",
                   "args": {"size": SIZE, "shards": SHARDS,
                            "mesh": [3, 1]}}]
        cases41 = [_run(f"wordcount-{s}", "wordcount", corpus, s, (4, 1))
                   for s in ("tree", "hier-kr-tree")]
        cases41 += [_run("grep_multi-gather", "grep_multi", corpus,
                         "gather", (4, 1), **jobs["grep_multi"]),
                    {"name": "topology", "kind": "topology",
                     "args": {"size": SIZE, "shards": SHARDS,
                              "mesh": [4, 1]}}]
        tmp22, tmp41 = (tmp_path_factory.mktemp(n) for n in ("w22", "w41"))
        worlds = torch_world.Later(lambda: (
            torch_world.spawn_world(4, cases, tmp22, hosts=2,
                                    group_timeout_s=60),
            torch_world.spawn_world(4, cases41, tmp41, hosts=4,
                                    group_timeout_s=60)))
        for s in STRATEGIES:
            out["jax", "wordcount", s] = jexecutor.run_job(
                _jjob("wordcount"), corpus, JCFG, mesh=m22,
                merge_strategy=s)
        out["jax", "ngram", "tree"] = jexecutor.run_job(
            _jjob("ngram"), corpus, JCFG, mesh=m22)
        for s in ("tree", "gather"):
            out["jax", "grep_multi", s] = jexecutor.run_job(
                _jjob("grep"), corpus, JCFG, mesh=m22, merge_strategy=s)
        for s in ("tree", "hier-kr-tree"):
            out["jax41", "wordcount", s] = jexecutor.run_job(
                _jjob("wordcount"), corpus, JCFG, mesh=m41,
                merge_strategy=s)
        out["w22"], out["w41"] = worlds.result()
        out["jax-resume"] = jexecutor.count_file(
            corpus, JCFG, mesh=m22, merge_strategy="hier-kr-tree",
            checkpoint_path=_copy(d / "port.npz.prev", d / "from-port.npz"))
    return out


def _ok(x):
    assert not (type(x) is tuple and x[:1] == ("error",)), x
    return x


def _assert_value(want, got):
    for f in want.value._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got["value"], f)).astype(np.uint32),
            np.asarray(getattr(want.value, f)).astype(np.uint32),
            err_msg=f)
    np.testing.assert_array_equal(got["bases"], want.bases)
    assert got["bytes"] == want.metrics.bytes_processed


CASES22 = [("wordcount", s) for s in STRATEGIES] \
    + [("ngram", "tree"), ("grep_multi", "tree"), ("grep_multi", "gather")]


@pytest.mark.parametrize("job,strategy", CASES22)
def test_two_by_two_equals_jax(runs, job, strategy):
    """Every field of the finished state as uint32, on every rank."""
    want = runs["jax", job, strategy]
    for rank in range(4):
        _assert_value(want, _ok(runs["w22"][rank][f"{job}-{strategy}"]))


@pytest.mark.parametrize("job,strategy", [
    ("wordcount", "tree"), ("wordcount", "hier-kr-tree"),
    ("grep_multi", "gather")])
def test_four_by_one_equals_jax(runs, job, strategy):
    """The word count against ``two_level_mesh(4, 1)``; grep's gather
    folds every level left in rank order, so its state on 4 x 1 is the
    JAX one on 2 x 2 (the JAX package gives one state for both)."""
    want = runs["jax41", job, strategy] if job == "wordcount" \
        else runs["jax", job, strategy]
    for rank in range(4):
        _assert_value(want, _ok(runs["w41"][rank][f"{job}-{strategy}"]))


def test_strategies_agree_and_grep_lines_cross_hosts(runs):
    """Nothing spills, so every strategy gives one table; grep counts
    lines that span the chunk joins between hosts."""
    head = runs["w22"][0]
    want = head["wordcount-tree"]["value"]
    for s in STRATEGIES:
        for f in want._fields:
            np.testing.assert_array_equal(
                getattr(head[f"wordcount-{s}"]["value"], f),
                getattr(want, f), err_msg=(s, f))
    assert int(np.asarray(want.dropped_uniques)) == 0
    value = head["grep_multi-tree"]["value"]
    assert all(int(x) for x in np.asarray(value.lines_lo)), value


def _levels(sent: dict) -> dict:
    """``{(op, level): bytes}`` of a run's ``collectives.bytes_sent``."""
    out = {}
    for key, v in sent.items():
        labels = dict(x.split("=") for x in key[key.index("{") + 1:-1]
                      .split(","))
        out[labels["op"], labels["level"]] = v
    return out


def test_merges_run_level_by_level(runs):
    """Where each strategy's bytes go on 2 x 2: tree, gather and
    hier-tree-tree one state a level (within a host, then across hosts),
    keyrange one round over the flattened mesh, hier-kr-tree keyrange
    within a host and one result table across hosts.  The flattened mesh
    also carries the start-up agreement (three words)."""
    table = (7 * CFG["table_capacity"] + 4) * 8  # a packed CountTable
    agree = 3 * 3 * 8
    want = {"tree": {("exchange", "data"): table,
                     ("exchange", "replica"): table},
            "gather": {("all_gather", "data"): table,
                       ("all_gather", "replica"): table},
            "keyrange": {("all_to_all", "world"), ("all_gather", "world")},
            "hier-tree-tree": {("exchange", "data"): table,
                               ("exchange", "replica"): table},
            "hier-kr-tree": {("all_to_all", "data"), ("all_gather", "data"),
                             ("exchange", "replica")}}
    for res in runs["w22"]:
        for s in STRATEGIES:
            got = _levels(res[f"wordcount-{s}"]["sent"])
            assert got.pop(("all_gather", "world")) \
                >= (agree if s != "keyrange" else agree + 1), s
            if isinstance(want[s], dict):
                assert got == want[s], s
            else:
                assert set(got) == want[s] - {("all_gather", "world")}, s
        assert _levels(res["wordcount-hier-kr-tree"]["sent"])[
            "exchange", "replica"] == (7 * CFG["table_capacity"] + 4) * 8


def test_snapshot_resumes_across_packages(runs):
    """At 2 x 2: the snapshots are equal leaf for leaf with ``n_devices``
    4; a JAX snapshot resumes in the port's world and a port snapshot in
    the JAX package, each to the uninterrupted result."""
    d = runs["dir"]
    want = np.load(d / "jax.npz")
    got = np.load(d / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k == "__meta":
            assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(bytes(got["__meta"]))["n_devices"] == 4
    fields = ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count")
    ref = runs["jax-count"]
    for name in ("count-run", "count-resume"):
        got_r = _ok(runs["w22"][0][name])
        for f in fields:
            assert got_r[f] == getattr(ref, f), (name, f)
        assert all(w[name] is None for w in runs["w22"][1:])
    for f in fields:
        assert getattr(runs["jax-resume"], f) == getattr(ref, f), f


def test_hosts_are_nodes_as_in_jax(runs):
    """``process_index`` is the node, not the rank: the helpers give the
    JAX functions' values for ``process_index`` p of ``process_count`` 2
    (of 4 for 4 x 1), and the mesh's levels hold the JAX mesh's rows and
    columns."""
    for world, hosts in (("w22", 2), ("w41", 4)):
        local = 4 // hosts
        for rank, res in enumerate(runs[world]):
            top = _ok(res["topology"])
            p = rank // local
            assert (top["process_index"], top["process_count"],
                    top["local_device_count"]) == (p, hosts, local)
            assert tuple(top["byte_range"]) \
                == jdist.host_byte_range(SIZE, p, hosts)
            assert top["shards"] == list(jdist.host_shards(SHARDS, p, hosts))
            assert top["local"]["ranks"] \
                == list(range(p * local, (p + 1) * local))
            assert top["global"]["ranks"] == [0, 1, 2, 3]
            r_, l_ = hosts, local
            grid = np.asarray(two_level_mesh(r_, l_).device_ids)
            mesh = top["mesh"]
            row, col = divmod(rank, l_)
            assert (mesh["outer"]["rank"], mesh["inner"]["rank"]) \
                == (row, col)
            assert [grid.ravel().tolist().index(x) for x in grid[row]] \
                == mesh["inner"]["ranks"]
            assert [grid.ravel().tolist().index(x) for x in grid[:, col]] \
                == mesh["outer"]["ranks"]
            for level in ("outer", "inner"):
                assert mesh[level]["group_rank"] in (
                    None if mesh[level]["size"] == 1 else
                    mesh[level]["rank"],)


def test_two_level_refusals(runs):
    """A ``hier-*`` strategy on one axis is the JAX Engine's error, and a
    mesh that does not hold the world is refused with the JAX message."""
    for res in runs["w22"]:
        err = res["hier-one-axis"]
        assert err[0] == "error" and "composes two mesh levels" in err[1]
        err = res["bad-mesh"]
        assert err[0] == "error" and "requested 3 devices" in err[1], err
